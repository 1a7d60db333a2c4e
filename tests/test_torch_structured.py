"""The port's structured (HSS) slice (``swlevel < 0`` with ``hss=True``, the
default) against the JAX package, on one shared plan, float64, CPU.

The problems are tests/test_structured.py's: poisson2d(65) and
helmholtz2d(65, k=15) under nested dissection with leafmax 60, ``swlevel=-4,
swsize=8, leafsize=16``.  Handed the JAX package's sketches, the port must
reproduce its structured levels (per-level largest interpolation ranks
exactly; the low-rank Gauss transforms ``LU_ LV_^T`` and ``RU_ RV_^T`` to 1e-9
relative) and its GMRES iteration counts; with its own generator it must
converge in at most two more iterations.  The JAX factorizations are shared
through module-scoped fixtures (the JAX structured factor compiles slowly on
the CPU)."""

import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import hsolve
import hsolve_torch as ht
from hsolve_torch.factor import _factor_levels, solve_with_data
from hsolve_torch.interop import factorization_from_numpy, plan_to_torch
from hsolve.structured import densify_schur as jdensify_schur
from hsolve_torch.structured import SchurHss, StructuredLevel, densify_schur

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function

CASES = {
    "poisson": (("poisson2d", 65, {}),
                dict(swlevel=-4, swsize=8, atol=1e-6, rtol=1e-6, leafsize=16)),
    "helmholtz": (("helmholtz2d", 65, {"k": 15.0}),
                  dict(swlevel=-4, swsize=8, atol=1e-4, rtol=1e-4, leafsize=16)),
}


def jax_sketch(seed):
    """The JAX package's draws for every key of the port's ``Sketch``: a
    compressed batch's ``split(fold_in(PRNGKey(seed), bidx))`` pair, and a
    structured batch's ``split(fold_in(fold_in(PRNGKey(seed), 7000 + bidx),
    tag), B)``, then per front ``kO, kP = split(k)`` and ``normal(kO | kP,
    (n_pad, s))`` (hsolve/factor.py:899, hsolve/structured.py:320, :425)."""
    def draw(key, shape_a, shape_b):
        root = jax.random.PRNGKey(seed)
        if isinstance(key, int):
            keys = jax.random.split(jax.random.fold_in(root, key))
            return tuple(torch.as_tensor(np.array(jax.random.normal(
                k, sh, dtype=jnp.float64))) for k, sh in zip(keys, (shape_a, shape_b)))
        k0, tag = key
        B, n, s = shape_a
        om, ps = [], []
        for k in jax.random.split(jax.random.fold_in(jax.random.fold_in(root, k0),
                                                     tag), B):
            kO, kP = jax.random.split(k)
            om.append(np.array(jax.random.normal(kO, (n, s), dtype=jnp.float64)))
            ps.append(np.array(jax.random.normal(kP, (n, s), dtype=jnp.float64)))
        return torch.as_tensor(np.stack(om)), torch.as_tensor(np.stack(ps))
    return draw


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    if ref.size == 0:
        return 0.0
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _lowrank(U, V):
    return np.asarray(U) @ np.swapaxes(np.asarray(V), -1, -2)


def _jax_gmres(A, b, F):
    _, info = hsolve.gmres_compiled(
        lambda d, v: hsolve.dia_matvec(d, v), jfactor.solve_with_data,
        jnp.asarray(b), reltol=1e-9, restart=30, maxiter=60,
        mv_data=hsolve.to_dia(A), M_data=F.solve_data)
    return info


def _port_gmres(A, b, F):
    op, mv = ht.spmv_format(A, device="cpu")
    x, info = ht.gmres_compiled(mv, solve_with_data, torch.as_tensor(b),
                                reltol=1e-9, restart=30, maxiter=60, mv_data=op,
                                M_data=F.solve_data)
    return info, np.linalg.norm(A @ x.numpy() - b) / np.linalg.norm(b)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One problem factored by both packages on the JAX plan: the JAX levels
    and Schur stacks (per-batch path), its GMRES run, and the port's levels
    and stacks with the JAX sketches."""
    (name, n, pkw), kw = CASES[request.param]
    A, b, shape = getattr(hsolve, name)(n, **pkw)
    b = np.asarray(b)
    opts_j = hsolve.SolverOptions(**kw)
    plan = hsolve.plan_factorization(A, hsolve.nested_dissection(shape, leafmax=60),
                                     opts_j)
    jlevels, jstacks = [], {}
    Fj = jfactor._factor_levels(plan, opts_j, jnp.float64, jlevels, jstacks, None)
    opts_t = ht.SolverOptions(**kw)
    sketch = jax_sketch(opts_t.seed)
    tlevels, troot, tstacks = _factor_levels(plan, plan_to_torch(plan, "cpu"),
                                             opts_t, torch.float64, sketch)
    return SimpleNamespace(name=request.param, A=A, b=b, shape=shape, kw=kw,
                           plan=plan, Fj=Fj, jstacks=jstacks, tlevels=tlevels,
                           troot=troot, tstacks=tstacks, sketch=sketch,
                           jinfo=_jax_gmres(A, b, Fj))


@pytest.mark.parametrize("name,n,pkw,kw", [
    *[(*p, kw) for p, kw in CASES.values()],
    ("helmholtz2d", 48, {"k": 15.0}, dict(swlevel=-3, swsize=1, atol=1e-4,
                                          rtol=1e-4)),
    ("poisson2d", 65, {}, dict(swlevel=-4, swsize=8, atol=1e-6, rtol=1e-6,
                               leafsize=16, level_caps=(40, 24, 16)))])
def test_structured_plan_matches_jax_planner(name, n, pkw, kw):
    """Array for array, cluster plans, smap and cross strips included."""
    from test_torch_plan import _assert_plans_equal

    A, _, shape = getattr(ht, name)(n, **pkw)
    P_t = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=60),
                                ht.SolverOptions(**kw))
    P_j = hsolve.plan_factorization(A, hsolve.nested_dissection(shape, leafmax=60),
                                    hsolve.SolverOptions(**kw))
    _assert_plans_equal(P_t, P_j)
    assert any(bp.structured for bp in P_t.batches)
    assert any(bp.compress and not bp.structured and bp.cplan is not None
               for bp in P_t.batches)                  # a transition batch


def test_per_node_structured_planner_matches_jax(monkeypatch):
    """Without the native symbolic factorization both packages plan their
    structured batches node by node (tests/test_structured.py's fallback
    case); the port's per-node plan is the JAX package's, array for array."""
    from test_torch_plan import _assert_plans_equal

    from hsolve.utils import trees as jtrees
    from hsolve_torch.utils import trees as ttrees

    A, _, shape = ht.helmholtz2d(48, k=15.0)
    kw = dict(swlevel=-3, swsize=1, atol=1e-4, rtol=1e-4)
    for mod in (jtrees, ttrees):
        monkeypatch.setattr(mod, "_symfact_native", lambda *a, **k: None)
    P_j = hsolve.plan_factorization(A, hsolve.nested_dissection(shape, leafmax=60),
                                    hsolve.SolverOptions(**kw))
    P_t = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=60),
                                ht.SolverOptions(**kw))
    _assert_plans_equal(P_t, P_j)
    assert any(bp.structured for bp in P_t.batches)


def test_structured_levels_match_jax(case):
    """With the JAX sketches: the transition batches' HSS Schur complements,
    and per structured level equal largest interpolation ranks and the
    low-rank Gauss transforms to 1e-9 relative."""
    nstruct = ntrans = 0
    assert case.troot is None and len(case.tlevels) == len(case.Fj.levels)
    for i, (tl, jl) in enumerate(zip(case.tlevels, case.Fj.levels)):
        bp = case.plan.batches[i]
        assert isinstance(tl, StructuredLevel) == bp.structured, i
        if bp.structured:
            nstruct += 1
            assert tl.rank_cap == jl.rank_cap == bp.rank_cap
            assert np.array_equal(tl.rank_maxed.numpy(), np.asarray(jl.rank_maxed))
            assert _rel(_lowrank(tl.LU_, tl.LV_), _lowrank(jl.LU_, jl.LV_)) < 1e-9
            assert _rel(_lowrank(tl.RU_, tl.RV_), _lowrank(jl.RU_, jl.RV_)) < 1e-9
        if isinstance(case.tstacks[i], SchurHss):
            # the compact Schur complements, masked to their content
            ntrans += not bp.structured
            ts, js = case.tstacks[i], case.jstacks[i]
            assert np.array_equal(ts.n1.numpy(), np.asarray(js.n1))
            assert np.array_equal(ts.n2.numpy(), np.asarray(js.n2))
            w = bp.cplan.n_pad
            live = (np.arange(w)[None, :] < (ts.n1 + ts.n2).numpy()[:, None])
            live = live[:, :, None] & live[:, None, :]
            dj = np.asarray(jdensify_schur(js, w)) * live
            assert _rel(densify_schur(ts, w).numpy() * live, dj) < 1e-9, i
    assert nstruct >= 1 and ntrans >= 1


def test_structured_gmres_iterations_match_jax(case):
    """The JAX sketches give JAX's GMRES iteration count, ranks and rank
    report; the port's own generator at most two more iterations, with no
    saturated cap."""
    assert case.jinfo["converged"]
    topts = ht.SolverOptions(**case.kw)
    F_same = ht.factor_with_plan(case.plan, topts, device="cpu",
                                 sketch=case.sketch)
    info, relres = _port_gmres(case.A, case.b, F_same)
    assert info["converged"] and relres <= 1e-9
    assert info["iters"] == case.jinfo["iters"]
    assert F_same.rank_report() == case.Fj.rank_report()
    assert F_same.maxrank() == case.Fj.maxrank()
    F_own = ht.factor_with_plan(case.plan, topts, device="cpu")
    info, relres = _port_gmres(case.A, case.b, F_own)
    assert info["converged"] and relres <= 1e-9
    assert info["iters"] <= case.jinfo["iters"] + 2
    assert not F_own.rank_report()["saturated"]


def test_structured_gmres_history_matches_jax(case):
    """The float64 GMRES (kernels L and M's plain versions) keeps JAX's
    residual history on the structured levels: with the JAX sketches, equal
    counts and histories within 1e-8 relative (the Gauss transforms agree to
    1e-9, and the residuals fall to 1e-9 of ||b||)."""
    F_same = ht.factor_with_plan(case.plan, ht.SolverOptions(**case.kw),
                                 device="cpu", sketch=case.sketch)
    info, _ = _port_gmres(case.A, case.b, F_same)
    assert info["iters"] == case.jinfo["iters"]
    assert _rel(info["resnorm"], case.jinfo["resnorm"]) < 1e-8


def test_port_solve_on_jax_structured_factors(case):
    """factorization_from_numpy carries JAX's structured records over; the
    port's solve sweep (kernels C and E around d_apply) then gives JAX's
    solve to 1e-10 relative."""
    Ft = factorization_from_numpy(case.Fj.levels, case.Fj.root, case.plan.perm,
                                  "cpu")
    assert sum(isinstance(lv, StructuredLevel) for lv in Ft.levels) >= 1
    rng = np.random.default_rng(7)
    for rhs in (case.b, rng.standard_normal((case.A.shape[0], 2))):
        ref = np.asarray(case.Fj.solve(rhs))
        assert _rel(Ft.solve(rhs).numpy(), ref) < 1e-10


def test_structured_solve_accuracy_at_a_tight_tolerance():
    """tests/test_structured.py's accuracy case on the port alone."""
    A, b, shape = ht.poisson2d(65)
    F = ht.factor(A, ht.nested_dissection(shape, leafmax=60), swlevel=-4,
                  swsize=8, atol=1e-8, rtol=1e-8, leafsize=16, device="cpu")
    assert any(isinstance(lv, StructuredLevel) for lv in F.levels)
    x_ref = spla.spsolve(A.tocsc(), b)
    x = F.solve(b).numpy()
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-5

