"""The port's low-rank compressed slice (``swlevel < 0``, ``hss=False``) against
the JAX package, on one shared plan, float64.

Handed the JAX package's sketches, the port must reproduce its compressed
level records (ranks exactly; low-rank products and Schur complements to
1e-10 relative) and its GMRES iteration counts.  With its own generator it must
converge in at most two more iterations than JAX."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import hsolve
import hsolve_torch as ht
from hsolve_torch.factor import (CompressedLevel, _factor_levels,
                                 solve_with_data)
from hsolve_torch.interop import factorization_from_numpy, plan_to_torch

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # the name hsolve.factor is the function
jsolve_with_data = jfactor.solve_with_data

# the slice's configuration (swlevel=-2, swsize=16, atol=rtol=1e-3, kest=32)
COMP = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3, kest=32, hss=False)
CASES = [("poisson2d", 33, 40, {}), ("helmholtz2d", 48, 40, {"k": 20.0})]


def jax_sketch(seed):
    """The JAX package's sketches: ``split(fold_in(PRNGKey(seed), bidx))``,
    then ``normal(k, (n, s))`` for Abi and Aib (hsolve/factor.py:354, :821)."""
    def draw(bidx, bi, ib):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                   bidx))
        return tuple(torch.as_tensor(np.array(
            jax.random.normal(k, shape, dtype=jnp.float64)))
            for k, shape in zip(keys, (bi, ib)))
    return draw


def _problem(name, n, leafmax, kw, **opts):
    A, b, shape = getattr(hsolve, name)(n, **kw)
    tree = hsolve.nested_dissection(shape, leafmax=leafmax)
    jopts = hsolve.SolverOptions(**{**COMP, **opts})
    return A, np.asarray(b), shape, hsolve.plan_factorization(A, tree, jopts)


def _rel(got, ref):
    ref = np.asarray(ref)
    assert np.shape(got) == ref.shape
    if ref.size == 0:
        return 0.0
    return np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-300)


def _lowrank(U, V):
    return np.asarray(U) @ np.swapaxes(np.asarray(V), -1, -2)


@pytest.mark.parametrize("opts", [{}, {"swlevel": -3, "swsize": 8},
                                  {"kest": -1, "rank_cap": 12},
                                  {"level_caps": (40, 16, 8)},
                                  {"swsize": 10_000}])
@pytest.mark.parametrize("name,n,leafmax", [("poisson2d", 33, 30),
                                            ("helmholtz2d", 48, 40)])
def test_compressed_plan_matches_jax_planner(name, n, leafmax, opts):
    from test_torch_plan import _assert_plans_equal

    A, _, shape = getattr(ht, name)(n)
    o = {**COMP, **opts}
    P_t = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=leafmax),
                                ht.SolverOptions(**o))
    P_j = hsolve.plan_factorization(
        A, hsolve.nested_dissection(shape, leafmax=leafmax),
        hsolve.SolverOptions(**o))
    _assert_plans_equal(P_t, P_j)
    assert any(bp.compress for bp in P_t.batches) == (o["swsize"] < 10_000)


@pytest.mark.parametrize("name,n,leafmax,pkw,kw", [
    (*CASES[0], {}), (*CASES[1], {}), (*CASES[0], {"explicit_inverse": True}),
    (*CASES[0], {"explicit_inverse": True, "fast_inverse": True})])
def test_compressed_levels_match_jax(name, n, leafmax, pkw, kw):
    """Per level, with the JAX sketches: equal ranks, and LU_ LV_^T,
    RU_ RV_^T and the Schur complements within 1e-10 relative (the
    explicit-inverse variants on one problem)."""
    _, _, _, plan = _problem(name, n, leafmax, pkw)
    jlevels, jstacks = [], {}
    jfactor._factor_levels(plan, hsolve.SolverOptions(**COMP, **kw), jnp.float64,
                           jlevels, jstacks, None)
    topts = ht.SolverOptions(**COMP, **kw)
    tlevels, troot, tstacks = _factor_levels(
        plan, plan_to_torch(plan, "cpu"), topts, torch.float64,
        jax_sketch(topts.seed))
    assert troot is None and len(tlevels) == len(jlevels)
    ncomp = 0
    for i, (tl, jl) in enumerate(zip(tlevels, jlevels)):
        assert isinstance(tl, CompressedLevel) == plan.batches[i].compress
        assert isinstance(tl, CompressedLevel) == hasattr(jl, "LU_")
        if isinstance(tl, CompressedLevel):
            ncomp += 1
            assert np.array_equal(tl.lrank.numpy(), np.asarray(jl.lrank)), i
            assert np.array_equal(tl.rrank.numpy(), np.asarray(jl.rrank)), i
            assert _rel(_lowrank(tl.LU_, tl.LV_), _lowrank(jl.LU_, jl.LV_)) \
                < 1e-10, (i, "L")
            assert _rel(_lowrank(tl.RU_, tl.RV_), _lowrank(jl.RU_, jl.RV_)) \
                < 1e-10, (i, "R")
            assert tl.LU_.shape[-1] == plan.batches[i].rank_cap
        if tstacks[i].numel():
            assert _rel(tstacks[i].numpy(), jstacks[i]) < 1e-10, (i, "S")
        assert (tl.dinv is None) != bool(kw)
    assert ncomp >= 3


def _jax_gmres(A, b, plan, opts):
    Fj = hsolve.factor_with_plan(plan, opts)
    _, info = hsolve.gmres_compiled(
        lambda d, v: hsolve.dia_matvec(d, v), jsolve_with_data, jnp.asarray(b),
        reltol=1e-9, restart=30, maxiter=60, mv_data=hsolve.to_dia(A),
        M_data=Fj.solve_data)
    return Fj, info


def _port_gmres(A, b, F):
    op, mv = ht.spmv_format(A, device="cpu")
    x, info = ht.gmres_compiled(mv, solve_with_data, torch.as_tensor(b),
                                reltol=1e-9, restart=30, maxiter=60, mv_data=op,
                                M_data=F.solve_data)
    relres = np.linalg.norm(A @ x.numpy() - b) / np.linalg.norm(b)
    return info, relres


@pytest.mark.parametrize("name,n,leafmax,pkw", CASES)
def test_compressed_gmres_iterations_match_jax(name, n, leafmax, pkw):
    """With the JAX sketches the port's preconditioner takes JAX's GMRES
    iteration count; with its own generator at most two more.  The JAX
    factors carried over with factorization_from_numpy give the JAX solves
    through the port's sweeps (kernels C and E around the pivot solves)."""
    A, b, _, plan = _problem(name, n, leafmax, pkw)
    Fj, ij = _jax_gmres(A, b, plan, hsolve.SolverOptions(**COMP))
    assert ij["converged"]
    topts = ht.SolverOptions(**COMP)
    F_same = ht.factor_with_plan(plan, topts, device="cpu",
                                 sketch=jax_sketch(topts.seed))
    F_own = ht.factor_with_plan(plan, topts, device="cpu")
    info, relres = _port_gmres(A, b, F_same)
    assert info["converged"] and info["iters"] == ij["iters"] and relres <= 1e-9
    assert F_same.maxrank() == Fj.maxrank()
    assert F_same.rank_report() == Fj.rank_report()
    info, relres = _port_gmres(A, b, F_own)
    assert info["converged"] and info["iters"] <= ij["iters"] + 2
    assert relres <= 1e-9
    assert not F_own.rank_report()["saturated"]

    Ft = factorization_from_numpy(Fj.levels, Fj.root, plan.perm, "cpu")
    assert sum(isinstance(lv, CompressedLevel) for lv in Ft.levels) >= 3
    rng = np.random.default_rng(4)
    for rhs in (b, rng.standard_normal((A.shape[0], 2))):
        ref = np.asarray(Fj.solve(rhs))
        np.testing.assert_allclose(Ft.solve(rhs).numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())


def test_adaptive_replan_follows_jax_caps(monkeypatch):
    """A cap too small for the tolerance saturates: both packages re-plan
    with the largest saturated cap doubled, three attempts in all."""
    tfactor = importlib.import_module("hsolve_torch.factor")

    A, b, shape = hsolve.poisson2d(33)
    kw = dict(swlevel=-3, swsize=8, atol=1e-10, rtol=1e-10, rank_cap=4,
              adaptive=True, hss=False)
    caps = {"jax": [], "port": []}
    for mod, tag in ((jfactor, "jax"), (tfactor, "port")):
        orig = mod.plan_factorization

        def record(A_, tree_, opts_, *a, _orig=orig, _tag=tag, **k):
            plan = _orig(A_, tree_, opts_, *a, **k)
            caps[_tag].append(tuple(bp.rank_cap for bp in plan.batches))
            return plan
        monkeypatch.setattr(mod, "plan_factorization", record)
    Fj = hsolve.factor(A, hsolve.nested_dissection(shape, leafmax=30), **kw)
    Ft = ht.factor(A, ht.nested_dissection(shape, leafmax=30), device="cpu",
                   sketch=jax_sketch(123), **kw)
    assert len(caps["jax"]) > 1
    assert caps["port"] == caps["jax"]
    assert Ft.rank_report() == Fj.rank_report()


def test_swsize_gates_compression():
    A, b, shape = ht.poisson2d(33)
    tree = ht.nested_dissection(shape, leafmax=30)
    # nothing is big enough: no compressed batch, so hss=True does not refuse
    F = ht.factor(A, tree, swlevel=-3, swsize=10_000, device="cpu")
    assert F.maxrank() == 0 and F.rank_report() == {"levels": [],
                                                     "saturated": False}
    assert not any(isinstance(lv, CompressedLevel) for lv in F.levels)


def test_tolerance_monotonicity_and_tight_tolerance():
    """The cases of tests/test_compressed.py on the port, with its own
    generator: a tighter tolerance needs no more GMRES iterations and no
    smaller ranks, and a tight one is near exact."""
    A, b, shape = ht.poisson2d(33)
    tree = ht.nested_dissection(shape, leafmax=30)
    iters, ranks = [], []
    for tol in (1e-2, 1e-6):
        F = ht.factor(A, tree, swlevel=-3, swsize=8, atol=tol, rtol=tol,
                      hss=False, device="cpu")
        info, relres = _port_gmres(A, b, F)
        assert info["converged"] and relres < 1e-9
        iters.append(info["iters"])
        ranks.append(F.maxrank())
    assert iters[1] <= iters[0]
    assert 0 < ranks[0] <= ranks[1]
    F = ht.factor(A, ht.nested_dissection(shape, leafmax=40), swlevel=-2,
                  atol=1e-12, rtol=1e-12, hss=False, device="cpu")
    assert F.maxrank() > 0
    x_ref = spla.spsolve(A.tocsc(), b)
    x = F.solve(b).numpy()
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-8
    rep = F.cond_report()
    assert len(rep["levels"]) == len(F.levels) and not rep["risky"]
