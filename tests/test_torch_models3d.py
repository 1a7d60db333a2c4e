"""The port's 3D problems (7-point finite differences on the unit cube)
against the JAX package, float64, CPU.

The generators must give JAX's (A, b, shape) exactly; the port's planner
JAX's ``Plan`` array for array, on an exact plan and on
``tests/test_compressed.py``'s compressed 3D input (helmholtz3d(14, k=8),
leafmax 60, ``swlevel=-3, swsize=8, atol=rtol=1e-4``), low-rank and
structured; the exact 3D factor's solve JAX's to 1e-10 relative; and, handed
JAX's sketches, the compressed and structured 3D factors JAX's ranks, their
low-rank products to 1e-9 relative and JAX's GMRES iteration count."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht
from hsolve_torch.factor import CompressedLevel, _factor_levels, solve_with_data
from hsolve_torch.interop import plan_to_torch
from hsolve_torch.structured import StructuredLevel
from test_torch_plan import _assert_plans_equal
from test_torch_structured import jax_sketch

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function

# tests/test_compressed.py:71-84's input
COMP3D = (("helmholtz3d", 14, {"k": 8.0}), 60,
          dict(swlevel=-3, swsize=8, atol=1e-4, rtol=1e-4))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    if ref.size == 0:
        return 0.0
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _lowrank(U, V):
    return np.asarray(U) @ np.swapaxes(np.asarray(V), -1, -2)


@pytest.mark.parametrize("name,kw", [("poisson3d", {}),
                                     ("helmholtz3d", {}),
                                     ("helmholtz3d", {"k": 10.0})])
@pytest.mark.parametrize("n", [6, 9])
def test_3d_problems_match_jax(name, kw, n):
    At, bt, st = getattr(ht, name)(n, **kw)
    Aj, bj, sj = getattr(hsolve, name)(n, **kw)
    assert st == sj == (n - 1,) * 3
    assert At.shape == Aj.shape == ((n - 1) ** 3,) * 2
    assert At.dtype == Aj.dtype and (At != Aj).nnz == 0
    assert np.array_equal(At.indptr, Aj.indptr)
    assert np.array_equal(At.indices, Aj.indices)
    assert bt.dtype == bj.dtype and np.array_equal(bt, bj)


@pytest.mark.parametrize("problem,leafmax,opts", [
    (("poisson3d", 9, {}), 40, dict(swlevel=0)),
    (*COMP3D[:2], dict(COMP3D[2], hss=False)),
    (*COMP3D[:2], dict(COMP3D[2], hss=True))])
def test_3d_plan_matches_jax_planner(problem, leafmax, opts):
    name, n, kw = problem
    A, _, shape = getattr(ht, name)(n, **kw)
    P_t = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=leafmax),
                                ht.SolverOptions(**opts))
    P_j = hsolve.plan_factorization(
        A, hsolve.nested_dissection(shape, leafmax=leafmax),
        hsolve.SolverOptions(**opts))
    _assert_plans_equal(P_t, P_j)
    assert any(bp.compress for bp in P_t.batches) == (opts["swlevel"] < 0)
    if opts.get("hss"):
        assert any(bp.structured for bp in P_t.batches)


@pytest.mark.parametrize("name,n,kw,leafmax", [("poisson3d", 9, {}, 40),
                                               ("helmholtz3d", 12, {"k": 8.0}, 40)])
def test_exact_3d_solve_matches_jax(name, n, kw, leafmax):
    A, b, shape = getattr(hsolve, name)(n, **kw)
    plan = hsolve.plan_factorization(
        A, hsolve.nested_dissection(shape, leafmax=leafmax),
        hsolve.SolverOptions(swlevel=0))
    Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(swlevel=0))
    Ft = ht.factor_with_plan(plan, ht.SolverOptions(swlevel=0), device="cpu")
    rng = np.random.default_rng(3)
    for rhs in (np.asarray(b), rng.standard_normal((A.shape[0], 2))):
        ref = np.asarray(Fj.solve(rhs))
        assert _rel(Ft.solve(rhs).numpy(), ref) < 1e-10


def _gmres_iters_jax(A, b, F):
    _, info = hsolve.gmres_compiled(
        lambda d, v: hsolve.dia_matvec(d, v), jfactor.solve_with_data,
        jnp.asarray(b), reltol=1e-9, restart=30, maxiter=60,
        mv_data=hsolve.to_dia(A), M_data=F.solve_data)
    return info


def _gmres_iters_port(A, b, F):
    op, mv = ht.spmv_format(A, device="cpu")
    x, info = ht.gmres_compiled(mv, solve_with_data, torch.as_tensor(b),
                                reltol=1e-9, restart=30, maxiter=60, mv_data=op,
                                M_data=F.solve_data)
    return info, np.linalg.norm(A @ x.numpy() - b) / np.linalg.norm(b)


@pytest.mark.parametrize("hss", [False, True])
def test_compressed_3d_factor_matches_jax(hss):
    """With JAX's sketches, on tests/test_compressed.py's 3D input: per
    compressed level equal ranks (low-rank: both sides' per-front ranks;
    structured: the largest interpolation ranks), the Gauss transforms'
    products ``LU_ LV_^T`` and ``RU_ RV_^T`` within 1e-9 relative, JAX's rank
    report and its GMRES iteration count."""
    (name, n, kw), leafmax, copts = COMP3D
    opts = dict(copts, hss=hss)
    A, b, shape = getattr(hsolve, name)(n, **kw)
    b = np.asarray(b)
    jopts = hsolve.SolverOptions(**opts)
    plan = hsolve.plan_factorization(
        A, hsolve.nested_dissection(shape, leafmax=leafmax), jopts)
    Fj = jfactor._factor_levels(plan, jopts, jnp.float64, [], {}, None)
    topts = ht.SolverOptions(**opts)
    sketch = jax_sketch(topts.seed)
    tlevels, troot, _ = _factor_levels(plan, plan_to_torch(plan, "cpu"), topts,
                                       torch.float64, sketch)
    assert len(tlevels) == len(Fj.levels)
    kind = StructuredLevel if hss else CompressedLevel
    ncomp = 0
    for i, (tl, jl) in enumerate(zip(tlevels, Fj.levels)):
        bp = plan.batches[i]
        if not bp.compress:
            continue
        if isinstance(tl, kind):
            ncomp += 1
        if isinstance(tl, StructuredLevel):
            assert np.array_equal(tl.rank_maxed.numpy(),
                                  np.asarray(jl.rank_maxed)), i
        else:
            assert np.array_equal(tl.lrank.numpy(), np.asarray(jl.lrank)), i
            assert np.array_equal(tl.rrank.numpy(), np.asarray(jl.rrank)), i
        assert _rel(_lowrank(tl.LU_, tl.LV_), _lowrank(jl.LU_, jl.LV_)) < 1e-9, i
        assert _rel(_lowrank(tl.RU_, tl.RV_), _lowrank(jl.RU_, jl.RV_)) < 1e-9, i
    assert ncomp >= 1
    F_same = ht.factor_with_plan(plan, topts, device="cpu", sketch=sketch)
    assert F_same.rank_report() == Fj.rank_report()
    assert F_same.maxrank() == Fj.maxrank() > 0
    jinfo = _gmres_iters_jax(A, b, Fj)
    info, relres = _gmres_iters_port(A, b, F_same)
    assert jinfo["converged"] and info["converged"] and relres <= 1e-9
    assert info["iters"] == jinfo["iters"]
