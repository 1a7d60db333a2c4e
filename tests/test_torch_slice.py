"""The port's exact slice end to end against the JAX package, on one shared plan:
per-level factors, the direct solve, and GMRES iteration counts."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import hsolve
import hsolve_torch as ht
from hsolve_torch.factor import _factor_levels, solve_with_data
from hsolve_torch.interop import plan_to_torch

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # the name hsolve.factor is the function
jsolve_with_data = jfactor.solve_with_data

CASES = [("poisson2d", 33, 40, {}), ("helmholtz2d", 48, 40, {"k": 20.0})]


def _problem(name, n, leafmax, kw):
    A, b, shape = getattr(hsolve, name)(n, **kw)
    tree = hsolve.nested_dissection(shape, leafmax=leafmax)
    plan = hsolve.plan_factorization(A, tree, hsolve.SolverOptions(swlevel=0))
    return A, np.asarray(b), shape, plan


def _rel(got, ref):
    ref = np.asarray(ref)
    assert np.shape(got) == ref.shape
    if ref.size == 0:
        return 0.0
    return np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("name,n,leafmax,kw", CASES)
def test_levels_match_jax(name, n, leafmax, kw, explicit):
    """Per-level L, R and Schur complements S (and D^{-1} in explicit-inverse
    mode) of the port against the JAX factorization of the same plan."""
    _, _, _, plan = _problem(name, n, leafmax, kw)
    jopts = hsolve.SolverOptions(swlevel=0, explicit_inverse=explicit)
    jlevels, jstacks = [], {}
    jfactor._factor_levels(plan, jopts, jnp.float64, jlevels, jstacks, None)
    topts = ht.SolverOptions(swlevel=0, explicit_inverse=explicit)
    tlevels, troot, tstacks = _factor_levels(plan, plan_to_torch(plan, "cpu"),
                                             topts, torch.float64)
    assert troot is None and plan.nb_root == 0
    assert len(tlevels) == len(jlevels)
    for i, (tl, jl) in enumerate(zip(tlevels, jlevels)):
        for f in ("L", "R") + (("dinv",) if explicit else ()):
            assert _rel(getattr(tl, f).numpy(), getattr(jl, f)) < 1e-10, (i, f)
        if tstacks[i].numel():
            assert _rel(tstacks[i].numpy(), jstacks[i]) < 1e-10, (i, "S")
        assert np.array_equal(tl.int_ids.numpy(), np.asarray(jl.int_ids))
        assert np.array_equal(tl.bnd_ids.numpy(), np.asarray(jl.bnd_ids))
        assert (tl.lu is None) == explicit


@pytest.mark.parametrize("name,n,leafmax,kw", CASES)
def test_direct_solve_matches_spsolve(name, n, leafmax, kw):
    A, b, shape, _ = _problem(name, n, leafmax, kw)
    F = ht.factor(A, ht.nested_dissection(shape, leafmax=leafmax), swlevel=0,
                  device="cpu")
    x_ref = spla.spsolve(A.tocsc(), b)
    x = F.solve(b)
    assert x.shape == (A.shape[0],) and x.dtype == torch.float64
    assert _rel(x.numpy(), x_ref) < 1e-10
    # multi-RHS: columns solve independently
    rng = np.random.default_rng(1)
    Bm = np.column_stack([b, rng.standard_normal((A.shape[0], 2))])
    X = F.solve(torch.as_tensor(Bm)).numpy()
    assert X.shape == Bm.shape
    assert _rel(X[:, 0], x_ref) < 1e-10
    assert _rel(A @ X, Bm) < 1e-10


@pytest.mark.parametrize("name,n,leafmax,kw", CASES)
def test_gmres_iterations_match_jax(name, n, leafmax, kw):
    """Exact preconditioner: the JAX and port GMRES take the same number of
    iterations, host and compiled variants alike, and reach relres <= 1e-9."""
    A, b, shape, plan = _problem(name, n, leafmax, kw)
    opts = hsolve.SolverOptions(swlevel=0)
    Fj = hsolve.factor_with_plan(plan, opts)
    Ft = ht.factor_with_plan(plan, ht.SolverOptions(swlevel=0), device="cpu")
    bt = torch.as_tensor(b)

    ell = hsolve.to_ell(A)
    _, ij = hsolve.gmres(lambda v: hsolve.ell_matvec(ell, v), b, M=Fj.solve,
                         reltol=1e-9, restart=30, maxiter=30)
    tell = ht.to_ell(A, device="cpu")
    xt, it = ht.gmres(lambda v: ht.ell_matvec(tell, v), bt, M=Ft.solve,
                      reltol=1e-9, restart=30, maxiter=30)
    assert it["iters"] == ij["iters"] and it["converged"] and ij["converged"]
    assert np.linalg.norm(A @ xt.numpy() - b) / np.linalg.norm(b) <= 1e-9

    jop = hsolve.to_dia(A)
    _, cj = hsolve.gmres_compiled(lambda d, v: hsolve.dia_matvec(d, v),
                                  jsolve_with_data, jnp.asarray(b), reltol=1e-9,
                                  restart=30, maxiter=60, mv_data=jop,
                                  M_data=Fj.solve_data)
    # DIA takes the fused residual of kernel D at restarts, ELL b - A x
    for op, mv in (ht.spmv_format(A, device="cpu"), (tell, ht.ell_matvec)):
        xc, ct = ht.gmres_compiled(mv, solve_with_data, bt, reltol=1e-9,
                                   restart=30, maxiter=60, mv_data=op,
                                   M_data=Ft.solve_data)
        assert ct["iters"] == cj["iters"] and ct["converged"] and cj["converged"]
        assert np.linalg.norm(A @ xc.numpy() - b) / np.linalg.norm(b) <= 1e-9


@pytest.mark.parametrize("n,restart,maxiter,reltol,m_eps",
                         [(16, 20, 200, 1e-8, 0.0), (24, 10, 60, 1e-6, 0.0),
                          (16, 20, 200, 1e-8, 1e-3)])
def test_unpreconditioned_gmres_follows_jax(n, restart, maxiter, reltol, m_eps):
    """Without a preconditioner GMRES needs many restarted cycles: the CGS2
    Arnoldi, Givens bookkeeping and true-residual restarts must give the JAX
    package's iteration count and residual history (the second case runs out
    of iterations unconverged, in both; the third ends each cycle at the
    ``m_eps`` floor of its Givens estimate)."""
    A, b, _ = hsolve.poisson2d(n)
    jop = hsolve.to_dia(A)
    xj, ij = hsolve.gmres_compiled(lambda d, v: hsolve.dia_matvec(d, v), None,
                                   jnp.asarray(b), reltol=reltol, restart=restart,
                                   maxiter=maxiter, mv_data=jop, m_eps=m_eps)
    op = ht.to_dia(A, device="cpu")
    xt, it = ht.gmres_compiled(ht.dia_matvec, None, torch.as_tensor(b),
                               reltol=reltol, restart=restart, maxiter=maxiter,
                               mv_data=op, m_eps=m_eps)
    assert it["iters"] == ij["iters"] and it["converged"] == ij["converged"]
    assert _rel(it["resnorm"], ij["resnorm"]) < 1e-10
    assert _rel(xt.numpy(), xj) < 1e-10
    _, hj = hsolve.gmres(lambda v: hsolve.dia_matvec(jop, v), b, reltol=reltol,
                         restart=restart, maxiter=maxiter)
    _, ht_ = ht.gmres(lambda v: ht.dia_matvec(op, v), torch.as_tensor(b),
                      reltol=reltol, restart=restart, maxiter=maxiter)
    assert ht_["iters"] == hj["iters"]
    assert _rel(ht_["resnorm"], hj["resnorm"]) < 1e-10


def test_explicit_and_fast_inverse_solve_and_report():
    A, b, shape, plan = _problem("helmholtz2d", 33, 40, {"k": 20.0})
    x_ref = spla.spsolve(A.tocsc(), b)
    for kw in ({"explicit_inverse": True},
               {"explicit_inverse": True, "fast_inverse": True}):
        F = ht.factor_with_plan(plan, ht.SolverOptions(swlevel=0, **kw),
                                device="cpu")
        assert _rel(F.solve(b).numpy(), x_ref) < 1e-10
        rep = F.cond_report()
        assert rep["explicit_inverse"] and not rep["risky"]
        assert len(rep["levels"]) == len(plan.batches)
        dev_max, thresh = F.max_diag_ratio_device()
        assert float(dev_max) == pytest.approx(rep["max_ratio"])
        assert thresh > rep["max_ratio"]
    Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(swlevel=0))
    Ft = ht.factor_with_plan(plan, ht.SolverOptions(swlevel=0), device="cpu")
    rj, rt = Fj.cond_report(), Ft.cond_report()
    assert rt["max_ratio"] == pytest.approx(rj["max_ratio"], rel=1e-8)


def test_root_solve_with_boundary_root_matches_jax():
    """A tree whose root keeps a boundary (its separator moved to ``bnd``)
    exercises the root solve."""
    A, b, shape = hsolve.poisson2d(17)
    tree = hsolve.nested_dissection(shape, leafmax=20)
    r = tree.root
    tree.bnd_idx[r] = tree.int_idx[r]
    tree.int_idx[r] = np.zeros(0, dtype=np.int64)
    opts = hsolve.SolverOptions(swlevel=0)
    plan = hsolve.plan_factorization(A, tree, opts)
    assert plan.nb_root > 0
    Fj = hsolve.factor_with_plan(plan, opts)
    for kw in ({}, {"explicit_inverse": True}):
        Ft = ht.factor_with_plan(plan, ht.SolverOptions(swlevel=0, **kw),
                                 device="cpu")
        assert Ft.root is not None
        assert _rel(Ft.solve(b).numpy(), np.asarray(Fj.solve(b))) < 1e-12
        assert _rel(Ft.solve(b).numpy(), spla.spsolve(A.tocsc(), b)) < 1e-10


def test_cuda_device_raises_without_a_card():
    A, b, shape = ht.poisson2d(9)
    tree = ht.nested_dissection(shape, leafmax=12)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ht.factor(A, tree, swlevel=0, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ht.factor_with_plan(ht.plan_factorization(A, tree, ht.SolverOptions(
            swlevel=0)), ht.SolverOptions(swlevel=0), device="cuda:0")
    F = ht.factor(A, tree, swlevel=0, device="cpu")
    with pytest.raises(ValueError, match="right-hand side on meta"):
        F.solve(torch.as_tensor(b, device="meta"))
