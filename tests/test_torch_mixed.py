"""The port's float32 factor and mixed-precision GMRES with escalation against
the JAX package on the CPU (x64 enabled, as its own tests run).

- The float32 exact factor, on test_torch_slice.py's plans: L, R and S per
  level within 1e-4 relative of JAX's float32 factor (pivoted LU in float32,
  the two libraries' sums in different orders), its solve within 1e-4 of
  JAX's and within cond(A) eps32 of scipy's spsolve.
- ``gmres_compiled(inner_dtype="float32", m_eps=1e-6)`` on JAX's fixture
  (tests/test_spmv_krylov.py:50-73): converged, relres < 1e-9, iterations
  within one of JAX's.
- The escalation on JAX's near-singular shifted Laplacian
  (tests/test_spmv_krylov.py:87-125): without it both packages stall above
  1e-7, with it both converge below 1e-9.
- With ``inner_dtype=None`` the float64 GMRES keeps JAX's iteration counts and
  residual histories on the exact and low-rank compressed fixtures.
- The entry points default to the card, and raise without one.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import hsolve
import hsolve_torch as ht
from hsolve_torch.factor import _factor_levels, solve_with_data
from hsolve_torch.interop import plan_to_torch

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function
EPS32 = float(np.finfo(np.float32).eps)
CASES = [("poisson2d", 33, 40, {}), ("helmholtz2d", 48, 40, {"k": 20.0})]


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    if ref.size == 0:
        return 0.0
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _plan(name, n, leafmax, kw, **opts):
    A, b, shape = getattr(hsolve, name)(n, **kw)
    tree = hsolve.nested_dissection(shape, leafmax=leafmax)
    return A, np.asarray(b), hsolve.plan_factorization(
        A, tree, hsolve.SolverOptions(swlevel=0, **opts))


def _jmv(op, v):
    return hsolve.dia_matvec(op, v)


def _jprec(data, v):
    return jfactor.solve_with_data(data, v.astype(jnp.float32)).astype(v.dtype)


def _tprec(data, v):
    return solve_with_data(data, v.to(torch.float32)).to(v.dtype)


def _mixed(A, b, plan, escalate=True, maxiter=60):
    """Both packages' float32 factor of ``plan`` and mixed GMRES on it;
    returns ((info, relres) of JAX, (info, relres) of the port)."""
    out = []
    Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(swlevel=0),
                                 dtype=jnp.float32)
    xj, ij = hsolve.gmres_compiled(
        _jmv, _jprec, jnp.asarray(b, jnp.float64), reltol=1e-9, restart=30,
        maxiter=maxiter, mv_data=hsolve.spmv_format(A, dtype=np.float64)[0],
        M_data=Fj.solve_data, inner_dtype="float32",
        mv_data_inner=hsolve.spmv_format(A, dtype=np.float32)[0], m_eps=1e-6,
        escalate=escalate)
    out.append((ij, np.linalg.norm(A @ np.asarray(xj) - b) / np.linalg.norm(b)))
    Ft = ht.factor_with_plan(plan, ht.SolverOptions(swlevel=0),
                             dtype=torch.float32, device="cpu")
    op64, mv = ht.spmv_format(A, dtype=np.float64, device="cpu")
    op32, _ = ht.spmv_format(A, dtype=np.float32, device="cpu")
    assert op32.values.dtype == torch.float32
    xt, it = ht.gmres_compiled(
        mv, _tprec, torch.as_tensor(b, dtype=torch.float64), reltol=1e-9,
        restart=30, maxiter=maxiter, mv_data=op64, M_data=Ft.solve_data,
        inner_dtype="float32", mv_data_inner=op32, m_eps=1e-6,
        escalate=escalate)
    assert xt.dtype == torch.float64
    out.append((it, np.linalg.norm(A @ xt.numpy() - b) / np.linalg.norm(b)))
    return out


@pytest.mark.parametrize("name,n,leafmax,kw", CASES)
def test_float32_levels_match_jax(name, n, leafmax, kw):
    _, _, plan = _plan(name, n, leafmax, kw)
    opts = hsolve.SolverOptions(swlevel=0)
    jlevels, jstacks = [], {}
    jfactor._factor_levels(plan, opts, jnp.float32, jlevels, jstacks, None)
    tlevels, _, tstacks = _factor_levels(plan, plan_to_torch(plan, "cpu"),
                                         ht.SolverOptions(swlevel=0),
                                         torch.float32)
    assert len(tlevels) == len(jlevels)
    for i, (tl, jl) in enumerate(zip(tlevels, jlevels)):
        assert tl.L.dtype == torch.float32 and jl.L.dtype == jnp.float32
        for f in ("L", "R"):
            assert _rel(getattr(tl, f).numpy(), getattr(jl, f)) < 1e-4, (i, f)
        if tstacks[i].numel():
            assert tstacks[i].dtype == torch.float32
            assert _rel(tstacks[i].numpy(), jstacks[i]) < 1e-4, (i, "S")


@pytest.mark.parametrize("name,n,leafmax,kw", CASES)
def test_float32_solve_matches_jax_and_spsolve(name, n, leafmax, kw):
    """The solve against JAX's float32 solve (to 1e-4) and spsolve (within
    cond(A) eps32); the pivot report takes the float32 epsilon, as JAX's."""
    A, b, plan = _plan(name, n, leafmax, kw)
    Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(swlevel=0),
                                 dtype=jnp.float32)
    Ft = ht.factor_with_plan(plan, ht.SolverOptions(swlevel=0),
                             dtype=np.float32, device="cpu")
    assert Ft.dtype == torch.float32
    x = Ft.solve(b)
    assert x.dtype == torch.float64          # b's type, solved in float32
    assert _rel(x.numpy(), Fj.solve(b.astype(np.float32))) < 1e-4
    x_ref = spla.spsolve(A.tocsc(), b)
    cond = np.linalg.cond(A.toarray())
    assert np.linalg.norm(x.numpy() - x_ref) / np.linalg.norm(x_ref) < cond * EPS32
    rj, rt = Fj.cond_report(), Ft.cond_report()
    assert rt["max_ratio"] == pytest.approx(rj["max_ratio"], rel=1e-4)
    assert [lv["risky"] for lv in rt["levels"]] == \
        [lv["risky"] for lv in rj["levels"]]
    assert Ft.max_diag_ratio_device()[1] == pytest.approx(0.01 / EPS32)
    assert Ft.max_diag_ratio_device()[1] == pytest.approx(
        Fj.max_diag_ratio_device()[1])


def test_mixed_gmres_matches_jax():
    """JAX's mixed-precision fixture: a float32 factor inside float32 Arnoldi
    cycles of a float64 solve."""
    A, b, plan = _plan("helmholtz2d", 33, 60, {"k": 10.0})
    (ij, rj), (it, rt) = _mixed(A, b, plan)
    assert ij["converged"] and it["converged"]
    assert rj < 1e-9 and rt < 1e-9
    assert abs(it["iters"] - ij["iters"]) <= 1
    assert it["resnorm"].shape == (it["iters"] + 1,)
    assert it["resnorm"][0] == pytest.approx(np.linalg.norm(b))


def _near_singular():
    """JAX's escalation fixture: poisson2d(64) shifted to 3e-7 above an
    eigenvalue near 0.3 (tests/test_spmv_krylov.py:96-101)."""
    A0, b, shape = hsolve.poisson2d(64)
    lam = spla.eigsh(A0.tocsc().asfptype(), k=1, sigma=0.3, which="LM",
                     return_eigenvectors=False)[0]
    A = (A0 - (lam + 3e-7) * sp.eye(A0.shape[0], format="csr")).tocsr()
    tree = hsolve.nested_dissection(shape, leafmax=100)
    return A, np.asarray(b), hsolve.plan_factorization(
        A, tree, hsolve.SolverOptions(swlevel=0))


@pytest.mark.parametrize("escalate", [False, True])
def test_escalation_near_singular(escalate):
    """JAX's float32 cycles have a true-residual floor here: without the
    float64 phase JAX stalls above 1e-7; with it both packages converge below
    1e-9.  The port's float32 sweep accumulates in float64 (F4), and without
    the float64 phase it converges in its float32 cycles alone, as the
    float64 sweep of the same float32 factors does (12 iterations; the port:
    20, within the 40 of the phase)."""
    A, b, plan = _near_singular()
    (ij, rj), (it, rt) = _mixed(A, b, plan, escalate=escalate, maxiter=40)
    if escalate:
        for info, relres in ((ij, rj), (it, rt)):
            assert info["converged"] and relres < 1e-9
            assert info["iters"] > 0
        return
    assert not ij["converged"] and rj > 1e-7
    assert it["converged"] and rt < 1e-9 and it["iters"] <= 40
    F32 = ht.factor_with_plan(plan, ht.SolverOptions(swlevel=0),
                              dtype=torch.float32, device="cpu")
    F64 = dataclasses.replace(F32, levels=[dataclasses.replace(lv, **{
        f.name: getattr(lv, f.name).double() for f in dataclasses.fields(lv)
        if isinstance(getattr(lv, f.name), torch.Tensor)
        and getattr(lv, f.name).dtype == torch.float32}) for lv in F32.levels])
    op64, mv = ht.spmv_format(A, device="cpu")
    op32, _ = ht.spmv_format(A, dtype=np.float32, device="cpu")
    _, i64 = ht.gmres_compiled(
        mv, lambda d, v: solve_with_data(d, v.double()).to(v.dtype),
        torch.as_tensor(b), reltol=1e-9, restart=30, maxiter=40, mv_data=op64,
        M_data=F64.solve_data, inner_dtype="float32", mv_data_inner=op32,
        m_eps=1e-6, escalate=False)
    assert i64["converged"] and i64["iters"] <= it["iters"]


def test_escalation_history_follows_jax_layout():
    """The escalated history is phase 1's [maxiter + 1] block, then phase 2's
    entries after its first, cut at iters + 1 (hsolve/krylov.py:345-348).  On
    this fixture JAX's phase 1 spends its 40 iterations stalled, so entry 40
    is its last true residual and phase 2's entries follow from 41.  The
    port's phase 1 converges in 20 (F4, see above), so its phase 1 gets 10:
    entry 10 is its last residual, unconverged, and phase 2's follow."""
    A, b, plan = _near_singular()
    bnorm = np.linalg.norm(b)
    (ij, _), _ = _mixed(A, b, plan, maxiter=40)
    _, (it, _) = _mixed(A, b, plan, maxiter=10)
    for info, m1, floor in ((ij, 40, 1e-7), (it, 10, 1e-9)):
        h = info["resnorm"]
        assert info["iters"] > m1 and h.shape == (info["iters"] + 1,)
        assert h[0] == pytest.approx(bnorm, rel=1e-12)
        assert h[m1] > floor * bnorm             # phase 1's last residual
        assert 0.0 < h[-1] <= 1e-9 * bnorm       # phase 2's converged one
        assert h[-1] < h[m1]
    assert np.all(ij["resnorm"][41:] < ij["resnorm"][40])


@pytest.mark.parametrize("name,n,leafmax,kw", CASES)
def test_float64_gmres_history_is_jax_s_on_the_exact_path(name, n, leafmax, kw):
    """inner_dtype=None, unpreconditioned and exact-preconditioned: equal
    iteration counts and histories within 1e-10 relative (the factors agree
    to 1e-10, test_torch_slice.py)."""
    A, b, plan = _plan(name, n, leafmax, kw)
    Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(swlevel=0))
    Ft = ht.factor_with_plan(plan, ht.SolverOptions(swlevel=0), device="cpu")
    jop, top = hsolve.to_dia(A), ht.to_dia(A, device="cpu")
    for jM, tM, Mj, Mt, maxiter in (
            (jfactor.solve_with_data, solve_with_data, Fj.solve_data,
             Ft.solve_data, 60),
            (None, None, None, None, 90)):
        _, ij = hsolve.gmres_compiled(_jmv, jM, jnp.asarray(b), reltol=1e-9,
                                      restart=30, maxiter=maxiter,
                                      mv_data=jop, M_data=Mj)
        _, it = ht.gmres_compiled(ht.dia_matvec, tM, torch.as_tensor(b),
                                  reltol=1e-9, restart=30, maxiter=maxiter,
                                  mv_data=top, M_data=Mt)
        assert it["iters"] == ij["iters"] and it["converged"] == ij["converged"]
        assert _rel(it["resnorm"], ij["resnorm"]) < 1e-10


def test_float64_gmres_history_is_jax_s_on_the_compressed_path():
    """The low-rank compressed fixture of test_torch_compressed.py with the
    JAX sketches: equal counts, histories within 1e-8 relative (the low-rank
    factors agree to 1e-10, and the GMRES residuals fall to 1e-9 of ||b||)."""
    from test_torch_compressed import COMP, jax_sketch

    A, b, shape = hsolve.helmholtz2d(48, k=20.0)
    b = np.asarray(b)
    plan = hsolve.plan_factorization(
        A, hsolve.nested_dissection(shape, leafmax=40), hsolve.SolverOptions(**COMP))
    Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(**COMP))
    topts = ht.SolverOptions(**COMP)
    Ft = ht.factor_with_plan(plan, topts, device="cpu",
                             sketch=jax_sketch(topts.seed))
    _, ij = hsolve.gmres_compiled(_jmv, jfactor.solve_with_data, jnp.asarray(b),
                                  reltol=1e-9, restart=30, maxiter=60,
                                  mv_data=hsolve.to_dia(A), M_data=Fj.solve_data)
    _, it = ht.gmres_compiled(ht.dia_matvec, solve_with_data, torch.as_tensor(b),
                              reltol=1e-9, restart=30, maxiter=60,
                              mv_data=ht.to_dia(A, device="cpu"),
                              M_data=Ft.solve_data)
    assert it["iters"] == ij["iters"] > 1 and it["converged"] and ij["converged"]
    assert _rel(it["resnorm"], ij["resnorm"]) < 1e-8


def test_entry_points_default_to_the_card():
    """Without ``device=`` every entry point asks for the card, and raises
    here, where there is none; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    A, _, shape = ht.poisson2d(9)
    tree = ht.nested_dissection(shape, leafmax=12)
    opts = ht.SolverOptions(swlevel=0)
    plan = ht.plan_factorization(A, tree, opts)
    for call in (lambda: ht.factor(A, tree, swlevel=0),
                 lambda: ht.factor_with_plan(plan, opts),
                 lambda: ht.factor_with_plan(plan, opts, dtype=np.float32),
                 lambda: ht.spmv_format(A), lambda: ht.spmv_format(A, np.float32),
                 lambda: ht.to_dia(A), lambda: ht.to_ell(A),
                 lambda: plan_to_torch(plan)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # the CPU stays available on request
    assert ht.to_dia(A, device="cpu").values.device.type == "cpu"
