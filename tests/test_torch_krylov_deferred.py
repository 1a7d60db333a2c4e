"""``gmres_compiled(fetch_info=False)`` with ``fetch_gmres_info``, and the
loop control on the device (``ops/gmres_control.py``: the plain versions of
the control kernels, which the CPU's host loop runs), against the JAX
package's ``gmres_compiled``/``fetch_gmres_info`` and the formulas of its
``_gmres_cycles`` (hsolve/krylov.py:215-350), on the CPU in float64.

Fixtures: the exact helmholtz2d(48, k=20) of ``test_torch_slice.py``, the
low-rank one of ``test_torch_compressed.py`` (with the JAX sketches) and
the mixed-precision escalated one of ``test_torch_mixed.py``
(helmholtz2d(33, k=10), float32 factors).  Tolerances: equal iterations
(mixed: within 1, as ``test_torch_mixed.py::test_mixed_gmres_matches_jax``,
since the float32 factors of the two packages agree to 6e-5 a level), equal
``converged``, histories to 1e-8 relative; the control functions' floors and
flags bit for bit JAX's.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht
from hsolve_torch.factor import solve_with_data
from hsolve_torch.ops import gmres_control as GC
from hsolve_torch.ops.arnoldi import (CYC, DONE, GO, IT, J, MAXITER, NCYC,
                                      arnoldi_state)
from test_torch_compressed import COMP, jax_sketch

jfactor = importlib.import_module("hsolve.factor")


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _jmv(d, v):
    return hsolve.dia_matvec(d, v)


def _fixture(kind):
    """(A, b, JAX's gmres_compiled kwargs, the port's) for one fixture."""
    if kind == "mixed":
        A, b, shape = hsolve.helmholtz2d(33, k=10.0)
        leafmax, opts = 60, dict(swlevel=0)
    else:
        A, b, shape = hsolve.helmholtz2d(48, k=20.0)
        leafmax, opts = 40, (dict(swlevel=0) if kind == "exact" else COMP)
    b = np.asarray(b)
    plan = hsolve.plan_factorization(
        A, hsolve.nested_dissection(shape, leafmax=leafmax),
        hsolve.SolverOptions(**opts))
    topts = ht.SolverOptions(**opts)
    common = dict(reltol=1e-9, restart=30, maxiter=60)
    if kind == "mixed":
        Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(**opts),
                                     dtype=jnp.float32)
        Ft = ht.factor_with_plan(plan, topts, dtype=torch.float32,
                                 device="cpu")
        jkw = dict(common, mv_data=hsolve.spmv_format(A, np.float64)[0],
                   M_data=Fj.solve_data, inner_dtype="float32",
                   mv_data_inner=hsolve.spmv_format(A, np.float32)[0],
                   m_eps=1e-6)
        tkw = dict(common, mv_data=ht.to_dia(A, device="cpu"),
                   M_data=Ft.solve_data, inner_dtype="float32",
                   mv_data_inner=ht.to_dia(A, dtype=np.float32, device="cpu"),
                   m_eps=1e-6)
        jM = lambda d, v: jfactor.solve_with_data(
            d, v.astype(jnp.float32)).astype(v.dtype)
        tM = lambda d, v: solve_with_data(d, v.to(torch.float32)).to(v.dtype)
    else:
        Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(**opts))
        sketch = None if kind == "exact" else jax_sketch(topts.seed)
        Ft = ht.factor_with_plan(plan, topts, device="cpu", sketch=sketch)
        jkw = dict(common, mv_data=hsolve.to_dia(A), M_data=Fj.solve_data)
        tkw = dict(common, mv_data=ht.to_dia(A, device="cpu"),
                   M_data=Ft.solve_data)
        jM, tM = jfactor.solve_with_data, solve_with_data
    return A, b, (jM, jkw), (tM, tkw)


@pytest.mark.parametrize("kind", ["exact", "lowrank", "mixed"])
def test_deferred_info_matches_jax(kind):
    """``fetch_info=False`` then ``fetch_gmres_info`` in both packages: the
    device tuple comes back unread, and the fetched info agrees."""
    A, b, (jM, jkw), (tM, tkw) = _fixture(kind)
    xj, dj = hsolve.gmres_compiled(_jmv, jM, jnp.asarray(b), fetch_info=False,
                                   **jkw)
    xt, dt = ht.gmres_compiled(ht.dia_matvec, tM, torch.as_tensor(b),
                               fetch_info=False, **tkw)
    assert set(dt) == {"_device", "reltol"} and dt["reltol"] == 1e-9
    assert all(isinstance(t, torch.Tensor) for t in dt["_device"])
    ij, it = hsolve.fetch_gmres_info(dj), ht.fetch_gmres_info(dt)
    assert it["converged"] == ij["converged"] is True
    if kind == "mixed":
        assert abs(it["iters"] - ij["iters"]) <= 1
        assert it["resnorm"][0] == pytest.approx(ij["resnorm"][0], rel=1e-12)
    else:
        assert it["iters"] == ij["iters"]
        assert _rel(it["resnorm"], ij["resnorm"]) < 1e-8
    assert it["resnorm"].shape == (it["iters"] + 1,)
    assert np.linalg.norm(A @ xt.numpy() - b) / np.linalg.norm(b) < 1e-9
    # an info that was already fetched passes through
    assert ht.fetch_gmres_info(it) is it


@pytest.mark.parametrize("kind", ["exact", "mixed"])
def test_fetch_info_true_and_false_agree(kind):
    A, b, _, (tM, tkw) = _fixture(kind)
    bt = torch.as_tensor(b)
    x1, i1 = ht.gmres_compiled(ht.dia_matvec, tM, bt, **tkw)
    x2, d2 = ht.gmres_compiled(ht.dia_matvec, tM, bt, fetch_info=False, **tkw)
    i2 = ht.fetch_gmres_info(d2)
    assert torch.equal(x1, x2)
    assert i1["iters"] == i2["iters"] and i1["converged"] == i2["converged"]
    assert np.array_equal(i1["resnorm"], i2["resnorm"])


def test_host_driven_loop_is_gmres_compiled_on_the_cpu():
    """On the CPU ``gmres_host_driven`` (the card's yardstick) and
    ``gmres_compiled`` are the same run."""
    from hsolve_torch.krylov import gmres_host_driven

    A, b, _, (tM, tkw) = _fixture("mixed")
    bt = torch.as_tensor(b)
    x1, i1 = ht.gmres_compiled(ht.dia_matvec, tM, bt, **tkw)
    x2, i2 = gmres_host_driven(ht.dia_matvec, tM, bt, **tkw)
    assert torch.equal(x1, x2) and i1["iters"] == i2["iters"]
    assert np.array_equal(i1["resnorm"], i2["resnorm"])


def test_port_exports_cover_jax_s():
    assert set(hsolve.__all__) <= set(ht.__all__)
    assert ht.fetch_gmres_info.__module__ == "hsolve_torch.krylov"


# ---------------------------------------------------------------------------
# the control functions against JAX's formulas
# ---------------------------------------------------------------------------

def _loop_state(m, N, dt, it, maxiter, beta, tol, reltol=1e-9):
    s = arnoldi_state(m, N, dt, "cpu")
    s.loop[IT], s.loop[MAXITER], s.loop[NCYC] = it, maxiter, maxiter
    sc = torch.zeros(GC.SC_LEN, dtype=torch.float64)
    sc[GC.BETA], sc[GC.TOL], sc[GC.RELTOL] = beta, tol, reltol
    return s, sc


@pytest.mark.parametrize("inner", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("case,beta,tol,m_eps,it", [
    ("steps", 3.0, 1e-9, 1e-6, 0),          # beta above the floor: a step
    ("on the floor", 1e-5, 1e-9, 1.0, 4),   # m_eps beta >= beta: no step
    ("below tol", 1e-10, 1e-9, 0.0, 4),     # tol above beta: no step
    ("on maxiter", 3.0, 1e-9, 1e-6, 12)])   # it == maxiter: no step
def test_cycle_start_floor_and_first_test_are_jax_s(inner, case, beta, tol,
                                                    m_eps, it):
    """``floor = max(tol, m_eps beta)`` in the cycles' real type and the step
    loop's first test, ``inner_cond`` at j = 0 (hsolve/krylov.py:269-273,
    :290), bit for bit; ``V[0] = r / beta`` in the cycles' type and the
    zeroed Givens state with ``g[0] = beta``.  Complex cycles take a
    complex128 ``r``: JAX's complex division by ``beta`` bit for bit."""
    m, N, maxiter = 5, 17, 12
    s, sc = _loop_state(m, N, inner, it, maxiter, beta, tol)
    s.H.fill_(7.0), s.y.fill_(7.0), s.sn.fill_(7.0)
    r = torch.linspace(-1.0, 2.0, N, dtype=torch.float64)
    if inner.is_complex:
        r = torch.complex(r, torch.linspace(2.0, -1.0, N, dtype=torch.float64))
    GC.gmres_cycle_start_plain(r, sc, s, m_eps)
    rdt = jnp.float32 if inner in (torch.float32, torch.complex64) \
        else jnp.float64
    vdt = getattr(jnp, str(inner).replace("torch.", ""))
    beta_i = jnp.asarray(beta, jnp.float64).astype(rdt)
    floor = jnp.maximum(jnp.asarray(tol, jnp.float64).astype(rdt),
                        m_eps * beta_i)
    go = bool((0 < m) & (beta_i > floor) & (it + 0 < maxiter))
    assert float(s.floor[0]) == float(floor)
    assert int(s.loop[DONE]) == int(not go)
    assert go == (case == "steps")
    assert int(s.loop[J]) == 0
    v0 = (jnp.asarray(r.numpy()) / jnp.where(beta > 0, beta, 1.0)).astype(vdt)
    assert np.array_equal(s.V[0].numpy(), np.asarray(v0))
    assert torch.equal(s.vj, s.V[0])
    assert not s.H.any() and not s.sn.any() and not s.y.any()
    assert bool((s.cs == 1).all())
    assert complex(s.g[0]) == float(beta_i) and not s.g[1:].any()


@pytest.mark.parametrize("case,j,it,beta,go", [
    ("ends on the floor", 3, 2, 1e-3, 1),   # j < m steps, unconverged: on
    ("converged", 3, 2, 1e-10, 0),          # beta <= tol
    ("on maxiter", 4, 8, 1e-3, 0),          # it + j == maxiter
    ("at j == 0", 0, 2, 1e-3, 0),           # a cycle that took no step
    ("out of cycles", 2, 2, 1e-3, 0)])      # cyc == ncycles afterwards
def test_cycle_end_flags_are_jax_s(case, j, it, beta, go):
    """``it += j``, ``hist[it] = beta``, ``done = beta <= tol | it >=
    maxiter | j == 0`` and the cycle loop's test ``~done & cyc < ncycles``
    (hsolve/krylov.py:300-306, :315)."""
    maxiter, tol = 12, 1e-9
    s, sc = _loop_state(5, 9, torch.float64, it, maxiter, beta, tol)
    s.loop[J] = j
    s.loop[CYC] = 2
    if case == "out of cycles":
        s.loop[NCYC] = 3
    hist = torch.zeros(maxiter + 1, dtype=torch.float64)
    GC.gmres_cycle_end_plain(sc, hist, s.loop)
    it_new = it + j
    done = (beta <= tol) | (it_new >= maxiter) | (j == 0)
    assert int(s.loop[IT]) == it_new and int(s.loop[CYC]) == 3
    assert float(hist[it_new]) == beta and int(hist.count_nonzero()) == 1
    assert int(s.loop[GO]) == int(not done and 3 < int(s.loop[NCYC])) == go


@pytest.mark.parametrize("bnorm,reltol,go", [(2.0, 1e-9, 1), (0.0, 1e-9, 0)])
def test_init_and_escalation_are_jax_s(bnorm, reltol, go):
    """A run's start (tol = reltol ||b||, hist = [||b||, 0, ...], the first
    cycle test ``~(||b|| <= tol)``, :310-315) and phase 2's ``reltol2 =
    reltol ||b|| / where(beta1 > 0, beta1, 1)`` (:340)."""
    s, sc = _loop_state(5, 9, torch.float64, 3, 12, 0.0, 0.0, reltol)
    sc[GC.BNORM] = bnorm
    hist = torch.full((13,), 5.0, dtype=torch.float64)
    GC.gmres_init_plain(sc, hist, s.loop)
    assert float(sc[GC.TOL]) == reltol * bnorm
    assert float(sc[GC.BETA]) == bnorm == float(hist[0])
    assert not hist[1:].any()
    assert [int(s.loop[k]) for k in (J, IT, CYC, GO)] == [0, 0, 0, go]
    for beta1 in (0.5, 0.0):
        sc2 = torch.zeros(GC.SC_LEN, dtype=torch.float64)
        sc2[GC.BNORM] = beta1
        GC.gmres_escalate_plain(sc, sc2)
        ref = (jnp.asarray(reltol) * bnorm) / jnp.where(beta1 > 0, beta1, 1.0)
        assert float(sc2[GC.RELTOL]) == float(ref)


@pytest.mark.parametrize("restart,maxiter,m_eps,inner", [
    (4, 7, 0.0, None),             # cycles end on maxiter
    (10, 30, 1e-2, "float32")])    # cycles end on the floor
def test_unconverged_cycles_follow_jax(restart, maxiter, m_eps, inner):
    """Whole runs that end on the budget and on the floor, unpreconditioned,
    ``fetch_info=False``: iterations, ``converged`` and the history as JAX's
    (float32 cycles: 1e-5, the step's rounding through the solves)."""
    A, b, _ = hsolve.helmholtz2d(24, k=10.0)
    b = np.asarray(b)
    kw = dict(reltol=1e-12, restart=restart, maxiter=maxiter, m_eps=m_eps,
              inner_dtype=inner, escalate=False)
    _, dj = hsolve.gmres_compiled(
        _jmv, None, jnp.asarray(b), mv_data=hsolve.to_dia(A), fetch_info=False,
        mv_data_inner=None if inner is None else hsolve.to_dia(A, np.float32),
        **kw)
    _, dt = ht.gmres_compiled(
        ht.dia_matvec, None, torch.as_tensor(b),
        mv_data=ht.to_dia(A, device="cpu"), fetch_info=False,
        mv_data_inner=None if inner is None else ht.to_dia(
            A, dtype=np.float32, device="cpu"), **kw)
    ij, it = hsolve.fetch_gmres_info(dj), ht.fetch_gmres_info(dt)
    assert it["iters"] == ij["iters"] and it["converged"] == ij["converged"]
    assert _rel(it["resnorm"], ij["resnorm"]) < (1e-10 if inner is None
                                                  else 1e-5)
