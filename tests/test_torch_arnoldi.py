"""Kernels L (CGS2) and M (Givens bookkeeping) of the port's Arnoldi step, and
the step as the GMRES loop runs it (``arnoldi_step``: L's launch with M's
step and ``V[j+1]`` as its tail on the card): their plain versions against
the JAX package's ``_gmres_cycles`` on the CPU, in float32 and float64, and
in complex64 and complex128 on a complex operator (JAX's complex Givens).

One step is checked against the ops of JAX's ``inner_body``
(hsolve/krylov.py:226-266) and the cycle end's masked triangular solve
(:293-298), reproduced here in jnp on the same state; whole cycles against
JAX's ``_gmres_cycles`` itself with ``restart = j + 1``.  Tolerances: 1e-13
relative in float64 and complex128 and 1e-6 in float32 and complex64 for one
step (only the summation order of the dot products and norms differs, and in
complex the modulus and the product, XLA's against kernel M's parts), looser
for a whole cycle, where those differences pass through the triangular solve
(stated per test)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import hsolve
from hsolve_torch import kernels
from hsolve_torch.krylov import gmres_compiled
from hsolve_torch.ops.arnoldi import (J, arnoldi_cgs2, arnoldi_cgs2_plain,
                                      arnoldi_givens, arnoldi_givens_plain,
                                      arnoldi_state, arnoldi_step,
                                      arnoldi_step_plain, cgs2_blocks,
                                      cgs2_max_slice, cgs2_slice, div_real,
                                      set_loop)

jkrylov = importlib.import_module("hsolve.krylov")
TOL = {np.float32: 1e-6, np.float64: 1e-13, np.complex64: 1e-6,
       np.complex128: 1e-13}
TYPES = [np.float32, np.float64, np.complex64, np.complex128]
M_RESTART = 30


def _rel(got, ref):
    got = np.asarray(got, dtype=np.complex128)
    ref = np.asarray(ref, dtype=np.complex128)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@jax.jit
def _jax_step(V, H, cs, sn, g, j, w):
    """The ops of ``inner_body`` (hsolve/krylov.py:226-266) after its matvec,
    for a real or complex value type; returns the new state and the
    residual estimate."""
    m = H.shape[1]
    dtype = V.dtype
    rdtype = cs.dtype
    mask = (jnp.arange(m + 1) <= j).astype(dtype)
    h1 = (jnp.conj(V) @ w) * mask
    w = w - V.T @ h1
    h2 = (jnp.conj(V) @ w) * mask
    w = w - V.T @ h2
    hcol = h1 + h2
    hnorm = jnp.linalg.norm(w).astype(rdtype)
    V = V.at[j + 1].set(w / jnp.where(hnorm > 0, hnorm, 1.0).astype(dtype))
    hcol = hcol.at[j + 1].set(hnorm.astype(dtype))

    def rot(hc, i):
        apply = (i < j)
        t = cs[i] * hc[i] + sn[i] * hc[i + 1]
        lo = -jnp.conj(sn[i]) * hc[i] + cs[i] * hc[i + 1]
        hc = hc.at[i].set(jnp.where(apply, t, hc[i]))
        hc = hc.at[i + 1].set(jnp.where(apply, lo, hc[i + 1]))
        return hc, None

    hcol, _ = lax.scan(rot, hcol, jnp.arange(m))
    a_, b_ = hcol[j], hcol[j + 1]
    denom = jnp.sqrt(jnp.abs(a_) ** 2 + jnp.abs(b_) ** 2)
    safe = denom > 0
    absa = jnp.abs(a_)
    cs_j = jnp.where(safe, jnp.where(absa > 0, absa / denom, 0.0), 1.0)
    sn_j = jnp.where(
        safe & (absa > 0),
        (a_ * jnp.conj(b_)) / jnp.maximum(absa * denom, jnp.finfo(rdtype).tiny),
        jnp.where(safe, 1.0, 0.0).astype(dtype))
    hcol = hcol.at[j].set(cs_j * a_ + sn_j * b_).at[j + 1].set(0.0)
    H = H.at[:, j].set(hcol)
    cs = cs.at[j].set(cs_j.astype(rdtype))
    sn = sn.at[j].set(sn_j)
    gj1 = -jnp.conj(sn_j) * g[j]
    g = g.at[j + 1].set(gj1).at[j].set(cs_j * g[j])
    return V, H, cs, sn, g, jnp.abs(gj1)


@jax.jit
def _jax_cycle_end(H, g, j):
    """The cycle end's masked solve (hsolve/krylov.py:294-298)."""
    m = H.shape[1]
    colmask = (jnp.arange(m) < j)
    Hm = jnp.where(colmask[None, :], H[:m, :m], 0.0)
    Hm = Hm + jnp.diag(jnp.where(colmask, 0.0, 1.0).astype(H.dtype))
    gm = jnp.where(colmask, g[:m], 0.0)
    return jax.scipy.linalg.solve_triangular(Hm, gm, lower=False)


def _operator(N, seed, cplx=False):
    """A well-conditioned nonsymmetric operator: I + a scaled Gaussian (with
    an imaginary Gaussian part where ``cplx``)."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((N, N))
    if cplx:
        G = G + 1j * rng.standard_normal((N, N))
    return np.eye(N) + G / (2.0 * np.sqrt(N))


def _jax_state(A, dtype, steps, seed):
    """JAX's state after ``steps`` Arnoldi steps from a random start, and the
    next step's matvec; everything in ``dtype`` (``cs`` in its real type).
    A complex ``dtype`` takes a complex operator and start."""
    N = A.shape[0]
    rng = np.random.default_rng(seed)
    r = rng.standard_normal(N)
    if np.iscomplexobj(np.zeros((), dtype)):
        r = r + 1j * rng.standard_normal(N)
        A = A if np.iscomplexobj(A) else _operator(N, seed, cplx=True)
    beta = np.linalg.norm(r)
    m = M_RESTART
    V = jnp.zeros((m + 1, N), dtype).at[0].set((r / beta).astype(dtype))
    H = jnp.zeros((m + 1, m), dtype)
    cs = jnp.ones((m,), np.zeros((), dtype).real.dtype)
    sn = jnp.zeros((m,), dtype)
    g = jnp.zeros((m + 1,), dtype).at[0].set(beta.astype(dtype))
    Aj = jnp.asarray(A, dtype)
    for j in range(steps):
        V, H, cs, sn, g, _ = _jax_step(V, H, cs, sn, g, j, Aj @ V[j])
    return [np.array(a) for a in (V, H, cs, sn, g, Aj @ V[steps])]


def _port_state(V, H, cs, sn, g):
    m1, N = V.shape
    s = arnoldi_state(m1 - 1, N, torch.from_numpy(V).dtype, "cpu")
    for dst, src in ((s.V, V), (s.H, H), (s.cs, cs), (s.sn, sn), (s.g, g)):
        dst.copy_(torch.from_numpy(src))
    return s


def _at_step(s, j, floor, cont):
    """Place the loop at step ``j`` with ``floor``; the budget lets the
    cycle go on after the step where ``cont`` and ``j + 1 < m`` allow."""
    set_loop(s, j, maxiter=None if cont else j + 1, floor=floor)


@pytest.mark.parametrize("j", [0, M_RESTART - 1])
@pytest.mark.parametrize("dtype", TYPES)
def test_step_matches_jax_inner_body(dtype, j):
    """One step at j = 0 and j = m - 1: V[j+1], the rotated column H[:, j],
    the rotation, g and the residual estimate; then the cycle end's
    coefficients against JAX's masked solve."""
    A = _operator(400, 1)
    V, H, cs, sn, g, w = _jax_state(A, dtype, j, seed=2)
    jV, jH, jcs, jsn, jg, jres = (np.asarray(a) for a in _jax_step(
        V, H, cs, sn, g, j, w))
    s = _port_state(V, H, cs, sn, g)
    wt = torch.from_numpy(w.copy())
    arnoldi_cgs2_plain(s, wt, j)
    arnoldi_givens_plain(s, j, floor=0.0, cont=j + 1 < M_RESTART)
    div_real(wt, s.st[1], out=s.V[j + 1])
    tol = TOL[dtype]
    assert s.V.dtype == torch.from_numpy(V).dtype
    assert _rel(s.V[j + 1].numpy(), jV[j + 1]) < tol
    assert _rel(s.H[:, j].numpy(), jH[:, j]) < tol
    assert abs(float(s.cs[j]) - float(jcs[j])) < tol
    assert abs(complex(s.sn[j]) - complex(jsn[j])) < tol
    assert _rel(s.g[: j + 2].numpy(), jg[: j + 2]) < tol
    assert abs(float(s.st[0]) - float(jres)) <= tol * abs(complex(jg[0]))
    # the last step of a cycle ends it: the coefficients of the update
    assert int(s.done[0]) == int(j + 1 == M_RESTART)
    s2 = _port_state(V, H, cs, sn, g)
    arnoldi_cgs2_plain(s2, torch.from_numpy(w.copy()), j)
    arnoldi_givens_plain(s2, j, floor=0.0, cont=False)
    assert int(s2.done[0]) == 1
    y = np.asarray(_jax_cycle_end(jH, jg, j + 1))
    assert _rel(s2.y.numpy(), y) < 10 * tol
    assert not s2.y[j + 1:].any()


@pytest.mark.parametrize("j", [0, 14, M_RESTART - 1])
@pytest.mark.parametrize("dtype", TYPES)
def test_arnoldi_step_matches_jax_inner_body(dtype, j):
    """The step as GMRES runs it, at j = 0, 14 and m - 1: V[j+1] (its
    scaling of w now inside the step), H[:, j], the rotation, g and the
    residual estimate against JAX's ``inner_body``, within the one-step
    tolerance (only the dot products' summation order differs)."""
    A = _operator(400, 9)
    V, H, cs, sn, g, w = _jax_state(A, dtype, j, seed=10)
    jV, jH, jcs, jsn, jg, jres = (np.asarray(a) for a in _jax_step(
        V, H, cs, sn, g, j, w))
    s = _port_state(V, H, cs, sn, g)
    _at_step(s, j, 0.0, True)
    arnoldi_step(s, torch.from_numpy(w.copy()))
    tol = TOL[dtype]
    assert _rel(s.V[j + 1].numpy(), jV[j + 1]) < tol
    assert _rel(s.V[: j + 1].numpy(), jV[: j + 1]) == 0.0
    assert _rel(s.H[:, j].numpy(), jH[:, j]) < tol
    assert abs(float(s.cs[j]) - float(jcs[j])) < tol
    assert abs(complex(s.sn[j]) - complex(jsn[j])) < tol
    assert _rel(s.g[: j + 2].numpy(), jg[: j + 2]) < tol
    assert abs(float(s.st[0]) - float(jres)) <= tol * abs(complex(jg[0]))
    assert int(s.done[0]) == int(j + 1 == M_RESTART)
    # the loop advanced, and the next step's input is V[j+1]
    assert int(s.loop[J]) == j + 1 and torch.equal(s.vj, s.V[j + 1])


@pytest.mark.parametrize("j", [0, 14, M_RESTART - 1])
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("cont", [True, False])
def test_arnoldi_step_is_l_then_m_then_the_division(dtype, j, cont):
    """On the CPU the step is kernel L's plain version, kernel M's (with the
    loop test the loop state gives: ``cont`` where ``j + 1 < m``), then
    ``V[j+1] = w / st[1]`` (each part divided in complex), bit for bit (the
    card holds its one launch to
    the same, ``tests/test_torch_cuda.py``); no launch is counted."""
    A = _operator(200, 12)
    V, H, cs, sn, g, w = _jax_state(A, dtype, j, seed=13)
    s1, s2 = _port_state(V, H, cs, sn, g), _port_state(V, H, cs, sn, g)
    w1, w2 = torch.from_numpy(w.copy()), torch.from_numpy(w.copy())
    before = kernels.launch_counts()
    _at_step(s1, j, 1e-3, cont)
    arnoldi_step(s1, w1)
    assert kernels.launch_counts() == before
    cont = cont and j + 1 < M_RESTART
    arnoldi_cgs2_plain(s2, w2, j)
    arnoldi_givens_plain(s2, j, 1e-3, cont)
    div_real(w2, s2.st[1], out=s2.V[j + 1])
    assert torch.equal(w1, w2)
    for name in ("V", "H", "cs", "sn", "g", "hc", "st", "done", "y"):
        assert torch.equal(getattr(s1, name), getattr(s2, name)), name
    assert int(s1.done[0]) == int(not (cont and float(s1.st[0]) > 1e-3))
    s3 = _port_state(V, H, cs, sn, g)
    _at_step(s3, j, 1e-3, cont)
    arnoldi_step_plain(s3, torch.from_numpy(w.copy()))
    assert torch.equal(s3.V, s1.V) and torch.equal(s3.y, s1.y)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("hc,cs_j,sn_j", [
    ([0.0, 0.0], 1.0, 0.0),            # a zero column: no rotation
    ([0.0, 2.5], 0.0, 1.0),            # a = 0: a swap
    ([-3.0, 4.0], 0.6, -0.8)])         # the general branch, a < 0
def test_givens_takes_jax_safe_branches(dtype, hc, cs_j, sn_j):
    s = _port_state(*[np.zeros(sh, dtype) for sh in
                      ((M_RESTART + 1, 8), (M_RESTART + 1, M_RESTART),
                       (M_RESTART,), (M_RESTART,), (M_RESTART + 1,))])
    s.cs.fill_(1.0)
    s.g[0] = 2.0
    s.hc[:2] = torch.tensor(hc, dtype=s.hc.dtype)
    arnoldi_givens_plain(s, 0, floor=0.0, cont=True)
    assert float(s.cs[0]) == pytest.approx(cs_j, rel=TOL[dtype])
    assert float(s.sn[0]) == pytest.approx(sn_j, rel=TOL[dtype])
    assert float(s.g[1]) == pytest.approx(-2.0 * sn_j, rel=TOL[dtype])
    # ||w|| = 0 leaves V[1] unscaled (divisor 1)
    assert float(s.st[1]) == (hc[1] if hc[1] > 0 else 1.0)


@pytest.mark.parametrize("cont,floor,done", [
    (True, 0.0, 0), (True, 1e30, 1), (False, 0.0, 1)])
def test_done_flag_follows_inner_cond(cont, floor, done):
    """done = not (j + 1 < m and it + j + 1 < maxiter and res > floor): the
    caller passes the first two as ``cont``, M tests the floor."""
    A = _operator(64, 3)
    V, H, cs, sn, g, w = _jax_state(A, np.float64, 3, seed=4)
    s = _port_state(V, H, cs, sn, g)
    arnoldi_cgs2(s, torch.from_numpy(w.copy()), 3)
    arnoldi_givens(s, 3, floor=floor, cont=cont)
    assert int(s.done[0]) == done
    assert bool(s.y.any()) == bool(done)


@pytest.mark.parametrize("j", [0, 29])
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
def test_one_cycle_matches_jax_gmres_cycles(dtype, j):
    """JAX's own ``_gmres_cycles`` with ``restart = maxiter = j + 1`` (one
    cycle of j + 1 steps) against the port's, whose steps are L and M: the
    solution and the history.  In float32 (complex64) the cycle runs inside
    a float64 (complex128) solve (``inner_dtype``); its solution agrees to
    1e-5 (the step's 1e-6 through the cycle's triangular solve), in float64
    and complex128 to 1e-11."""
    cplx = dtype.startswith("complex")
    A = _operator(300, 5, cplx)
    rng = np.random.default_rng(6)
    b = rng.standard_normal(300)
    if cplx:
        b = b + 1j * rng.standard_normal(300)
    idt = None if dtype in ("float64", "complex128") else dtype
    A32 = A.astype(np.complex64 if cplx else np.float32)
    mv = lambda d, v: d @ v
    xj, itj, hj, resj, _ = jkrylov._gmres_cycles(
        mv, jkrylov._IDENTITY_M, jnp.asarray(A), None, jnp.asarray(b), 1e-14,
        j + 1, j + 1, j + 1, 0.0, None if idt is None else jnp.asarray(A32), idt)
    At, A32t = torch.from_numpy(A), torch.from_numpy(A32)
    xt, info = gmres_compiled(
        mv, None, torch.from_numpy(b), reltol=1e-14, restart=j + 1,
        maxiter=j + 1, mv_data=At, inner_dtype=idt,
        mv_data_inner=None if idt is None else A32t, escalate=False)
    itt, ht_ = info["iters"], info["resnorm"]
    assert itt == int(itj) == j + 1
    tol = 1e-11 if idt is None else 1e-5
    assert _rel(xt.numpy(), xj) < tol
    assert _rel(ht_, np.asarray(hj)) < tol


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers are their plain versions: the same
    results, and no launch counted."""
    A = _operator(128, 7)
    V, H, cs, sn, g, w = _jax_state(A, np.float32, 5, seed=8)
    before = kernels.launch_counts()
    s1, s2 = _port_state(V, H, cs, sn, g), _port_state(V, H, cs, sn, g)
    w1, w2 = torch.from_numpy(w.copy()), torch.from_numpy(w.copy())
    arnoldi_cgs2(s1, w1, 5)
    arnoldi_givens(s1, 5, 1e-3, True)
    arnoldi_cgs2_plain(s2, w2, 5)
    arnoldi_givens_plain(s2, 5, 1e-3, True)
    assert torch.equal(w1, w2)
    for a, b in ((s1.H, s2.H), (s1.g, s2.g), (s1.st, s2.st), (s1.done, s2.done)):
        assert torch.equal(a, b)
    assert kernels.launch_counts() == before
    # kernel L's partial sums fit the state's scratch at every step
    assert s1.part.numel() >= (2 * M_RESTART + 1) * cgs2_blocks(128)
    assert cgs2_blocks(261121) == 132 and cgs2_blocks(16129) == 16
    assert cgs2_slice(10 ** 6, cgs2_blocks(10 ** 6)) <= cgs2_max_slice(
        torch.float64)


def test_value_type_takes_one_type_per_call():
    f32, f64 = torch.zeros(2), torch.zeros(2, dtype=torch.float64)
    assert kernels.value_type(f32, f32) == torch.float32
    assert kernels.value_type(f64) == torch.float64
    assert kernels.symbol("hs_dia_spmv", torch.float32) == "hs_dia_spmv_f32"
    assert kernels.symbol("hs_dia_spmv", torch.float64) == "hs_dia_spmv"
    c64 = torch.zeros(2, dtype=torch.complex64)
    assert kernels.value_type(c64, c64) == torch.complex64
    assert kernels.symbol("hs_dia_spmv", torch.complex128) == \
        "hs_dia_spmv_c128"
    for bad in ((f32, f64), (torch.zeros(2, dtype=torch.float16),),
                (f32, c64), (torch.zeros(2, dtype=torch.int32),)):
        with pytest.raises(TypeError, match="one type per call"):
            kernels.value_type(*bad)
    assert {"hs_arnoldi_cgs2_f32", "hs_arnoldi_givens_f32",
            "hs_front_assemble_f32"} <= set(kernels._SIGNATURES)
    assert set(kernels.MIXED_PATH) >= {"arnoldi_cgs2:float32",
                                       "arnoldi_givens:float32",
                                       "dia_spmv:float64"}
    assert hsolve is not None
