"""Restarted GMRES with right preconditioning (port of ``hsolve/krylov.py``).

Capability parity with the reference's Krylov integration
(``IterativeSolvers.gmres(A, b; Pr=F, reltol, restart, maxiter, log)`` at
``test/rungmres.jl:47-48``): restarted GMRES(restart) whose right preconditioner
is a callable (the port's :class:`~hsolve_torch.factor.Factorization`), with a
residual-norm history.

:func:`gmres_compiled` runs on the tensors' device: the matvec, the
preconditioner and each Arnoldi step (one launch: kernel L, CGS2, with
kernel M's Givens bookkeeping and the scaling into the next basis vector as
its tail, in the cycles' value type) stay there, and the host reads one
4-byte done flag per step and one residual norm per cycle (torch has no
device-side while loop).  It also runs the JAX package's mixed-precision
configuration: float32 cycles inside a float64 solve, with escalation to a
float64 phase.  :func:`gmres` is the host-loop variant (MGS, host Givens).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from hsolve_torch.ops.arnoldi import arnoldi_state, arnoldi_step
from hsolve_torch.ops.sparse import DiaMatrix, dia_residual, torch_dtype


def _givens(a, b):
    """Complex-safe Givens pair (cs, sn) zeroing b: apply as
    [cs, sn; -conj(sn), cs] @ [a; b] = [r; 0]."""
    denom = np.sqrt(abs(a) ** 2 + abs(b) ** 2)
    if denom == 0.0:
        return 1.0, 0.0 * a
    if abs(a) == 0.0:
        return 0.0, b / abs(b) if abs(b) else 0.0
    cs = abs(a) / denom
    sn = (a * np.conj(b)) / (abs(a) * denom)
    return cs, sn


def _scalar_type(b: torch.Tensor):
    return np.complex128 if b.is_complex() else np.float64


def _mgs(V: torch.Tensor, w: torch.Tensor, j: int):
    """Modified Gram-Schmidt of w against V[0..j]; returns (w_orth, coefficients)."""
    hs = []
    for i in range(j + 1):
        h = torch.vdot(V[i], w)
        w = w - h * V[i]
        hs.append(h)
    return w, torch.stack(hs)


def gmres(matvec: Callable, b, M: Optional[Callable] = None, x0=None,
          reltol: float = 1e-9, abstol: float = 0.0, restart: int = 30,
          maxiter: Optional[int] = None):
    """Solve ``A x = b`` with right-preconditioned restarted GMRES (MGS Arnoldi).

    matvec: ``v -> A v``; M: ``v -> M^{-1} v`` (right preconditioner).
    Returns ``(x, info)``: ``info['resnorm']`` holds the initial residual norm
    followed by one entry per inner iteration; ``info['iters']``;
    ``info['converged']``."""
    b = torch.as_tensor(b)
    n = b.shape[0]
    if maxiter is None:
        maxiter = restart
    if M is None:
        M = lambda v: v
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device)
    have_x = x0 is not None

    scalar = _scalar_type(b)
    bnorm = float(torch.linalg.vector_norm(b))
    tol = max(reltol * bnorm, abstol)
    history: List[float] = []
    iters = 0
    converged = False

    while iters < maxiter and not converged:
        r = b - matvec(x) if (have_x or iters > 0) else b
        beta = float(torch.linalg.vector_norm(r))
        if iters == 0:
            history.append(beta)
        if beta <= tol:
            converged = True
            break
        m = min(restart, maxiter - iters)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / beta
        H = np.zeros((m + 1, m), dtype=scalar)
        cs = np.ones(m, dtype=np.float64)
        sn = np.zeros(m, dtype=scalar)
        g = np.zeros(m + 1, dtype=scalar)
        g[0] = beta
        j_done = 0
        for j in range(m):
            w = matvec(M(V[j]))
            w, hcol = _mgs(V, w, j)
            hnorm_t = torch.linalg.vector_norm(w)
            hj = torch.cat([hcol, hnorm_t.to(hcol.dtype)[None]]).cpu().numpy()
            hnorm = float(abs(hj[-1]))
            H[: j + 1, j] = hj[: j + 1]
            H[j + 1, j] = hnorm
            if hnorm > 0:
                V[j + 1] = w / hnorm
            for i in range(j):  # apply accumulated rotations
                t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -np.conj(sn[i]) * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = t
            cs[j], sn[j] = _givens(H[j, j], H[j + 1, j])
            H[j, j] = cs[j] * H[j, j] + sn[j] * H[j + 1, j]
            H[j + 1, j] = 0.0
            g[j + 1] = -np.conj(sn[j]) * g[j]
            g[j] = cs[j] * g[j]
            j_done = j + 1
            res = abs(g[j + 1])
            history.append(float(res))
            if res <= tol:
                break
        if j_done:
            y = np.linalg.solve(H[:j_done, :j_done], g[:j_done])
            upd = torch.as_tensor(y, dtype=b.dtype, device=b.device) @ V[:j_done]
            x = x + M(upd)
            have_x = True
        iters += j_done
        # declare convergence only on the true residual (restarted cycles then act
        # as iterative refinement around an inexact preconditioner)
        true_res = float(torch.linalg.vector_norm(b - matvec(x)))
        history[-1] = true_res
        converged = bool(true_res <= tol)

    info = {"resnorm": np.asarray(history, dtype=np.float64), "iters": iters,
            "converged": converged}
    return x, info


def gmres_compiled(matvec: Callable, M: Optional[Callable], b: torch.Tensor,
                   reltol: float = 1e-9, restart: int = 30,
                   maxiter: Optional[int] = None, M_data=None, mv_data=None,
                   m_eps: float = 0.0, inner_dtype=None, mv_data_inner=None,
                   escalate: bool = True):
    """Restarted GMRES with CGS2 Arnoldi and true-residual restarts: the
    semantics and iteration counts of the JAX package's ``gmres_compiled``.
    Returns ``(x, info)`` with ``info['iters']``, ``info['resnorm']`` (initial
    and per-cycle true residual norms) and ``info['converged']``.

    ``matvec``/``M`` take ``(data, v)`` when ``mv_data``/``M_data`` is given,
    else ``v``.  When ``mv_data`` is a :class:`~hsolve_torch.ops.sparse.DiaMatrix`
    the restarts' true residual ``b - A x`` is one fused pass of kernel D
    (:func:`~hsolve_torch.ops.sparse.dia_residual`), else ``b - matvec(x)``.
    ``m_eps`` floors a cycle's Givens estimate relative to its starting
    residual, so a cycle restarts once the estimate falls below what the basis
    can deliver.

    Mixed precision: ``inner_dtype="float32"`` (with a float32
    ``mv_data_inner``) runs the Arnoldi cycles (basis, orthogonalization,
    Givens bookkeeping, inner matvecs) in float32 while the solution, the
    residual and the convergence test stay in ``b``'s type; ``M`` then sees
    inner-type vectors inside a cycle and outer-type ones at its end.  With
    ``escalate`` (the default) a second phase in the outer type solves the
    remaining residual system (:func:`_gmres_escalated`).  Each phase has its
    own ``maxiter`` budget, so ``iters`` may exceed ``maxiter``.

    Every Arnoldi step is one launch on the device
    (:func:`~hsolve_torch.ops.arnoldi.arnoldi_step`: kernel L with kernel
    M's step and ``V[j+1]`` as its tail); the host reads the step's 4-byte
    done flag and, per cycle, the true residual norm."""
    if maxiter is None:
        maxiter = restart
    mv = (lambda v: matvec(mv_data, v)) if mv_data is not None else matvec
    mv_i = (lambda v: matvec(mv_data_inner, v)) \
        if mv_data_inner is not None else mv
    if M is None:
        prec = lambda v: v
    elif M_data is not None:
        prec = lambda v: M(M_data, v)
    else:
        prec = M
    idt = None if inner_dtype is None else torch_dtype(inner_dtype)
    if idt is not None and escalate:
        x, it, hist, res, bnorm = _gmres_escalated(
            mv, mv_i, prec, mv_data, b, float(reltol), restart, int(maxiter),
            float(m_eps), idt)
    else:
        x, it, hist, res, bnorm = _gmres_cycles(
            mv, mv_i, prec, mv_data, b, float(reltol), restart, int(maxiter),
            float(m_eps), idt)
    return x, {"resnorm": hist[: it + 1], "iters": it,
               "converged": bool(res <= max(reltol * bnorm, 0.0))}


def _residual(mv: Callable, mv_data, b: torch.Tensor) -> Callable:
    if isinstance(mv_data, DiaMatrix):
        return lambda x: dia_residual(mv_data, x, b)
    return lambda x: b - mv(x)


def _gmres_cycles(mv, mv_i, prec, mv_data, b, reltol, restart, maxiter, m_eps,
                  inner_dtype):
    """The restart cycles (``hsolve/krylov.py:_gmres_cycles``): returns
    ``(x, iters, history [maxiter + 1], final residual norm, ||b||)``.

    The cycles' basis, Hessenberg matrix, rotations and ``g`` live in
    ``inner_dtype`` (``b``'s type when None); a cycle starts from the true
    residual ``r`` cast to it and adds ``M(y V)`` cast back to ``b``'s type.
    Its floor is ``max(tol, m_eps beta)`` in the inner real type, and a step
    runs only while JAX's ``inner_cond`` holds: ``j < m``, the estimate above
    the floor, ``it + j < maxiter``."""
    odt = b.dtype
    dt = odt if inner_dtype is None else inner_dtype
    rdt = torch.empty(0, dtype=dt).real.dtype
    rnp = torch.empty(0, dtype=rdt).numpy().dtype.type   # np.float32 / float64
    resid = _residual(mv, mv_data, b)
    N, m = b.shape[0], restart
    bnorm = float(torch.linalg.vector_norm(b))
    tol = reltol * bnorm
    hist = np.zeros(maxiter + 1, dtype=np.float64)
    hist[0] = bnorm
    x = torch.zeros_like(b)
    r, beta, it, cyc = b, bnorm, 0, 0
    done = bnorm <= tol
    s = arnoldi_state(m, N, dt, b.device) if not done else None
    while not done and cyc < maxiter:
        beta_i = rnp(beta)
        floor = max(rnp(tol), rnp(m_eps) * beta_i)
        s.V[0] = (r / (beta if beta > 0 else 1.0)).to(dt)
        s.g[0] = float(beta_i)
        j = 0
        if beta_i > floor:                 # inner_cond before the first step
            while True:
                w = mv_i(prec(s.V[j])).to(dt).contiguous()
                cont = j + 1 < m and it + j + 1 < maxiter
                arnoldi_step(s, w, j, floor, cont)
                j += 1
                # the step's one device->host read: the done flag
                if not cont or bool(s.done.item()):
                    break
        if j:
            upd = s.y[:j] @ s.V[:j]
            x = x + prec(upd).to(odt)
        it += j
        r = resid(x)
        beta = float(torch.linalg.vector_norm(r))
        hist[it] = beta
        done = beta <= tol or it >= maxiter or j == 0
        cyc += 1
    return x, it, hist, beta, bnorm


def _gmres_escalated(mv, mv_i, prec, mv_data, b, reltol, restart, maxiter,
                     m_eps, inner_dtype):
    """Reduced-precision cycles, then an outer-precision phase on the
    remaining residual (``hsolve/krylov.py:_gmres_escalated``): phase 2 solves
    ``A x2 = b - A x`` at ``reltol * ||b|| / ||b - A x||`` with ``m_eps = 0``
    and no inner type; ``x += x2``.  The iterations add up, the history is
    phase 1's ``[maxiter + 1]`` block followed by phase 2's entries after its
    first, and the residual is phase 2's.  When phase 1 converged, phase 2
    costs one residual."""
    x, it, hist, _, bnorm = _gmres_cycles(mv, mv_i, prec, mv_data, b, reltol,
                                          restart, maxiter, m_eps, inner_dtype)
    r1 = _residual(mv, mv_data, b)(x)
    beta1 = float(torch.linalg.vector_norm(r1))
    reltol2 = reltol * bnorm / (beta1 if beta1 > 0 else 1.0)
    x2, it2, hist2, res2, _ = _gmres_cycles(mv, mv, prec, mv_data, r1, reltol2,
                                            restart, maxiter, 0.0, None)
    return (x + x2.to(x.dtype), it + it2, np.concatenate([hist, hist2[1:]]),
            res2, bnorm)
