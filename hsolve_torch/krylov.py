"""Restarted GMRES with right preconditioning (port of ``hsolve/krylov.py``).

Capability parity with the reference's Krylov integration
(``IterativeSolvers.gmres(A, b; Pr=F, reltol, restart, maxiter, log)`` at
``test/rungmres.jl:47-48``): restarted GMRES(restart) whose right preconditioner
is a callable (the port's :class:`~hsolve_torch.factor.Factorization`), with a
residual-norm history.

The O(n) work (matvec, preconditioner, orthogonalization) runs on the tensors'
device.  Torch has no device-side while loop, so the O(restart^2) Hessenberg and
Givens bookkeeping runs on the host in float64, fed by one device->host fetch of
the new Hessenberg column per Arnoldi step; that fetch is also the step's
convergence test.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import scipy.linalg
import torch

from hsolve_torch.ops.sparse import DiaMatrix, dia_residual


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
                   m_eps: float = 0.0):
    """Restarted GMRES with CGS2 Arnoldi and true-residual restarts; the
    semantics and iteration count of the JAX package's ``gmres_compiled`` at
    ``inner_dtype=None``.  Returns ``(x, info)`` with ``info['iters']``,
    ``info['resnorm']`` (initial and per-cycle true residual norms) and
    ``info['converged']``.

    ``matvec``/``M`` take ``(data, v)`` when ``mv_data``/``M_data`` is given,
    else ``v``.  When ``mv_data`` is a :class:`~hsolve_torch.ops.sparse.DiaMatrix`
    the restarts' true residual ``b - A x`` is one fused pass of kernel D
    (:func:`~hsolve_torch.ops.sparse.dia_residual`), else ``b - matvec(x)``.
    ``m_eps`` floors a cycle's Givens estimate relative to its starting
    residual, so a cycle restarts once the estimate falls below what the basis
    can deliver."""
    if maxiter is None:
        maxiter = restart
    mv = (lambda v: matvec(mv_data, v)) if mv_data is not None else matvec
    if M is None:
        prec = lambda v: v
    elif M_data is not None:
        prec = lambda v: M(M_data, v)
    else:
        prec = M
    if isinstance(mv_data, DiaMatrix):
        resid = lambda x: dia_residual(mv_data, x, b)
    else:
        resid = lambda x: b - mv(x)

    n = b.shape[0]
    m = restart
    scalar = _scalar_type(b)
    bnorm = float(torch.linalg.vector_norm(b))
    tol = reltol * bnorm
    hist = np.zeros(maxiter + 1, dtype=np.float64)
    hist[0] = bnorm
    x = torch.zeros_like(b)
    r, beta, it, cyc = b, bnorm, 0, 0
    done = bnorm <= tol
    while not done and cyc < maxiter:
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / (beta if beta > 0 else 1.0)
        H = np.zeros((m + 1, m), dtype=scalar)
        cs = np.ones(m, dtype=np.float64)
        sn = np.zeros(m, dtype=scalar)
        g = np.zeros(m + 1, dtype=scalar)
        g[0] = beta
        j, res = 0, beta
        floor = max(tol, m_eps * beta)
        while j < m and res > floor and it + j < maxiter:
            w = mv(prec(V[j]))
            Vj = V[: j + 1]
            # CGS2 (classical Gram-Schmidt, twice): two GEMV pairs instead of a
            # sequential MGS loop, with MGS-grade orthogonality
            h1 = Vj.conj() @ w
            w = w - Vj.T @ h1
            h2 = Vj.conj() @ w
            w = w - Vj.T @ h2
            hnorm_t = torch.linalg.vector_norm(w)
            V[j + 1] = w / torch.where(hnorm_t > 0, hnorm_t, 1.0).to(w.dtype)
            # the step's one host fetch: the new Hessenberg column
            hc = torch.cat([h1 + h2, hnorm_t.to(w.dtype)[None]]).cpu().numpy()
            hcol = np.zeros(m + 1, dtype=scalar)
            hcol[: j + 2] = hc
            for i in range(j):   # apply accumulated rotations
                t = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hcol[i + 1] = -np.conj(sn[i]) * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i] = t
            a_, b_ = hcol[j], hcol[j + 1]
            denom = np.sqrt(abs(a_) ** 2 + abs(b_) ** 2)
            absa = abs(a_)
            if denom > 0 and absa > 0:
                cs_j = absa / denom
                sn_j = (a_ * np.conj(b_)) / max(absa * denom,
                                                np.finfo(np.float64).tiny)
            elif denom > 0:
                cs_j, sn_j = 0.0, 1.0
            else:
                cs_j, sn_j = 1.0, 0.0
            hcol[j] = cs_j * a_ + sn_j * b_
            hcol[j + 1] = 0.0
            H[:, j] = hcol
            cs[j], sn[j] = cs_j, sn_j
            gj1 = -np.conj(sn_j) * g[j]
            g[j] = cs_j * g[j]
            g[j + 1] = gj1
            res = abs(gj1)
            j += 1
        if j:
            y = scipy.linalg.solve_triangular(H[:j, :j], g[:j], lower=False)
            upd = torch.as_tensor(y, dtype=b.dtype, device=b.device) @ V[:j]
            x = x + prec(upd)
        it += j
        r = resid(x)
        beta = float(torch.linalg.vector_norm(r))
        hist[it] = beta
        done = beta <= tol or it >= maxiter or j == 0
        cyc += 1
    return x, {"resnorm": hist[: it + 1], "iters": it,
               "converged": bool(beta <= tol)}
