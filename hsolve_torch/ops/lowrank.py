"""Batched randomized low-rank factorization (port of the part of
``hsolve/ops/lowrank.py`` that the low-rank compressed path runs).

- :class:`LowRank`: a batched factor pair ``A ~= U @ V^T`` (plain transpose, V
  stored untransposed), padded to a static rank cap with zero columns past
  each element's rank,
- :func:`rand_lowrank`: randomized range finder + small SVD, truncated at
  ``max(atol, rtol * sigma_0)`` and capped.  The sketch ``omega`` is an
  argument, so a caller (or a test) decides where its random numbers come from,
- :func:`lowrank_truncate` (kernel G, ``csrc/lowrank_truncate.cu``): the
  truncation epilogue of :func:`rand_lowrank`, with its plain version
  :func:`lowrank_truncate_plain`.

- :func:`cpqr` and :func:`interp_decomp`: column-pivoted QR without Q
  accumulation and the row interpolative decomposition built on it, for the
  structured (HSS) path.  The pivot loop is kernel H (``csrc/hss_cpqr.cu``,
  :func:`cpqr_pivots`, plain version :func:`cpqr_pivots_plain`).

The sketch GEMM, ``torch.linalg.qr``, ``torch.linalg.svd`` and the triangular
solve of :func:`interp_decomp` are library calls, as the JAX package leaves them
to ``lax.linalg``.  ``lowrank_recompress`` runs on no path and is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hsolve_torch import kernels


class LowRank(NamedTuple):
    """Batched low-rank factor pair: ``A ~= U @ V^T`` (V stored untransposed)."""

    U: torch.Tensor     # [..., m, k_cap]
    V: torch.Tensor     # [..., n, k_cap]
    rank: torch.Tensor  # [...] int32 numerical ranks

    def todense(self) -> torch.Tensor:
        return self.U @ self.V.transpose(-1, -2)


def _rank_mask(s: torch.Tensor, atol: float, rtol: float, cap: int):
    """Rank from singular values: keep ``sigma_i > max(atol, rtol*sigma_0)``,
    capped; returns (int32 rank, 0/1 mask in ``s``'s dtype)."""
    keep = s > torch.clamp(rtol * s[..., :1], min=atol)
    rank = torch.clamp(keep.sum(-1), max=cap).to(torch.int32)
    cols = torch.arange(s.shape[-1], device=s.device)
    return rank, (cols < rank[..., None]).to(s.dtype)


def lowrank_truncate_plain(QU: torch.Tensor, sv: torch.Tensor, Vh: torch.Tensor,
                           atol: float, rtol: float, cap: int):
    """``U = QU[:, :, :k] * (sv * mask)``, ``V = Vh^T[:, :, :k] * mask`` with
    ``k = min(cap, r)``, both zero-padded to ``cap`` columns; returns
    ``(U [B, m, cap], V [B, n, cap], rank [B] int32)``."""
    rank, mask = _rank_mask(sv, atol, rtol, cap)
    k = min(cap, sv.shape[-1])
    U = QU[..., :, :k] * (sv[..., None, :k] * mask[..., None, :k])
    V = Vh.transpose(-1, -2)[..., :, :k] * mask[..., None, :k]
    if k < cap:
        U = torch.nn.functional.pad(U, (0, cap - k))
        V = torch.nn.functional.pad(V, (0, cap - k))
    return U, V, rank


def lowrank_truncate(QU: torch.Tensor, sv: torch.Tensor, Vh: torch.Tensor,
                     atol: float, rtol: float, cap: int):
    """Kernel G wrapper (see the plain version); ``QU`` is [B, m, r], ``sv``
    [B, r] (descending), ``Vh`` [B, r, n]."""
    if kernels.on_cpu(QU, sv, Vh):
        return lowrank_truncate_plain(QU, sv, Vh, atol, rtol, cap)
    B, m, r = QU.shape
    n = Vh.shape[-1]
    kernels.require(QU, "QU", torch.float64, (B, m, r))
    kernels.require(sv, "sv", torch.float64, (B, r))
    kernels.require(Vh, "Vh", torch.float64, (B, r, n))
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    U = torch.empty((B, m, cap), dtype=QU.dtype, device=QU.device)
    V = torch.empty((B, n, cap), dtype=QU.dtype, device=QU.device)
    rank = torch.empty((B,), dtype=torch.int32, device=QU.device)
    if B:
        kernels.launch("hs_lowrank_truncate", QU.device, QU.data_ptr(),
                       sv.data_ptr(), Vh.data_ptr(), U.data_ptr(), V.data_ptr(),
                       rank.data_ptr(), float(atol), float(rtol), B, m, n, r,
                       cap)
        lowrank_truncate.launches += 1
    return U, V, rank


lowrank_truncate.launches = 0


OVERSAMPLE = 8    # sketch columns beyond the rank cap (JAX's default)


def sketch_width(cap: int, n: int) -> int:
    """Columns of the sketch of an ``[m, n]`` block at rank cap ``cap``."""
    return min(cap + OVERSAMPLE, n)


def rand_lowrank(A: torch.Tensor, omega: torch.Tensor, atol: float, rtol: float,
                 cap: int) -> LowRank:
    """Randomized tolerance-truncated low-rank factorization of batched dense
    ``A`` [B, m, n] with the sketch ``omega`` [n, s], shared across the batch
    (``s = sketch_width(cap, n)``): ``Y = A omega``, ``Q = qr(Y)``,
    ``svd(Q^T A)``, truncated at ``max(atol, rtol * sigma_0)`` and ``cap``
    (parity with ``pqrfact(...; sketch=:randn, atol, rtol)``,
    factorization.jl:189,202)."""
    Q, _ = torch.linalg.qr(A @ omega)                     # reduced: [B, m, s]
    Uw, sv, Vh = torch.linalg.svd(Q.transpose(-1, -2) @ A, full_matrices=False)
    U, V, rank = lowrank_truncate((Q @ Uw).contiguous(), sv.contiguous(),
                                  Vh.contiguous(), atol, rtol, cap)
    return LowRank(U=U, V=V, rank=rank)


# ---------------------------------------------------------------------------
# column-pivoted QR and interpolative decomposition (the HSS path)
# ---------------------------------------------------------------------------

class CPQR(NamedTuple):
    R: torch.Tensor     # [..., cap, n] upper-trapezoidal factor (pivoted order)
    piv: torch.Tensor   # [..., cap] int64 selected column indices, -1 past rank
    rank: torch.Tensor  # [...] int32 numerical rank against the tolerance


def cpqr_pivots_plain(A: torch.Tensor, atol: float, rtol: float, k: int):
    """The pivot loop of ``hsolve/ops/lowrank.py:cpqr`` (:189-219): ``k`` steps
    of Businger-Golub column pivoting with norm downdating on ``A`` [B, m, n];
    returns ``(piv [B, k] int32, -1 past the rank; rank [B] int32)``.  Ties go
    to the first maximal norm, as ``jnp.argmax`` does."""
    Bn, m, n = A.shape
    A = A.clone()
    norms2 = (A * A).sum(-2)
    norms0 = norms2.max(-1).values.sqrt() if n else A.new_zeros(Bn)
    thr = torch.clamp(rtol * norms0, min=atol)
    piv = torch.full((Bn, k), -1, dtype=torch.int32, device=A.device)
    rank = torch.zeros(Bn, dtype=torch.int32, device=A.device)
    active = torch.ones(Bn, dtype=torch.bool, device=A.device)
    rows = torch.arange(Bn, device=A.device)
    for j in range(k):
        p = norms2.argmax(-1)
        a = A[rows, :, p]                                       # [B, m]
        nrm = torch.clamp((a * a).sum(-1), min=1e-300).sqrt()
        ok = active & (nrm > thr)
        piv[:, j] = torch.where(ok, p, -1).to(torch.int32)
        rank += ok.to(torch.int32)
        q = torch.where(ok[:, None], a / nrm[:, None], 0.0)
        coef = (q[:, :, None] * A).sum(-2)                      # [B, n]
        A -= q[:, :, None] * coef[:, None, :]
        norms2 = torch.clamp(norms2 - coef * coef, min=0.0)
        norms2[rows, p] = -float("inf")
        active = ok
    return piv, rank


# dynamic shared memory a CTA of kernel H may take: a Hopper CTA's 227 KB
# less a margin for the kernel's static arrays
CPQR_MAX_SMEM = 227 * 1024 - 1024
CPQR_CLUSTERS = (1, 2, 4, 8)     # portable thread block cluster sizes


def cpqr_smem(m: int, n: int, cs: int, resident: bool = True) -> int:
    """Dynamic shared memory of one CTA of kernel H when a cluster of ``cs``
    CTAs shares an ``[m, n]`` matrix: its ``ceil(n / cs)`` columns (where
    ``resident``), their norms and coefficients, and the pivot direction."""
    w = -(-n // cs)
    return 8 * ((m * w if resident else 0) + 2 * w + m)


def cpqr_cluster(m: int, n: int):
    """``(cs, resident)``: kernel H spreads one ``[m, n]`` matrix's columns
    over the fewest CTAs of a cluster whose shared memory holds them; a
    matrix that 8 CTAs cannot hold keeps them in a global scratch copy
    (``resident`` False) on a cluster of 8."""
    for cs in CPQR_CLUSTERS:
        if cpqr_smem(m, n, cs) <= CPQR_MAX_SMEM:
            return cs, True
    return CPQR_CLUSTERS[-1], False


def cpqr_pivots(A: torch.Tensor, atol: float, rtol: float, k: int):
    """Kernel H wrapper (see the plain version); ``A`` is [B, m, n] float64,
    each matrix's columns spread over a thread block cluster
    (:func:`cpqr_cluster`)."""
    if kernels.on_cpu(A):
        return cpqr_pivots_plain(A, atol, rtol, k)
    Bn, m, n = A.shape
    kernels.require(A, "A", torch.float64)
    piv = torch.empty((Bn, k), dtype=torch.int32, device=A.device)
    rank = torch.empty((Bn,), dtype=torch.int32, device=A.device)
    if Bn and k:
        cs, resident = cpqr_cluster(m, n)
        if cpqr_smem(m, n, cs, resident) > CPQR_MAX_SMEM:
            raise ValueError(f"cpqr: a [{m}, {n}] matrix's norms and pivot "
                             "direction alone exceed a CTA's shared memory")
        work = None if resident else torch.empty(
            (Bn * cs, m, -(-n // cs)), dtype=A.dtype, device=A.device)
        kernels.launch("hs_cpqr", A.device, A.data_ptr(), piv.data_ptr(),
                       rank.data_ptr(), None if work is None else work.data_ptr(),
                       float(atol), float(rtol), Bn, m, n, k, cs)
        cpqr_pivots.launches += 1
    elif Bn:
        rank.zero_()
    return piv, rank


cpqr_pivots.launches = 0


def cpqr(A: torch.Tensor, atol: float, rtol: float, cap: int) -> CPQR:
    """Batched column-pivoted QR, R and pivots only (parity with
    ``hsolve/ops/lowrank.py:cpqr``): the pivot loop (kernel H), then a plain QR
    of the selected columns and ``R = Q^T A``, masked past the rank and padded
    to ``cap`` rows."""
    *batch, m, n = A.shape
    k = min(cap, m, n)
    A3 = A.reshape(-1, m, n).contiguous()
    piv, rank = cpqr_pivots(A3, atol, rtol, k)
    piv = piv.long()
    pos = piv.clamp(min=0)
    Asel = torch.gather(A3, -1, pos[:, None, :].expand(-1, m, k))
    mask = (torch.arange(k, device=A.device) < rank[:, None]).to(A.dtype)
    Q, _ = torch.linalg.qr(Asel * mask[:, None, :])
    R = (Q.transpose(-1, -2) @ A3) * mask[:, :, None]
    if k < cap:
        R = torch.nn.functional.pad(R, (0, 0, 0, cap - k))
        piv = torch.nn.functional.pad(piv, (0, cap - k), value=-1)
    return CPQR(R=R.reshape(*batch, cap, n), piv=piv.reshape(*batch, cap),
                rank=rank.reshape(batch))


def interp_decomp(A: torch.Tensor, atol: float, rtol: float, cap: int):
    """Row interpolative decomposition ``A ~= T @ A[J, :]`` (parity with
    ``hsolve/ops/lowrank.py:interp_decomp``) from :func:`cpqr` of ``A^T``.
    Returns ``(J [..., cap] int64 row ids, -1 past the rank; T [..., m, cap],
    zero past the rank; rank [...] int32)``."""
    f = cpqr(A.transpose(-1, -2), atol, rtol, cap)
    k = f.R.shape[-2]
    pos = f.piv.clamp(min=0)
    R11 = torch.gather(f.R, -1, pos[..., None, :].expand(*f.R.shape[:-1], k))
    mask = (torch.arange(k, device=A.device) < f.rank[..., None]).to(A.dtype)
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    # identity on the masked-out part keeps the triangular solve well-posed
    R11g = R11 * mask[..., None, :] + eye * (1.0 - mask[..., None, :])
    Tt = torch.linalg.solve_triangular(R11g, f.R, upper=True)
    T = Tt.transpose(-1, -2) * mask[..., None, :]
    return torch.where(f.piv >= 0, pos, -1), T, f.rank
