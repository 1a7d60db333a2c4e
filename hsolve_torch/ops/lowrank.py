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

The sketch GEMM, ``torch.linalg.qr`` and ``torch.linalg.svd`` are library
calls, as the JAX package leaves them to ``lax.linalg``.  ``cpqr``,
``interp_decomp`` and ``lowrank_recompress`` serve only the structured (HSS)
path and come with it.
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
