"""Batched randomized low-rank factorization (port of the part of
``hsolve/ops/lowrank.py`` that the low-rank compressed path runs).

- :class:`LowRank`: a batched factor pair ``A ~= U @ V^T`` (plain transpose, V
  stored untransposed), padded to a static rank cap with zero columns past
  each element's rank,
- :func:`rand_lowrank`: randomized range finder + small SVD, truncated at
  ``max(atol, rtol * sigma_0)`` and capped.  The sketch ``omega`` is an
  argument, so a caller (or a test) decides where its random numbers come from,
- :func:`lowrank_truncate` (kernel G, ``csrc/lowrank_truncate.cu``): the
  product ``Q @ Uw`` and the truncation epilogue of :func:`rand_lowrank`,
  with its plain version :func:`lowrank_truncate_plain`; float64, float32,
  complex64 or complex128 values (the singular values real).

- :func:`cpqr` and :func:`interp_decomp`: column-pivoted QR without Q
  accumulation and the row interpolative decomposition built on it, for the
  structured (HSS) path.  The pivot loop is kernel H (``csrc/hss_cpqr.cu``,
  :func:`cpqr_pivots`, plain version :func:`cpqr_pivots_plain`).

- :func:`lowrank_recompress`: re-orthogonalize and re-truncate a low-rank
  pair (the QRs of U and V, the SVD of their small core, then kernel G's
  truncation), on no factor path: a capability of the JAX package's API.

The sketch GEMM, ``torch.linalg.qr``, ``torch.linalg.svd`` and the triangular
solve of :func:`interp_decomp` are library calls, as the JAX package leaves them
to ``lax.linalg``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hsolve_torch import kernels
from hsolve_torch.ops.sweep import accumulator


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


def lowrank_truncate_plain(Q: torch.Tensor, Uw: torch.Tensor,
                           sv: torch.Tensor, Vh: torch.Tensor, atol: float,
                           rtol: float, cap: int):
    """``QU = Q @ Uw``, then ``U = QU[:, :, :k] * (sv * mask)``, ``V =
    Vh^T[:, :, :k] * mask`` with ``k = min(cap, r)``, both zero-padded to
    ``cap`` columns; returns ``(U [B, m, cap], V [B, n, cap], rank [B]
    int32)``.  ``Vh^T`` is the plain transpose, not conjugated, in complex
    too (``A ~= U V^T``); ``sv`` and the mask stay real."""
    QU = Q @ Uw
    rank, mask = _rank_mask(sv, atol, rtol, cap)
    k = min(cap, sv.shape[-1])
    U = QU[..., :, :k] * (sv[..., None, :k] * mask[..., None, :k])
    V = Vh.transpose(-1, -2)[..., :, :k] * mask[..., None, :k]
    if k < cap:
        U = torch.nn.functional.pad(U, (0, cap - k))
        V = torch.nn.functional.pad(V, (0, cap - k))
    return U, V, rank


def lowrank_truncate(Q: torch.Tensor, Uw: torch.Tensor, sv: torch.Tensor,
                     Vh: torch.Tensor, atol: float, rtol: float, cap: int):
    """Kernel G wrapper (see the plain version); ``Q`` is [B, m, s], ``Uw``
    [B, s, r], ``Vh`` [B, r, n], all float64, float32, complex64 or
    complex128, ``sv`` [B, r] in their real type (descending).  The kernel
    computes only the rank's columns of ``Q @ Uw``."""
    if kernels.on_cpu(Q, Uw, sv, Vh):
        return lowrank_truncate_plain(Q, Uw, sv, Vh, atol, rtol, cap)
    B, m, s = Q.shape
    r = Uw.shape[-1]
    n = Vh.shape[-1]
    dt = kernels.lowrank_type(Q, Uw, Vh)
    kernels.require(Q, "Q", dt, (B, m, s))
    kernels.require(Uw, "Uw", dt, (B, s, r))
    kernels.require(sv, "sv", dt.to_real(), (B, r))
    kernels.require(Vh, "Vh", dt, (B, r, n))
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    U = torch.empty((B, m, cap), dtype=Q.dtype, device=Q.device)
    V = torch.empty((B, n, cap), dtype=Q.dtype, device=Q.device)
    rank = torch.empty((B,), dtype=torch.int32, device=Q.device)
    if B:
        kernels.launch(kernels.symbol("hs_lowrank_truncate", dt), Q.device,
                       Q.data_ptr(), Uw.data_ptr(), sv.data_ptr(),
                       Vh.data_ptr(), U.data_ptr(), V.data_ptr(),
                       rank.data_ptr(), float(atol), float(rtol), B, m, n, s,
                       r, cap)
        kernels.count_launch(lowrank_truncate, dt)
    return U, V, rank


lowrank_truncate.launches = 0
lowrank_truncate.launches_by_type = {}


OVERSAMPLE = 8    # sketch columns beyond the rank cap (JAX's default)


def sketch_width(cap: int, n: int) -> int:
    """Columns of the sketch of an ``[m, n]`` block at rank cap ``cap``."""
    return min(cap + OVERSAMPLE, n)


def rand_lowrank(A: torch.Tensor, omega: torch.Tensor, atol: float, rtol: float,
                 cap: int) -> LowRank:
    """Randomized tolerance-truncated low-rank factorization of batched dense
    ``A`` [B, m, n] with the sketch ``omega`` [n, s], shared across the batch
    (``s = sketch_width(cap, n)``): ``Y = A omega``, ``Q = qr(Y)``,
    ``svd(Q^H A)``, truncated at ``max(atol, rtol * sigma_0)`` and ``cap``
    (parity with ``pqrfact(...; sketch=:randn, atol, rtol)``,
    factorization.jl:189,202).  A complex ``A`` keeps the plain-transpose
    convention ``A ~= U V^T`` (``hsolve/ops/lowrank.py:155-160``)."""
    Q, _ = torch.linalg.qr(A @ omega)                     # reduced: [B, m, s]
    Uw, sv, Vh = torch.linalg.svd(Q.mH @ A, full_matrices=False)
    U, V, rank = lowrank_truncate(*map(kernels.materialized, (Q, Uw, sv, Vh)),
                                  atol, rtol, cap)
    return LowRank(U=U, V=V, rank=rank)


def lowrank_recompress(lr: LowRank, atol: float, rtol: float,
                       cap: int) -> LowRank:
    """Re-orthogonalize and re-truncate a (possibly stacked) low-rank pair
    (``hsolve/ops/lowrank.py:260-276``, the capability of the reference's
    ``_recompress!``, factorization.jl:251-259): ``U = Qu Ru``, ``V = Qv
    Rv``, ``svd(Ru Rv^T) = Uc s Vh``, then ``U' = Qu Uc s`` and ``V' = Qv
    Vh^T`` truncated at ``max(atol, rtol * s_0)`` and ``cap`` and padded to
    ``cap`` columns, as :func:`rand_lowrank` truncates (kernel G, handed
    ``Vh Qv^T`` for ``Vh``).  Complex pairs keep the plain transpose,
    ``A ~= U V^T``."""
    lead = lr.U.shape[:-2]
    Qu, Ru = torch.linalg.qr(lr.U.reshape(-1, *lr.U.shape[-2:]))
    Qv, Rv = torch.linalg.qr(lr.V.reshape(-1, *lr.V.shape[-2:]))
    Uc, sv, Vh = torch.linalg.svd(Ru @ Rv.transpose(-1, -2), full_matrices=False)
    U, V, rank = lowrank_truncate(
        *map(kernels.materialized, (Qu, Uc, sv, Vh @ Qv.transpose(-1, -2))),
        atol, rtol, cap)
    return LowRank(U=U.reshape(*lead, *U.shape[-2:]),
                   V=V.reshape(*lead, *V.shape[-2:]), rank=rank.reshape(lead))


# ---------------------------------------------------------------------------
# column-pivoted QR and interpolative decomposition (the HSS path)
# ---------------------------------------------------------------------------

class CPQR(NamedTuple):
    R: torch.Tensor     # [..., cap, n] upper-trapezoidal factor (pivoted order)
    piv: torch.Tensor   # [..., cap] int64 selected column indices, -1 past rank
    rank: torch.Tensor  # [...] int32 numerical rank against the tolerance


def _abs2(x: torch.Tensor) -> torch.Tensor:
    """``|x|^2`` in the real type: ``x * x`` for a real ``x``; ``re^2 +
    im^2`` for a complex one, each product rounded (kernel H's order)."""
    if not x.is_complex():
        return x * x
    return x.real * x.real + x.imag * x.imag


def _div_real(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``a / d`` for a real ``d`` [B], each part of a complex ``a`` [B, m]
    divided on its own (JAX's division by ``d + 0j``; torch's complex
    division by a real is a product with the reciprocal)."""
    if not a.is_complex():
        return a / d[:, None]
    return torch.view_as_complex(torch.view_as_real(a) / d[:, None, None])


def cpqr_loop_type(dtype: torch.dtype) -> torch.dtype:
    """The type kernel H's pivot loop and its plain version run in for
    input of type ``dtype``: float64 for float32 and complex128 for
    complex64 (F4's rule, as the narrow sweeps sum: a 32-bit downdate
    ``norms^2 - |coef|^2`` cancels to noise once a residual falls to 3e-4
    of its column, where the transition compressions truncate), else
    ``dtype``: the solve sweeps' accumulator."""
    return accumulator(dtype)


def cpqr_pivots_plain(A: torch.Tensor, atol: float, rtol: float, k: int):
    """The pivot loop of ``hsolve/ops/lowrank.py:cpqr`` (:189-219): ``k`` steps
    of Businger-Golub column pivoting with norm downdating on ``A`` [B, m, n]
    (float64, float32, complex64 or complex128; float32 and complex64 run
    the loop in float64 and complex128, :func:`cpqr_loop_type`); returns ``(piv [B, k] int32, -1 past the rank;
    rank [B] int32)``.  The norms are real, ``sum |a|^2``; the coefficients
    are ``q^H A`` and the downdate subtracts ``|coef|^2``.  Ties go to the
    first maximal norm, as ``jnp.argmax`` does."""
    Bn, m, n = A.shape
    A = A.to(cpqr_loop_type(A.dtype), copy=True)
    norms2 = _abs2(A).sum(-2)
    norms0 = norms2.max(-1).values.sqrt() if n else norms2.new_zeros(Bn)
    thr = torch.clamp(rtol * norms0, min=atol)
    piv = torch.full((Bn, k), -1, dtype=torch.int32, device=A.device)
    rank = torch.zeros(Bn, dtype=torch.int32, device=A.device)
    active = torch.ones(Bn, dtype=torch.bool, device=A.device)
    rows = torch.arange(Bn, device=A.device)
    for j in range(k):
        p = norms2.argmax(-1)
        a = A[rows, :, p]                                       # [B, m]
        nrm = torch.clamp(_abs2(a).sum(-1), min=1e-300).sqrt()
        ok = active & (nrm > thr)
        piv[:, j] = torch.where(ok, p, -1).to(torch.int32)
        rank += ok.to(torch.int32)
        q = torch.where(ok[:, None], _div_real(a, nrm), 0.0)
        coef = (q.conj()[:, :, None] * A).sum(-2)               # [B, n]
        A -= q[:, :, None] * coef[:, None, :]
        norms2 = torch.clamp(norms2 - _abs2(coef), min=0.0)
        norms2[rows, p] = -float("inf")
        active = ok
    return piv, rank


# dynamic shared memory a CTA of kernel H may take: a Hopper CTA's 227 KB
# less a margin for the kernel's static arrays
CPQR_MAX_SMEM = 227 * 1024 - 1024
CPQR_CLUSTERS = (1, 2, 4, 8)     # portable thread block cluster sizes
CPQR_WARPS = 8                   # warps of a CTA of kernel H (H_WARPS)


def cpqr_smem(m: int, n: int, cs: int, resident: bool = True,
              itemsize: int = 8) -> int:
    """Dynamic shared memory of one CTA of kernel H when a cluster of ``cs``
    CTAs shares an ``[m, n]`` matrix whose pivot loop runs on
    ``itemsize``-byte values (8: float64, and float32, whose loop runs in
    float64; 16: complex128, and complex64, whose loop runs in complex128;
    :func:`cpqr_itemsize`): its ``w = ceil(n / cs)`` columns (where
    ``resident``), the warps' partial column sums ``[CPQR_WARPS, w]`` (the
    coefficients are their sum) and the pivot direction in the loop's type,
    the columns' norms in float64."""
    w = -(-n // cs)
    return itemsize * ((m * w if resident else 0) + CPQR_WARPS * w + m) \
        + 8 * w


def cpqr_itemsize(dtype: torch.dtype) -> int:
    """Bytes of one value of kernel H's pivot loop for input ``dtype``."""
    return torch.empty((), dtype=cpqr_loop_type(dtype)).element_size()


def cpqr_cluster(m: int, n: int, itemsize: int = 8):
    """``(cs, resident)``: the fewest CTAs of a cluster whose shared memory
    holds one ``[m, n]`` matrix's columns (kernel H spreads them over the
    cluster); a matrix that 8 CTAs cannot hold keeps them in a global
    scratch copy (``resident`` False) on a cluster of 8."""
    for cs in CPQR_CLUSTERS:
        if cpqr_smem(m, n, cs, True, itemsize) <= CPQR_MAX_SMEM:
            return cs, True
    return CPQR_CLUSTERS[-1], False


def cpqr_geometry(B: int, m: int, n: int, itemsize: int = 8, active=None):
    """``(cs, resident)`` of kernel H's launch over ``B`` ``[m, n]``
    matrices.  ``active(cs, resident)`` is how many clusters of that
    geometry the card holds at once (None: as many as the launch has).
    Among the cluster sizes from :func:`cpqr_cluster`'s up to 8, whose
    shared memory all hold the columns, it takes the one whose launch runs
    in the fewest waves, ``ceil(B / active)``, ties to the fewest CTAs; a
    geometry the card cannot hold at all (``active`` < 1) is refused."""
    cs0, resident = cpqr_cluster(m, n, itemsize)
    if cpqr_smem(m, n, cs0, resident, itemsize) > CPQR_MAX_SMEM:
        raise ValueError(f"cpqr: a [{m}, {n}] matrix's norms and pivot "
                         "direction alone exceed a CTA's shared memory")
    if active is None:
        return cs0, resident
    sizes = [cs for cs in CPQR_CLUSTERS if cs >= cs0] if resident else [cs0]
    waves = {cs: -(-B // held) for cs in sizes
             if (held := active(cs, resident)) >= 1}
    if not waves:
        raise ValueError(f"cpqr: the card cannot hold a cluster of kernel H "
                         f"for a [{m}, {n}] matrix")
    return min(waves, key=lambda cs: (waves[cs], cs)), resident


_ACTIVE = {}


def cpqr_launch(B: int, m: int, n: int, dtype: torch.dtype):
    """:func:`cpqr_geometry` of kernel H's launch over ``B`` ``[m, n]``
    matrices of input type ``dtype`` on the card: the clusters it holds at
    once asked of it (``cudaOccupancyMaxActiveClusters``, once per
    geometry)."""
    def active(cs: int, resident: bool) -> int:
        key = (m, n, cs, resident, dtype)
        if key not in _ACTIVE:
            _ACTIVE[key] = getattr(kernels.lib(), kernels.symbol(
                "hs_cpqr_clusters", dtype))(m, n, cs, int(resident))
        return _ACTIVE[key]

    return cpqr_geometry(B, m, n, cpqr_itemsize(dtype), active)


def cpqr_pivots(A: torch.Tensor, atol: float, rtol: float, k: int):
    """Kernel H wrapper (see the plain version); ``A`` is [B, m, n] float64,
    float32 (read as float32, the loop in float64), complex64 (the loop in
    complex128) or complex128, each
    matrix's columns spread over a thread block cluster
    (:func:`cpqr_launch`); each matrix's loop stops at its rank, the
    pivots past it -1."""
    if kernels.on_cpu(A):
        return cpqr_pivots_plain(A, atol, rtol, k)
    Bn, m, n = A.shape
    dt = kernels.lowrank_type(A)
    kernels.require(A, "A", dt)
    piv = torch.empty((Bn, k), dtype=torch.int32, device=A.device)
    rank = torch.empty((Bn,), dtype=torch.int32, device=A.device)
    if Bn and k:
        cs, resident = cpqr_launch(Bn, m, n, dt)
        work = None if resident else torch.empty(
            (Bn * cs, m, -(-n // cs)), dtype=cpqr_loop_type(dt),
            device=A.device)
        kernels.launch(kernels.symbol("hs_cpqr", dt), A.device, A.data_ptr(),
                       piv.data_ptr(), rank.data_ptr(),
                       None if work is None else work.data_ptr(),
                       float(atol), float(rtol), Bn, m, n, k, cs)
        kernels.count_launch(cpqr_pivots, dt)
    elif Bn:
        rank.zero_()
    return piv, rank


cpqr_pivots.launches = 0
cpqr_pivots.launches_by_type = {}


def cpqr(A: torch.Tensor, atol: float, rtol: float, cap: int) -> CPQR:
    """Batched column-pivoted QR, R and pivots only (parity with
    ``hsolve/ops/lowrank.py:cpqr``): the pivot loop (kernel H), then a plain QR
    of the selected columns and ``R = Q^H A``, masked past the rank and padded
    to ``cap`` rows."""
    *batch, m, n = A.shape
    k = min(cap, m, n)
    A3 = kernels.materialized(A.reshape(-1, m, n))
    piv, rank = cpqr_pivots(A3, atol, rtol, k)
    piv = piv.long()
    pos = piv.clamp(min=0)
    Asel = torch.gather(A3, -1, pos[:, None, :].expand(-1, m, k))
    mask = (torch.arange(k, device=A.device) < rank[:, None]).to(A.dtype)
    Q, _ = torch.linalg.qr(Asel * mask[:, None, :])
    R = (Q.mH @ A3) * mask[:, :, None]
    if k < cap:
        R = torch.nn.functional.pad(R, (0, 0, 0, cap - k))
        piv = torch.nn.functional.pad(piv, (0, cap - k), value=-1)
    return CPQR(R=R.reshape(*batch, cap, n), piv=piv.reshape(*batch, cap),
                rank=rank.reshape(batch))


def interp_decomp(A: torch.Tensor, atol: float, rtol: float, cap: int):
    """Row interpolative decomposition ``A ~= T @ A[J, :]`` (parity with
    ``hsolve/ops/lowrank.py:interp_decomp``) from :func:`cpqr` of ``A^H``.
    Returns ``(J [..., cap] int64 row ids, -1 past the rank; T [..., m, cap],
    zero past the rank; rank [...] int32)``."""
    f = cpqr(A.mH, atol, rtol, cap)
    k = f.R.shape[-2]
    pos = f.piv.clamp(min=0)
    R11 = torch.gather(f.R, -1, pos[..., None, :].expand(*f.R.shape[:-1], k))
    mask = (torch.arange(k, device=A.device) < f.rank[..., None]).to(A.dtype)
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    # identity on the masked-out part keeps the triangular solve well-posed
    R11g = R11 * mask[..., None, :] + eye * (1.0 - mask[..., None, :])
    Tt = torch.linalg.solve_triangular(R11g, f.R, upper=True)
    T = Tt.mH * mask[..., None, :]
    return torch.where(f.piv >= 0, pos, -1), T, f.rank
