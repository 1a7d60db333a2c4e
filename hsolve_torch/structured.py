"""Fully-structured compressed branches: the quasilinear path (port of
``hsolve/structured.py``).

Children Schur complements stay in HSS form end to end (the reference's HSS
branch factorization, ``_factor_branch`` Val{true} + ``_assemble_blocks`` for
HSS children, factorization.jl:78-140):

- the pivot block ``D = [[H1, C12], [C21, H2]]`` couples the children's interior
  HSS blocks through the junction couplings, which are EXACT skinny factor
  pairs (one-hot row selectors x nonzero-row value strips, planned host-side);
  its inverse action is block substitution with two HSS solvers, where the
  inner Schur complement ``S22' = H2 - C21 H1^{-1} C12`` is rebuilt as HSS by
  interpolative sampling, with one refinement step against the exact operator,
- the off-diagonal front blocks reuse the children's generators
  (factorization.jl:129-137), so the Gauss transforms ``L = Abi D^{-1}`` and
  ``R = D^{-1} Aib`` are exact skinny factor pairs,
- the parent Schur complement is compressed straight from its sampling
  operator ``S = P(Abb - (Abi R.U) R.V^T)P^T`` (factorization.jl:228-249).

The JAX package ``vmap``s single-front code; here every operand carries the
batch axis.  The HSS work runs on kernels H-K (:mod:`hsolve_torch.ops.hss`,
:mod:`hsolve_torch.ops.lowrank`).  Not carried over: ``structured_precision``
(TPU matmul passes).  With the environment variable ``HS_DEBUG_DENSE_S`` set
(to anything), both compressions are built from the dense matrix instead
of sampled (``hsolve/structured.py:294-301``, ``:415-421``): the bisection
hook that tells a sampling fault from an algebra fault.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch

from hsolve_torch.ops.hss import (ClusterPlan, Hss, HssSolver, generators,
                                  hss_compress_dense, hss_entries_prepared,
                                  hss_entry_factors, hss_factor, hss_matvec,
                                  hss_randcompress_batched, hss_solve, hss_sub,
                                  hss_todense)

# Internal tightening of the HSS compression tolerances relative to the user's
# atol/rtol (interpolative decompositions deliver ~2-5x the requested error,
# and pivot-block inversion amplifies it by cond(D)); the reference's 0.5 on
# the transforms, factorization.jl:99-100, plays the same role.
_SAFETY = 0.25


@dataclasses.dataclass
class SchurHss:
    """A batch of Schur complements in HSS form on a shared cluster plan; node
    i's content occupies ``[0, n1[i])`` (parent-int part) and ``[half, half +
    n2[i])`` (parent-bnd part) of the padded index space, identity elsewhere."""

    h: Hss
    n1: torch.Tensor          # [B] int64
    n2: torch.Tensor          # [B] int64

    @property
    def cplan(self) -> ClusterPlan:
        return self.h.plan

    def select(self, idx: torch.Tensor) -> "SchurHss":
        idx = idx.long()
        return SchurHss(h=self.h.map(lambda a: a[idx]), n1=self.n1[idx],
                        n2=self.n2[idx])


def _embed_idx(cplan: ClusterPlan, n1: torch.Tensor, n2: torch.Tensor,
               width: int) -> torch.Tensor:
    """[B, width] compact position -> HSS pad coordinate, sentinel ``n_pad``
    past the content."""
    t = torch.arange(width, device=n1.device)[None, :]
    k1, k12 = n1[:, None], (n1 + n2)[:, None]
    pad = torch.where(t < k1, t, cplan.half + (t - k1))
    return torch.where(t < k12, pad, cplan.n_pad)


def transition_compress(S_perm: torch.Tensor, n1: torch.Tensor, n2: torch.Tensor,
                        cplan: ClusterPlan, atol: float, rtol: float,
                        cap: int) -> SchurHss:
    """Dense ``[int_loc; bnd_loc]``-permuted Schur complements ``[B, w, w]`` ->
    batched HSS (the first compressed level, whose children were dense): embed
    in HSS pad coordinates through a sentinel row and column, identity on the
    padding, then :func:`hss_compress_dense`."""
    Bn, w, _ = S_perm.shape
    npd = cplan.n_pad
    emb = _embed_idx(cplan, n1, n2, w)                         # [B, w]
    b = torch.arange(Bn, device=S_perm.device)[:, None, None]
    Spad = S_perm.new_zeros((Bn, npd + 1, npd + 1))
    Spad[b, emb[:, :, None], emb[:, None, :]] = S_perm
    covered = S_perm.new_zeros((Bn, npd + 1))
    covered.scatter_(1, emb, 1.0)
    Spad = Spad[:, :npd, :npd] + torch.diag_embed(1.0 - covered[:, :npd])
    h = hss_compress_dense(Spad, cplan, _SAFETY * atol, _SAFETY * rtol, cap)
    return SchurHss(h=h, n1=n1, n2=n2)


def densify_schur(s: SchurHss, s_pad: int) -> torch.Tensor:
    """Dense compact Schur complements ``[B, s_pad, s_pad]`` (for parents that
    assemble HSS children densely); the padded region is garbage and must be
    masked by the consumer's maps."""
    Hd = hss_todense(s.h)
    emb = _embed_idx(s.cplan, s.n1, s.n2, s_pad).clamp(max=s.cplan.n_pad - 1)
    b = torch.arange(Hd.shape[0], device=Hd.device)[:, None, None]
    return Hd[b, emb[:, :, None], emb[:, None, :]]


# ---------------------------------------------------------------------------
# the structured level record and its pivot solve
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StructuredLevel:
    """Solve-sweep data of a structured level: HSS pivot solvers + exact skinny
    Gauss-transform factors (reference FactorNode with BlockFactorization D +
    LowRankMatrix L/R, factornode.jl:7-35).  The pivot couplings are skinny
    pairs ``C12 = U12 V12^T``, ``C21 = U21 V21^T``, and ``W = H1^{-1} C12 =
    WU V12^T``."""

    solver1: HssSolver       # child-1 interior HSS solver
    solver22: HssSolver      # inner Schur complement solver
    H2: Hss                  # child-2 interior HSS (the exact S22' operand)
    WU: torch.Tensor         # [B, h1, rc] = H1^{-1} U12
    V12: torch.Tensor        # [B, h2, rc]
    U21: torch.Tensor        # [B, h2, rc]
    V21: torch.Tensor        # [B, h1, rc]
    LU_: Optional[torch.Tensor]   # [B, q1+q2, kk]
    LV_: Optional[torch.Tensor]   # [B, h1+h2, kk]
    RU_: Optional[torch.Tensor]   # [B, h1+h2, kk]
    RV_: Optional[torch.Tensor]   # [B, q1+q2, kk]
    int_ids: torch.Tensor    # [B, h1+h2] int32, sentinel N
    bnd_ids: torch.Tensor    # [B, q1+q2] int32, sentinel N
    h1: int
    h2: int
    # [B] largest interpolation rank of this batch's randomized compressions;
    # rank_maxed >= rank_cap flags silent-truncation risk
    rank_maxed: Optional[torch.Tensor] = None
    rank_cap: int = 0


def d_apply(lev: StructuredLevel, x: torch.Tensor,
            adjoint: bool = False) -> torch.Tensor:
    """Pivot-block solve ``D^{-1} x`` (or ``D^{-T} x``) for ``x [B, h1+h2, k]``:
    block substitution with the two HSS solvers (parity with ``blockldiv!``,
    blockmatrix.jl:135-144), the inner Schur solve sharpened by one step of
    iterative refinement against ``S22' = H2 - C21 H1^{-1} C12``."""
    h1 = lev.h1
    x1, x2 = x[:, :h1], x[:, h1:]
    WUt = lev.WU.transpose(-1, -2)
    V12t = lev.V12.transpose(-1, -2)
    U21t = lev.U21.transpose(-1, -2)
    V21t = lev.V21.transpose(-1, -2)

    def s22_mv(y, adj=False):
        # S22' y = H2 y - U21 (V21^T (WU (V12^T y)))
        if not adj:
            return hss_matvec(lev.H2, y) - lev.U21 @ (V21t @ (lev.WU @ (V12t @ y)))
        return hss_matvec(lev.H2, y, adjoint=True) \
            - lev.V12 @ (WUt @ (lev.V21 @ (U21t @ y)))

    if not adjoint:
        y1 = hss_solve(lev.solver1, x1)
        t = x2 - lev.U21 @ (V21t @ y1)               # C21 y1
        y2 = hss_solve(lev.solver22, t)
        y2 = y2 + hss_solve(lev.solver22, t - s22_mv(y2))
        y1 = y1 - lev.WU @ (V12t @ y2)               # W y2
    else:
        y1 = hss_solve(lev.solver1, x1, adjoint=True)
        t = x2 - lev.V12 @ (WUt @ x1)                # W^T x1
        y2 = hss_solve(lev.solver22, t, adjoint=True)
        y2 = y2 + hss_solve(lev.solver22, t - s22_mv(y2, adj=True), adjoint=True)
        y1 = y1 - hss_solve(lev.solver1, lev.V21 @ (U21t @ y2), adjoint=True)
    return torch.cat([y1, y2], dim=1)


# ---------------------------------------------------------------------------
# the structured factor step
# ---------------------------------------------------------------------------

def _rows_of(A: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``A[b, idx[b, ...], :]`` for ``A [B, n, c]`` and ``idx [B, ...]``."""
    b = torch.arange(A.shape[0], device=A.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    return A[b, idx]


def structured_factor_batch(sh1: SchurHss, sh2: SchurHss,
                            cross: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                            smap: torch.Tensor, cplan: ClusterPlan,
                            n1: torch.Tensor, n2: torch.Tensor,
                            int_ids: torch.Tensor, bnd_ids: torch.Tensor,
                            atol: float, rtol: float, rank_cap: int,
                            sketch22: Tuple[torch.Tensor, torch.Tensor],
                            sketchS: Tuple[torch.Tensor, torch.Tensor]
                            ) -> Tuple[StructuredLevel, SchurHss]:
    """Factor one structured batch (``hsolve/structured.py:246-430``); returns
    the solve-sweep record and the parent Schur complements in HSS form.

    ``cross`` holds the 8 junction couplings as exact pairs ``(U, V)`` with
    ``A_blk = U V^T``; ``smap [B, n_pad]`` int64 maps parent-S pad coordinates
    to the child-aligned boundary layout (sentinel ``q1 + q2``);
    ``sketch22``/``sketchS`` are the ``(Om, Ps)`` sketches of the S22' and the
    parent-S compressions, ``[B, n_pad, s]`` on their plans."""
    cpl, cpr = sh1.cplan, sh2.cplan
    h1, h2 = cpl.half, cpr.half
    q1, q2 = cpl.n_pad - cpl.half, cpr.n_pad - cpr.half
    tol = (_SAFETY * atol, _SAFETY * rtol)

    A11_1, A11_2 = hss_sub(sh1.h, 0), hss_sub(sh2.h, 0)
    A22_1, A22_2 = hss_sub(sh1.h, 1), hss_sub(sh2.h, 1)

    # children generators and root couplings (factorization.jl:129-132)
    U1a, V1a, U1b, V1b = generators(sh1.h)
    U2a, V2a, U2b, V2b = generators(sh2.h)
    Ui1 = U1a @ sh1.h.B12s[-1][:, 0]      # [B, h1, r] int->bnd row factor
    Ub1 = U1b @ sh1.h.B21s[-1][:, 0]      # [B, q1, r] bnd->int
    Ui2 = U2a @ sh2.h.B12s[-1][:, 0]
    Ub2 = U2b @ sh2.h.B21s[-1][:, 0]

    Ui12, Vi12 = cross["ci12"]
    Ui21, Vi21 = cross["ci21"]
    Uib12, Vib12 = cross["cib12"]
    Uib21, Vib21 = cross["cib21"]
    Ubi12, Vbi12 = cross["cbi12"]
    Ubi21, Vbi21 = cross["cbi21"]
    Ubb12, Vbb12 = cross["cbb12"]
    Ubb21, Vbb21 = cross["cbb21"]

    # pivot block: H1 solver + skinny coupling algebra
    solver1 = hss_factor(A11_1)
    WU = hss_solve(solver1, Ui12)                        # [B, h1, r12]

    # S22' = H2 - G21 V12^T with G21 = U21 (V21^T WU), rebuilt as HSS by the
    # partially-matrix-free interpolative compressor (blockmatrix.jl:121-130)
    G21 = Ui21 @ (Vi21.transpose(-1, -2) @ WU)          # [B, h2, r12]
    ef2 = hss_entry_factors(A11_2)
    dense_s = bool(os.environ.get("HS_DEBUG_DENSE_S"))

    def s22_sample(X, adjoint):
        if not adjoint:
            return hss_matvec(A11_2, X) - G21 @ (Vi12.transpose(-1, -2) @ X)
        return hss_matvec(A11_2, X, adjoint=True) \
            - Vi12 @ (G21.transpose(-1, -2) @ X)

    def s22_blocks(rows, cols):
        return hss_entries_prepared(ef2, rows, cols) \
            - _rows_of(G21, rows) @ _rows_of(Vi12, cols).transpose(-1, -2)

    if dense_s:
        S22d = hss_todense(A11_2) - G21 @ Vi12.transpose(-1, -2)
        hssS22 = hss_compress_dense(S22d, A11_2.plan, *tol, rank_cap)
        maxed22 = torch.zeros(Ui1.shape[0], dtype=torch.int32,
                              device=Ui1.device)
    else:
        hssS22, maxed22 = hss_randcompress_batched(
            s22_sample, s22_blocks, A11_2.plan, *sketch22, *tol, rank_cap)
    solver22 = hss_factor(hssS22)

    lev = StructuredLevel(
        solver1=solver1, solver22=solver22, H2=A11_2, WU=WU, V12=Vi12,
        U21=Ui21, V21=Vi21, LU_=None, LV_=None, RU_=None, RV_=None,
        int_ids=int_ids, bnd_ids=bnd_ids, h1=h1, h2=h2)

    # --- exact skinny Gauss transforms ---
    # The children's ranks r1 = sh1.h.r and r2 = sh2.h.r may differ (they come
    # from batches with other caps), so the column groups sit side by side,
    # r1 + r2 + rib12 + rib21 wide.  The JAX package places child 2's group
    # at column r1 in a width of 2 r1 + ...: the same product where r2 <= r1,
    # but where r2 > r1 its group overlaps the cross groups' columns.
    Bn = n1.shape[0]

    def blocks_of(rows_total, parts):
        """Column groups ``(A, row offset)`` side by side, zero elsewhere."""
        out = Ui1.new_zeros((Bn, rows_total, sum(A.shape[2] for A, _ in parts)))
        col = 0
        for A, r0 in parts:
            out[:, r0: r0 + A.shape[1], col: col + A.shape[2]] = A
            col += A.shape[2]
        return out

    # Aib = AibU AibV^T: groups [child1-gen, child2-gen, cross i1b2, cross i2b1]
    AibU = blocks_of(h1 + h2, [(Ui1, 0), (Ui2, h1), (Uib12, 0), (Uib21, h1)])
    AibV = blocks_of(q1 + q2, [(V1b, 0), (V2b, q1), (Vib12, q1), (Vib21, 0)])
    # Abi = AbiU AbiV^T
    AbiU = blocks_of(q1 + q2, [(Ub1, 0), (Ub2, q1), (Ubi12, 0), (Ubi21, q1)])
    AbiV = blocks_of(h1 + h2, [(V1a, 0), (V2a, h1), (Vbi12, h1), (Vbi21, 0)])

    RU = d_apply(lev, AibU).contiguous()                 # R = (D^-1 AibU) AibV^T
    LV = d_apply(lev, AbiV, adjoint=True).contiguous()   # L = AbiU (D^-T AbiV)^T
    lev = dataclasses.replace(lev, LU_=AbiU, LV_=LV, RU_=RU, RV_=AibV)

    # --- parent Schur complement via sampling ---
    # corr = Abi R = KU RV^T with KU = AbiU (AbiV^T RU)
    KU = AbiU @ (AbiV.transpose(-1, -2) @ RU)            # [B, q1+q2, kk_ib]
    RV = AibV
    nq = q1 + q2
    efb1 = hss_entry_factors(A22_1)
    efb2 = hss_entry_factors(A22_2)

    def s_sample(X, adjoint):
        s = X.shape[-1]
        sm = smap[:, :, None].expand(-1, -1, s)
        Xb = X.new_zeros((Bn, nq + 1, s)).scatter_add_(1, sm, X)[:, :nq]
        x1, x2 = Xb[:, :q1], Xb[:, q1:]
        if not adjoint:
            y1 = hss_matvec(A22_1, x1) + Ubb12 @ (Vbb12.transpose(-1, -2) @ x2)
            y2 = hss_matvec(A22_2, x2) + Ubb21 @ (Vbb21.transpose(-1, -2) @ x1)
            Yb = torch.cat([y1, y2], 1) - KU @ (RV.transpose(-1, -2) @ Xb)
        else:
            y1 = hss_matvec(A22_1, x1, adjoint=True) \
                + Vbb21 @ (Ubb21.transpose(-1, -2) @ x2)
            y2 = hss_matvec(A22_2, x2, adjoint=True) \
                + Vbb12 @ (Ubb12.transpose(-1, -2) @ x1)
            Yb = torch.cat([y1, y2], 1) - RV @ (KU.transpose(-1, -2) @ Xb)
        Yb = torch.cat([Yb, X.new_zeros((Bn, 1, s))], 1)
        Y = torch.gather(Yb, 1, sm)
        return torch.where((smap < nq)[:, :, None], Y, X)   # identity on padding

    def s_blocks(rows, cols):
        rb, cb = _rows_of(smap, rows), _rows_of(smap, cols)
        rv, cv = rb < nq, cb < nq
        r1, c1 = rb < q1, cb < q1
        rbc, cbc = rb.clamp(max=nq - 1), cb.clamp(max=nq - 1)
        r_lo, c_lo = rbc.clamp(max=q1 - 1), cbc.clamp(max=q1 - 1)
        r_hi, c_hi = (rbc - q1).clamp(min=0), (cbc - q1).clamp(min=0)
        e11 = hss_entries_prepared(efb1, r_lo, c_lo)
        e22 = hss_entries_prepared(efb2, r_hi, c_hi)
        e12 = _rows_of(Ubb12, r_lo) @ _rows_of(Vbb12, c_hi).transpose(-1, -2)
        e21 = _rows_of(Ubb21, r_hi) @ _rows_of(Vbb21, c_lo).transpose(-1, -2)
        both1 = r1[..., :, None] & c1[..., None, :]
        both2 = (~r1)[..., :, None] & (~c1)[..., None, :]
        val = torch.where(both1, e11, torch.where(
            both2, e22, torch.where(r1[..., :, None], e12, e21)))
        val = val - _rows_of(KU, rbc) @ _rows_of(RV, cbc).transpose(-1, -2)
        valid = rv[..., :, None] & cv[..., None, :]
        pad_diag = ((~rv)[..., :, None] & (~cv)[..., None, :]
                    & (rows[..., :, None] == cols[..., None, :])).to(val.dtype)
        return torch.where(valid, val, pad_diag)

    if dense_s:
        eye = torch.eye(cplan.n_pad, dtype=KU.dtype, device=KU.device)
        hssS = hss_compress_dense(s_sample(eye.expand(Bn, -1, -1), False),
                                  cplan, *tol, rank_cap)
        maxedS = torch.zeros_like(maxed22)
    else:
        hssS, maxedS = hss_randcompress_batched(s_sample, s_blocks, cplan,
                                                *sketchS, *tol, rank_cap)
    lev = dataclasses.replace(lev, rank_maxed=torch.maximum(maxed22, maxedS),
                              rank_cap=rank_cap)
    return lev, SchurHss(h=hssS, n1=n1, n2=n2)
