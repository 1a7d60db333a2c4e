"""Numeric factorization: level-synchronous batched multifrontal elimination
(port of the exact, low-rank compressed and structured HSS paths of
``hsolve/factor.py``).

The planner's schedule runs bottom-up, one batched step per height level, as a
plain Python loop over eagerly executed torch calls.  Each level:

1. assembles its padded fronts on the device from the matrix values (kernel A,
   :func:`~hsolve_torch.ops.assembly.front_assemble`) and adds the children's
   Schur complements (kernel B, :func:`~hsolve_torch.ops.assembly.extend_add`),
2. factors the pivot block ``D`` with batched pivoted LU (factorization.jl:33),
3. forms the Gauss transforms ``L = Abi D^-1`` and ``R = D^-1 Aib`` by batched
   triangular solves (factorization.jl:36-37),
4. forms ``S = Abb - Abi R``, permuted to ``[int_loc; bnd_loc]`` order for the
   parent (factorization.jl:40).

Steps 2-4 are library calls (:mod:`hsolve_torch.ops.dense`).  The solve
(:func:`solve_with_data`) runs each dense level's forward step, pivot solve
included, as one launch of kernel C
(:func:`~hsolve_torch.ops.sweep.level_forward`) and its backward step as
another (:func:`~hsolve_torch.ops.sweep.sweep_update`).

A compressed level (``swlevel < 0`` with ``hss=False``) stores its Gauss
transforms as tolerance-truncated low-rank pairs ``L ~= LU_ LV_^T`` and
``R ~= RU_ RV_^T`` from a randomized factorization of ``Abi`` and ``Aib``
(:func:`~hsolve_torch.ops.lowrank.rand_lowrank`, whose truncation is kernel
G); ``D`` touches only the ``k`` sketch columns, and ``S = Abb - (Abi RU_)
RV_^T`` is kernel F (:func:`~hsolve_torch.ops.schur.lowrank_schur_update`).
Its solve updates are kernel E
(:func:`~hsolve_torch.ops.sweep.lowrank_sweep_update`).  The sketches come
from a host ``torch.Generator`` seeded from ``(opts.seed, batch index)`` and
are copied to the factorization's device, so every device factors with the
same sketches (:func:`torch_sketch`); ``sketch=`` hands in others (the tests
pass the JAX package's).

With ``hss=True`` (the default) a compressed batch whose parent assembles
structurally emits its Schur complements as HSS
(:func:`~hsolve_torch.structured.transition_compress`), and a batch whose
children are both HSS is *structured*
(:func:`~hsolve_torch.structured.structured_factor_batch`): its pivot block is
solved by two HSS solvers and its Schur complement is compressed from a
sampling operator, never formed.  Its records are
:class:`~hsolve_torch.structured.StructuredLevel`; the solve runs kernel E on
its low-rank Gauss transforms around :func:`~hsolve_torch.structured.d_apply`.
A dense parent of HSS children densifies them and adds them with kernel B.

The factor runs in float64 or float32: the JAX bench's device
configuration, a float32 factor as the preconditioner of mixed-precision
GMRES (kernels A-C then run in float32, and on compressed and structured
levels kernels E-K too, E summing in float64 and rounding once, as C's
float32 sweep does, and H's column-pivoting loop and K's Woodbury solve
running in float64; the sketches are drawn in float32, as the JAX package
draws them for a float32 factor).  A complex system
(the damped Helmholtz operator) factors in complex128 or, as the bench's
device configuration, complex64, on exact plans, and in complex128 on
compressed levels, low-rank (``hss=False``: kernels E-G in complex128) or
structured (``hss=True``: kernels E-K in complex128), the sketches drawn
real and cast, as the JAX package draws them.  Only the column-pivoted QR
behind the interpolative decompositions conjugates (``R = Q^H A``, the ID of
``A^H``); every other product of the structured levels, their adjoint
solves included, takes plain transposes, as the JAX package's do.  Float32 and
complex64 products never use TF32 here:
``factor_with_plan`` sets ``torch.backends.cuda.matmul.allow_tf32 = False``
explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from hsolve_torch import kernels
from hsolve_torch.interop import TorchPlan, plan_to_torch
from hsolve_torch.kernels import VALUE_TYPES, resolve_device
from hsolve_torch.ops import dense as dk
from hsolve_torch.ops.assembly import extend_add, front_assemble
from hsolve_torch.ops.lowrank import rand_lowrank, sketch_width
from hsolve_torch.ops.schur import lowrank_schur_update
from hsolve_torch.ops.sparse import torch_dtype
from hsolve_torch.ops.sweep import (level_forward, lowrank_sweep_update,
                                    pivot_solve, sweep_update)
from hsolve_torch.options import SolverOptions
from hsolve_torch.planner import Plan, cross_block_shapes, plan_factorization
from hsolve_torch.structured import (SchurHss, StructuredLevel, d_apply,
                                     densify_schur, structured_factor_batch,
                                     transition_compress)
from hsolve_torch.ops.hss import sample_width
from hsolve_torch.utils.trees import NDTree


@dataclasses.dataclass
class DenseLevel:
    """Factor data for one height level (all fronts batched)."""

    lu: Optional[torch.Tensor]    # [B, ni_pad, ni_pad] pivot-block LU (None with dinv)
    perm: Optional[torch.Tensor]  # [B, ni_pad] int64 LU row permutation
    L: torch.Tensor               # [B, nb_pad, ni_pad] left Gauss transform
    R: torch.Tensor               # [B, ni_pad, nb_pad] right Gauss transform
    int_ids: torch.Tensor         # [B, ni_pad] int32 gather/scatter map, sentinel N
    bnd_ids: torch.Tensor         # [B, nb_pad] int32 gather/scatter map, sentinel N
    dinv: Optional[torch.Tensor] = None        # [B, ni_pad, ni_pad] explicit D^{-1}
    diag_ratio: Optional[torch.Tensor] = None  # [B] pivot-growth proxy (with dinv)


@dataclasses.dataclass
class CompressedLevel:
    """Factor data for a compressed height level: the Gauss transforms in
    tolerance-truncated low-rank form (parity with ``_lgauss_transform`` /
    ``_rgauss_transform``, factorization.jl:171-209)."""

    lu: Optional[torch.Tensor]    # [B, ni_pad, ni_pad] (None with dinv)
    perm: Optional[torch.Tensor]  # [B, ni_pad] int64
    LU_: torch.Tensor             # L ~= LU_ @ LV_^T : [B, nb_pad, k]
    LV_: torch.Tensor             # [B, ni_pad, k]
    RU_: torch.Tensor             # R ~= RU_ @ RV_^T : [B, ni_pad, k]
    RV_: torch.Tensor             # [B, nb_pad, k]
    lrank: torch.Tensor           # [B] int32
    rrank: torch.Tensor           # [B] int32
    int_ids: torch.Tensor         # [B, ni_pad] int32, sentinel N
    bnd_ids: torch.Tensor         # [B, nb_pad] int32, sentinel N
    dinv: Optional[torch.Tensor] = None
    diag_ratio: Optional[torch.Tensor] = None


Level = Union[DenseLevel, CompressedLevel, StructuredLevel]
# sketch(key, shape_a, shape_b) -> (a, b), two Gaussian sketches:
# - key = batch index, shapes (n_bi, s_bi), (n_ib, s_ib): the [n, s] sketches
#   of Abi and Aib of one compressed batch;
# - key = (7000 + batch index, tag), shapes (B, n_pad, s) twice: the per-front
#   sketches (Om, Ps) of a structured batch's randomized HSS compression, tag
#   203 for the inner Schur complement S22', 202 for the parent S
Sketch = Callable[[Union[int, Tuple[int, int]], Tuple[int, ...], Tuple[int, ...]],
                  Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class RootSolve:
    lu: Optional[torch.Tensor]    # [nbr, nbr]
    perm: Optional[torch.Tensor]  # [nbr]
    bnd_ids: torch.Tensor         # [nbr] int32, sentinel-padded
    inv: Optional[torch.Tensor] = None   # [nbr, nbr] explicit inverse
    diag_ratio: Optional[torch.Tensor] = None


class SolveData(tuple):
    """``(levels, root, dperm, diperm)``: a factorization's solve data, a
    tuple that also takes attributes (``gmres_compiled`` caches the CUDA
    graphs that read it there, so they live no longer than it)."""


@dataclasses.dataclass
class Factorization:
    """The assembled preconditioner / direct solver (reference ``FactorNode``).

    ``solve`` applies the inverse in the original DOF ordering;
    ``apply_permuted`` works in the planner's post-order permutation.  Inputs
    must be tensors on the factorization's device (numpy arrays are uploaded
    to it); results stay there."""

    N: int
    perm: np.ndarray
    levels: List[Level]
    root: Optional[RootSolve]
    opts: SolverOptions
    plan: Optional[Plan]
    device: torch.device

    def __post_init__(self):
        self._dperm = torch.as_tensor(self.perm, dtype=torch.int64,
                                      device=self.device)
        inv = np.empty(len(self.perm), dtype=np.int64)
        inv[self.perm] = np.arange(len(self.perm), dtype=np.int64)
        self._diperm = torch.as_tensor(inv, device=self.device)  # gather, not scatter
        self._solve_data = SolveData((self.levels, self.root, self._dperm,
                                      self._diperm))

    def _on_device(self, b) -> torch.Tensor:
        if isinstance(b, torch.Tensor):
            if b.device != self.device:
                raise ValueError(f"right-hand side on {b.device}, factorization "
                                 f"on {self.device}")
            return b
        return torch.as_tensor(np.asarray(b), device=self.device)

    def apply_permuted(self, b) -> torch.Tensor:
        return _apply(self.levels, self.root, self._on_device(b))

    @property
    def dtype(self) -> torch.dtype:
        """The factors' value type."""
        for lev in self.levels:
            return (lev.L if isinstance(lev, DenseLevel) else lev.LU_).dtype
        return (self.root.lu if self.root.lu is not None else self.root.inv).dtype

    def solve(self, b) -> torch.Tensor:
        """x = F^{-1} b in the original ordering (parity with ``ldiv!``,
        factornode.jl:62-74); ``b`` is [N] or [N, k].  The sweeps run in the
        factor's type; x comes back in ``b``'s."""
        b = self._on_device(b)
        return solve_with_data(self.solve_data, b.to(self.dtype)).to(b.dtype)

    @property
    def solve_data(self) -> "SolveData":
        """Everything ``solve`` needs, for :func:`solve_with_data` (the
        preconditioner data of :func:`~hsolve_torch.krylov.gmres_compiled`,
        which keeps its CUDA graphs on it): one object for the
        factorization's lifetime."""
        return self._solve_data

    def maxrank(self) -> int:
        """Max compression rank across the factorization (parity with
        ``maxrank``, factornode.jl:49-57); 0 on the dense path.  Structured
        levels report the computed interpolation rank capped at the planned
        cap.  One small device->host fetch."""
        return max([min(lv["max_rank"], lv["cap"])
                    for lv in self.rank_report()["levels"]], default=0)

    def rank_report(self) -> dict:
        """Per compressed or structured level: planned cap, computed max rank,
        and whether any node *saturated* its cap (the randomized compression
        may then have truncated - the condition ``randcompress_adaptive``
        grows its sample budget on, factorization.jl:110).  One small
        device->host fetch."""
        comp = [(i, lev) for i, lev in enumerate(self.levels)
                if isinstance(lev, CompressedLevel) or (
                    isinstance(lev, StructuredLevel)
                    and lev.rank_maxed is not None)]
        out = {"levels": [], "saturated": False}
        if not comp:
            return out
        ranks = torch.stack([
            lev.rank_maxed.max() if isinstance(lev, StructuredLevel)
            else torch.maximum(lev.lrank.max(), lev.rrank.max())
            for _, lev in comp]).cpu().tolist()
        for (i, lev), mr in zip(comp, ranks):
            cap = lev.rank_cap if isinstance(lev, StructuredLevel) \
                else lev.LU_.shape[-1]
            sat = mr >= cap
            out["levels"].append({"level": i, "max_rank": int(mr), "cap": cap,
                                  "saturated": sat})
            out["saturated"] = out["saturated"] or sat
        return out

    def _cond_device(self):
        """Per-level pivot diag ratios as device scalars + (tag, eps) labels."""
        ratios, tags = [], []
        for i, lev in enumerate(self.levels):
            if isinstance(lev, StructuredLevel):
                continue                    # HSS pivot solvers: no dense LU
            if lev.lu is not None and lev.lu.shape[-1] > 0:
                ratios.append(dk._diag_ratio(lev.lu).max())
                tags.append((i, torch.finfo(lev.lu.dtype).eps))
            elif lev.diag_ratio is not None:
                ratios.append(lev.diag_ratio.max())
                tags.append((i, torch.finfo(lev.dinv.dtype).eps))
        if self.root is not None:
            if self.root.lu is not None:
                ratios.append(dk._diag_ratio(self.root.lu))
                tags.append(("root", torch.finfo(self.root.lu.dtype).eps))
            elif self.root.diag_ratio is not None:
                ratios.append(self.root.diag_ratio.max())
                tags.append(("root", torch.finfo(self.root.inv.dtype).eps))
        return ratios, tags

    def cond_report(self) -> dict:
        """Pivot-block conditioning diagnostics (``max |U_ii| / min |U_ii|`` per
        level); ``risky`` flags levels within 100x of ``1/eps``, where an
        explicit inverse may start costing GMRES iterations.  One device->host
        fetch."""
        ratios, tags = self._cond_device()
        vals = torch.stack(ratios).cpu().numpy() if ratios else []
        out = {"levels": [], "max_ratio": 0.0, "risky": False,
               "explicit_inverse": bool(self.opts.explicit_inverse)}
        for (tag, eps), v in zip(tags, vals):
            risky = bool(v > 0.01 / eps)
            out["levels"].append({"level": tag, "diag_ratio": float(v),
                                  "risky": risky})
            out["max_ratio"] = max(out["max_ratio"], float(v))
            out["risky"] = out["risky"] or risky
        return out

    def max_diag_ratio_device(self):
        """(device scalar max pivot-diag ratio, risky threshold); no host fetch."""
        ratios, tags = self._cond_device()
        if not ratios:
            return torch.zeros((), device=self.device), float("inf")
        thresh = min(0.01 / eps for _, eps in tags)
        return torch.stack(ratios).max(), float(thresh)


def solve_with_data(data, b: torch.Tensor) -> torch.Tensor:
    """x = F^{-1} b from a :attr:`Factorization.solve_data` tuple."""
    levels, root, dperm, diperm = data
    return _apply(levels, root, b[dperm])[diperm]


# ---------------------------------------------------------------------------
# per-level step
# ---------------------------------------------------------------------------

def _factor_front(front: torch.Tensor, sperm: torch.Tensor, ni_pad: int,
                  explicit_inv: bool = False, fast_inverse: bool = False):
    D = front[:, :ni_pad, :ni_pad]
    Aib = front[:, :ni_pad, ni_pad:]
    Abi = front[:, ni_pad:, :ni_pad]
    Abb = front[:, ni_pad:, ni_pad:]
    if fast_inverse and explicit_inv:
        dinv, ratio = dk.block_inverse(D)
        R = (dinv @ Aib).contiguous()
        L = (Abi @ dinv).contiguous()
        S = dk.permute_sym(dk.schur_complement(Abb, Abi, R), sperm)
        return None, None, L, R, S, dinv, ratio
    lu, perm = dk.lu_factor(D)
    # row-major copies: the solve sweeps (kernel C) stream L, R and dinv by
    # rows, and the triangular solves may return them column-major; kernel C
    # reads lu column-major, as the LU returns it
    R = dk.lu_solve(lu, perm, Aib).contiguous()
    L = dk.lu_solve_right(lu, perm, Abi).contiguous()
    S = dk.permute_sym(dk.schur_complement(Abb, Abi, R), sperm)
    if explicit_inv:
        # the solve sweeps use only dinv: the level keeps no lu/perm
        return (None, None, L, R, S, dk.lu_inverse(lu, perm).contiguous(),
                dk._diag_ratio(lu))
    return lu, perm, L, R, S, None, None


def _factor_front_compressed(front: torch.Tensor, sperm: torch.Tensor,
                             ni_pad: int, cap: int, atol: float, rtol: float,
                             omega_bi: torch.Tensor, omega_ib: torch.Tensor,
                             explicit_inv: bool = False,
                             fast_inverse: bool = False):
    """Compressed front step (parity with ``_factor_branch`` Val{true},
    factorization.jl:78-112, and ``hsolve/factor.py:331-381``):

    - Gauss transforms from the randomized tolerance-truncated factorization
      of the off-diagonal blocks (tolerances already scaled by ``c_tol``),
    - ``L = LU_ (D^-T LV)^T`` and ``R = (D^-1 RU) RV^T``: the D-solve touches
      only the k sketch columns,
    - ``S = Abb - (Abi RU_) RV_^T`` (exact Abi, compressed R), permuted:
      both products in kernel F."""
    D = front[:, :ni_pad, :ni_pad]
    Aib = front[:, :ni_pad, ni_pad:]
    Abi = front[:, ni_pad:, :ni_pad]
    lr_bi = rand_lowrank(Abi, omega_bi, atol, rtol, cap)
    lr_ib = rand_lowrank(Aib, omega_ib, atol, rtol, cap)
    lu = perm = dinv = ratio = None
    if fast_inverse and explicit_inv:
        dinv, ratio = dk.block_inverse(D)
        LV = dinv.transpose(-1, -2) @ lr_bi.V     # D^-T V: [B, ni_pad, k]
        RU = dinv @ lr_ib.U
    else:
        lu, perm = dk.lu_factor(D)
        LV = dk.lu_solve_right(lu, perm, lr_bi.V.transpose(-1, -2)
                               ).transpose(-1, -2)
        RU = dk.lu_solve(lu, perm, lr_ib.U)       # [B, ni_pad, k]
        if explicit_inv:
            dinv, ratio = dk.lu_inverse(lu, perm), dk._diag_ratio(lu)
            lu = perm = None
    # row-major factors for kernels E and F (the triangular solves may return
    # column-major ones)
    LV, RU = kernels.materialized(LV), kernels.materialized(RU)
    S = lowrank_schur_update(front, ni_pad, RU, lr_ib.V, sperm)
    return (lu, perm, lr_bi.U, LV, RU, lr_ib.V, lr_bi.rank, lr_ib.rank, S,
            dinv, ratio)


def torch_sketch(seed: int, device: torch.device, dtype: torch.dtype) -> Sketch:
    """The factorization's default sketches (see :data:`Sketch`): per key a
    host ``torch.Generator`` seeded from ``(seed, key)`` draws the first
    sketch, then the second (the JAX package's ``split`` order), and both are
    copied to ``device``.  A complex ``dtype`` draws in its real type and
    casts, as ``hsolve/ops/lowrank.py:rand_lowrank`` does: a complex128
    factor sees the float64 factor's sketches.

    Drawing on the host makes the factorization the same on every device: a
    card run reproduces the CPU run of the same seed.  That matters because
    the structured preconditioner's GMRES count depends on the draw at
    realistic sizes (helmholtz2d n=512, k=40, atol=rtol=1e-3: 12 to 60
    iterations over seeds, the JAX package's own draws included), so a
    device-side generator would make the card and the CPU disagree.  The
    cost is the host draw and one copy per key."""
    real = dtype.to_real()

    def draw(key, shape_a, shape_b):
        k0, tag = (key, 0) if isinstance(key, int) else key
        gen = torch.Generator()
        gen.manual_seed((int(seed) << 24) + (int(tag) << 14) + int(k0))
        return tuple(torch.randn(shape, generator=gen, dtype=real).to(
            device=device, dtype=dtype) for shape in (shape_a, shape_b))
    return draw


def _gather_schur(groups, s_stacks, B: int) -> SchurHss:
    """The child SchurHss rows of a structured batch: children may live in
    several source batches, all on one cluster plan (a planner invariant);
    every row of the batch is covered by exactly one group."""
    assert groups, "structured batch requires child sources"
    out = None
    for src_batch, src_rows, dst_rows in groups:
        src = s_stacks[src_batch]
        assert isinstance(src, SchurHss), \
            "structured batch fed by a non-HSS source (planner invariant)"
        sel = src.select(src_rows)
        if out is None and len(groups) == 1:
            return sel
        if out is None:
            out = SchurHss(h=sel.h.map(lambda a: a.new_zeros((B,) + a.shape[1:])),
                           n1=sel.n1.new_zeros(B), n2=sel.n2.new_zeros(B))
        dst = dst_rows.long()
        for a, v in zip(out.h.arrays() + [out.n1, out.n2],
                        sel.h.arrays() + [sel.n1, sel.n2]):
            a[dst] = v
    return out


def _run_structured(bp, tb, s_stacks, opts: SolverOptions, dtype, bidx: int,
                    sketch: Sketch):
    """One structured batch (``hsolve/factor.py:876-903``): the 8 cross
    couplings as EXACT skinny pairs ``A_blk = U V^T`` (``U`` the one-hot
    selector of the nonzero rows, ``V^T`` the value strip scattered from the
    planner's COO), the sketches, then :func:`structured_factor_batch`."""
    sh1 = _gather_schur(tb.groups_l, s_stacks, bp.B)
    sh2 = _gather_schur(tb.groups_r, s_stacks, bp.B)
    dev = tb.int_ids.device
    cross = {}
    for name in cross_block_shapes(bp.child_cplans):
        spec = bp.cross[name]
        r_, c_, rcap = spec["r"], spec["c"], spec["rcap"]
        rows, pos, vals = tb.cross[name]
        flat = torch.zeros(bp.B * rcap * c_, dtype=dtype, device=dev)
        flat[pos] = vals.to(dtype)
        strip = flat.reshape(bp.B, rcap, c_)
        U = (rows[:, None, :] == torch.arange(r_, device=dev)[None, :, None]
             ).to(dtype)                                       # [B, r, rcap]
        cross[name] = (U, strip.transpose(-1, -2).contiguous())  # V [B, c, rcap]
    sketches = []
    for tag, plan_ in ((203, bp.child_cplans[1]), (202, bp.cplan)):
        # S22' lives on child 2's interior half: its plan is one level shallower
        n = plan_.half if tag == 203 else plan_.n_pad
        s = min(sample_width(plan_, bp.rank_cap, opts.kest,
                             max(opts.stepsize, 8)), n)
        sketches.append(tuple(o.to(device=dev, dtype=dtype) for o in sketch(
            (7000 + bidx, tag), (bp.B, n, s), (bp.B, n, s))))
    return structured_factor_batch(
        sh1, sh2, cross, tb.smap, bp.cplan, tb.n1, tb.n2, tb.int_ids,
        tb.bnd_ids, opts.atol, opts.rtol, bp.rank_cap, *sketches)


def _factor_levels(plan: Plan, tp: TorchPlan, opts: SolverOptions,
                   dtype: torch.dtype, sketch: Optional[Sketch] = None):
    """Run the schedule; returns (levels, root, Schur stacks by batch)."""
    adata = tp.adata.to(dtype)
    fastinv = opts.resolve_fast_inverse()
    if sketch is None:
        sketch = torch_sketch(opts.seed, tp.device, dtype)
    levels: List[Level] = []
    s_stacks: Dict[int, torch.Tensor] = {}
    for bidx, (bp, tb) in enumerate(zip(plan.batches, tp.batches)):
        if bp.structured:
            lev, S = _run_structured(bp, tb, s_stacks, opts, dtype, bidx, sketch)
            levels.append(lev)
            s_stacks[bidx] = S
            continue
        front = front_assemble(bp.B, bp.m_pad, tb.pos, tb.src, adata)
        # left groups before right ones, the JAX package's order
        for groups, counts, imap, s_pad in (
                (tb.groups_l, tb.rows_l, tb.map_l, bp.sl_pad),
                (tb.groups_r, tb.rows_r, tb.map_r, bp.sr_pad)):
            for (src_batch, src_rows, dst_rows), rows in zip(groups, counts,
                                                             strict=True):
                src = s_stacks[src_batch]
                if isinstance(src, SchurHss):
                    # a dense parent of HSS children densifies them (the
                    # planner emits HSS only where something structured reads
                    # it; odd siblings and the root batch land here)
                    src = densify_schur(src.select(src_rows), s_pad)
                    src_rows = torch.arange(src.shape[0], dtype=torch.int32,
                                            device=src.device)
                extend_add(front, src, src_rows, dst_rows, imap, rows)
        if bp.compress:
            shapes = [(n, sketch_width(bp.rank_cap, n))
                      for n in (bp.ni_pad, bp.nb_pad)]
            om_bi, om_ib = (o.to(device=tp.device, dtype=dtype)
                            for o in sketch(bidx, *shapes))
            (lu, perm, LU_, LV_, RU_, RV_, lrank, rrank, S, dinv,
             ratio) = _factor_front_compressed(
                front, tb.sperm, bp.ni_pad, bp.rank_cap, opts.c_tol * opts.atol,
                opts.c_tol * opts.rtol, om_bi, om_ib, opts.explicit_inverse,
                fastinv)
            levels.append(CompressedLevel(
                lu=lu, perm=perm, LU_=LU_, LV_=LV_, RU_=RU_, RV_=RV_,
                lrank=lrank, rrank=rrank, int_ids=tb.int_ids,
                bnd_ids=tb.bnd_ids, dinv=dinv, diag_ratio=ratio))
            if bp.cplan is not None and opts.hss:
                S = transition_compress(S, tb.n1, tb.n2, bp.cplan, opts.atol,
                                        opts.rtol, bp.rank_cap)
        else:
            lu, perm, L, R, S, dinv, ratio = _factor_front(
                front, tb.sperm, bp.ni_pad, opts.explicit_inverse, fastinv)
            levels.append(DenseLevel(lu=lu, perm=perm, L=L, R=R,
                                     int_ids=tb.int_ids, bnd_ids=tb.bnd_ids,
                                     dinv=dinv, diag_ratio=ratio))
        s_stacks[bidx] = S
    root = _root_from_stacks(plan, tp, s_stacks, dtype, opts)
    return levels, root, s_stacks


def _root_from_stacks(plan: Plan, tp: TorchPlan, s_stacks, dtype,
                      opts: SolverOptions) -> Optional[RootSolve]:
    if plan.nb_root == 0:
        return None
    if isinstance(s_stacks[len(plan.batches) - 1], SchurHss):
        raise NotImplementedError(
            "the root's boundary Schur complement is HSS (plan.nb_root > 0 "
            "under a compressed top batch): RootHss, its HSS root solve, is "
            "not ported; nested_dissection trees never give this")
    bnd_ids = tp.batches[-1].bnd_ids[0]
    S_root = s_stacks[len(plan.batches) - 1][0]
    # padded diagonal -> identity so the root LU stays well-defined
    pad = torch.arange(S_root.shape[0], device=S_root.device) >= plan.nb_root
    S_root = S_root + torch.diag(pad.to(dtype))
    if opts.resolve_fast_inverse():
        inv, ratio = dk.block_inverse(S_root)
        return RootSolve(lu=None, perm=None, bnd_ids=bnd_ids, inv=inv,
                         diag_ratio=ratio.reshape(-1))
    lu, perm = dk.lu_factor(S_root)
    if opts.explicit_inverse:
        return RootSolve(lu=None, perm=None, bnd_ids=bnd_ids,
                         inv=dk.lu_inverse(lu, perm),
                         diag_ratio=dk._diag_ratio(lu).reshape(1))
    return RootSolve(lu=lu, perm=perm, bnd_ids=bnd_ids)


# ---------------------------------------------------------------------------
# solve sweeps
# ---------------------------------------------------------------------------

def _apply(levels: List[Level], root: Optional[RootSolve],
           b: torch.Tensor) -> torch.Tensor:
    """Hierarchical solve (parity with ``ldiv!`` + ``_lsolve!/_dsolve!/_rsolve!``,
    factornode.jl:62-99) in the post-order permutation.

    Bottom-up: ``C[bnd] -= L C[int]`` then ``C[int] = D^{-1} C[int]``: one
    launch of kernel C on a dense level; kernel E around the pivot solve
    (:func:`d_apply` on a structured level) on a compressed or structured
    one; root boundary solve; top-down: ``C[int] -= R C[bnd]`` (kernel C or
    E).  ``C`` carries a zero sentinel row N that padded ids point at."""
    N = b.shape[0]
    vec = b.ndim == 1
    C = b[:, None] if vec else b
    C = torch.cat([C, C.new_zeros((1, C.shape[1]))], dim=0)

    for lev in levels:
        if isinstance(lev, DenseLevel):
            level_forward(C, lev, N)
            continue
        x = C[lev.int_ids]                      # [B, ni_pad, k], before the solve
        lowrank_sweep_update(C, lev.bnd_ids, lev.LU_, lev.LV_, N, X=x)
        if isinstance(lev, StructuredLevel):
            C[lev.int_ids] = d_apply(lev, x)
            # padded ids all write the sentinel row; keep it zero
            C[N] = 0.0
        else:
            C[lev.int_ids] = pivot_solve(lev, x)

    if root is not None:
        xr = C[root.bnd_ids]                    # [nbr, k]
        C[root.bnd_ids] = root.inv @ xr if root.inv is not None else \
            dk.lu_solve(root.lu, root.perm, xr)

    for lev in reversed(levels):
        if isinstance(lev, DenseLevel):
            sweep_update(C, lev.int_ids, lev.R, N, ids_in=lev.bnd_ids)
        else:
            lowrank_sweep_update(C, lev.int_ids, lev.RU_, lev.RV_, N,
                                 ids_in=lev.bnd_ids)

    C = C[:N]
    return C[:, 0] if vec else C


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _torch_dtype(dtype, plan: Plan) -> torch.dtype:
    tdt = torch_dtype(plan.A_dtype if dtype is None else dtype)
    if not (tdt.is_floating_point or tdt.is_complex):
        raise TypeError(f"unsupported factorization dtype {tdt}")
    return tdt


def factor_with_plan(plan: Plan, opts: SolverOptions, dtype=None, *,
                     device="cuda", sketch: Optional[Sketch] = None
                     ) -> Factorization:
    """Execute the planner's schedule on ``device`` ("cuda[:i]", the
    default, or "cpu"); a missing card raises.

    ``plan`` may come from either planner.  On a CUDA device the kernels run,
    in float64 or float32, exact, low-rank compressed (``hss=False``) and
    structured (``hss=True``, the default) levels alike; on the CPU every
    kernel runs as its plain torch version.  A complex system
    (``plan.A_dtype`` complex128, e.g. ``helmholtz2d(n, damping=0.1)``)
    factors in complex128 or complex64 on an exact plan (``swlevel=0``), and
    in complex128 on compressed levels, low-rank or structured, on either
    device (complex64 there only on the CPU: kernels E-K in complex64 are
    slice 16 of the port).  ``sketch`` replaces the default
    sketches of the compressed batches (see :data:`Sketch` and
    :func:`torch_sketch`)."""
    dev = resolve_device(device)
    tdt = _torch_dtype(dtype, plan)
    if dev.type == "cuda" and tdt not in VALUE_TYPES:
        raise NotImplementedError(f"the CUDA kernels take {VALUE_TYPES}")
    if dev.type == "cuda" and tdt == torch.complex64 and any(
            bp.compress for bp in plan.batches):
        raise NotImplementedError(
            "complex64 on compressed and structured levels on the card "
            "(kernels E-K in complex64) is slice 16 of the port (ROADMAP.md, "
            "queue 1, item 1); factor this plan in complex128 there")
    torch.backends.cuda.matmul.allow_tf32 = False
    opts = opts.replace(explicit_inverse=opts.resolve_explicit_inverse())
    if opts.verbose:
        from hsolve_torch.utils.logging import logger, verbose_level

        with verbose_level(True):
            for i, bp in enumerate(plan.batches):
                logger.info("batch %d: B=%d ni_pad=%d nb_pad=%d %s%snnz=%d", i,
                            bp.B, bp.ni_pad, bp.nb_pad,
                            "leaf " if bp.is_leaf else "",
                            (f"{'structured' if bp.structured else 'compressed'}"
                             f" cap={bp.rank_cap} ") if bp.compress else "",
                            len(bp.front_pos))
    tp = plan_to_torch(plan, dev)
    levels, root, _ = _factor_levels(plan, tp, opts, tdt, sketch)
    return Factorization(N=plan.N, perm=plan.perm, levels=levels, root=root,
                         opts=opts, plan=plan, device=dev)


def factor(A: sp.spmatrix, tree: NDTree, opts: Optional[SolverOptions] = None,
           dtype=None, *, device="cuda", sketch: Optional[Sketch] = None,
           **overrides) -> Factorization:
    """Top-level entry (parity with ``factor(A, nd, nd_loc, opts; args...)``,
    factorization.jl:5-11): plan, then factor on ``device`` (the card unless
    the caller asks for the CPU; see :func:`factor_with_plan`, also for the
    value types: a complex system factors in complex128 on exact, low-rank
    and structured levels alike).

    With ``opts.adaptive`` the computed compression ranks are checked against
    the planned caps; on saturation the problem is re-planned with the largest
    saturated cap doubled as ``rank_cap`` and re-factored, at most three
    attempts in all (host-loop parity with ``randcompress_adaptive``'s sample
    budget growth, factorization.jl:110)."""
    opts = (opts or SolverOptions()).replace(**overrides)
    opts.validate()
    dev = resolve_device(device)
    for attempt in range(3):
        plan = plan_factorization(A, tree, opts)
        F = factor_with_plan(plan, opts, dtype=dtype, device=dev, sketch=sketch)
        if not opts.adaptive:
            return F
        report = F.rank_report()
        if not report["saturated"]:
            return F
        from hsolve_torch.utils.logging import logger

        new_cap = 2 * max(lv["cap"] for lv in report["levels"] if lv["saturated"])
        logger.warning(
            "compression rank saturated the planned cap on %d level(s) "
            "(report: %s); re-planning with rank_cap=%d (attempt %d)",
            sum(lv["saturated"] for lv in report["levels"]), report["levels"],
            new_cap, attempt + 1)
        opts = opts.replace(rank_cap=new_cap)
    return F
