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
A tree whose root keeps a boundary (``plan.nb_root > 0``, e.g. the
reference's elimination-tree files, or a root separator moved into ``bnd``)
under a compressed top batch ends in a :class:`RootHss`: the top Schur
complement stays HSS and its root solve is :func:`hss_solve` (kernel K).

The factor runs in float64 or float32: the JAX bench's device
configuration, a float32 factor as the preconditioner of mixed-precision
GMRES (kernels A-C then run in float32, and on compressed and structured
levels kernels E-K too, E summing in float64 and rounding once, as C's
float32 sweep does, and H's column-pivoting loop and K's Woodbury solve
running in float64; the sketches are drawn in float32, as the JAX package
draws them for a float32 factor).  A complex system
(the damped Helmholtz operator) factors in complex128 or, as the bench's
complex device configuration, complex64, on exact plans and on compressed
levels, low-rank (``hss=False``: kernels E-G in the factor's type) or
structured (``hss=True``: kernels E-K), the sketches drawn real and cast,
as the JAX package draws them; complex64 follows float32's rules, E
summing in complex128 and H's loop and K's solve running in complex128.  Only the column-pivoted QR
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
from hsolve_torch.ops.hss import HssSolver, hss_factor, hss_solve, sample_width
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


@dataclasses.dataclass
class RootHss:
    """Root boundary solve with an HSS Schur complement
    (``hsolve/factor.py:907-917``): a tree whose root keeps a boundary
    (``plan.nb_root > 0``) under a compressed top batch hands up its Schur
    complement as HSS, factored here by :func:`hss_factor` as a batch of one
    (the JAX package keeps it unbatched).  ``ids_pad`` maps the HSS pad
    coordinates to global dof ids, the sentinel N on the padding."""

    solver: HssSolver             # batch of 1
    ids_pad: torch.Tensor         # [n_pad] int32, sentinel N


Root = Union[RootSolve, RootHss]


def data_dtype(levels: List[Level], root: Optional[Root]) -> torch.dtype:
    """The value type of a factorization's records."""
    for lev in levels:
        return (lev.L if isinstance(lev, DenseLevel) else lev.LU_).dtype
    if isinstance(root, RootHss):
        return root.solver.D_lu.dtype
    return (root.lu if root.lu is not None else root.inv).dtype


class SolveData(tuple):
    """``(levels, root, dperm, diperm)``: a factorization's solve data, a
    tuple that also takes attributes (``gmres_compiled`` caches the CUDA
    graphs that read it there, so they live no longer than it).  A mesh
    factor's is a subclass whose :meth:`apply_permuted` sums over the ranks
    (:class:`~hsolve_torch.parallel.sharded.MeshSolveData`) and whose
    hooks, which the solvers and ``save_solver`` call on any solve data, are
    collective; on one device they do nothing."""

    def apply_permuted(self, b: torch.Tensor) -> torch.Tensor:
        """The hierarchical solve of ``b`` in the plan's ordering."""
        return _apply(self[0], self[1], b)

    def consensus(self, values: np.ndarray) -> np.ndarray:
        """The host values every rank branches on (one device: its own)."""
        return values

    def check_replicated(self, x: torch.Tensor) -> None:
        """Raise unless ``x`` is the same on every rank (one device: never)."""

    def prepare_graph(self, device: torch.device) -> None:
        """Make a CUDA graph of solves on ``device`` possible, or raise
        (one device: nothing to do)."""

    def gathered(self, dst: int = 0) -> Optional["SolveData"]:
        """The one-device solve data, on rank ``dst`` (None elsewhere)."""
        return self


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
    root: Optional[Root]
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

    def apply_permuted(self, b) -> torch.Tensor:
        return self.solve_data.apply_permuted(on_device(b, self.device))

    @property
    def dtype(self) -> torch.dtype:
        """The factors' value type."""
        return data_dtype(self.levels, self.root)

    def solve(self, b) -> torch.Tensor:
        """x = F^{-1} b in the original ordering (parity with ``ldiv!``,
        factornode.jl:62-74); ``b`` is [N] or [N, k].  The sweeps run in the
        factor's type; x comes back in ``b``'s."""
        return solve_in_type(self.solve_data, on_device(b, self.device))

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
        ranks = self._global_max(torch.stack([
            lev.rank_maxed.max() if isinstance(lev, StructuredLevel)
            else torch.maximum(lev.lrank.max(), lev.rrank.max())
            for _, lev in comp])).cpu().tolist()
        for (i, lev), mr in zip(comp, ranks):
            cap = lev.rank_cap if isinstance(lev, StructuredLevel) \
                else lev.LU_.shape[-1]
            sat = mr >= cap
            out["levels"].append({"level": i, "max_rank": int(mr), "cap": cap,
                                  "saturated": sat})
            out["saturated"] = out["saturated"] or sat
        return out

    def _global_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the devices holding the levels (one
        here; every rank on a mesh)."""
        return t

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
        if isinstance(self.root, RootSolve):     # RootHss: no dense LU
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


def on_device(b, device: torch.device) -> torch.Tensor:
    """A right-hand side on ``device``: numpy arrays are uploaded, a tensor
    elsewhere raises."""
    if isinstance(b, torch.Tensor):
        if b.device != device:
            raise ValueError(f"right-hand side on {b.device}, factorization "
                             f"on {device}")
        return b
    return torch.as_tensor(np.asarray(b), device=device)


def solve_in_type(data, b: torch.Tensor) -> torch.Tensor:
    """:func:`solve_with_data` in the factors' type, x in ``b``'s."""
    levels, root = data[0], data[1]
    return solve_with_data(data, b.to(data_dtype(levels, root))).to(b.dtype)


def solve_with_data(data, b: torch.Tensor) -> torch.Tensor:
    """x = F^{-1} b from a :attr:`Factorization.solve_data` tuple (on a mesh
    factor's, collective)."""
    _, _, dperm, diperm = data
    return data.apply_permuted(b[dperm])[diperm]


# ---------------------------------------------------------------------------
# per-level step
# ---------------------------------------------------------------------------

def _factor_front(front: torch.Tensor, sperm: torch.Tensor, ni_pad: int,
                  explicit_inv: bool = False, fast_inverse: bool = False,
                  schur: Callable = dk.schur_complement):
    """One dense level: LU of ``D``, the Gauss transforms and
    ``schur(Abb, Abi, R)`` permuted (on a mesh ``schur`` may split the
    product's rows over the ranks of a front group)."""
    D = front[:, :ni_pad, :ni_pad]
    Aib = front[:, :ni_pad, ni_pad:]
    Abi = front[:, ni_pad:, :ni_pad]
    Abb = front[:, ni_pad:, ni_pad:]
    if fast_inverse and explicit_inv:
        dinv, ratio = dk.block_inverse(D)
        R = (dinv @ Aib).contiguous()
        L = (Abi @ dinv).contiguous()
        S = dk.permute_sym(schur(Abb, Abi, R), sperm)
        return None, None, L, R, S, dinv, ratio
    lu, perm = dk.lu_factor(D)
    # row-major copies: the solve sweeps (kernel C) stream L, R and dinv by
    # rows, and the triangular solves may return them column-major; kernel C
    # reads lu column-major, as the LU returns it
    R = dk.lu_solve(lu, perm, Aib).contiguous()
    L = dk.lu_solve_right(lu, perm, Abi).contiguous()
    S = dk.permute_sym(schur(Abb, Abi, R), sperm)
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


def schur_sources(groups, B: int):
    """A structured batch's child groups as ``(src_batch, src_rows,
    dst_rows)`` numpy triples, and the mask of the rows no group covers
    (dummy fronts, ``batch_multiple``).  Those rows read row 0 of the first
    group's source with content sizes 0, as the JAX package's masked
    selects leave them (``hsolve/factor.py:467-502``): a copy of a real
    child keeps the dummy's HSS factor finite."""
    parts = [(int(g.src_batch), np.asarray(g.src_rows, dtype=np.int64),
              np.asarray(g.dst_rows, dtype=np.int64)) for g in groups]
    assert parts, "structured batch requires child sources"
    dummy = np.ones(B, dtype=bool)
    for _, _, d in parts:
        dummy[d] = False
    if dummy.any():
        sb, src, dst = parts[0]
        extra = np.flatnonzero(dummy)
        parts[0] = (sb, np.concatenate([src, np.zeros_like(extra)]),
                    np.concatenate([dst, extra]))
    return parts, dummy


def merge_schur(parts, dummy: np.ndarray) -> SchurHss:
    """One SchurHss from ``(rows, dst_rows)`` parts that cover its rows once
    each (children may live in several source batches, all on one cluster
    plan: a planner invariant); ``dummy`` rows get content sizes 0."""
    B = len(dummy)
    if len(parts) == 1 and np.array_equal(parts[0][1], np.arange(B)):
        out = parts[0][0]
    else:
        sel = parts[0][0]
        out = SchurHss(h=sel.h.map(lambda a: a.new_zeros((B,) + a.shape[1:])),
                       n1=sel.n1.new_zeros(B), n2=sel.n2.new_zeros(B))
        for sel, dst in parts:
            dst = torch.as_tensor(dst, device=sel.n1.device)
            for a, v in zip(out.h.arrays() + [out.n1, out.n2],
                            sel.h.arrays() + [sel.n1, sel.n2]):
                a[dst] = v
    if dummy.any():
        keep = torch.as_tensor(~dummy, device=out.n1.device)
        out = SchurHss(h=out.h, n1=torch.where(keep, out.n1, 0),
                       n2=torch.where(keep, out.n2, 0))
    return out


def _gather_schur(groups, s_stacks, B: int) -> SchurHss:
    """The child SchurHss rows of a structured batch (:func:`schur_sources`,
    :func:`merge_schur`)."""
    parts, dummy = schur_sources(groups, B)
    sel = []
    for sb, src, dst in parts:
        S = s_stacks[sb]
        assert isinstance(S, SchurHss), \
            "structured batch fed by a non-HSS source (planner invariant)"
        sel.append((S.select(torch.as_tensor(src, device=S.n1.device)), dst))
    return merge_schur(sel, dummy)


def _run_structured(bp, tb, sh1: SchurHss, sh2: SchurHss, opts: SolverOptions,
                    dtype, bidx: int, sketch: Sketch, held: slice = slice(None)):
    """One structured batch (``hsolve/factor.py:876-903``): the 8 cross
    couplings as EXACT skinny pairs ``A_blk = U V^T`` (``U`` the one-hot
    selector of the nonzero rows, ``V^T`` the value strip scattered from the
    planner's COO), the sketches, then :func:`structured_factor_batch`.
    ``tb`` holds the fronts ``held`` of the batch (all of them on one
    device); the sketches are drawn for the batch's real fronts and sliced,
    so a rank's fronts see the draws of a one-device factor, and a padded
    plan's (``batch_multiple``) those of the unpadded plan."""
    dev = tb.int_ids.device
    Bl = tb.int_ids.shape[0]
    cross = {}
    for name in cross_block_shapes(bp.child_cplans):
        spec = bp.cross[name]
        r_, c_, rcap = spec["r"], spec["c"], spec["rcap"]
        rows, pos, vals = tb.cross[name]
        flat = torch.zeros(Bl * rcap * c_, dtype=dtype, device=dev)
        flat[pos] = vals.to(dtype)
        strip = flat.reshape(Bl, rcap, c_)
        U = (rows[:, None, :] == torch.arange(r_, device=dev)[None, :, None]
             ).to(dtype)                                       # [B, r, rcap]
        cross[name] = (U, strip.transpose(-1, -2).contiguous())  # V [B, c, rcap]
    # the batch's real fronts draw as an unpadded plan's do; a dummy front
    # (batch_multiple) reuses front 0's draws
    B0 = len(bp.node_ids)
    sketches = []
    for tag, plan_ in ((203, bp.child_cplans[1]), (202, bp.cplan)):
        # S22' lives on child 2's interior half: its plan is one level shallower
        n = plan_.half if tag == 203 else plan_.n_pad
        s = min(sample_width(plan_, bp.rank_cap, opts.kest,
                             max(opts.stepsize, 8)), n)
        sketches.append(tuple(
            torch.cat([o, o[:1].expand(bp.B - B0, -1, -1)])[held].to(
                device=dev, dtype=dtype)
            for o in sketch((7000 + bidx, tag), (B0, n, s), (B0, n, s))))
    return structured_factor_batch(
        sh1, sh2, cross, tb.smap, bp.cplan, tb.n1, tb.n2, tb.int_ids,
        tb.bnd_ids, opts.atol, opts.rtol, bp.rank_cap, *sketches)


def _factor_levels(plan: Plan, tp: TorchPlan, opts: SolverOptions,
                   dtype: torch.dtype, sketch: Optional[Sketch] = None):
    """Run the schedule; returns (levels, root, Schur stacks by batch)."""
    adata = tp.adata.to(dtype)
    if sketch is None:
        sketch = torch_sketch(opts.seed, tp.device, dtype)
    levels: List[Level] = []
    s_stacks: Dict[int, torch.Tensor] = {}
    for bidx, (bp, tb) in enumerate(zip(plan.batches, tp.batches)):
        if bp.structured:
            lev, S = _run_structured(
                bp, tb, _gather_schur(bp.groups_l, s_stacks, bp.B),
                _gather_schur(bp.groups_r, s_stacks, bp.B), opts, dtype, bidx,
                sketch)
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
        lev, s_stacks[bidx] = _factor_regular(bp, tb, front, opts, dtype, bidx,
                                              sketch)
        levels.append(lev)
    root = _root_from_stacks(plan, tp, s_stacks, dtype, opts)
    return levels, root, s_stacks


def _factor_regular(bp, tb, front: torch.Tensor, opts: SolverOptions, dtype,
                    bidx: int, sketch: Sketch,
                    schur: Callable = dk.schur_complement):
    """A dense or low-rank compressed batch's numeric step on its assembled
    ``front`` (the fronts ``tb`` holds); returns (level record, S), S in HSS
    form where a structured parent reads it."""
    fastinv = opts.resolve_fast_inverse()
    if not bp.compress:
        lu, perm, L, R, S, dinv, ratio = _factor_front(
            front, tb.sperm, bp.ni_pad, opts.explicit_inverse, fastinv, schur)
        return DenseLevel(lu=lu, perm=perm, L=L, R=R, int_ids=tb.int_ids,
                          bnd_ids=tb.bnd_ids, dinv=dinv, diag_ratio=ratio), S
    shapes = [(n, sketch_width(bp.rank_cap, n)) for n in (bp.ni_pad, bp.nb_pad)]
    om_bi, om_ib = (o.to(device=front.device, dtype=dtype)
                    for o in sketch(bidx, *shapes))
    (lu, perm, LU_, LV_, RU_, RV_, lrank, rrank, S, dinv,
     ratio) = _factor_front_compressed(
        front, tb.sperm, bp.ni_pad, bp.rank_cap, opts.c_tol * opts.atol,
        opts.c_tol * opts.rtol, om_bi, om_ib, opts.explicit_inverse, fastinv)
    lev = CompressedLevel(lu=lu, perm=perm, LU_=LU_, LV_=LV_, RU_=RU_, RV_=RV_,
                          lrank=lrank, rrank=rrank, int_ids=tb.int_ids,
                          bnd_ids=tb.bnd_ids, dinv=dinv, diag_ratio=ratio)
    if bp.cplan is not None and opts.hss:
        S = transition_compress(S, tb.n1, tb.n2, bp.cplan, opts.atol,
                                opts.rtol, bp.rank_cap)
    return lev, S


def _root_from_stacks(plan: Plan, tp: TorchPlan, s_stacks, dtype,
                      opts: SolverOptions) -> Optional[Root]:
    if plan.nb_root == 0:
        return None
    S_top = s_stacks[len(plan.batches) - 1]
    if isinstance(S_top, SchurHss):
        return _root_hss(plan, S_top, tp.device)
    bnd_ids = tp.batches[-1].bnd_ids[0]
    S_root = S_top[0]
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


def _root_hss(plan: Plan, S_top: SchurHss, device: torch.device) -> RootHss:
    """The HSS root solve (``hsolve/factor.py:927-943``): :func:`hss_factor`
    of the top batch's Schur complement, and the global ids of its first
    ``nb_root`` pad coordinates.  A structured top batch's ``bnd_ids`` are
    child-aligned (child 1's boundary at 0, child 2's at ``cq1``); any other
    top batch's hold the root's boundary first."""
    last = plan.batches[-1]
    nbr = plan.nb_root
    bnd0 = np.asarray(last.bnd_ids[0])
    if last.structured:
        cq1 = last.child_cplans[0].n_pad - last.child_cplans[0].half
        nb1r = int(last.cross["nb1"][0])
        s = np.arange(nbr)
        bnd0 = bnd0[np.where(s < nb1r, s, cq1 + s - nb1r)]
    else:
        bnd0 = bnd0[:nbr]
    ids = np.full(S_top.cplan.n_pad, plan.N, dtype=np.int32)
    ids[:nbr] = bnd0
    return RootHss(solver=hss_factor(S_top.h.map(lambda a: a[:1])),
                   ids_pad=torch.as_tensor(ids, device=device))


# ---------------------------------------------------------------------------
# solve sweeps
# ---------------------------------------------------------------------------

def _apply(levels: List[Level], root: Optional[Root],
           b: torch.Tensor) -> torch.Tensor:
    """Hierarchical solve (parity with ``ldiv!`` + ``_lsolve!/_dsolve!/_rsolve!``,
    factornode.jl:62-99) in the post-order permutation.

    Bottom-up: ``C[bnd] -= L C[int]`` then ``C[int] = D^{-1} C[int]``: one
    launch of kernel C on a dense level; kernel E around the pivot solve
    (:func:`d_apply` on a structured level) on a compressed or structured
    one; root boundary solve (:func:`hss_solve`, kernel K, on a
    :class:`RootHss`); top-down: ``C[int] -= R C[bnd]`` (kernel C or E).
    ``C`` carries a zero sentinel row N that padded ids point at."""
    N = b.shape[0]
    C = sweep_buffer(b)
    for lev in levels:
        forward_step(C, lev, N)
    root_step(C, root, N)
    for lev in reversed(levels):
        backward_step(C, lev, N)
    C = C[:N]
    return C[:, 0] if b.ndim == 1 else C


def sweep_buffer(b: torch.Tensor) -> torch.Tensor:
    """``b`` as ``[N + 1, k]`` with the zero sentinel row N."""
    C = b[:, None] if b.ndim == 1 else b
    return torch.cat([C, C.new_zeros((1, C.shape[1]))], dim=0)


def forward_step(C: torch.Tensor, lev: Level, N: int) -> None:
    """One level of the bottom-up sweep, in place on ``C``."""
    if isinstance(lev, DenseLevel):
        level_forward(C, lev, N)
        return
    x = C[lev.int_ids]                      # [B, ni_pad, k], before the solve
    lowrank_sweep_update(C, lev.bnd_ids, lev.LU_, lev.LV_, N, X=x)
    if isinstance(lev, StructuredLevel):
        C[lev.int_ids] = d_apply(lev, x)
        # padded ids all write the sentinel row; keep it zero
        C[N] = 0.0
    else:
        C[lev.int_ids] = pivot_solve(lev, x)


def root_step(C: torch.Tensor, root: Optional[Root], N: int) -> None:
    """The root boundary solve, in place on ``C``."""
    if isinstance(root, RootHss):
        C[root.ids_pad] = hss_solve(root.solver, C[root.ids_pad][None])[0]
        C[N] = 0.0                              # the padding wrote the sentinel
    elif root is not None:
        xr = C[root.bnd_ids]                    # [nbr, k]
        C[root.bnd_ids] = root.inv @ xr if root.inv is not None else \
            dk.lu_solve(root.lu, root.perm, xr)


def backward_step(C: torch.Tensor, lev: Level, N: int) -> None:
    """One level of the top-down sweep, in place on ``C``."""
    if isinstance(lev, DenseLevel):
        sweep_update(C, lev.int_ids, lev.R, N, ids_in=lev.bnd_ids)
    else:
        lowrank_sweep_update(C, lev.int_ids, lev.RU_, lev.RV_, N,
                             ids_in=lev.bnd_ids)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _torch_dtype(dtype, plan: Plan) -> torch.dtype:
    tdt = torch_dtype(plan.A_dtype if dtype is None else dtype)
    if not (tdt.is_floating_point or tdt.is_complex):
        raise TypeError(f"unsupported factorization dtype {tdt}")
    return tdt


def factor_with_plan(plan: Plan, opts: SolverOptions, dtype=None, *,
                     device="cuda", sketch: Optional[Sketch] = None,
                     mesh=None) -> Factorization:
    """Execute the planner's schedule on ``device`` ("cuda[:i]", the
    default, or "cpu"); a missing card raises.

    ``plan`` may come from either planner.  On a CUDA device the kernels run,
    in float64 or float32, exact, low-rank compressed (``hss=False``) and
    structured (``hss=True``, the default) levels alike; on the CPU every
    kernel runs as its plain torch version.  A complex system
    (``plan.A_dtype`` complex128, e.g. ``helmholtz2d(n, damping=0.1)``)
    factors in complex128 or complex64 on exact, low-rank and structured
    levels alike, on either device.  ``sketch`` replaces the default
    sketches of the compressed batches (see :data:`Sketch` and
    :func:`torch_sketch`).

    With ``mesh`` (:func:`hsolve_torch.parallel.dist.make_mesh`, on
    ``device``'s type) every rank factors its share of each level on its
    own device and the ranks exchange the child Schur panels between
    levels: a :class:`~hsolve_torch.parallel.sharded.ShardedFactorization`
    (the plan padded with ``batch_multiple`` = the tree axis, as
    :func:`factor` plans it, shards every level over ``tree``).  Every rank
    calls it, with the same arguments."""
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a mesh of {mesh.device_type} devices cannot factor "
                         f"on {dev}")
    tdt = _torch_dtype(dtype, plan)
    if dev.type == "cuda" and tdt not in VALUE_TYPES:
        raise NotImplementedError(f"the CUDA kernels take {VALUE_TYPES}")
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
    if mesh is not None:
        from hsolve_torch.parallel.sharded import factor_sharded

        return factor_sharded(plan, opts, tdt, mesh, sketch)
    tp = plan_to_torch(plan, dev)
    levels, root, _ = _factor_levels(plan, tp, opts, tdt, sketch)
    return Factorization(N=plan.N, perm=plan.perm, levels=levels, root=root,
                         opts=opts, plan=plan, device=dev)


def factor(A: sp.spmatrix, tree: NDTree, opts: Optional[SolverOptions] = None,
           dtype=None, *, device="cuda", sketch: Optional[Sketch] = None,
           mesh=None, **overrides) -> Factorization:
    """Top-level entry (parity with ``factor(A, nd, nd_loc, opts; args...)``,
    factorization.jl:5-11): plan, then factor on ``device`` (the card unless
    the caller asks for the CPU; see :func:`factor_with_plan`, also for the
    value types: a complex system factors in complex128 or complex64 on
    exact, low-rank and structured levels alike).

    With ``opts.adaptive`` the computed compression ranks are checked against
    the planned caps; on saturation the problem is re-planned with the largest
    saturated cap doubled as ``rank_cap`` and re-factored, at most three
    attempts in all (host-loop parity with ``randcompress_adaptive``'s sample
    budget growth, factorization.jl:110).

    Pass ``mesh`` (:func:`hsolve_torch.parallel.dist.make_mesh`) to shard
    the factorization over its ranks: the plan pads every level to a
    multiple of the tree axis, and the saturation test reads the ranks'
    largest rank, so every rank re-plans alike."""
    opts = (opts or SolverOptions()).replace(**overrides)
    opts.validate()
    dev = resolve_device(device)
    batch_multiple = mesh.size(0) if mesh is not None else 1
    for attempt in range(3):
        plan = plan_factorization(A, tree, opts, batch_multiple=batch_multiple)
        F = factor_with_plan(plan, opts, dtype=dtype, device=dev, sketch=sketch,
                             mesh=mesh)
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
