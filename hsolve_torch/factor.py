"""Numeric factorization: level-synchronous batched multifrontal elimination
(port of the exact path of ``hsolve/factor.py``).

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
(:func:`solve_with_data`) sweeps the levels with kernel C
(:func:`~hsolve_torch.ops.sweep.sweep_update`) around the pivot solves.

Float32 products never use TF32 here: ``factor_with_plan`` sets
``torch.backends.cuda.matmul.allow_tf32 = False`` explicitly (float64, the
slice's type, is unaffected either way).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from hsolve_torch.interop import TorchPlan, plan_to_torch
from hsolve_torch.ops import dense as dk
from hsolve_torch.ops.assembly import extend_add, front_assemble
from hsolve_torch.ops.sweep import sweep_update
from hsolve_torch.options import SolverOptions
from hsolve_torch.planner import Plan, plan_factorization
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
class RootSolve:
    lu: Optional[torch.Tensor]    # [nbr, nbr]
    perm: Optional[torch.Tensor]  # [nbr]
    bnd_ids: torch.Tensor         # [nbr] int32, sentinel-padded
    inv: Optional[torch.Tensor] = None   # [nbr, nbr] explicit inverse
    diag_ratio: Optional[torch.Tensor] = None


def resolve_device(device) -> torch.device:
    """The explicit device of a factorization; asking for a CUDA device that
    is not there raises (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={str(device)!r} requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass
class Factorization:
    """The assembled preconditioner / direct solver (reference ``FactorNode``).

    ``solve`` applies the inverse in the original DOF ordering;
    ``apply_permuted`` works in the planner's post-order permutation.  Inputs
    must be tensors on the factorization's device (numpy arrays are uploaded
    to it); results stay there."""

    N: int
    perm: np.ndarray
    levels: List[DenseLevel]
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

    def _on_device(self, b) -> torch.Tensor:
        if isinstance(b, torch.Tensor):
            if b.device != self.device:
                raise ValueError(f"right-hand side on {b.device}, factorization "
                                 f"on {self.device}")
            return b
        return torch.as_tensor(np.asarray(b), device=self.device)

    def apply_permuted(self, b) -> torch.Tensor:
        return _apply(self.levels, self.root, self._on_device(b))

    def solve(self, b) -> torch.Tensor:
        """x = F^{-1} b in the original ordering (parity with ``ldiv!``,
        factornode.jl:62-74); ``b`` is [N] or [N, k]."""
        return solve_with_data(self.solve_data, self._on_device(b))

    @property
    def solve_data(self):
        """Everything ``solve`` needs, for :func:`solve_with_data` (the
        preconditioner data of :func:`~hsolve_torch.krylov.gmres_compiled`)."""
        return (self.levels, self.root, self._dperm, self._diperm)

    def _cond_device(self):
        """Per-level pivot diag ratios as device scalars + (tag, eps) labels."""
        ratios, tags = [], []
        for i, lev in enumerate(self.levels):
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
    # row-major copies: the solve sweeps (kernel C) stream L and R by rows,
    # and the triangular solves may return them column-major
    R = dk.lu_solve(lu, perm, Aib).contiguous()
    L = dk.lu_solve_right(lu, perm, Abi).contiguous()
    S = dk.permute_sym(dk.schur_complement(Abb, Abi, R), sperm)
    if explicit_inv:
        # the solve sweeps use only dinv: the level keeps no lu/perm
        return None, None, L, R, S, dk.lu_inverse(lu, perm), dk._diag_ratio(lu)
    return lu, perm, L, R, S, None, None


def _factor_levels(plan: Plan, tp: TorchPlan, opts: SolverOptions,
                   dtype: torch.dtype):
    """Run the schedule; returns (levels, root, Schur stacks by batch)."""
    adata = tp.adata.to(dtype)
    fastinv = opts.resolve_fast_inverse()
    levels: List[DenseLevel] = []
    s_stacks: Dict[int, torch.Tensor] = {}
    for bidx, (bp, tb) in enumerate(zip(plan.batches, tp.batches)):
        if bp.compress or bp.structured:
            raise NotImplementedError(
                f"batch {bidx} is compressed; compressed batches belong to the "
                "port's low-rank slice")
        front = front_assemble(bp.B, bp.m_pad, tb.pos, tb.src, adata)
        # left groups before right ones, the JAX package's order
        for groups, imap in ((tb.groups_l, tb.map_l), (tb.groups_r, tb.map_r)):
            for src_batch, src_rows, dst_rows in groups:
                extend_add(front, s_stacks[src_batch], src_rows, dst_rows, imap)
        lu, perm, L, R, S, dinv, ratio = _factor_front(
            front, tb.sperm, bp.ni_pad, opts.explicit_inverse, fastinv)
        levels.append(DenseLevel(lu=lu, perm=perm, L=L, R=R, int_ids=tb.int_ids,
                                 bnd_ids=tb.bnd_ids, dinv=dinv,
                                 diag_ratio=ratio))
        s_stacks[bidx] = S
    root = _root_from_stacks(plan, tp, s_stacks, dtype, opts)
    return levels, root, s_stacks


def _root_from_stacks(plan: Plan, tp: TorchPlan, s_stacks, dtype,
                      opts: SolverOptions) -> Optional[RootSolve]:
    if plan.nb_root == 0:
        return None
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

def _pivot_solve(lev, x: torch.Tensor) -> torch.Tensor:
    if lev.dinv is not None:
        return lev.dinv @ x
    return dk.lu_solve(lev.lu, lev.perm, x)


def _apply(levels: List[DenseLevel], root: Optional[RootSolve],
           b: torch.Tensor) -> torch.Tensor:
    """Hierarchical solve (parity with ``ldiv!`` + ``_lsolve!/_dsolve!/_rsolve!``,
    factornode.jl:62-99) in the post-order permutation.

    Bottom-up: ``C[bnd] -= L C[int]`` (kernel C) then ``C[int] = D^{-1} C[int]``;
    root boundary solve; top-down: ``C[int] -= R C[bnd]`` (kernel C).  ``C``
    carries a zero sentinel row N that padded ids point at."""
    N = b.shape[0]
    vec = b.ndim == 1
    C = b[:, None] if vec else b
    C = torch.cat([C, C.new_zeros((1, C.shape[1]))], dim=0)

    for lev in levels:
        x = C[lev.int_ids]                      # [B, ni_pad, k], before the solve
        sweep_update(C, lev.bnd_ids, lev.L, N, X=x)
        C[lev.int_ids] = _pivot_solve(lev, x)

    if root is not None:
        xr = C[root.bnd_ids]                    # [nbr, k]
        C[root.bnd_ids] = root.inv @ xr if root.inv is not None else \
            dk.lu_solve(root.lu, root.perm, xr)

    for lev in reversed(levels):
        sweep_update(C, lev.int_ids, lev.R, N, ids_in=lev.bnd_ids)

    C = C[:N]
    return C[:, 0] if vec else C


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _torch_dtype(dtype, plan: Plan) -> torch.dtype:
    if dtype is None:
        dtype = plan.A_dtype
    if isinstance(dtype, torch.dtype):
        tdt = dtype
    else:
        tdt = torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype
    if tdt.is_complex:
        raise NotImplementedError("complex dtypes are a later slice of the port")
    if not tdt.is_floating_point:
        raise TypeError(f"unsupported factorization dtype {tdt}")
    return tdt


def factor_with_plan(plan: Plan, opts: SolverOptions, dtype=None, *,
                     device) -> Factorization:
    """Execute the planner's schedule on ``device`` ("cpu" or "cuda[:i]").

    ``plan`` may come from either planner.  On a CUDA device the four kernels
    run and the dtype must be float64; on the CPU every kernel runs as its plain
    torch version."""
    dev = resolve_device(device)
    tdt = _torch_dtype(dtype, plan)
    if dev.type == "cuda" and tdt != torch.float64:
        raise NotImplementedError("the CUDA kernels take float64 only")
    torch.backends.cuda.matmul.allow_tf32 = False
    opts = opts.replace(explicit_inverse=opts.resolve_explicit_inverse())
    if opts.verbose:
        from hsolve_torch.utils.logging import logger, verbose_level

        with verbose_level(True):
            for i, bp in enumerate(plan.batches):
                logger.info("batch %d: B=%d ni_pad=%d nb_pad=%d %snnz=%d", i,
                            bp.B, bp.ni_pad, bp.nb_pad,
                            "leaf " if bp.is_leaf else "", len(bp.front_pos))
    tp = plan_to_torch(plan, dev)
    levels, root, _ = _factor_levels(plan, tp, opts, tdt)
    return Factorization(N=plan.N, perm=plan.perm, levels=levels, root=root,
                         opts=opts, plan=plan, device=dev)


def factor(A: sp.spmatrix, tree: NDTree, opts: Optional[SolverOptions] = None,
           dtype=None, *, device, **overrides) -> Factorization:
    """Top-level entry (parity with ``factor(A, nd, nd_loc, opts; args...)``,
    factorization.jl:5-11): plan, then factor on ``device``."""
    opts = (opts or SolverOptions()).replace(**overrides)
    opts.validate()
    dev = resolve_device(device)
    plan = plan_factorization(A, tree, opts)
    return factor_with_plan(plan, opts, dtype=dtype, device=dev)
