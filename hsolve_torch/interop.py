"""Carrying plans and factors across: numpy host records -> device tensors.

- :func:`plan_to_torch` uploads a :class:`Plan`'s index arrays to a device once
  (cached on the plan).  It accepts a plan from either planner: the JAX
  package's and the port's ``Plan`` have identical fields.
- :func:`factorization_from_numpy` turns a JAX ``Factorization``'s level records,
  fetched to numpy, into the port's, so the port's solve sweep can run on the
  JAX factors alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class TorchBatch:
    """One batch's device index arrays (int32 for the kernels, int64 where a
    torch gather needs it)."""

    pos: torch.Tensor        # [nnz] int32 flat front positions
    src: torch.Tensor        # [nnz] int32 source index into TorchPlan.adata
    sperm: torch.Tensor      # [B, nb_pad] int64
    int_ids: torch.Tensor    # [B, ni_pad] int32, sentinel N
    bnd_ids: torch.Tensor    # [B, nb_pad] int32, sentinel N
    map_l: Optional[torch.Tensor]   # [B, m_pad] int32, -1 = no contribution
    map_r: Optional[torch.Tensor]
    # per child group: (source batch, src_rows int32, dst_rows int32)
    groups_l: Tuple[Tuple[int, torch.Tensor, torch.Tensor], ...]
    groups_r: Tuple[Tuple[int, torch.Tensor, torch.Tensor], ...]


@dataclasses.dataclass
class TorchPlan:
    device: torch.device
    adata: torch.Tensor      # value source of every batch's front entries
    batches: List[TorchBatch]


def _i32(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)


def plan_to_torch(plan, device) -> TorchPlan:
    """Upload ``plan``'s index arrays to ``device`` once; later calls return the
    cached copy.  The matrix values come along as one device array
    (``A_perm.data``) that the fronts gather from through ``front_src``; a batch
    planned without ``front_src`` (no native planner) gathers from its own
    ``front_vals`` appended to that array instead."""
    device = torch.device(device)
    cache = plan.__dict__.setdefault("_torch_cache", {})
    if str(device) in cache:
        return cache[str(device)]
    adata = [np.asarray(plan.A_raw[2])]
    off = len(adata[0])
    srcs = []
    for bp in plan.batches:
        if bp.front_src is not None:
            srcs.append(bp.front_src)
        else:
            n = len(bp.front_vals)
            srcs.append(np.arange(off, off + n))
            adata.append(np.asarray(bp.front_vals, dtype=adata[0].dtype))
            off += n
    batches = []
    for bp, src in zip(plan.batches, srcs):
        def groups(gs):
            return tuple((int(g.src_batch), _i32(g.src_rows, device),
                          _i32(g.dst_rows, device)) for g in gs)

        batches.append(TorchBatch(
            pos=_i32(bp.front_pos, device), src=_i32(src, device),
            sperm=torch.as_tensor(bp.sperm, dtype=torch.int64, device=device),
            int_ids=_i32(bp.int_ids, device), bnd_ids=_i32(bp.bnd_ids, device),
            map_l=None if bp.map_l is None else _i32(bp.map_l, device),
            map_r=None if bp.map_r is None else _i32(bp.map_r, device),
            groups_l=groups(bp.groups_l), groups_r=groups(bp.groups_r)))
    tp = TorchPlan(device=device,
                   adata=torch.as_tensor(np.concatenate(adata), device=device),
                   batches=batches)
    cache[str(device)] = tp
    return tp


def _field(rec: Any, name: str) -> Optional[np.ndarray]:
    v = rec.get(name) if isinstance(rec, Mapping) else getattr(rec, name, None)
    return None if v is None else np.array(v)     # a writable host copy


def factorization_from_numpy(levels_np: Sequence[Any], root_np: Optional[Any],
                             perm: np.ndarray, device, opts=None):
    """Build a port :class:`~hsolve_torch.factor.Factorization` from level
    records fetched to numpy.

    ``levels_np``: one record per level, a mapping or an object with the fields
    ``lu, perm, L, R, dinv, int_ids, bnd_ids`` (None where absent);
    ``root_np``: None or a record with ``lu, perm, bnd_ids, inv``; ``perm``: the
    plan's post-order permutation."""
    from hsolve_torch.factor import DenseLevel, Factorization, RootSolve
    from hsolve_torch.options import SolverOptions

    device = torch.device(device)

    def t(a, dtype=None):
        return None if a is None else torch.as_tensor(a, dtype=dtype,
                                                      device=device)

    levels = []
    for rec in levels_np:
        levels.append(DenseLevel(
            lu=t(_field(rec, "lu")), perm=t(_field(rec, "perm"), torch.int64),
            L=t(_field(rec, "L")), R=t(_field(rec, "R")),
            int_ids=t(_field(rec, "int_ids"), torch.int32),
            bnd_ids=t(_field(rec, "bnd_ids"), torch.int32),
            dinv=t(_field(rec, "dinv"))))
    root = None
    if root_np is not None:
        root = RootSolve(lu=t(_field(root_np, "lu")),
                         perm=t(_field(root_np, "perm"), torch.int64),
                         bnd_ids=t(_field(root_np, "bnd_ids"), torch.int32),
                         inv=t(_field(root_np, "inv")))
    return Factorization(N=len(perm), perm=np.asarray(perm), levels=levels,
                         root=root, opts=opts or SolverOptions(), plan=None,
                         device=device)
