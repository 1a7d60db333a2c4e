"""Carrying plans and factors across: numpy host records -> device tensors.

- :func:`plan_to_torch` uploads a :class:`Plan`'s index arrays to a device once
  (cached on the plan).  It accepts a plan from either planner: the JAX
  package's and the port's ``Plan`` have identical fields.
- :func:`factorization_from_numpy` turns a JAX ``Factorization``'s level records
  (dense, low-rank compressed and structured HSS) and root (``RootSolve`` or
  ``RootHss``), fetched to numpy, into the port's, so the port's solve sweep
  can run on the JAX factors alone.  The port's checkpoints
  (:mod:`hsolve_torch.utils.checkpoint`) hold the same records as tensors
  and load through it too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from hsolve_torch.kernels import resolve_device


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
    # HSS output (a compressed batch with a cluster plan): content sizes [B]
    n1: Optional[torch.Tensor] = None     # int64
    n2: Optional[torch.Tensor] = None     # int64
    # structured batches: parent-S pad -> child-aligned boundary map and the
    # 8 cross strips, name -> (rows [B, rcap] int64, pos int64, vals float64)
    smap: Optional[torch.Tensor] = None   # [B, cplan.n_pad] int64
    cross: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]]] = None
    # per child group: the most valid map entries (in [0, s_pad)) of one of
    # its fronts, which sizes kernel B's grid (ops/assembly.py valid_rows)
    rows_l: Tuple[int, ...] = ()
    rows_r: Tuple[int, ...] = ()


@dataclasses.dataclass
class TorchPlan:
    device: torch.device
    adata: torch.Tensor      # value source of every batch's front entries
    batches: List[TorchBatch]


def _i32(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)


def plan_to_torch(plan, device="cuda") -> TorchPlan:
    """Upload ``plan``'s index arrays to ``device`` once; later calls return the
    cached copy.  The matrix values come along as one device array
    (``A_perm.data``) that the fronts gather from through ``front_src``; a batch
    planned without ``front_src`` (no native planner) gathers from its own
    ``front_vals`` appended to that array instead."""
    device = resolve_device(device)
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

        def rows(gs, imap, s_pad):
            if imap is None:            # a structured batch: no extend-add
                return (0,) * len(gs)
            out = []
            for g in gs:
                m_ = np.asarray(imap)[np.asarray(g.dst_rows)]
                out.append(int(((m_ >= 0) & (m_ < s_pad)).sum(1).max())
                           if len(m_) else 0)
            return tuple(out)

        def i64(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a, dtype=np.int64), device=device)

        cross = None
        if bp.structured:
            cross = {name: (i64(spec["rows"]), i64(spec["pos"]),
                            torch.as_tensor(np.asarray(spec["vals"]),
                                            device=device))
                     for name, spec in bp.cross.items()
                     if isinstance(spec, dict)}
        batches.append(TorchBatch(
            pos=_i32(bp.front_pos, device), src=_i32(src, device),
            sperm=torch.as_tensor(bp.sperm, dtype=torch.int64, device=device),
            int_ids=_i32(bp.int_ids, device), bnd_ids=_i32(bp.bnd_ids, device),
            map_l=None if bp.map_l is None else _i32(bp.map_l, device),
            map_r=None if bp.map_r is None else _i32(bp.map_r, device),
            groups_l=groups(bp.groups_l), groups_r=groups(bp.groups_r),
            rows_l=rows(bp.groups_l, bp.map_l, bp.sl_pad),
            rows_r=rows(bp.groups_r, bp.map_r, bp.sr_pad),
            n1=i64(bp.n1) if bp.cplan is not None else None,
            n2=i64(bp.n2) if bp.cplan is not None else None,
            smap=i64(bp.smap) if bp.structured else None, cross=cross))
    tp = TorchPlan(device=device,
                   adata=torch.as_tensor(np.concatenate(adata), device=device),
                   batches=batches)
    cache[str(device)] = tp
    return tp


def _field(rec: Any, name: str) -> Any:
    """A record's field, None where it has none."""
    return rec.get(name) if isinstance(rec, Mapping) else getattr(rec, name, None)


def _get(rec: Any, name: str) -> Any:
    return rec.get(name) if isinstance(rec, Mapping) else getattr(rec, name)


def _host(a: Any) -> Any:
    """A tensor as it is; any other array (numpy, JAX) as a writable host
    copy."""
    return a if a is None or isinstance(a, torch.Tensor) else np.array(a)


def _hss_from_numpy(rec: Any, t):
    """A batched HSS record (fields ``D, U, V, Rs, Ws, B12s, B21s, plan``,
    the plan an object or a mapping of its four ints)."""
    from hsolve_torch.ops.hss import ClusterPlan, Hss

    p = _get(rec, "plan")
    plan = ClusterPlan(**{f: int(_get(p, f)) for f in ("ls", "depth", "n1", "n2")})
    lists = {f: [t(_host(a)) for a in _get(rec, f)]
             for f in ("Rs", "Ws", "B12s", "B21s")}
    return Hss(D=t(_host(_get(rec, "D"))), U=t(_host(_get(rec, "U"))),
               V=t(_host(_get(rec, "V"))), plan=plan, **lists)


def _solver_from_numpy(rec: Any, t):
    """A batched HSS solver record (``h, D_lu, D_piv, Phis, cores_lu, ...``);
    pivots become int64, the port's LU permutation type."""
    from hsolve_torch.ops.hss import HssSolver

    def arr(name, dtype=None):
        return t(_host(_get(rec, name)), dtype)

    def lst(name, dtype=None):
        return [t(_host(a), dtype) for a in _get(rec, name)]

    return HssSolver(h=_hss_from_numpy(_get(rec, "h"), t), D_lu=arr("D_lu"),
                     D_piv=arr("D_piv", torch.int64), Phis=lst("Phis"),
                     cores_lu=lst("cores_lu"),
                     cores_piv=lst("cores_piv", torch.int64),
                     PhisT=lst("PhisT"), coresT_lu=lst("coresT_lu"),
                     coresT_piv=lst("coresT_piv", torch.int64))


def factorization_from_numpy(levels_np: Sequence[Any], root_np: Optional[Any],
                             perm: np.ndarray, device, opts=None):
    """Build a port :class:`~hsolve_torch.factor.Factorization` from level
    records fetched to numpy.

    ``levels_np``: one record per level, a mapping or an object with the fields
    ``lu, perm, L, R, dinv, int_ids, bnd_ids`` (None where absent), or, for a
    compressed level, ``LU_, LV_, RU_, RV_, lrank, rrank`` in place of
    ``L, R``, or, for a structured level, the fields of
    :class:`~hsolve_torch.structured.StructuredLevel` (HSS records nested as
    the JAX package nests them); ``root_np``: None, a record with ``lu, perm,
    bnd_ids, inv``, or a ``RootHss`` record ``solver, ids_pad`` (the JAX
    package's solver unbatched: it gains a batch axis of 1); ``perm``: the
    plan's post-order permutation.  Arrays may be numpy, JAX or torch
    arrays; a tensor already on ``device`` in its type is taken as it is."""
    from hsolve_torch.factor import (CompressedLevel, DenseLevel, Factorization,
                                     RootHss, RootSolve)
    from hsolve_torch.options import SolverOptions
    from hsolve_torch.structured import StructuredLevel

    device = torch.device(device)

    def t(a, dtype=None):
        return None if a is None else torch.as_tensor(_host(a), dtype=dtype,
                                                      device=device)

    levels = []
    for rec in levels_np:
        if _field(rec, "WU") is not None:
            mx = _field(rec, "rank_maxed")
            levels.append(StructuredLevel(
                solver1=_solver_from_numpy(_get(rec, "solver1"), t),
                solver22=_solver_from_numpy(_get(rec, "solver22"), t),
                H2=_hss_from_numpy(_get(rec, "H2"), t),
                **{f: t(_field(rec, f)) for f in
                   ("WU", "V12", "U21", "V21", "LU_", "LV_", "RU_", "RV_")},
                int_ids=t(_field(rec, "int_ids"), torch.int32),
                bnd_ids=t(_field(rec, "bnd_ids"), torch.int32),
                h1=int(_get(rec, "h1")), h2=int(_get(rec, "h2")),
                rank_maxed=t(mx, torch.int32),
                rank_cap=int(_get(rec, "rank_cap"))))
            continue
        common = dict(
            lu=t(_field(rec, "lu")), perm=t(_field(rec, "perm"), torch.int64),
            int_ids=t(_field(rec, "int_ids"), torch.int32),
            bnd_ids=t(_field(rec, "bnd_ids"), torch.int32),
            dinv=t(_field(rec, "dinv")), diag_ratio=t(_field(rec, "diag_ratio")))
        if _field(rec, "LU_") is not None:
            levels.append(CompressedLevel(
                **common, **{f: t(_field(rec, f)) for f in
                             ("LU_", "LV_", "RU_", "RV_")},
                lrank=t(_field(rec, "lrank"), torch.int32),
                rrank=t(_field(rec, "rrank"), torch.int32)))
        else:
            lu = common.pop("lu")
            # kernel C reads lu column-major, as the port's LU stores it
            levels.append(DenseLevel(
                **common, lu=None if lu is None else lu.mT.contiguous().mT,
                L=t(_field(rec, "L")), R=t(_field(rec, "R"))))
    root = None
    if root_np is not None and _field(root_np, "solver") is not None:
        rs = _get(root_np, "solver")
        # the JAX package's root solver is unbatched: leaves [nleaves, ls, ls]
        t1 = t if _get(_get(rs, "h"), "D").ndim == 4 else \
            (lambda a, dtype=None: t(a[None], dtype))
        root = RootHss(solver=_solver_from_numpy(rs, t1),
                       ids_pad=t(_field(root_np, "ids_pad"), torch.int32))
    elif root_np is not None:
        root = RootSolve(lu=t(_field(root_np, "lu")),
                         perm=t(_field(root_np, "perm"), torch.int64),
                         bnd_ids=t(_field(root_np, "bnd_ids"), torch.int32),
                         inv=t(_field(root_np, "inv")),
                         diag_ratio=t(_field(root_np, "diag_ratio")))
    return Factorization(N=len(perm), perm=np.asarray(perm), levels=levels,
                         root=root, opts=opts or SolverOptions(), plan=None,
                         device=device)
