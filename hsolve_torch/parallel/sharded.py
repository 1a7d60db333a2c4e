"""The factorization and its solve on a device mesh: the port of
``factor(..., mesh=)`` (``hsolve/factor.py:577-612``, ``:797-810``,
``:842-874``, ``:1036-1052``).

Each rank runs the schedule on its share of every level
(:func:`~hsolve_torch.parallel.dist.shard_batch_spec`):

- a level split over the ``tree`` axis: the rank assembles (kernel A),
  extend-adds (kernel B, its child panels fetched by
  :func:`~hsolve_torch.parallel.exchange.fetch_rows`) and factors only its
  block of fronts; low-rank levels draw the factorization's sketches whole
  on the host and structured levels slice theirs to the block, so a rank's
  fronts see the draws of a one-device factor of the same padded plan;
  ``transition_compress`` stays per rank;
- a level the tree axis cannot divide is held whole by every rank; on an
  exact level the ranks of a ``front`` group split the Schur product's rows
  and all-gather ``S``, the LU and the Gauss transforms run replicated;
- the root (a batch of one) is replicated: every rank builds the same dense
  or :class:`~hsolve_torch.factor.RootHss` root from the top Schur stack's
  row 0, broadcast by its owner.

The solve keeps its vectors replicated.  A tree-split level's ranks sweep
their fronts (kernel C, or E around ``d_apply``), then sum the level's
update over the ranks on the rows it touches: its boundary rows on the way
up, its interior rows (written by their one owner) on the way down.  The
bytes each level moves, factor and solve, are counted on the factorization.
Its solve data (:class:`MeshSolveData`) carries the sums, so
``solve_with_data``, :func:`~hsolve_torch.krylov.gmres_compiled` (one CUDA
graph a rank over NCCL, the host program over gloo on the CPU) and
``save_solver`` (gathered to rank 0) take a mesh factor as they take a
one-device one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from hsolve_torch.factor import (Factorization, Level, SchurHss, Sketch,
                                 SolveData, _factor_regular, _root_from_stacks,
                                 _run_structured, backward_step, forward_step,
                                 merge_schur, root_step,
                                 schur_sources, sweep_buffer, torch_sketch)
from hsolve_torch.interop import TorchBatch, TorchPlan
from hsolve_torch.ops import dense as dk
from hsolve_torch.ops.assembly import extend_add, front_assemble
from hsolve_torch.ops.hss import Hss
from hsolve_torch.parallel.dist import BatchSpec, MeshInfo, shard_batch_spec
from hsolve_torch.parallel.exchange import (broadcast_row0, crossings,
                                            fetch_rows, gather_front_rows)
from hsolve_torch.structured import densify_schur


def local_batch(bp, tb: TorchBatch, spec: BatchSpec) -> TorchBatch:
    """A batch's device index arrays cut to the fronts ``spec`` holds."""
    if spec.kind != "tree":
        return tb
    lo, hi = spec.lo, spec.hi
    mm = bp.m_pad * bp.m_pad
    sel = (tb.pos >= lo * mm) & (tb.pos < hi * mm)

    def rows(a):
        return None if a is None else a[lo:hi]

    def counts(groups, imap, s_pad):
        out = []
        for g in groups:
            d = np.asarray(g.dst_rows)
            m_ = np.asarray(imap)[d[(d >= lo) & (d < hi)]]
            out.append(int(((m_ >= 0) & (m_ < s_pad)).sum(1).max())
                       if len(m_) else 0)
        return tuple(out)

    cross = None
    if tb.cross is not None:
        cross = {}
        for name, (r_, pos, vals) in tb.cross.items():
            blk = bp.cross[name]["rcap"] * bp.cross[name]["c"]
            keep = (pos >= lo * blk) & (pos < hi * blk)
            cross[name] = (r_[lo:hi], pos[keep] - lo * blk, vals[keep])
    return TorchBatch(
        pos=tb.pos[sel] - lo * mm, src=tb.src[sel], sperm=rows(tb.sperm),
        int_ids=rows(tb.int_ids), bnd_ids=rows(tb.bnd_ids),
        map_l=rows(tb.map_l), map_r=rows(tb.map_r), groups_l=(), groups_r=(),
        n1=rows(tb.n1), n2=rows(tb.n2), smap=rows(tb.smap), cross=cross,
        rows_l=counts(bp.groups_l, bp.map_l, bp.sl_pad) if bp.map_l is not None
        else (),
        rows_r=counts(bp.groups_r, bp.map_r, bp.sr_pad) if bp.map_r is not None
        else ())


def _hss_like(h: Hss, arrays: List[torch.Tensor]) -> Hss:
    """An :class:`Hss` on ``h``'s plan from arrays in ``h.arrays()`` order."""
    n = len(h.Rs)
    rest = arrays[3:]
    return Hss(D=arrays[0], U=arrays[1], V=arrays[2], Rs=rest[:n],
               Ws=rest[n:2 * n], B12s=rest[2 * n:3 * n],
               B21s=rest[3 * n:4 * n], plan=h.plan)


def _as_schur(S, rows: List[torch.Tensor], tb: TorchBatch, src: np.ndarray):
    """Fetched rows of a Schur stack: a dense stack, or a SchurHss with the
    source batch's content sizes of rows ``src``."""
    if not isinstance(S, SchurHss):
        return rows[0]
    idx = torch.as_tensor(src, device=tb.n1.device)
    return SchurHss(h=_hss_like(S.h, rows), n1=tb.n1[idx], n2=tb.n2[idx])


def _arrays(S) -> List[torch.Tensor]:
    return S.h.arrays() if isinstance(S, SchurHss) else [S]


def _row_bytes(S) -> int:
    """The bytes of one row of a Schur stack (every array of a SchurHss)."""
    arrays = _arrays(S)
    return sum(a[0].numel() for a in arrays) * arrays[0].element_size()


@dataclasses.dataclass
class LevelSync:
    """A tree-split level's part of the solve's exchange: the rows it
    touches (global ids) and what this rank adds to their sums."""

    int_rows: torch.Tensor   # [ni] int64, the level's interior rows
    own: torch.Tensor        # [ni, 1] 1 where this rank writes the row, else 0
    bnd_rows: torch.Tensor   # [nb] int64, the level's boundary rows (unique)
    weight: float            # 1 on front coordinate 0, else 0 (replicas add nothing)

    def nbytes(self, itemsize: int) -> int:
        """The payload of one application's two sums, per right-hand side."""
        return (len(self.int_rows) + len(self.bnd_rows)) * itemsize


def _level_sync(bp, N: int, spec: BatchSpec, info: MeshInfo,
                dtype: torch.dtype) -> Optional[LevelSync]:
    if spec.kind != "tree":
        return None                      # every rank sweeps the whole level
    ids = np.asarray(bp.int_ids, dtype=np.int64)
    node = np.repeat(np.arange(bp.B), ids.shape[1])
    flat = ids.ravel()
    keep = flat != N
    own = (node[keep] >= spec.lo) & (node[keep] < spec.hi) & (info.f == 0)
    bnd = np.asarray(bp.bnd_ids, dtype=np.int64)
    dev = info.device
    return LevelSync(
        int_rows=torch.as_tensor(flat[keep], device=dev),
        own=torch.as_tensor(own, dtype=dtype, device=dev)[:, None],
        bnd_rows=torch.as_tensor(np.unique(bnd[bnd != N]), device=dev),
        weight=1.0 if info.f == 0 else 0.0)


def factor_levels_sharded(plan, tp: TorchPlan, opts, dtype: torch.dtype,
                          info: MeshInfo, sketch: Optional[Sketch] = None):
    """Run the schedule on this rank's share of every level; returns
    ``(levels, root, specs, moved, waited, dummies)``: the records of the
    fronts this rank holds, the replicated root, every level's
    :class:`BatchSpec`, the bytes the mesh moved for each batch (the root's
    broadcast last), the seconds this rank spent in those exchanges (host
    clock: a collective returns when its data is here), and per batch the
    part of its bytes that copied a source row into a dummy front
    (``batch_multiple``'s padding of a structured batch, whose rows read
    row 0 of a child group's source)."""
    adata = tp.adata.to(dtype)
    if sketch is None:
        sketch = torch_sketch(opts.seed, tp.device, dtype)
    levels: List[Level] = []
    specs: List[BatchSpec] = []
    stacks: Dict[int, object] = {}
    moved: List[int] = []
    waited: List[float] = []
    dummies: List[int] = []
    for bidx, (bp, tb) in enumerate(zip(plan.batches, tp.batches)):
        spec = shard_batch_spec(info.mesh, bp.B, 3)
        held = slice(spec.lo, spec.hi)
        tl = local_batch(bp, tb, spec)
        nbytes, secs, dummy_bytes = [0], [0.0], 0

        def fetch(src_batch, src, dst):
            t0 = time.perf_counter()
            rows, mine, nb = fetch_rows(info, _arrays(stacks[src_batch]),
                                        specs[src_batch], src, spec, dst)
            secs[0] += time.perf_counter() - t0
            nbytes[0] += nb
            return (_as_schur(stacks[src_batch], rows, tp.batches[src_batch],
                              np.asarray(src)[mine]),
                    np.asarray(dst)[mine] - spec.lo)

        if bp.structured:
            sh = []
            for groups in (bp.groups_l, bp.groups_r):
                parts, dummy = schur_sources(groups, bp.B)
                for sb, src, dst in parts:
                    d = dummy[dst]
                    dummy_bytes += crossings(info, specs[sb], src[d], spec,
                                             dst[d]) * _row_bytes(stacks[sb])
                sh.append(merge_schur([fetch(*p) for p in parts], dummy[held]))
            lev, S = _run_structured(bp, tl, sh[0], sh[1], opts, dtype, bidx,
                                     sketch, held)
        else:
            front = front_assemble(tl.int_ids.shape[0], bp.m_pad, tl.pos,
                                   tl.src, adata)
            for groups, counts, imap, s_pad in (
                    (bp.groups_l, tl.rows_l, tl.map_l, bp.sl_pad),
                    (bp.groups_r, tl.rows_r, tl.map_r, bp.sr_pad)):
                for g, rows in zip(groups, counts, strict=True):
                    stage, dst = fetch(g.src_batch, g.src_rows, g.dst_rows)
                    if not len(dst):             # none of this rank's fronts
                        continue
                    if isinstance(stage, SchurHss):
                        stage = densify_schur(stage, s_pad)
                    extend_add(front, stage,
                               torch.arange(len(dst), dtype=torch.int32,
                                            device=front.device),
                               torch.as_tensor(dst, dtype=torch.int32,
                                               device=front.device),
                               imap, rows)
            schur = dk.schur_complement
            if spec.kind == "front" and not bp.compress:
                def schur(Abb, Abi, R):
                    rows = spec.rows(Abb.shape[1])
                    part = Abb[:, rows] - Abi[:, rows] @ R
                    t0 = time.perf_counter()
                    S, nb = gather_front_rows(info, part, Abb.shape[1])
                    secs[0] += time.perf_counter() - t0
                    nbytes[0] += nb
                    return S
            lev, S = _factor_regular(bp, tl, front, opts, dtype, bidx, sketch,
                                     schur)
        levels.append(lev)
        specs.append(spec)
        stacks[bidx] = S
        moved.append(nbytes[0])
        waited.append(secs[0])
        dummies.append(dummy_bytes)
    root = None
    if plan.nb_root:
        last = len(plan.batches) - 1
        t0 = time.perf_counter()
        rows, nb = broadcast_row0(info, _arrays(stacks[last]), specs[last])
        waited.append(time.perf_counter() - t0)
        top = _as_schur(stacks[last], rows, tp.batches[last], np.zeros(1, int))
        root = _root_from_stacks(plan, tp, {last: top}, dtype, opts)
        moved.append(nb)
        dummies.append(0)
    return levels, root, specs, moved, waited, dummies


def apply_sharded(levels, root, syncs: List[Optional[LevelSync]],
                  b: torch.Tensor) -> torch.Tensor:
    """The hierarchical solve on replicated vectors (see the module
    docstring); collective, the same ``x`` on every rank."""
    N = b.shape[0]
    C = sweep_buffer(b)
    for lev, sy in zip(levels, syncs):
        if sy is None:
            forward_step(C, lev, N)
            continue
        before = C[sy.bnd_rows]
        C[sy.bnd_rows] = 0.0
        forward_step(C, lev, N)
        upd = C[sy.bnd_rows] * sy.weight
        dist.all_reduce(upd)
        C[sy.bnd_rows] = before + upd
    root_step(C, root, N)
    for lev, sy in zip(reversed(levels), reversed(syncs)):
        backward_step(C, lev, N)
        if sy is not None:
            x = C[sy.int_rows] * sy.own
            dist.all_reduce(x)
            C[sy.int_rows] = x
    C = C[:N]
    return C[:, 0] if b.ndim == 1 else C


class MeshSolveData(SolveData):
    """A mesh factor's solve data: ``(levels, root, dperm, diperm)`` of this
    rank's fronts, with the tree-split levels' :class:`LevelSync` s (their
    row indices and owner masks on the device) and the mesh whose ranks
    they sum over.  :meth:`apply_permuted` is :func:`apply_sharded`: collective,
    and capturable into a CUDA graph over NCCL (no host read, no
    host-to-device copy, the sums on the current stream), so
    ``gmres_compiled`` takes it as any solve data; gloo's collectives on
    CUDA tensors stage through the host and do not capture.  Its hooks
    (:meth:`consensus`, :meth:`check_replicated`, :meth:`prepare_graph`,
    :meth:`gathered`) are collective."""

    def __new__(cls, data, syncs: List[Optional[LevelSync]], info: MeshInfo,
                specs: List[BatchSpec]):
        self = super().__new__(cls, data)
        self.syncs, self.info, self.specs = syncs, info, specs
        return self

    def apply_permuted(self, b: torch.Tensor) -> torch.Tensor:
        return apply_sharded(self[0], self[1], self.syncs, b)

    @property
    def backend(self) -> str:
        """The process group's backend ("nccl", "gloo", ...)."""
        return str(dist.get_backend())

    def prepare_graph(self, device: torch.device) -> None:
        """Make a CUDA graph of solves on ``device`` possible: raise unless
        the backend's collectives capture (NCCL), and set the communicator
        up outside the capture (its first collective), once."""
        if self.backend != "nccl":
            raise RuntimeError(
                f"gmres_compiled captures the mesh factor's solve as one CUDA "
                f"graph, whose collectives only NCCL captures; this process "
                f"group's backend is {self.backend}: solve with "
                f"gmres_host_driven or krylov.gmres")
        if not getattr(self, "_warm", False):
            dist.all_reduce(torch.zeros(1, device=device))
            torch.cuda.synchronize(device)
            self._warm = True

    def consensus(self, values: np.ndarray) -> np.ndarray:
        """Rank 0's host values on every rank: :func:`krylov.gmres` takes
        its branches on them, so every rank takes each alike."""
        t = torch.as_tensor(np.asarray(values), device=self.info.device)
        dist.broadcast(t, src=self.info.rank_of(0, 0))
        return t.cpu().numpy()

    def check_replicated(self, x: torch.Tensor) -> None:
        """Raise unless ``x`` is bit for bit the same on every rank (an
        all-gathered checksum of its words)."""
        w = x.detach().contiguous().reshape(-1).view(torch.int32).to(torch.int64)
        cs = torch.stack([w.sum(), (w * (torch.arange(
            len(w), device=w.device) % 1000003)).sum()])
        out = cs.new_empty(self.info.world * 2)
        dist.all_gather_into_tensor(out, cs)
        out = out.view(self.info.world, 2)
        if not bool((out == out[0]).all()):
            raise RuntimeError(f"the ranks' solutions differ: checksums "
                               f"{out.cpu().tolist()}")

    def gathered(self, dst: int = 0) -> Optional[SolveData]:
        """The shards collected into one device's solve data, on rank
        ``dst`` (None elsewhere)."""
        F = self.gather_factor(dst, self[2].cpu().numpy())
        return None if F is None else F.solve_data

    def gather_factor(self, dst: int, perm: np.ndarray,
                      opts=None) -> Optional[Factorization]:
        """The shards collected into the one-device record layout, a
        :class:`~hsolve_torch.factor.Factorization` of ``perm`` on rank
        ``dst`` (None elsewhere)."""
        from hsolve_torch.interop import factorization_from_numpy
        from hsolve_torch.utils.checkpoint import _record

        tree_group = self.info.mesh.get_group("tree")
        device = self[2].device

        def whole(rec, spec):
            if isinstance(rec, dict):
                return {k: whole(v, spec) for k, v in rec.items()}
            if isinstance(rec, list):
                return [whole(v, spec) for v in rec]
            if not isinstance(rec, torch.Tensor) or spec.kind != "tree":
                return rec
            part = rec.to(device).contiguous()
            out = part.new_empty((spec.parts * part.shape[0],) + part.shape[1:])
            dist.all_gather_into_tensor(out, part, group=tree_group)
            return out

        levels = [whole(_record(lev), spec)
                  for lev, spec in zip(self[0], self.specs)]
        if dist.get_rank() != dst:
            return None
        root = self[1]
        return factorization_from_numpy(
            levels, None if root is None else _record(root), perm, device,
            opts)


@dataclasses.dataclass
class ShardedFactorization(Factorization):
    """A :class:`~hsolve_torch.factor.Factorization` whose levels hold this
    rank's fronts.  ``solve``, ``apply_permuted``, ``rank_report``,
    ``maxrank`` and ``gather_levels`` are collective (every rank calls them,
    in the same order) and give the same answer on every rank; its
    ``solve_data`` is a :class:`MeshSolveData`.  ``factor_bytes[i]``: the
    bytes the mesh moved to factor batch ``i`` (the root's broadcast after
    the last), ``factor_dummy_bytes[i]`` the part of them that filled dummy
    fronts, ``factor_wait_s[i]`` this rank's seconds in those exchanges;
    ``solve_bytes()``: the bytes one application to one right-hand side
    sums over the ranks, per level."""

    info: Optional[MeshInfo] = None
    specs: Optional[List[BatchSpec]] = None
    syncs: Optional[List[Optional[LevelSync]]] = None
    factor_bytes: Optional[List[int]] = None
    factor_wait_s: Optional[List[float]] = None
    factor_dummy_bytes: Optional[List[int]] = None

    def __post_init__(self):
        super().__post_init__()
        self._solve_data = MeshSolveData(self._solve_data, self.syncs,
                                         self.info, self.specs)

    def solve_bytes(self) -> List[int]:
        item = torch.empty(0, dtype=self.dtype).element_size()
        return [0 if sy is None else sy.nbytes(item) for sy in self.syncs]

    def _global_max(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    def gather_levels(self, dst: int = 0) -> Optional[Factorization]:
        """The shards collected into the one-device record layout, on rank
        ``dst`` (None elsewhere); collective."""
        return self.solve_data.gather_factor(dst, self.perm, self.opts)


def factor_sharded(plan, opts, dtype: torch.dtype, mesh,
                   sketch: Optional[Sketch] = None) -> ShardedFactorization:
    """:func:`~hsolve_torch.factor.factor_with_plan` on a mesh (see the
    module docstring)."""
    from hsolve_torch.interop import plan_to_torch

    info = MeshInfo.of(mesh)
    tp = plan_to_torch(plan, info.device)
    levels, root, specs, moved, waited, dummies = factor_levels_sharded(
        plan, tp, opts, dtype, info, sketch)
    syncs = [_level_sync(bp, plan.N, spec, info, dtype)
             for bp, spec in zip(plan.batches, specs)]
    return ShardedFactorization(
        N=plan.N, perm=plan.perm, levels=levels, root=root, opts=opts,
        plan=plan, device=info.device, info=info, specs=specs,
        syncs=syncs, factor_bytes=moved, factor_wait_s=waited,
        factor_dummy_bytes=dummies)

