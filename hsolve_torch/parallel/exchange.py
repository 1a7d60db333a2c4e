"""The extend-add exchange between ranks: the cross-rank form of the child
gather (``_stage_children``, ``hsolve/factor.py:432``), which one device
runs as kernel B's source rows.

A parent batch consumes rows of earlier Schur stacks: child group
``(src_batch, src_rows, dst_rows)`` of the plan says that parent row
``dst_rows[j]`` reads source row ``src_rows[j]``.  On a mesh a stack split
over the ``tree`` axis in contiguous blocks is held by the ranks of its
block's tree coordinate, so a consumer needs the panels of its own rows that
another block holds.  Every rank derives the whole send and receive pattern
from the plan, so one ``all_to_all_single`` per group moves exactly those
panels, each from the sender of the consumer's ``front`` coordinate:

- a tree-sharded source feeding a tree-sharded consumer sends a panel only
  where its owner block differs from the consumer's (children ``2j`` and
  ``2j + 1`` of a balanced tree land on parent ``j``'s block, so most
  panels stay put: the pattern ``collective_estimate`` counts,
  ``hsolve/utils/profiling.py:384-409``),
- a replicated consumer of a tree-sharded source all-gathers it,
- a replicated source moves nothing.

A row may be several arrays (a :class:`~hsolve_torch.structured.SchurHss`
record's ``D, U, V`` and level generators); they travel packed in one buffer
of the factor's value type.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from hsolve_torch.parallel.dist import BatchSpec, MeshInfo


def _consumers(dst: BatchSpec, dst_rows: np.ndarray, ntree: int
               ) -> List[np.ndarray]:
    """Per tree coordinate, the group positions whose parent rows it holds."""
    if dst.kind == "tree":
        blk = dst.hi - dst.lo
        td = dst_rows // blk
        return [np.flatnonzero(td == t) for t in range(ntree)]
    return [np.arange(len(dst_rows))] * ntree


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t).reshape(-1) if t.is_complex() else t.reshape(-1)


def _pack(arrays: Sequence[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[idx].reshape(len(idx), a[0].numel()) for a in arrays],
                     1)


def crossings(info: MeshInfo, src: BatchSpec, src_rows, dst: BatchSpec,
              dst_rows) -> int:
    """The panels of one child group that cross between ranks, each front
    coordinate's copy counted: what :func:`fetch_rows` sends, in rows."""
    if src.kind != "tree":
        return 0
    src_rows = np.asarray(src_rows, dtype=np.int64)
    need = _consumers(dst, np.asarray(dst_rows, dtype=np.int64), info.ntree)
    owner = src_rows // (src.hi - src.lo)
    return info.nfront * sum(int(np.sum(owner[need[t]] != t))
                             for t in range(info.ntree))


def fetch_rows(info: MeshInfo, arrays: Sequence[torch.Tensor], src: BatchSpec,
               src_rows, dst: BatchSpec, dst_rows
               ) -> Tuple[List[torch.Tensor], np.ndarray, int]:
    """The source rows this rank's parents of one child group read.

    ``arrays`` are this rank's rows of the source stack (``[held, ...]``
    each, one value type).  Returns ``(rows, mine, nbytes)``: the fetched
    rows of every array (``[len(mine), ...]``), the group positions they
    serve (the ones whose parent rows this rank holds, ascending), and the
    bytes the whole mesh sent for the group (0 where nothing crosses).
    Collective: every rank calls it for every group, in the same order."""
    src_rows = np.asarray(src_rows, dtype=np.int64)
    dst_rows = np.asarray(dst_rows, dtype=np.int64)
    dev = arrays[0].device
    need = _consumers(dst, dst_rows, info.ntree)
    mine = need[info.t]
    if src.kind != "tree":
        idx = torch.as_tensor(src_rows[mine] - src.lo, device=dev)
        return [a[idx] for a in arrays], mine, 0
    owner = src_rows // (src.hi - src.lo)
    crossing = crossings(info, src, src_rows, dst, dst_rows)
    here = mine[owner[mine] == info.t]
    out = [a.new_empty((len(mine),) + tuple(a.shape[1:])) for a in arrays]
    pos = np.searchsorted(mine, here)
    for o, a in zip(out, arrays):
        o[torch.as_tensor(pos, device=dev)] = a[torch.as_tensor(
            src_rows[here] - src.lo, device=dev)]
    if not crossing:
        return out, mine, 0
    in_splits = [0] * info.world
    out_splits = [0] * info.world
    send, recv = [], []
    for t in range(info.ntree):
        if t == info.t:
            continue
        r = info.rank_of(t, info.f)
        js = need[t][owner[need[t]] == info.t]     # what t's parents read of mine
        in_splits[r] = len(js)
        send.append(src_rows[js] - src.lo)
        js = mine[owner[mine] == t]                # what mine read of t's
        out_splits[r] = len(js)
        recv.append(js)
    width = sum(a[0].numel() for a in arrays)
    sbuf = _pack(arrays, torch.as_tensor(np.concatenate(send), device=dev))
    rbuf = sbuf.new_empty((sum(out_splits), width))
    # complex values travel as their real pairs
    real = 2 if sbuf.is_complex() else 1
    dist.all_to_all_single(_real(rbuf), _real(sbuf),
                           [n * width * real for n in out_splits],
                           [n * width * real for n in in_splits])
    idx = torch.as_tensor(np.searchsorted(mine, np.concatenate(recv)),
                          device=dev)
    col = 0
    for o, a in zip(out, arrays):
        w = a[0].numel()
        o[idx] = rbuf[:, col: col + w].reshape((len(idx),) + tuple(a.shape[1:]))
        col += w
    return out, mine, crossing * width * arrays[0].element_size()


def broadcast_row0(info: MeshInfo, arrays: Sequence[torch.Tensor],
                   src: BatchSpec) -> Tuple[List[torch.Tensor], int]:
    """Row 0 of a stack on every rank (the root's Schur complement, which
    the owner of the top batch's first block holds); returns the rows
    (``[1, ...]`` each) and the bytes sent."""
    if src.kind != "tree" or info.world == 1:
        return [a[:1] for a in arrays], 0
    buf = _pack(arrays, torch.zeros(1, dtype=torch.int64,
                                    device=arrays[0].device))
    dist.broadcast(_real(buf), src=info.rank_of(0, 0))
    out, col = [], 0
    for a in arrays:
        w = a[0].numel()
        out.append(buf[:, col: col + w].reshape((1,) + tuple(a.shape[1:])))
        col += w
    return out, (info.world - 1) * buf.numel() * buf.element_size()


def gather_front_rows(info: MeshInfo, part: torch.Tensor, n: int
                      ) -> Tuple[torch.Tensor, int]:
    """All-gather over the ``front`` group the row parts ``[B, rows_f, c]``
    of a ``[B, n, c]`` stack (part ``f`` holds rows ``[n f / F, n (f + 1) /
    F)``); returns the whole stack and the bytes sent."""
    F = info.nfront
    cuts = [n * i // F for i in range(F + 1)]
    w = max(cuts[i + 1] - cuts[i] for i in range(F))
    pad = part.new_zeros((part.shape[0], w, part.shape[2]))
    pad[:, :part.shape[1]] = part
    bufs = pad.new_empty((F,) + pad.shape)
    dist.all_gather_into_tensor(_real(bufs), _real(pad), group=info.front_group)
    whole = torch.cat([b[:, : cuts[i + 1] - cuts[i]] for i, b in enumerate(bufs)],
                      1)
    return whole, (F - 1) * F * pad.numel() * pad.element_size()
