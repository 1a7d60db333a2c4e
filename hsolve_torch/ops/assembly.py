"""Front assembly on the device: kernels A and B with their plain versions.

- :func:`front_assemble` (kernel A, ``csrc/front_assemble.cu``) builds a batch's
  padded ``[B, m_pad, m_pad]`` fronts from the device copy of the permuted
  matrix's values, gathered through the planner's ``front_src`` and scattered to
  ``front_pos`` (JAX: ``factor.py`` ``_vals_of`` + ``build_front_vals``).
- :func:`extend_add` (kernel B, ``csrc/extend_add.cu``) adds one child group's
  Schur complements into the fronts through the inverse map ``map_l``/``map_r``,
  reading straight from the child batch's Schur stack (JAX: ``_stage_children``
  + ``_extend_add_impl``).

Both take float32, float64, complex64 or complex128 values (one type per
call); on complex values kernel B stays bitwise its plain version (a complex
add is two real adds, in the same order).
"""

from __future__ import annotations

from typing import Optional

import torch

from hsolve_torch import kernels


def front_assemble_plain(B: int, m: int, pos: torch.Tensor, src: torch.Tensor,
                         adata: torch.Tensor) -> torch.Tensor:
    """``front.flat[pos[e]] = src[e] >= 0 ? adata[src[e]] : 1`` into zeros."""
    flat = torch.zeros(B * m * m, dtype=adata.dtype, device=adata.device)
    if pos.numel():
        one = torch.ones((), dtype=adata.dtype, device=adata.device)
        vals = torch.where(src >= 0, adata[src.clamp(min=0).long()], one)
        flat[pos.long()] = vals
    return flat.view(B, m, m)


def front_assemble(B: int, m: int, pos: torch.Tensor, src: torch.Tensor,
                   adata: torch.Tensor) -> torch.Tensor:
    """Kernel A wrapper: a new ``[B, m, m]`` front stack (see the plain version)."""
    if kernels.on_cpu(pos, src, adata):
        return front_assemble_plain(B, m, pos, src, adata)
    nnz = pos.numel()
    if B * m * m >= 2 ** 31:
        raise ValueError("kernel A addresses fronts with int32 positions; "
                         f"B * m_pad^2 = {B * m * m} is too large")
    dt = kernels.value_type(adata)
    kernels.require(pos, "pos", torch.int32, (nnz,))
    kernels.require(src, "src", torch.int32, (nnz,))
    kernels.require(adata, "adata", dt)
    front = torch.zeros(B, m, m, dtype=dt, device=adata.device)
    if nnz:
        kernels.launch(kernels.symbol("hs_front_assemble", dt), adata.device,
                       front.data_ptr(), pos.data_ptr(), src.data_ptr(),
                       adata.data_ptr(), nnz)
        kernels.count_launch(front_assemble, dt)
    return front


front_assemble.launches = 0
front_assemble.launches_by_type = {}


def extend_add_plain(front: torch.Tensor, S: torch.Tensor, src_rows: torch.Tensor,
                     dst_rows: torch.Tensor, imap: torch.Tensor) -> torch.Tensor:
    """In place: ``front[r, i, j] += S[s, imap[r, i], imap[r, j]]`` for each
    group pair ``(s, r) = (src_rows[k], dst_rows[k])``, where both map entries
    are >= 0 and inside S's width; returns ``front``."""
    w = S.shape[-1]
    if w == 0 or dst_rows.numel() == 0:
        return front
    m = front.shape[-1]
    dst = dst_rows.long()
    idx = imap[dst].long()                                   # [G, m]
    valid = (idx >= 0) & (idx < w)
    idx = torch.where(valid, idx, 0)
    Sg = S[src_rows.long()]                                  # [G, w, w]
    G = Sg.shape[0]
    g = torch.gather(Sg, 1, idx[:, :, None].expand(G, m, w))
    g = torch.gather(g, 2, idx[:, None, :].expand(G, m, m))
    mask = valid[:, :, None] & valid[:, None, :]
    front[dst] = front[dst] + torch.where(mask, g, 0.0)
    return front


B_THREADS = 256     # kernel B's CTA
B_CTAS = 4          # CTAs per SM a launch aims at


def valid_rows(imap: torch.Tensor, dst_rows: torch.Tensor, w: int) -> int:
    """The most map entries in ``[0, w)`` of one front row of the group: the
    valid rows (and columns) of its largest child placement."""
    if dst_rows.numel() == 0:
        return 0
    rows = imap[dst_rows.long()]
    return int(((rows >= 0) & (rows < w)).sum(1).max())


def extend_add_geometry(G: int, rows: int, sms: int = 132):
    """Kernel B's grid for ``G`` groups whose fronts take at most ``rows``
    valid rows each: ``(tiles, trows)``, ``tiles`` CTAs per group, each
    taking ``trows`` of its compacted valid rows at a time (CTA ``t`` the
    rows ``[t trows, (t + 1) trows)``, then ``tiles * trows`` further on):
    enough CTAs to give every SM ``B_CTAS``, the rows spread evenly over
    them, no tile without a row."""
    rows = max(int(rows), 1)
    tiles = -(-rows // min(max(1, rows * max(G, 1) // (B_CTAS * sms)), rows))
    return tiles, -(-rows // tiles)


def extend_add(front: torch.Tensor, S: torch.Tensor, src_rows: torch.Tensor,
               dst_rows: torch.Tensor, imap: torch.Tensor,
               rows: Optional[int] = None) -> torch.Tensor:
    """Kernel B wrapper (in place on ``front``; see the plain version).
    ``rows`` is :func:`valid_rows` of the group, which sizes the grid
    (:func:`extend_add_geometry`); the factor passes the plan's count
    (``interop.plan_to_torch``), and without it the wrapper counts on the
    device and reads the count back."""
    if kernels.on_cpu(front, S, src_rows, dst_rows, imap):
        return extend_add_plain(front, S, src_rows, dst_rows, imap)
    B, m, _ = front.shape
    G = dst_rows.numel()
    w = S.shape[-1]
    dt = kernels.value_type(front, S)
    kernels.require(front, "front", dt, (B, m, m))
    kernels.require(S, "S", dt, (S.shape[0], w, w))
    kernels.require(src_rows, "src_rows", torch.int32, (G,))
    kernels.require(dst_rows, "dst_rows", torch.int32, (G,))
    kernels.require(imap, "imap", torch.int32, (B, m))
    if 8 * m > 232448:
        raise ValueError(f"front width {m}: kernel B's compacted map does not "
                         "fit one CTA's shared memory")
    if G and w:
        if rows is None:
            rows = valid_rows(imap, dst_rows, w)
        extend_add_launch(front, S, src_rows, dst_rows, imap,
                          *extend_add_geometry(G, rows,
                                               kernels.sm_count(front.device)))
        kernels.count_launch(extend_add, dt)
    return front


def extend_add_launch(front, S, src_rows, dst_rows, imap, tiles: int,
                      trows: int) -> None:
    """One launch of kernel B on ``tiles`` CTAs a group of ``trows`` rows
    each, on operands the wrapper checked."""
    kernels.launch(kernels.symbol("hs_extend_add", front.dtype), front.device,
                   front.data_ptr(), S.data_ptr(), src_rows.data_ptr(),
                   dst_rows.data_ptr(), imap.data_ptr(), dst_rows.numel(),
                   front.shape[-1], S.shape[-1], tiles, trows)


extend_add.launches = 0
extend_add.launches_by_type = {}
