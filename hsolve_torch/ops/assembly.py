"""Front assembly on the device: kernels A and B with their plain versions.

- :func:`front_assemble` (kernel A, ``csrc/front_assemble.cu``) builds a batch's
  padded ``[B, m_pad, m_pad]`` fronts from the device copy of the permuted
  matrix's values, gathered through the planner's ``front_src`` and scattered to
  ``front_pos`` (JAX: ``factor.py`` ``_vals_of`` + ``build_front_vals``).
- :func:`extend_add` (kernel B, ``csrc/extend_add.cu``) adds one child group's
  Schur complements into the fronts through the inverse map ``map_l``/``map_r``,
  reading straight from the child batch's Schur stack (JAX: ``_stage_children``
  + ``_extend_add_impl``).
"""

from __future__ import annotations

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
    kernels.require(pos, "pos", torch.int32, (nnz,))
    kernels.require(src, "src", torch.int32, (nnz,))
    kernels.require(adata, "adata", torch.float64)
    front = torch.zeros(B, m, m, dtype=torch.float64, device=adata.device)
    if nnz:
        kernels.launch("hs_front_assemble", adata.device, front.data_ptr(),
                       pos.data_ptr(), src.data_ptr(), adata.data_ptr(), nnz)
        front_assemble.launches += 1
    return front


front_assemble.launches = 0


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


def extend_add(front: torch.Tensor, S: torch.Tensor, src_rows: torch.Tensor,
               dst_rows: torch.Tensor, imap: torch.Tensor) -> torch.Tensor:
    """Kernel B wrapper (in place on ``front``; see the plain version)."""
    if kernels.on_cpu(front, S, src_rows, dst_rows, imap):
        return extend_add_plain(front, S, src_rows, dst_rows, imap)
    B, m, _ = front.shape
    G = dst_rows.numel()
    w = S.shape[-1]
    kernels.require(front, "front", torch.float64, (B, m, m))
    kernels.require(S, "S", torch.float64, (S.shape[0], w, w))
    kernels.require(src_rows, "src_rows", torch.int32, (G,))
    kernels.require(dst_rows, "dst_rows", torch.int32, (G,))
    kernels.require(imap, "imap", torch.int32, (B, m))
    if G and w:
        kernels.launch("hs_extend_add", front.device, front.data_ptr(),
                       S.data_ptr(), src_rows.data_ptr(), dst_rows.data_ptr(),
                       imap.data_ptr(), G, m, w)
        extend_add.launches += 1
    return front


extend_add.launches = 0
