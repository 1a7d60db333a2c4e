"""Batched dense linear algebra of the pivot step (port of ``hsolve/ops/dense.py``).

These stay library calls (``torch.linalg`` and ``torch.matmul``, on real or
complex tensors: cuSOLVER's and cuBLAS's ``d``/``s``/``z``/``c`` routines on
the card), as the JAX package leaves them to ``lax.linalg`` and ``@``; a fused hand kernel for the LU +
Schur step is later work.

- :func:`lu_factor` / :func:`lu_solve` / :func:`lu_solve_right`: batched pivoted
  LU and the two-sided triangular solves behind ``D \\ B`` and ``B / D``,
- :func:`lu_inverse` / :func:`block_inverse`: explicit pivot-block inverses,
- :func:`schur_complement`: the Schur update GEMM,
- :func:`permute_sym`: symmetric gather-permutation of a batch of Schur
  complements into ``[int_loc; bnd_loc]`` order (factorization.jl:39-41).

Padding convention: pivot blocks carry an identity diagonal on padded rows/cols
(set by the planner), so LU, solves and Schur updates are exact on the real
sub-blocks.
"""

from __future__ import annotations

import torch


def lu_factor(D: torch.Tensor):
    """Batched pivoted LU: returns ``(lu, perm)`` with ``D[..., perm, :] = L @ U``.

    ``torch.linalg.lu_factor_ex`` returns LAPACK's 1-based row swaps; they are
    turned into the row permutation ``perm`` that ``lax.linalg.lu`` returns, so
    the level records match the JAX package's.  ``_ex`` skips the singularity
    check that would force a device sync."""
    if D.shape[-1] == 0:
        return D.clone(), torch.zeros(D.shape[:-1], dtype=torch.int64,
                                      device=D.device)
    lu, piv, _ = torch.linalg.lu_factor_ex(D)
    # D = P L U, so (L U)[i] = (P^T D)[i] = D[perm[i]] with P[perm[i], i] = 1.
    # The dense [B, n, n] P costs O(n^2) per front where the swaps need O(n);
    # applying them in order is a sequential loop that no torch op vectorizes,
    # so the fused LU kernel (ROADMAP K2) is to emit perm itself.
    P, _, _ = torch.lu_unpack(lu, piv, unpack_data=False)
    # (P has lu's type: its real part for a complex LU)
    return lu, (P.real if P.is_complex() else P).argmax(dim=-2)


def _take_rows(B: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return torch.gather(B, -2, perm.unsqueeze(-1).expand_as(B))


def lu_solve(lu: torch.Tensor, perm: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``D X = B`` given ``(lu, perm)`` from :func:`lu_factor` (batched)."""
    Y = torch.linalg.solve_triangular(lu, _take_rows(B, perm), upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(lu, Y, upper=True)


def lu_solve_right(lu: torch.Tensor, perm: torch.Tensor,
                   B: torch.Tensor) -> torch.Tensor:
    """Solve ``X D = B`` given ``(lu, perm)`` from :func:`lu_factor` (batched).

    With ``P D = L U`` (rows ``perm``), ``X = ((B / U) / L) P``; the final column
    permutation is ``X[..., :, c] = Z[..., :, invperm[c]]``."""
    Z = torch.linalg.solve_triangular(lu, B, upper=True, left=False)
    Z = torch.linalg.solve_triangular(lu, Z, upper=False, left=False,
                                      unitriangular=True)
    inv = torch.argsort(perm, dim=-1)
    return torch.gather(Z, -1, inv.unsqueeze(-2).expand_as(Z))


def lu_inverse(lu: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Explicit ``D^{-1}`` from ``(lu, perm)`` (batched); the solve sweeps then
    apply the pivot block as one GEMM."""
    n = lu.shape[-1]
    eye = torch.eye(n, dtype=lu.dtype, device=lu.device).expand_as(lu)
    return lu_solve(lu, perm, eye)


def _diag_ratio(lu: torch.Tensor) -> torch.Tensor:
    """``max |U_ii| / min |U_ii|`` per matrix (moduli, in the real type): the
    pivot-growth proxy."""
    d = torch.diagonal(lu, dim1=-2, dim2=-1).abs()
    if d.shape[-1] == 0:             # an empty pivot block has no growth
        return torch.ones(d.shape[:-1], dtype=d.dtype, device=d.device)
    tiny = torch.finfo(d.dtype).tiny
    return d.amax(-1) / d.amin(-1).clamp_min(tiny)


def block_inverse(D: torch.Tensor, base: int = 64):
    """Explicit ``D^{-1}`` by recursive block-Schur inversion (batched).

    With ``M = [[A, B], [C, E]]``, ``S = E - C A^{-1} B``, ``T = C A^{-1}``,
    ``W = A^{-1} B`` and ``XS = S^{-1}``:
    ``M^{-1} = [[A^{-1} + W XS T, -W XS], [-XS T, XS]]``, recursing down to
    ``base``-sized diagonal blocks that use pivoted LU (pivoting confined to
    those blocks).  Returns ``(inv, ratio)`` where ``ratio`` is the max
    base-block pivot diagonal ratio (the conditioning proxy of ``cond_report``).
    """
    n = D.shape[-1]
    if n <= base:
        lu, perm = lu_factor(D)
        return lu_inverse(lu, perm), _diag_ratio(lu)
    h = ((n // 2) + 7) // 8 * 8
    A = D[..., :h, :h]
    B = D[..., :h, h:]
    C = D[..., h:, :h]
    E = D[..., h:, h:]
    X11, r1 = block_inverse(A, base)
    T = C @ X11
    S = E - T @ B
    XS, r2 = block_inverse(S, base)
    W = X11 @ B
    B12 = -(W @ XS)
    B11 = X11 - B12 @ T
    B21 = -(XS @ T)
    top = torch.cat([B11, B12], dim=-1)
    bot = torch.cat([B21, XS], dim=-1)
    return torch.cat([top, bot], dim=-2), torch.maximum(r1, r2)


def schur_complement(Abb: torch.Tensor, Abi: torch.Tensor,
                     R: torch.Tensor) -> torch.Tensor:
    """``S = Abb - Abi @ R`` (batched GEMM; factorization.jl:40 and :72)."""
    return Abb - Abi @ R


def permute_sym(S: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Batched symmetric permutation ``S[perm][:, perm]`` (two gathers); ``perm``
    is an int64 tensor of shape ``S.shape[:-1]``."""
    if S.shape[-1] == 0:
        return S
    S = torch.gather(S, -2, perm.unsqueeze(-1).expand_as(S))
    return torch.gather(S, -1, perm.unsqueeze(-2).expand_as(S))
