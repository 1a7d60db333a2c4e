"""Per-level update of the hierarchical solve: kernel C with its plain version.

:func:`sweep_update` (``csrc/sweep_update.cu``) is the fused gather -> batched
GEMV -> scatter-add that ``hsolve/factor.py:_apply_impl`` runs twice per level:

- forward: ``C[bnd_ids] -= L @ X`` with ``X = C[int_ids]`` gathered by the caller
  before the pivot solve overwrites ``C[int]``,
- backward: ``C[int_ids] -= R @ C[bnd_ids]``, gathered inside.

``C`` is ``[rows, k]``; ids ``>= N`` are the planner's sentinel: output rows with
such ids are skipped and input rows with them read as zero.
"""

from __future__ import annotations

from typing import Optional

import torch

from hsolve_torch import kernels


def _check_inputs(X: Optional[torch.Tensor], ids_in: Optional[torch.Tensor]):
    if (X is None) == (ids_in is None):
        raise ValueError("pass exactly one of X and ids_in")


def _inputs(C: torch.Tensor, N: int, X: Optional[torch.Tensor],
            ids_in: Optional[torch.Tensor]) -> torch.Tensor:
    _check_inputs(X, ids_in)
    if X is not None:
        return X
    valid = ids_in < N
    Y = C[torch.where(valid, ids_in, 0).long()]              # [B, Cc, k]
    return torch.where(valid[..., None], Y, 0.0)


def sweep_update_plain(C: torch.Tensor, ids_out: torch.Tensor, M: torch.Tensor,
                       N: int, X: Optional[torch.Tensor] = None,
                       ids_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In place: ``C[ids_out[b, r]] -= sum_c M[b, r, c] * Y[b, c]`` with
    ``Y = X`` or ``Y = C[ids_in]``; returns ``C``."""
    upd = M @ _inputs(C, N, X, ids_in)                       # [B, R, k]
    keep = ids_out < N
    C.index_put_((ids_out[keep].long(),), -upd[keep], accumulate=True)
    return C


def sweep_update(C: torch.Tensor, ids_out: torch.Tensor, M: torch.Tensor, N: int,
                 X: Optional[torch.Tensor] = None,
                 ids_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel C wrapper (in place on ``C``; see the plain version)."""
    operands = [C, ids_out, M] + [t for t in (X, ids_in) if t is not None]
    if kernels.on_cpu(*operands):
        return sweep_update_plain(C, ids_out, M, N, X, ids_in)
    _check_inputs(X, ids_in)
    B, R, Cc = M.shape
    k = C.shape[1]
    if not 0 <= N <= C.shape[0]:
        raise ValueError(f"N={N} outside C's {C.shape[0]} rows")
    kernels.require(C, "C", torch.float64, (C.shape[0], k))
    kernels.require(M, "M", torch.float64)
    kernels.require(ids_out, "ids_out", torch.int32, (B, R))
    if X is not None:
        kernels.require(X, "X", torch.float64, (B, Cc, k))
    else:
        kernels.require(ids_in, "ids_in", torch.int32, (B, Cc))
    if B * R and Cc:
        kernels.launch("hs_sweep_update", C.device, C.data_ptr(),
                       ids_out.data_ptr(), M.data_ptr(),
                       None if X is None else X.data_ptr(),
                       None if ids_in is None else ids_in.data_ptr(),
                       B, R, Cc, k, N)
        sweep_update.launches += 1
    return C


sweep_update.launches = 0
