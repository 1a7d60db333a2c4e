"""Per-level updates of the hierarchical solve: kernels C and E with their plain
versions.

:func:`sweep_update` (kernel C, ``csrc/sweep_update.cu``) is the fused gather ->
batched GEMV -> scatter-add that ``hsolve/factor.py:_apply_impl`` runs twice per
dense level:

- forward: ``C[bnd_ids] -= L @ X`` with ``X = C[int_ids]`` gathered by the caller
  before the pivot solve overwrites ``C[int]``,
- backward: ``C[int_ids] -= R @ C[bnd_ids]``, gathered inside.

:func:`lowrank_sweep_update` (kernel E, ``csrc/lowrank_sweep_update.cu``) is the
same update on a compressed level, where the Gauss transform is a low-rank pair
``M ~= U V^T``: ``C[ids_out] -= U @ (V^T @ Y)`` (``hsolve/factor.py:528-529``,
``:555-556``).

Kernel C takes float32 or float64 values (one type per call), kernel E
float64.  ``C`` is ``[rows, k]``; ids ``>= N`` are the planner's sentinel: output rows with
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


def _scatter_sub(C: torch.Tensor, ids_out: torch.Tensor, upd: torch.Tensor,
                 N: int) -> torch.Tensor:
    keep = ids_out < N
    C.index_put_((ids_out[keep].long(),), -upd[keep], accumulate=True)
    return C


def sweep_update_plain(C: torch.Tensor, ids_out: torch.Tensor, M: torch.Tensor,
                       N: int, X: Optional[torch.Tensor] = None,
                       ids_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In place: ``C[ids_out[b, r]] -= sum_c M[b, r, c] * Y[b, c]`` with
    ``Y = X`` or ``Y = C[ids_in]``; returns ``C``."""
    return _scatter_sub(C, ids_out, M @ _inputs(C, N, X, ids_in), N)


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
    dt = kernels.value_type(C, M, *([] if X is None else [X]))
    kernels.require(C, "C", dt, (C.shape[0], k))
    kernels.require(M, "M", dt)
    kernels.require(ids_out, "ids_out", torch.int32, (B, R))
    if X is not None:
        kernels.require(X, "X", dt, (B, Cc, k))
    else:
        kernels.require(ids_in, "ids_in", torch.int32, (B, Cc))
    if B * R and Cc:
        kernels.launch(kernels.symbol("hs_sweep_update", dt), C.device,
                       C.data_ptr(), ids_out.data_ptr(), M.data_ptr(),
                       None if X is None else X.data_ptr(),
                       None if ids_in is None else ids_in.data_ptr(),
                       B, R, Cc, k, N)
        kernels.count_launch(sweep_update, dt)
    return C


sweep_update.launches = 0
sweep_update.launches_by_type = {}


# the [k_cap, k] sketch-product tile that kernel E stages in shared memory
LOWRANK_SMEM_DOUBLES = 4096


def lowrank_sweep_update_plain(C: torch.Tensor, ids_out: torch.Tensor,
                               U: torch.Tensor, V: torch.Tensor, N: int,
                               X: Optional[torch.Tensor] = None,
                               ids_in: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """In place: ``C[ids_out[b, r]] -= (U[b] @ (V[b]^T @ Y[b]))[r]`` with
    ``Y = X`` or ``Y = C[ids_in]``; returns ``C``."""
    Y = _inputs(C, N, X, ids_in)
    return _scatter_sub(C, ids_out, U @ (V.transpose(-1, -2) @ Y), N)


def lowrank_sweep_update(C: torch.Tensor, ids_out: torch.Tensor, U: torch.Tensor,
                         V: torch.Tensor, N: int,
                         X: Optional[torch.Tensor] = None,
                         ids_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel E wrapper (in place on ``C``; see the plain version).  ``U`` is
    [B, R, k_cap] (rows follow ``ids_out``), ``V`` [B, Cc, k_cap] (rows follow
    ``X`` or ``ids_in``)."""
    operands = [C, ids_out, U, V] + [t for t in (X, ids_in) if t is not None]
    if kernels.on_cpu(*operands):
        return lowrank_sweep_update_plain(C, ids_out, U, V, N, X, ids_in)
    _check_inputs(X, ids_in)
    B, R, kc = U.shape
    Cc = V.shape[1]
    k = C.shape[1]
    if not 0 <= N <= C.shape[0]:
        raise ValueError(f"N={N} outside C's {C.shape[0]} rows")
    if kc > LOWRANK_SMEM_DOUBLES:
        raise ValueError(f"rank cap {kc} > {LOWRANK_SMEM_DOUBLES}, the kernel's "
                         "shared-memory tile")
    kernels.require(C, "C", torch.float64, (C.shape[0], k))
    kernels.require(U, "U", torch.float64)
    kernels.require(V, "V", torch.float64, (B, Cc, kc))
    kernels.require(ids_out, "ids_out", torch.int32, (B, R))
    if X is not None:
        kernels.require(X, "X", torch.float64, (B, Cc, k))
    else:
        kernels.require(ids_in, "ids_in", torch.int32, (B, Cc))
    if B * R and Cc and kc and k:
        kernels.launch("hs_lowrank_sweep_update", C.device, C.data_ptr(),
                       ids_out.data_ptr(), U.data_ptr(), V.data_ptr(),
                       None if X is None else X.data_ptr(),
                       None if ids_in is None else ids_in.data_ptr(),
                       B, R, Cc, kc, k, N)
        lowrank_sweep_update.launches += 1
    return C


lowrank_sweep_update.launches = 0
