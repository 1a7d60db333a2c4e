"""Device sparse matvec: ELL (padded-row) and DIA (diagonal-offset) formats
(port of ``hsolve/ops/sparse.py``).

- ELLPACK: rows padded to the max nonzeros-per-row; SpMV is a gather plus a row
  reduction (plain torch).  The general-purpose path.
- DIA: for stencil/FEM matrices with few populated diagonals (every generated
  Poisson/Helmholtz problem), SpMV is a handful of shifted multiply-adds with no
  index gathers.  :func:`dia_spmv` is kernel D (``csrc/dia_spmv.cu``), which also
  fuses the residual ``b - A x`` that GMRES's restarts need; it takes float32
  (the inner operator of mixed-precision GMRES) or float64 values, and
  complex64 or complex128 ones (the damped Helmholtz operator).
:func:`spmv_format` picks the format.  The entry points build on the card
(``device="cuda"``) unless the caller names another device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from hsolve_torch import kernels

MAX_DIAGS = 64   # kernel D keeps the offsets in a fixed shared-memory array


class EllMatrix(NamedTuple):
    indices: torch.Tensor   # [N, w] column ids, sentinel N on padding (int64)
    values: torch.Tensor    # [N, w] matching values, 0 on padding
    shape: tuple


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch, numpy or string dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def to_ell(A: sp.spmatrix, dtype=None, *, device="cuda") -> EllMatrix:
    device = kernels.resolve_device(device)
    A = sp.csr_matrix(A)
    N = A.shape[0]
    counts = np.diff(A.indptr)
    w = max(int(counts.max()), 1)
    idx = np.full((N, w), N, dtype=np.int64)
    val = np.zeros((N, w), dtype=A.dtype if dtype is None else dtype)
    rows = np.repeat(np.arange(N), counts)
    slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    idx[rows, slot] = A.indices
    val[rows, slot] = A.data
    return EllMatrix(torch.as_tensor(idx, device=device),
                     torch.as_tensor(val, device=device), A.shape)


def ell_matvec(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for x of shape [N] or [N, k] (padded gather + row reduction)."""
    xp = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], dim=0)
    gathered = xp[A.indices]                      # [N, w, ...]
    if x.ndim == 1:
        return (A.values * gathered).sum(dim=1)
    return (A.values[..., None] * gathered).sum(dim=1)


@dataclasses.dataclass
class DiaMatrix:
    """Diagonal-offset storage: ``values[d, i] = A[i, i + offsets[d]]`` (0 outside).

    ``offsets`` is the host tuple (the plain version's static slices);
    ``offs`` the same offsets as a device int32 array (kernel D's input)."""

    values: torch.Tensor       # [ndiag, N]
    offsets: Tuple[int, ...]
    offs: torch.Tensor         # [ndiag] int32, on values' device
    shape: Tuple[int, int]


def to_dia(A: sp.spmatrix, dtype=None, max_diags: int = MAX_DIAGS, *,
           device="cuda"):
    """Convert to DIA storage; returns None if A populates more than
    ``max_diags`` diagonals (use :func:`to_ell` then)."""
    device = kernels.resolve_device(device)
    A = sp.csr_matrix(A)
    N = A.shape[0]
    if A.shape[0] != A.shape[1]:
        return None
    coo = A.tocoo()
    offs = np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64))
    if len(offs) > min(max_diags, MAX_DIAGS) or len(offs) == 0:
        return None
    vals = np.zeros((len(offs), N), dtype=A.dtype if dtype is None else dtype)
    for k, d in enumerate(offs):
        diag = A.diagonal(int(d))
        if d >= 0:
            vals[k, : N - d] = diag
        else:
            vals[k, -d:] = diag
    return DiaMatrix(values=torch.as_tensor(vals, device=device),
                     offsets=tuple(int(d) for d in offs),
                     offs=torch.as_tensor(offs.astype(np.int32), device=device),
                     shape=A.shape)


def dia_spmv_plain(A: DiaMatrix, x: torch.Tensor,
                   b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version of kernel D on ``x [N, k]``: per-diagonal shifted
    multiply-adds over a zero-padded copy of x (hsolve/ops/sparse.py:98-111);
    returns ``A x``, or ``b - A x`` when ``b`` is given."""
    N = A.shape[0]
    M = max(max(abs(d) for d in A.offsets), 1)
    xp = torch.nn.functional.pad(x, (0, 0, M, M))
    acc = torch.zeros_like(x)
    for j, d in enumerate(A.offsets):
        acc = acc + A.values[j].to(x.dtype)[:, None] * xp[M + d: M + d + N]
    return acc if b is None else b - acc


def dia_spmv(A: DiaMatrix, x: torch.Tensor,
             b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel D wrapper: ``A x`` (or ``b - A x``) for ``x [N, k]``."""
    operands = (A.values, A.offs, x) + (() if b is None else (b,))
    if kernels.on_cpu(*operands):
        return dia_spmv_plain(A, x, b)
    N = A.shape[0]
    nd = len(A.offsets)
    if nd > MAX_DIAGS:
        raise ValueError(f"kernel D takes at most {MAX_DIAGS} diagonals")
    dt = kernels.value_type(A.values, x, *([] if b is None else [b]))
    kernels.require(A.values, "values", dt, (nd, N))
    kernels.require(A.offs, "offs", torch.int32, (nd,))
    kernels.require(x, "x", dt)
    if x.ndim != 2 or x.shape[0] != N:
        raise ValueError(f"x: expected [{N}, k], got {tuple(x.shape)}")
    if b is not None:
        kernels.require(b, "b", dt, x.shape)
    y = torch.empty_like(x)
    kernels.launch(kernels.symbol("hs_dia_spmv", dt), x.device, y.data_ptr(),
                   A.values.data_ptr(), A.offs.data_ptr(), x.data_ptr(),
                   None if b is None else b.data_ptr(), nd, N, x.shape[1])
    kernels.count_launch(dia_spmv, dt)
    return y


dia_spmv.launches = 0
dia_spmv.launches_by_type = {}


def dia_matvec(A: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for x of shape [N] or [N, k]."""
    if x.ndim == 1:
        return dia_spmv(A, x[:, None])[:, 0]
    return dia_spmv(A, x)


def dia_residual(A: DiaMatrix, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = b - A @ x in one pass (x, b of shape [N] or [N, k])."""
    if x.ndim == 1:
        return dia_spmv(A, x[:, None], b[:, None])[:, 0]
    return dia_spmv(A, x, b)


def spmv_format(A: sp.spmatrix, dtype=None, max_diags: int = MAX_DIAGS, *,
                device="cuda"):
    """Pick the device SpMV format for A: ``(operator_data, matvec_fn)``.

    DIA when A is few-diagonal (all generated stencil problems), else ELL.
    ``dtype`` sets the values' type (A's by default): ``np.float32`` gives the
    inner operator of mixed-precision GMRES."""
    dia = to_dia(A, dtype=dtype, max_diags=max_diags, device=device)
    if dia is not None:
        return dia, dia_matvec
    return to_ell(A, dtype=dtype, device=device), ell_matvec
