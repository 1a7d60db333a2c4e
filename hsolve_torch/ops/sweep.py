"""Per-level steps of the hierarchical solve: kernels C and E with their plain
versions.

Kernel C (``csrc/sweep_update.cu``) runs a dense level's two steps of
``hsolve/factor.py:_apply_impl``, one launch each:

- :func:`level_forward`: the forward step (``:527-539``) with its pivot
  solve, ``x = C[int_ids]``, ``C[bnd_ids] -= L x``, ``C[int_ids] = D^-1 x``
  by the level's ``(lu, perm)`` or its explicit ``dinv``;
- :func:`sweep_update`: the backward step (``:553-559``),
  ``C[int_ids] -= R C[bnd_ids]``.

:func:`lowrank_sweep_update` (kernel E, ``csrc/lowrank_sweep_update.cu``) is the
update of a compressed level, where the Gauss transform is a low-rank pair
``M ~= U V^T``: ``C[ids_out] -= U @ (V^T @ Y)`` (``hsolve/factor.py:528-529``,
``:555-556``); the pivot solve between stays :func:`pivot_solve`.

Kernels C and E take float32, float64, complex64 or complex128 values (one
type per call).  In float32 every product
of a level step (``L x``, the pivot solve, ``R C[bnd]``, and on a compressed
level E's ``U (V^T Y)``) accumulates in float64 and rounds to float32 once,
and in complex64 in complex128, in the kernels and in the plain versions
alike: the top levels of a float32 exact factor are nearly
singular, and a float32 summation there cost the mixed-precision solve half
again as many iterations as the reference's.  ``C`` is ``[rows, k]``; ids ``>= N`` are the planner's sentinel: output rows with
such ids are skipped and input rows with them read as zero, so ``C``'s
sentinel row ``N`` stays zero.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from hsolve_torch import kernels
from hsolve_torch.ops import dense as dk

PANEL = 32          # kernel C's substitution panel: rows per warp
PANEL_WARPS = 8     # panels (warps) per CTA of the forward step
MAX_CLUSTER = 8     # the portable thread block cluster size
SPLIT_ROWS = 32     # a backward front gets one CTA per this many rows


WINDOW_ROWS = MAX_CLUSTER * PANEL_WARPS * PANEL   # 2048: one cluster's rows


def forward_cluster(ni_pad: int) -> int:
    """CTAs (a thread block cluster) that kernel C's forward step spreads one
    front of ``ni_pad <= WINDOW_ROWS`` interior rows over: one warp per
    32-row panel, at most 8 panels per CTA, so one CTA up to 256 rows, 2 for
    512, 4 for 1024, 8 for 2048."""
    return max(1, -(-(-(-ni_pad // PANEL)) // PANEL_WARPS))


def accumulator(dtype: torch.dtype) -> torch.dtype:
    """The type kernel C and its plain versions accumulate a value type's
    sums in: float64, or complex128 for the complex types."""
    return torch.complex128 if dtype.is_complex else torch.float64


def _acc_bytes(dtype: torch.dtype) -> int:
    return 16 if dtype.is_complex else 8


# kernel C's forward step on a front wider than WINDOW_ROWS
# (``hs_level_forward_windowed``): one substitution launch on a cluster of
# up to WIDE_CLUSTER CTAs (non-portable above 8) whose warps own panels
WIDE_CLUSTER = 16


def wide_max_warps(dtype: torch.dtype) -> int:
    """Warps of one CTA of the wide substitution: 16, or 8 in the complex
    types (a lane's 32 x 32 block of lu takes 64 or 128 registers)."""
    return 8 if dtype.is_complex else 16


def wide_window_panels(dtype: torch.dtype) -> int:
    """Panels of one window of the wide substitution: 512 (16384 rows) in
    float64 and float32, 256 (8192 rows) in the complex types, whose
    solved values (16 bytes a row in every CTA) then fill 128 KB."""
    return 256 if dtype.is_complex else 512


def forward_wide_launch(npw: int, dtype: torch.dtype,
                        cs_max: int = WIDE_CLUSTER):
    """``(cs, warps, smem)`` of the wide substitution over a window of
    ``npw`` panels (``csrc/sweep_update.cu`` ``wide_launch`` mirrors it): a
    cluster of min(cs_max, npw) CTAs, each of as many warps as its panels,
    within :func:`wide_max_warps` and what shared memory leaves beside the
    window's solved values (``npw * 32`` in the accumulator type) and the
    CTA's own panels' running values (``ceil(npw / cs) * 32``), at one
    [32][32] inverse slot a warp.  Raises where no warp fits."""
    acc = _acc_bytes(dtype)
    if npw < 1 or not 1 <= cs_max <= WIDE_CLUSTER:
        raise ValueError(f"no wide launch for {npw} panels at cluster "
                         f"{cs_max}")
    cs = min(cs_max, npw)
    per = -(-npw // cs)
    fixed, slot = (npw + per) * PANEL * acc, PANEL * PANEL * acc
    if fixed + slot > SMEM_MAX:
        raise ValueError(f"{npw} panels: the window's values outgrow a CTA")
    warps = min(wide_max_warps(dtype), (SMEM_MAX - fixed) // slot, per)
    return cs, warps, fixed + warps * slot


def forward_windows(ni_pad: int, dtype: torch.dtype = torch.float64,
                    cs_max: int = WIDE_CLUSTER):
    """The windows of kernel C's forward step: ``[(row0, row1, cluster)]``.
    A front of up to ``WINDOW_ROWS`` rows is one window, solved by one
    launch of ``level_forward_kernel`` on a cluster of
    :func:`forward_cluster` CTAs.  A wider one (``hs_level_forward_
    windowed``) is one window of up to :func:`wide_window_panels` panels on
    a cluster of up to ``cs_max`` CTAs (:func:`forward_wide_launch`), and
    beyond that a sequence of such windows, each followed by the update of
    the rows after it (and back again for the upper triangle)."""
    if ni_pad <= WINDOW_ROWS:
        return [(0, ni_pad, forward_cluster(ni_pad))]
    step = wide_window_panels(dtype) * PANEL
    return [(r0, min(r0 + step, ni_pad),
             forward_wide_launch(-(-(min(r0 + step, ni_pad) - r0) // PANEL),
                                 dtype, cs_max)[0])
            for r0 in range(0, ni_pad, step)]


def forward_wide_geometry(ni_pad: int, nb: int, dtype: torch.dtype,
                          active=None, lu: bool = True) -> dict:
    """Kernel C's forward step on a front of ``ni_pad > WINDOW_ROWS`` rows
    and ``nb`` boundary rows: ``{"cs_max", "windows", "warps", "smem",
    "launches", "resident"}``.  ``active(npw, cs)``, where given, is how
    many clusters of the first window's launch at ``cs`` CTAs the card
    holds at once (``cudaOccupancyMaxActiveClusters``): a cluster of
    ``WIDE_CLUSTER`` where the card holds one, else of 8 (raises where it
    holds none of 8 either).  ``launches``: the prep kernel (the gather and
    the diagonal blocks' inverses), ``C[bnd] -= L x`` where ``nb``, then one
    substitution (both triangles) for one window, else two a window and the
    updates between them; with ``dinv`` (``lu=False``) the prep kernel and
    the row products."""
    if ni_pad <= WINDOW_ROWS:
        raise ValueError(f"{ni_pad} rows take level_forward_kernel")
    npw0 = min(-(-ni_pad // PANEL), wide_window_panels(dtype))
    cs_max, resident = WIDE_CLUSTER, None
    if active is not None and lu:
        for cs_max in (WIDE_CLUSTER, 8):
            resident = active(npw0, min(cs_max, npw0))
            if resident > 0:
                break
        else:
            raise RuntimeError(f"the card holds no cluster of kernel C's "
                               f"wide substitution ({npw0} panels)")
    wins = forward_windows(ni_pad, dtype, cs_max)
    geo = [forward_wide_launch(-(-(r1 - r0) // PANEL), dtype, cs_max)
           for r0, r1, _ in wins]
    n = len(wins)
    launches = 1 + (nb > 0) + ((1 if n == 1 else 2 * n + 2 * (n - 1))
                               if lu else 1)
    return {"cs_max": cs_max, "windows": wins, "warps": [g[1] for g in geo],
            "smem": [g[2] for g in geo], "launches": launches,
            "resident": resident}


# kernel C's forward substitution signals a panel's solved values point to
# point: one int a panel of a cluster of 8 CTAs, in each CTA's static
# shared memory (HS_C_MAX_PANELS)
FORWARD_SIGNALS = MAX_CLUSTER * PANEL_WARPS


def forward_smem(ni_pad: int, dtype: torch.dtype) -> int:
    """Shared memory of one CTA of kernel C's forward step on a front of
    ``ni_pad <= WINDOW_ROWS`` rows in value type ``dtype``, as its launcher
    asks for it: the solved values in the accumulator type and x in the
    value type, then (16-byte aligned) the CTA's panel warps' staged 32 x
    33 diagonal blocks (at least 2 warps; in the value type, but a complex64
    front on a cluster, whose substitution runs by signals, stages them as
    complex128), and the substitution's ready signals (the lu form)."""
    cs = forward_cluster(ni_pad)
    warps = max(2, -(-(-(-ni_pad // PANEL)) // cs))
    item = torch.empty((), dtype=dtype).element_size()
    acc = torch.empty((), dtype=accumulator(dtype)).element_size()
    dg_off = -(-ni_pad * (acc + item) // 16) * 16
    staged = acc if cs > 1 and dtype == torch.complex64 else item
    return dg_off + warps * PANEL * 33 * staged + 4 * FORWARD_SIGNALS


def backward_split(ni_pad: int) -> int:
    """CTAs per front of kernel C's backward step: one per 32 output rows."""
    return max(1, -(-ni_pad // SPLIT_ROWS))


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


def _wide(t: torch.Tensor) -> torch.Tensor:
    """Float32 and complex64 operands of a product go to float64 and
    complex128 (F4: the narrow sweep accumulates wide and rounds once);
    the wide types stay as they are."""
    return t.to(accumulator(t.dtype))


def _product(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``M @ X``, accumulated in float64 and rounded once to ``X``'s type."""
    return (_wide(M) @ _wide(X)).to(X.dtype)


def pivot_solve(lev, x: torch.Tensor) -> torch.Tensor:
    """``D^-1 x`` per front from a level's explicit ``dinv`` or its
    ``(lu, perm)`` (two batched triangular solves); float32 operands are
    solved in float64 and the result rounded once."""
    if lev.dinv is not None:
        return _product(lev.dinv, x)
    return dk.lu_solve(_wide(lev.lu), lev.perm, _wide(x)).to(x.dtype)


def level_forward_plain(C: torch.Tensor, lev, N: int) -> torch.Tensor:
    """In place: the forward step of a dense level record ``lev`` (fields
    ``L, int_ids, bnd_ids`` and ``dinv`` or ``lu, perm``): ``x = C[int_ids]``,
    ``C[bnd_ids] -= L x``, ``C[int_ids] = D^-1 x`` (ids ``>= N`` skipped);
    returns ``C``."""
    x = _inputs(C, N, None, lev.int_ids)                     # [B, ni, k]
    _scatter_sub(C, lev.bnd_ids, _product(lev.L, x), N)
    keep = lev.int_ids < N
    C[lev.int_ids[keep].long()] = pivot_solve(lev, x)[keep]
    return C


def level_forward(C: torch.Tensor, lev, N: int) -> torch.Tensor:
    """Kernel C's forward step (in place on ``C``; see the plain version):
    one launch per level, the pivot solve included, or for fronts wider than
    ``WINDOW_ROWS`` a short launch sequence (:func:`forward_wide_geometry`):
    the gather with the diagonal blocks' inverses, ``C[bnd] -= L x``, and
    both triangles' substitution in one launch on a cluster of up to 16
    CTAs (windows of :func:`wide_window_panels` panels beyond).  The kernel
    takes ``lu`` column-major (as the LU returns it) and ``L``, ``dinv``
    row-major."""
    A = lev.dinv if lev.dinv is not None else lev.lu
    operands = [C, lev.L, lev.int_ids, lev.bnd_ids, A] + (
        [] if lev.dinv is not None else [lev.perm])
    if kernels.on_cpu(*operands):
        return level_forward_plain(C, lev, N)
    B, nb, ni = lev.L.shape
    k = C.shape[1]
    if not 0 <= N <= C.shape[0]:
        raise ValueError(f"N={N} outside C's {C.shape[0]} rows")
    dt = kernels.value_type(C, lev.L, A)
    kernels.require(C, "C", dt, (C.shape[0], k))
    kernels.require(lev.L, "L", dt)
    if lev.dinv is not None:
        kernels.require(A, "dinv", dt, (B, ni, ni))
    else:
        # column-major, as torch.linalg.lu_factor returns it
        kernels.require(A.mT, "lu^T (lu column-major)", dt, (B, ni, ni))
    kernels.require(lev.int_ids, "int_ids", torch.int32, (B, ni))
    kernels.require(lev.bnd_ids, "bnd_ids", torch.int32, (B, nb))
    perm = None
    if lev.dinv is None:
        kernels.require(lev.perm, "perm", torch.int64, (B, ni))
        perm = lev.perm.data_ptr()
    if not B * ni or not k:
        return C
    lu = None if lev.dinv is not None else lev.lu.data_ptr()
    dinv = None if lev.dinv is None else lev.dinv.data_ptr()
    ptrs = (C.data_ptr(), lev.int_ids.data_ptr(), lev.bnd_ids.data_ptr(),
            lev.L.data_ptr(), lu, perm, dinv)
    if ni <= WINDOW_ROWS:
        kernels.launch(kernels.symbol("hs_level_forward", dt), C.device, *ptrs,
                       B, ni, nb, k, N, forward_cluster(ni))
    else:
        # x and z = x[perm] gathered into scratch, and each panel's inverted
        # diagonal blocks, in the accumulator type
        acc = accumulator(dt)
        XZ = torch.empty((2, B, k, ni), dtype=acc, device=C.device)
        Dinv = None if lev.dinv is not None else torch.empty(
            (B, 2, -(-ni // PANEL), PANEL, PANEL), dtype=acc, device=C.device)
        geo = forward_wide_geometry(ni, nb, dt, _wide_active(dt),
                                    lev.dinv is None)
        kernels.launch(kernels.symbol("hs_level_forward_windowed", dt),
                       C.device, *ptrs, XZ[0].data_ptr(), XZ[1].data_ptr(),
                       None if Dinv is None else Dinv.data_ptr(), B, ni, nb,
                       k, N, geo["cs_max"])
    kernels.count_launch(level_forward, dt)
    return C


level_forward.launches = 0
level_forward.launches_by_type = {}
_WIDE_ACTIVE = {}


def _wide_active(dtype: torch.dtype):
    """``active(npw, cs)`` for :func:`forward_wide_geometry`: the clusters of
    the wide substitution the card holds at once, asked of it once per
    shape (``hs_level_forward_wide_clusters``)."""
    def active(npw: int, cs: int) -> int:
        key = (dtype, npw, cs)
        if key not in _WIDE_ACTIVE:
            _WIDE_ACTIVE[key] = getattr(kernels.lib(), kernels.symbol(
                "hs_level_forward_wide_clusters", dtype))(npw, cs)
        return _WIDE_ACTIVE[key]

    return active


def sweep_update_plain(C: torch.Tensor, ids_out: torch.Tensor, M: torch.Tensor,
                       N: int, ids_in: torch.Tensor) -> torch.Tensor:
    """In place: ``C[ids_out[b, r]] -= sum_c M[b, r, c] * C[ids_in[b, c]]``
    (the backward step with ``M = R``, ``ids_out = int_ids``, ``ids_in =
    bnd_ids``); returns ``C``."""
    return _scatter_sub(C, ids_out, _product(M, _inputs(C, N, None, ids_in)),
                        N)


def sweep_update(C: torch.Tensor, ids_out: torch.Tensor, M: torch.Tensor, N: int,
                 ids_in: torch.Tensor) -> torch.Tensor:
    """Kernel C's backward step (in place on ``C``; see the plain version)."""
    if kernels.on_cpu(C, ids_out, M, ids_in):
        return sweep_update_plain(C, ids_out, M, N, ids_in)
    B, R, Cc = M.shape
    k = C.shape[1]
    if not 0 <= N <= C.shape[0]:
        raise ValueError(f"N={N} outside C's {C.shape[0]} rows")
    dt = kernels.value_type(C, M)
    kernels.require(C, "C", dt, (C.shape[0], k))
    kernels.require(M, "M", dt)
    kernels.require(ids_out, "ids_out", torch.int32, (B, R))
    kernels.require(ids_in, "ids_in", torch.int32, (B, Cc))
    if B * R and Cc and k:
        kernels.launch(kernels.symbol("hs_sweep_update", dt), C.device,
                       C.data_ptr(), ids_out.data_ptr(), M.data_ptr(),
                       ids_in.data_ptr(), B, R, Cc, k, N, backward_split(R))
        kernels.count_launch(sweep_update, dt)
    return C


sweep_update.launches = 0
sweep_update.launches_by_type = {}


E_THREADS = (256, 1024)   # kernel E's CTA sizes
E_CTAS = 4             # CTAs per SM a launch aims at
E_MAX_CLUSTER = 16     # CTAs a front spreads over at most (non-portable > 8)
E_MIN_WORK = 1024      # entries of U's or V's slice per CTA at the least
E_KB = 4               # right-hand sides per chunk where k > 1
E_DD_FRONTS = 16       # launches of at most this many fronts sum in double-double
SMEM_MAX = 232448      # shared memory one CTA can use (227 KB)


def lowrank_sweep_smem(threads: int, vec: int, kb: int, kc: int,
                       itemsize: int = 8, is_complex: bool = False) -> int:
    """Kernel E's dynamic shared memory: the phase-1 partials
    ([threads, vec, kb] double-double pairs), the staged Y rows ([threads,
    kb]) and two [kc, kb] tiles of pairs (the CTA's partial t and the
    cluster's sum), in sums of the accumulator type (:func:`accumulator`)
    of values of ``itemsize`` bytes: float64 for float64 and float32 (8
    bytes), complex128 for both complex types (16)."""
    return _acc_size(itemsize, is_complex) * (
        threads * (2 * vec + 1) * kb + 4 * kc * kb)


def _acc_size(itemsize: int, is_complex: bool) -> int:
    """Bytes of the accumulator type of values of ``itemsize`` bytes (a
    16-byte value is complex128)."""
    return 16 if is_complex or itemsize > 8 else 8


@functools.lru_cache(maxsize=None)     # the wrapper asks at every launch
def lowrank_sweep_geometry(B: int, R: int, Cc: int, kc: int, k: int,
                           sms: int = 132, aligned: bool = True,
                           itemsize: int = 8, is_complex: bool = False):
    """Kernel E's launch for ``B`` fronts with U [B, R, kc], V [B, Cc, kc]
    and ``k`` right-hand sides, values of ``itemsize`` bytes (complex where
    ``is_complex``): ``(cs, threads, rstep, cstep, vec, kb, dd, smem)``.

    A launch whose fronts fill between a half and one wave of the SMs takes
    one CTA of 1024 threads a front (k = 1).  Otherwise a CTA has 256
    threads, and where the launch has fewer fronts than ``E_CTAS`` per SM a
    front spreads over a thread block cluster of ``cs`` CTAs (a power of
    two, at most ``E_MAX_CLUSTER``): as many as bring the launch to that,
    but no CTA with fewer than ``E_MIN_WORK`` entries of the longer of U
    and V.  CTA ``j`` of a cluster reduces V's rows ``[j cstep, (j + 1)
    cstep)`` and applies U's rows ``[j rstep, (j + 1) rstep)``.  ``vec``:
    the values one 16-byte read of V's and U's rows takes, 2 doubles, 4
    floats or 2 complex64 values where it can (kc a multiple of it, 16-byte
    aligned), else 1, and one complex128 value;
    ``kb`` the right-hand sides per chunk (1 for k = 1,
    else ``E_KB`` where it fits); ``dd`` = 1 where the launch has at most
    ``E_DD_FRONTS`` fronts: the top levels, where a row's terms of U t sum
    to up to 650 times the update at n=512 (at most 0.8 from 31 fronts on,
    where double-double would cost most), sum in double-double, t kept as
    a pair (each part of a complex value a pair); float32 and complex64
    values sum in float64 and complex128, far below their own rounding,
    and take ``dd`` = 0; ``smem`` :func:`lowrank_sweep_smem`."""
    wide = itemsize == _acc_size(itemsize, is_complex)
    per16 = 16 // itemsize
    vec = per16 if aligned and kc % per16 == 0 else 1
    cs, threads = 1, E_THREADS[0]
    if k == 1 and sms // 2 <= B < sms:
        threads = E_THREADS[1]
    else:
        want = min(E_CTAS * sms // max(B, 1), E_MAX_CLUSTER,
                   max(R, Cc) * kc // E_MIN_WORK)
        while cs * 2 <= want:
            cs *= 2
    kb = E_KB if k > 1 and lowrank_sweep_smem(
        threads, vec, E_KB, kc, itemsize, is_complex) <= SMEM_MAX else 1
    smem = lowrank_sweep_smem(threads, vec, kb, kc, itemsize, is_complex)
    if smem > SMEM_MAX:
        raise ValueError(f"rank cap {kc} too large for kernel E's shared "
                         f"memory ({smem} > {SMEM_MAX} bytes)")
    dd = int(B <= E_DD_FRONTS and wide)
    return cs, threads, -(-R // cs), -(-Cc // cs), vec, kb, dd, smem


def lowrank_sweep_update_plain(C: torch.Tensor, ids_out: torch.Tensor,
                               U: torch.Tensor, V: torch.Tensor, N: int,
                               X: Optional[torch.Tensor] = None,
                               ids_in: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """In place: ``C[ids_out[b, r]] -= (U[b] @ (V[b]^T @ Y[b]))[r]`` with
    ``Y = X`` or ``Y = C[ids_in]``; returns ``C``.  Float32 and complex64
    operands multiply in float64 and complex128 and the update is rounded
    once (F4's rule)."""
    Y = _inputs(C, N, X, ids_in)
    upd = _wide(U) @ (_wide(V).transpose(-1, -2) @ _wide(Y))
    return _scatter_sub(C, ids_out, upd.to(C.dtype), N)


def lowrank_sweep_update(C: torch.Tensor, ids_out: torch.Tensor, U: torch.Tensor,
                         V: torch.Tensor, N: int,
                         X: Optional[torch.Tensor] = None,
                         ids_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel E wrapper (in place on ``C``; see the plain version).  ``U`` is
    [B, R, k_cap] (rows follow ``ids_out``), ``V`` [B, Cc, k_cap] (rows follow
    ``X`` or ``ids_in``), values float64, float32, complex64 or complex128
    (one type); the launch is :func:`lowrank_sweep_geometry`'s."""
    operands = [C, ids_out, U, V] + [t for t in (X, ids_in) if t is not None]
    if kernels.on_cpu(*operands):
        return lowrank_sweep_update_plain(C, ids_out, U, V, N, X, ids_in)
    _check_inputs(X, ids_in)
    B, R, kc = U.shape
    Cc = V.shape[1]
    k = C.shape[1]
    if not 0 <= N <= C.shape[0]:
        raise ValueError(f"N={N} outside C's {C.shape[0]} rows")
    dt = kernels.lowrank_type(C, U, V, *([X] if X is not None else []))
    kernels.require(C, "C", dt, (C.shape[0], k))
    kernels.require(U, "U", dt)
    kernels.require(V, "V", dt, (B, Cc, kc))
    kernels.require(ids_out, "ids_out", torch.int32, (B, R))
    if X is not None:
        kernels.require(X, "X", dt, (B, Cc, k))
    else:
        kernels.require(ids_in, "ids_in", torch.int32, (B, Cc))
    if B * R and Cc and kc and k:
        aligned = U.data_ptr() % 16 == 0 and V.data_ptr() % 16 == 0
        lowrank_sweep_launch(C, ids_out, U, V, N, X, ids_in,
                             lowrank_sweep_geometry(B, R, Cc, kc, k,
                                                    kernels.sm_count(C.device),
                                                    aligned, U.element_size(),
                                                    dt.is_complex))
        kernels.count_launch(lowrank_sweep_update, dt)
    return C


def lowrank_sweep_launch(C, ids_out, U, V, N, X, ids_in, geo) -> None:
    """One launch of kernel E in the geometry ``geo`` (the tuple of
    :func:`lowrank_sweep_geometry`) on operands the wrapper checked."""
    B, R, kc = U.shape
    kernels.launch(kernels.symbol("hs_lowrank_sweep_update", U.dtype),
                   C.device, C.data_ptr(),
                   ids_out.data_ptr(), U.data_ptr(), V.data_ptr(),
                   None if X is None else X.data_ptr(),
                   None if ids_in is None else ids_in.data_ptr(),
                   B, R, V.shape[1], kc, C.shape[1], N, *geo)


lowrank_sweep_update.launches = 0
lowrank_sweep_update.launches_by_type = {}
