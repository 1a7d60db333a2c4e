"""Native (C++) planner kernels with transparent build + ctypes bindings.

Jax-free copy of ``hsolve/native/__init__.py``.  It compiles its own copy of
the planner source, ``hsolve_torch/native/gather.cpp`` (the JAX package's
``hsolve/native/gather.cpp``, verbatim), into ``build/hsolve_torch/`` at first
use, so the port neither reads the JAX package's tree nor loads or overwrites
its shared object.  Falls back to scipy fancy indexing if no compiler is
available (these are host-side planner accelerators; the device work is in
:mod:`hsolve_torch.ops` and :mod:`hsolve_torch.kernels`).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gather.cpp")
_BUILD = os.path.join(_ROOT, "build", "hsolve_torch")
_LIB = os.path.join(_BUILD, f"_gather_{sys.implementation.cache_tag}.so")

_lib = None


def _build() -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    # compile to a private name and rename into place: concurrent test workers
    # may build at once, and none may load a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    for cc in ("c++", "g++", "cc"):
        try:
            subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
                 _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB)
            return True
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            continue
    return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        if not _build():
            _lib = False
            return _lib
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        _lib = False
        return _lib
    # raw-pointer argtypes: callers pass ``arr.ctypes.data`` (contiguity is the
    # caller's contract, enforced with ascontiguousarray at the build sites) -
    # ndpointer.from_param marshalling cost ~5us/arg and dominated small-batch
    # planner calls at ~700 pointer args per plan
    i64p = ctypes.c_void_p
    f64p = ctypes.c_void_p
    c128p = ctypes.c_void_p
    f64o = ctypes.c_void_p
    c128o = ctypes.c_void_p
    lib.csr_gather_f64.argtypes = [i64p, i64p, f64p, i64p, ctypes.c_int64, i64p,
                                   ctypes.c_int64, i64p, f64o, ctypes.c_int64]
    lib.csr_gather_c128.argtypes = [i64p, i64p, c128p, i64p, ctypes.c_int64, i64p,
                                    ctypes.c_int64, i64p, c128o, ctypes.c_int64]
    lib.mask_same_child_f64.argtypes = [f64o, ctypes.c_int64, i64p]
    lib.mask_same_child_c128.argtypes = [c128o, ctypes.c_int64, i64p]
    lib.csr_gather_many_f64.argtypes = [i64p, i64p, f64p, i64p, i64p, i64p, i64p,
                                        ctypes.c_int64, i64p, f64o, i64p,
                                        ctypes.c_int64]
    lib.csr_gather_many_c128.argtypes = [i64p, i64p, c128p, i64p, i64p, i64p, i64p,
                                         ctypes.c_int64, i64p, c128o, i64p,
                                         ctypes.c_int64]
    lib.csr_gather_coo_many_f64.restype = ctypes.c_int64
    lib.csr_gather_coo_many_f64.argtypes = [i64p, i64p, f64p, i64p, i64p, i64p, i64p,
                                            ctypes.c_int64, i64p, i64p, i64p, i64p,
                                            f64o]
    lib.csr_gather_coo_many_c128.restype = ctypes.c_int64
    lib.csr_gather_coo_many_c128.argtypes = [i64p, i64p, c128p, i64p, i64p, i64p,
                                             i64p, ctypes.c_int64, i64p, i64p, i64p,
                                             i64p, c128o]
    lib.csr_gather_coo_pooled_f64.restype = ctypes.c_int64
    lib.csr_gather_coo_pooled_f64.argtypes = [i64p, i64p, f64p, i64p, i64p, i64p,
                                              i64p, i64p, i64p, i64p,
                                              ctypes.c_int64, i64p, i64p, f64o]
    lib.csr_gather_coo_pooled_c128.restype = ctypes.c_int64
    lib.csr_gather_coo_pooled_c128.argtypes = [i64p, i64p, c128p, i64p, i64p, i64p,
                                               i64p, i64p, i64p, i64p,
                                               ctypes.c_int64, i64p, i64p, c128o]
    lib.csr_permute_f64.argtypes = [i64p, i64p, f64p, ctypes.c_int64, i64p, i64p,
                                    i64p, i64p, f64o]
    lib.csr_permute_c128.argtypes = [i64p, i64p, c128p, ctypes.c_int64, i64p, i64p,
                                     i64p, i64p, c128o]
    lib.tree_postorder.restype = ctypes.c_int64
    lib.tree_postorder.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                                   i64p, i64p]
    lib.csr_gather_front_f64.restype = ctypes.c_int64
    lib.csr_gather_front_f64.argtypes = [i64p, i64p, f64p, i64p, i64p, i64p, i64p,
                                         i64p, i64p, i64p, ctypes.c_int64,
                                         ctypes.c_int64, i64p, i64p, i64p, f64o]
    lib.fill_batch_maps.argtypes = [i64p] * 12 + [ctypes.c_int64] * 4 + [i64p] * 5
    lib.fill_ident_pos.restype = ctypes.c_int64
    lib.fill_ident_pos.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64, i64p]
    lib.symfact_pooled.restype = ctypes.c_int64
    lib.symfact_pooled.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                                   i64p, i64p, i64p, i64p, i64p, ctypes.c_int64,
                                   i64p, ctypes.c_int64, i64p, i64p, i64p, i64p,
                                   ctypes.c_int64, i64p, i64p, i64p]
    lib.csr_gather_front_c128.restype = ctypes.c_int64
    lib.csr_gather_front_c128.argtypes = [i64p, i64p, c128p, i64p, i64p, i64p, i64p,
                                          i64p, i64p, i64p, ctypes.c_int64,
                                          ctypes.c_int64, i64p, i64p, i64p, c128o]
    for nm in ("csr_gather_front_ident_f64", "csr_gather_front_ident_c128"):
        fn = getattr(lib, nm)
        fn.restype = ctypes.c_int64
        fn.argtypes = [i64p, i64p, f64p, i64p, i64p, i64p, i64p, i64p, i64p,
                       i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p,
                       ctypes.c_int64, ctypes.c_int64, i64p, f64o]
    for nm in ("plan_batches_all_f64", "plan_batches_all_c128"):
        fn = getattr(lib, nm)
        fn.restype = None
        fn.argtypes = ([i64p] * 5 + [ctypes.c_int64] + [i64p] * 11 +
                       [ctypes.c_int64] + [i64p] * 8)
    lib.strip_nrows.restype = ctypes.c_int64
    lib.strip_nrows.argtypes = [i64p] + [ctypes.c_int64] * 3
    lib.strip_fill.restype = None
    lib.strip_fill.argtypes = [i64p] + [ctypes.c_int64] * 5 + [i64p, i64p]
    lib.fill_structured_maps.restype = None
    lib.fill_structured_maps.argtypes = ([i64p] * 10 + [ctypes.c_int64] * 8
                                         + [i64p] * 3)
    _lib = lib
    return _lib


_DEBUG_PTRS = bool(os.environ.get("HSOLVE_DEBUG"))


def _pt(a: np.ndarray) -> int:
    """Raw data pointer of a (contiguous-enough) numpy array for the c_void_p ABI.

    The c_void_p argtypes deliberately skip ndpointer's per-call dtype/contiguity
    marshalling (~5us/arg, dominated small-batch planner calls); set HSOLVE_DEBUG=1
    to re-enable a contiguity check here when developing new call sites."""
    if _DEBUG_PTRS:
        assert a.flags["C_CONTIGUOUS"], (
            f"native kernel passed a non-contiguous array (shape={a.shape}, "
            f"strides={a.strides}, dtype={a.dtype})")
    return a.ctypes.data


class CsrGather:
    """Reusable gather context for one CSR matrix (keeps the column-map workspace)."""

    def __init__(self, A):
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        self.ok = bool(_load())
        self.A = A
        self.ncols = A.shape[1]
        self.iscomplex = np.iscomplexobj(A.data)
        if self.ok:
            self.indptr = A.indptr.astype(np.int64)
            self.indices = A.indices.astype(np.int64)
            self.data = np.ascontiguousarray(
                A.data, dtype=np.complex128 if self.iscomplex else np.float64)
            self._init_ws()

    @classmethod
    def from_raw(cls, indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                 ncols: int) -> "CsrGather":
        """Wrap already-int64 CSR arrays without the scipy round-trip (the
        csr_matrix constructor downcasts fresh int64 index arrays to int32, which
        the kernels would convert right back).  ``A`` (the scipy view used only by
        the no-native fallbacks) is built lazily via :meth:`_scipy`."""
        self = cls.__new__(cls)
        self.ok = True
        self.A = None
        self.ncols = int(ncols)
        self.indptr = indptr
        self.indices = indices
        self.iscomplex = np.iscomplexobj(data)
        self.data = data
        self._init_ws()
        return self

    def _init_ws(self):
        self.colmap = np.full(self.ncols, -1, dtype=np.int64)
        self.fn = _lib.csr_gather_c128 if self.iscomplex else _lib.csr_gather_f64
        # pointer tuple for the hot native calls (attribute->ctypes round
        # trips cost ~1.5us each; these four ride along on every call)
        self.csr_ptrs = (_pt(self.indptr), _pt(self.indices), _pt(self.data))
        self.colmap_ptr = _pt(self.colmap)

    def extract(self, rows: np.ndarray, cols: np.ndarray, out=None) -> np.ndarray:
        """Dense A[rows][:, cols] in the given order; ``out`` may be a preallocated
        (possibly larger-strided) buffer view."""
        nr, nc = len(rows), len(cols)
        if not self.ok:
            if nr == 0 or nc == 0:
                return np.zeros((nr, nc), dtype=self.A.dtype)
            blk = np.asarray(self.A[rows][:, cols].todense())
            if out is None:
                return blk
            out[:nr, :nc] = blk
            return out
        if out is None:
            out = np.zeros(
                (nr, nc), dtype=np.complex128 if self.iscomplex else np.float64)
            stride = nc
            buf = out
        else:
            buf = out
            stride = out.strides[0] // out.itemsize
        if nr and nc:
            rows = np.ascontiguousarray(rows, dtype=np.int64)
            cols = np.ascontiguousarray(cols, dtype=np.int64)
            self.fn(*self.csr_ptrs, _pt(rows), nr, _pt(cols), nc,
                    self.colmap_ptr, _pt(buf), stride)
        return out


class BlockGatherBuilder:
    """Accumulate (rows, cols, out-offset) block specs and execute them in one
    native call (per-call ctypes overhead dominates small blocks)."""

    def __init__(self, gather: "CsrGather"):
        self.g = gather
        self.rows = []
        self.cols = []
        self.offs = []
        self.strides = []

    def add(self, rows: np.ndarray, cols: np.ndarray, elem_off: int,
            stride: int = 0) -> None:
        if len(rows) and len(cols):
            self.rows.append(np.ascontiguousarray(rows, dtype=np.int64))
            self.cols.append(np.ascontiguousarray(cols, dtype=np.int64))
            self.offs.append(elem_off)
            self.strides.append(stride)

    def run_coo(self, default_stride: int):
        """Emit (flat positions, values) for all accumulated blocks in one native
        call; returns (pos [nnz] int64, vals [nnz]).  Per-block stride defaults
        to ``default_stride`` (blocks that set their own stride keep it)."""
        g = self.g
        dt = np.complex128 if g.iscomplex else np.float64
        if not self.rows:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=dt)
        strides = np.asarray([s if s else default_stride for s in self.strides],
                             dtype=np.int64)
        offs = np.asarray(self.offs, dtype=np.int64)
        if not g.ok:
            poss, vals = [], []
            for rs, cs, off, st in zip(self.rows, self.cols, offs, strides):
                blk = g.A[rs][:, cs].tocoo()
                poss.append(off + blk.row.astype(np.int64) * st + blk.col)
                vals.append(blk.data.astype(dt))
            return np.concatenate(poss), np.concatenate(vals)
        row_ptr = np.zeros(len(self.rows) + 1, dtype=np.int64)
        np.cumsum([len(r) for r in self.rows], out=row_ptr[1:])
        col_ptr = np.zeros(len(self.cols) + 1, dtype=np.int64)
        np.cumsum([len(c) for c in self.cols], out=col_ptr[1:])
        rows_cat = np.concatenate(self.rows)
        cols_cat = np.concatenate(self.cols)
        # upper bound on emitted pairs: total nnz of the gathered rows
        bound = int(np.sum(g.indptr[rows_cat + 1] - g.indptr[rows_cat]))
        pos = np.empty(max(bound, 1), dtype=np.int64)
        val = np.empty(max(bound, 1), dtype=dt)
        fn = _lib.csr_gather_coo_many_c128 if g.iscomplex else \
            _lib.csr_gather_coo_many_f64
        n = fn(*g.csr_ptrs, _pt(rows_cat), _pt(row_ptr), _pt(cols_cat),
               _pt(col_ptr), len(offs), g.colmap_ptr, _pt(offs), _pt(strides),
               _pt(pos), _pt(val))
        return pos[:n].copy(), val[:n].copy()


def run_coo_pooled(gather: "CsrGather", pool: np.ndarray, rs: np.ndarray,
                   rl: np.ndarray, cs: np.ndarray, cl: np.ndarray,
                   out_off: np.ndarray, out_stride: np.ndarray,
                   bound: "int | None" = None):
    """COO gather of many blocks whose row/col index vectors are segments of one
    shared ``pool`` (vectorized planner assembly: no per-block Python arrays).
    Returns (pos [nnz] int64, vals [nnz]).  ``bound`` caps the emitted pairs
    (callers that know their row segments can pass the exact row-nnz sum and
    skip the conservative whole-pool scan below)."""
    g = gather
    dt = np.complex128 if g.iscomplex else np.float64
    nblocks = len(rs)
    if nblocks == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=dt)
    pool = np.ascontiguousarray(pool, dtype=np.int64)
    args = [np.ascontiguousarray(a, dtype=np.int64)
            for a in (rs, rl, cs, cl, out_off, out_stride)]
    if not g.ok:
        poss, vals = [], []
        for k in range(nblocks):
            rows = pool[args[0][k]: args[0][k] + args[1][k]]
            cols = pool[args[2][k]: args[2][k] + args[3][k]]
            if len(rows) == 0 or len(cols) == 0:
                continue
            blk = g.A[rows][:, cols].tocoo()
            poss.append(args[4][k] + blk.row.astype(np.int64) * args[5][k] + blk.col)
            vals.append(blk.data.astype(dt))
        if not poss:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=dt)
        return np.concatenate(poss), np.concatenate(vals)
    if bound is None:
        counts = g.indptr[1:] - g.indptr[:-1]
        # every pool segment appears as block rows at most twice in the planner's
        # front layout (int rows of [ii, ib]; bnd rows of [bi, bb]; same for
        # branches)
        bound = 2 * int(np.sum(counts[pool])) if len(pool) else 0
    # reuse one geometrically-grown workspace per gather context: the bound
    # over-allocates ~2x, and fresh 100MB+ mmap'd buffers per batch made the
    # planner page-fault-bound at large N
    ws = getattr(g, "_coo_ws", None)
    if ws is None or len(ws[0]) < bound or ws[1].dtype != dt:
        cap_n = max(int(bound * 1.25), 1)
        ws = (np.empty(cap_n, dtype=np.int64), np.empty(cap_n, dtype=dt))
        g._coo_ws = ws
    pos, val = ws
    fn = _lib.csr_gather_coo_pooled_c128 if g.iscomplex else \
        _lib.csr_gather_coo_pooled_f64
    n = fn(*g.csr_ptrs, _pt(pool), *(_pt(a) for a in args), nblocks,
           g.colmap_ptr, _pt(pos), _pt(val))
    return pos[:n].copy(), val[:n].copy()


def csr_permute(A, perm: np.ndarray):
    """Symmetric CSR permutation ``A[perm][:, perm]`` (columns unsorted within rows -
    every consumer here is column-order agnostic).  Falls back to scipy fancy
    indexing without the native library."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    if not _load():
        return A[perm][:, perm].tocsr()
    n = A.shape[0]
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    relabel = np.empty(n, dtype=np.int64)
    relabel[perm] = np.arange(n, dtype=np.int64)
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int64)
    iscx = np.iscomplexobj(A.data)
    data = np.ascontiguousarray(A.data,
                                dtype=np.complex128 if iscx else np.float64)
    out_indptr = np.empty(n + 1, dtype=np.int64)
    out_indices = np.empty(A.nnz, dtype=np.int64)
    out_data = np.empty(A.nnz, dtype=data.dtype)
    fn = _lib.csr_permute_c128 if iscx else _lib.csr_permute_f64
    fn(_pt(indptr), _pt(indices), _pt(data), n, _pt(perm), _pt(relabel),
       _pt(out_indptr), _pt(out_indices), _pt(out_data))
    out = sp.csr_matrix((out_data, out_indices, out_indptr), shape=A.shape)
    out.has_sorted_indices = False
    return out


def csr_permute_raw(A, perm: np.ndarray, relabel: np.ndarray):
    """Like :func:`csr_permute` but returns the raw int64 CSR triple
    ``(indptr, indices, data)`` without constructing a scipy matrix (the
    constructor downcasts to int32, which :class:`CsrGather` would convert right
    back - two wasted passes per plan).  None without the native library."""
    if not _load():
        return None
    n = A.shape[0]
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    relabel = np.ascontiguousarray(relabel, dtype=np.int64)
    # scipy CSR carries int32 indices; cache the one-time int64 conversion on the
    # matrix object (planning the same A repeatedly re-paid two copy passes)
    cached = getattr(A, "_hsolve_csr64", None)
    if cached is None or cached[0] is not A.indptr or cached[1] is not A.indices:
        indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
        indices = np.ascontiguousarray(A.indices, dtype=np.int64)
        try:
            A._hsolve_csr64 = (A.indptr, A.indices, indptr, indices)
        except AttributeError:
            pass
    else:
        indptr, indices = cached[2], cached[3]
    iscx = np.iscomplexobj(A.data)
    data = np.ascontiguousarray(A.data,
                                dtype=np.complex128 if iscx else np.float64)
    out_indptr = np.empty(n + 1, dtype=np.int64)
    out_indices = np.empty(len(data), dtype=np.int64)
    out_data = np.empty(len(data), dtype=data.dtype)
    fn = _lib.csr_permute_c128 if iscx else _lib.csr_permute_f64
    fn(_pt(indptr), _pt(indices), _pt(data), n, _pt(perm), _pt(relabel),
       _pt(out_indptr), _pt(out_indices), _pt(out_data))
    return out_indptr, out_indices, out_data


def tree_postorder_native(left: np.ndarray, right: np.ndarray, root: int,
                          nnodes: int):
    """Post-order node walk (children first, left before right); None if the native
    library is unavailable."""
    if not _load():
        return None
    left = np.ascontiguousarray(left, dtype=np.int64)
    right = np.ascontiguousarray(right, dtype=np.int64)
    stack = np.empty(2 * nnodes + 2, dtype=np.int64)
    out = np.empty(nnodes, dtype=np.int64)
    c = _lib.tree_postorder(_pt(left), _pt(right), int(root), nnodes, _pt(stack),
                            _pt(out))
    return out[:c]


def run_front_gather(gather: "CsrGather", pool: np.ndarray, seg_ptr: np.ndarray,
                     seg_off: np.ndarray, seg_len: np.ndarray, seg_tag: np.ndarray,
                     seg_fo: np.ndarray, node_base: np.ndarray, m_pad: int,
                     copy: bool = True, bound: int = None):
    """Fused per-node front COO gather (one pass over each front row's nonzeros;
    leaves keep all mapped entries, branches only cross-child ones).  Returns
    (pos, vals); with ``copy=False`` they are views into a per-context workspace,
    valid only until the next gather call on the same context.  ``bound``: caller-
    provided emitted-pair upper bound (nnz of the gathered rows); computed from the
    pool when absent."""
    g = gather
    dt = np.complex128 if g.iscomplex else np.float64
    args = [np.ascontiguousarray(a, dtype=np.int64)
            for a in (pool, seg_ptr, seg_off, seg_len, seg_tag, seg_fo, node_base)]
    if bound is None:
        counts = g.indptr[1:] - g.indptr[:-1]
        bound = int(np.sum(counts[args[0]])) if len(args[0]) else 0
    ws = getattr(g, "_coo_ws", None)
    if ws is None or len(ws[0]) < bound or ws[1].dtype != dt:
        cap_n = max(int(bound * 1.25), 1)
        ws = (np.empty(cap_n, dtype=np.int64), np.empty(cap_n, dtype=dt))
        g._coo_ws = ws
    pos, val = ws
    if not hasattr(g, "_coltag"):
        g._coltag = np.zeros(g.ncols, dtype=np.int64)
    fn = _lib.csr_gather_front_c128 if g.iscomplex else _lib.csr_gather_front_f64
    n = fn(*g.csr_ptrs, *(_pt(a) for a in args), len(node_base), m_pad,
           g.colmap_ptr, _pt(g._coltag), _pt(pos), _pt(val))
    if copy:
        return pos[:n].copy(), val[:n].copy()
    return pos[:n], val[:n]


def run_front_gather_ident(gather: "CsrGather", pool: np.ndarray,
                           seg_ptr: np.ndarray, seg_off: np.ndarray,
                           seg_len: np.ndarray, seg_tag: np.ndarray,
                           seg_fo: np.ndarray, node_base: np.ndarray,
                           m_pad: int, ni: np.ndarray, B: int, ni_pad: int,
                           bound: "int | None" = None):
    """Fused front COO gather + identity-padding fill, positions written int32
    (requires B * m_pad^2 < 2^31; the planner falls back to
    :func:`run_front_gather` + fill_ident_pos_native otherwise).  Returns freshly
    allocated exact-size (pos int32, vals) arrays - the planner's previous
    workspace-copy + concatenate + astype(int32) epilogue made three more passes
    over these multi-100k-entry buffers."""
    g = gather
    dt = np.complex128 if g.iscomplex else np.float64
    B0 = len(node_base)
    args = [np.ascontiguousarray(a, dtype=np.int64)
            for a in (pool, seg_ptr, seg_off, seg_len, seg_tag, seg_fo,
                      node_base, ni)]
    if bound is None:
        counts = g.indptr[1:] - g.indptr[:-1]
        bound = int(np.sum(counts[args[0]])) if len(args[0]) else 0
    cap = bound + int(np.sum(ni_pad - args[7][:B0])) + (B - B0) * ni_pad
    ws = getattr(g, "_fi_ws", None)
    if ws is None or len(ws[0]) < cap or ws[1].dtype != dt:
        cap_n = max(int(cap * 1.25), 1)
        ws = (np.empty(cap_n, dtype=np.int32), np.empty(cap_n, dtype=dt))
        g._fi_ws = ws
    pos, val = ws
    if not hasattr(g, "_coltag"):
        g._coltag = np.zeros(g.ncols, dtype=np.int64)
    fn = _lib.csr_gather_front_ident_c128 if g.iscomplex else \
        _lib.csr_gather_front_ident_f64
    n = fn(*g.csr_ptrs, *(_pt(a) for a in args[:7]), B0, m_pad, g.colmap_ptr,
           _pt(g._coltag), _pt(args[7]), B, ni_pad, _pt(pos), _pt(val))
    return pos[:n].copy(), val[:n].copy()


def plan_batches_all_native(gather: "CsrGather", reqs):
    """Regular-batch planning for a whole plan: ONE ctypes crossing emits every
    batch's front COO (int32 positions, identity padding included) and fills
    its int32 device maps (gather.cpp plan_batches_all).  Each request dict
    carries the per-batch arguments (``o_int/o_bnd/ni/nb/branch/lo/lsum/B/
    ni_pad/nb_pad/bound``) plus the caller-allocated int32 map outputs
    (``int_ids/bnd_ids/sperm/map_l/map_r``), which are filled in place.
    Returns a list of (front_pos, front_vals, front_src) views into shared COO
    buffers (kept alive by the returned arrays); ``front_src`` holds per-entry
    source indices into the CSR data array (-1 for identity padding), enabling
    the device-resident value gather in the numeric phase."""
    g = gather
    dt = np.complex128 if g.iscomplex else np.float64
    nb_ = len(reqs)
    meta = np.empty((nb_, 6), dtype=np.int64)
    outp = np.zeros((nb_, 5), dtype=np.uint64)
    pos_off = np.empty(nb_ + 1, dtype=np.int64)
    pos_off[0] = 0
    cat = {k: [] for k in ("o_int", "o_bnd", "ni", "nb", "ni1", "ni2",
                           "nb1", "nb2", "lo", "lsum")}
    no = 0
    for i, r in enumerate(reqs):
        B0, B = r["B0"], r["B"]
        meta[i] = (no, B0, B, r["ni_pad"], r["nb_pad"],
                   0 if r["branch"] is None else 1)
        for k in ("o_int", "o_bnd", "ni", "nb", "lo", "lsum"):
            cat[k].append(np.ascontiguousarray(r[k], dtype=np.int64))
        if r["branch"] is None:
            z = np.zeros(B0, dtype=np.int64)
            for k in ("ni1", "ni2", "nb1", "nb2"):
                cat[k].append(z)
        else:
            for k, v in zip(("ni1", "ni2", "nb1", "nb2"), r["branch"]):
                cat[k].append(np.ascontiguousarray(v, dtype=np.int64))
        for j, k in enumerate(("int_ids", "bnd_ids", "sperm", "map_l",
                               "map_r")):
            a = r.get(k)
            if a is not None:
                outp[i, j] = a.ctypes.data
        cap = (r["bound"] + int(np.sum(r["ni_pad"] - cat["ni"][-1][:B0]))
               + (B - B0) * r["ni_pad"])
        pos_off[i + 1] = pos_off[i] + cap
        no += B0
    flat = {k: (np.concatenate(v) if v else np.zeros(1, dtype=np.int64))
            for k, v in cat.items()}
    total = int(pos_off[-1])
    pos = np.empty(max(total, 1), dtype=np.int32)
    val = np.empty(max(total, 1), dtype=dt)
    src = np.empty(max(total, 1), dtype=np.int32)
    counts = np.empty(nb_, dtype=np.int64)
    if not hasattr(g, "_coltag"):
        g._coltag = np.zeros(g.ncols, dtype=np.int64)
    # every regular batch references the one plan-level pooled symfact layout;
    # the native call reads only reqs[0]'s pools, so differing per-request pools
    # would silently corrupt the COO output
    assert all(r["pool"] is reqs[0]["pool"] and
               r["locpool"] is reqs[0]["locpool"] for r in reqs), \
        "plan_batches_all_native requires one shared pool/locpool across requests"
    pool = np.ascontiguousarray(reqs[0]["pool"], dtype=np.int64)
    locpool = np.ascontiguousarray(reqs[0]["locpool"], dtype=np.int64)
    # the int32 per-entry source indices cannot address nnz >= 2^31: skip
    # emitting them (callers fall back to the host-shipped vals path)
    emit_src = int(g.indptr[-1]) < 2 ** 31
    fn = _lib.plan_batches_all_c128 if g.iscomplex else \
        _lib.plan_batches_all_f64
    fn(*g.csr_ptrs, _pt(pool), _pt(locpool), nb_, _pt(meta),
       _pt(flat["o_int"]), _pt(flat["o_bnd"]), _pt(flat["ni"]),
       _pt(flat["nb"]), _pt(flat["ni1"]), _pt(flat["ni2"]), _pt(flat["nb1"]),
       _pt(flat["nb2"]), _pt(flat["lo"]), _pt(flat["lsum"]), gather.ncols,
       g.colmap_ptr, _pt(g._coltag), _pt(pos_off), _pt(pos), _pt(val),
       _pt(src) if emit_src else 0, _pt(outp), _pt(counts))
    out = []
    for i in range(nb_):
        o, c = int(pos_off[i]), int(counts[i])
        out.append((pos[o:o + c], val[o:o + c],
                    src[o:o + c] if emit_src else None))
    return out


def symfact_pooled_native(left: np.ndarray, right: np.ndarray, root: int,
                          order: np.ndarray, iptr: np.ndarray, ipool: np.ndarray,
                          bptr: np.ndarray, bpool: np.ndarray, ndofs: int):
    """Pooled symbolic factorization (see gather.cpp symfact_pooled); None if the
    native library is unavailable.  Returns (vals_pool, vals_off, n_int, n_bnd,
    loc_pool, loc_off, loc_icnt) with every node's [int; bnd] / [int_loc; bnd_loc]
    contiguous in the respective pool."""
    if not _load():
        return None
    n = len(left)
    args = [np.ascontiguousarray(a, dtype=np.int64)
            for a in (left, right, order, iptr, ipool, bptr, bpool)]
    elim = np.empty(ndofs, dtype=np.int64)
    vals_cap = int(iptr[-1] + bptr[-1])
    loc_cap = int(bptr[-1])
    vals_pool = np.empty(max(vals_cap, 1), dtype=np.int64)
    loc_pool = np.empty(max(loc_cap, 1), dtype=np.int64)
    vals_off = np.empty(n, dtype=np.int64)
    n_int = np.empty(n, dtype=np.int64)
    n_bnd = np.empty(n, dtype=np.int64)
    loc_off = np.empty(n, dtype=np.int64)
    loc_icnt = np.empty(n, dtype=np.int64)
    rc = _lib.symfact_pooled(
        _pt(args[0]), _pt(args[1]), int(root), n, _pt(args[2]), _pt(args[3]),
        _pt(args[4]), _pt(args[5]), _pt(args[6]), ndofs, _pt(elim), vals_cap,
        _pt(vals_pool), _pt(vals_off), _pt(n_int), _pt(n_bnd), loc_cap,
        _pt(loc_pool), _pt(loc_off), _pt(loc_icnt))
    if rc != 0:
        raise ValueError(
            "symfact: tree index sets inconsistent (a branch's int+bnd does not "
            "match the union of its children's boundaries); run NDTree.validate()")
    return vals_pool, vals_off, n_int, n_bnd, loc_pool, loc_off, loc_icnt


def fill_batch_maps_native(pool, o_int, o_bnd, ni, nb, locpool, lo, lsum,
                           branch, ni_pad, nb_pad, N, int_ids, bnd_ids, sperm,
                           map_l, map_r) -> None:
    """One C++ sweep filling rows [0, B0) of a batch's int32 device maps (see
    gather.cpp fill_batch_maps).  ``branch``: (ni1, ni2, nb1, nb2) or None for
    leaf batches (map_l/map_r are then ignored)."""
    B0 = len(o_int)
    a = [np.ascontiguousarray(x, dtype=np.int64)
         for x in (o_int, o_bnd, ni, nb, lo, lsum)]
    if branch is not None:
        br = [np.ascontiguousarray(x, dtype=np.int64) for x in branch]
        bp = [_pt(x) for x in br]
        mlp, mrp = _pt(map_l), _pt(map_r)
    else:
        bp = [0, 0, 0, 0]
        mlp = mrp = 0
    _lib.fill_batch_maps(_pt(pool), _pt(a[0]), _pt(a[1]), _pt(a[2]), _pt(a[3]),
                         _pt(locpool), _pt(a[4]), _pt(a[5]), *bp, B0, ni_pad,
                         nb_pad, N, _pt(int_ids), _pt(bnd_ids), _pt(sperm),
                         mlp, mrp)


def fill_ident_pos_native(ni: np.ndarray, B0: int, B: int, ni_pad: int,
                          m_pad: int) -> np.ndarray:
    """Identity-diagonal COO positions for padded pivot rows (int64)."""
    ni = np.ascontiguousarray(ni, dtype=np.int64)
    cap = int(np.sum(ni_pad - ni[:B0])) + (B - B0) * ni_pad
    out = np.empty(max(cap, 1), dtype=np.int64)
    c = _lib.fill_ident_pos(_pt(ni), B0, B, ni_pad, m_pad, _pt(out))
    return out[:c]


def fill_structured_maps_native(pool, locpool, off_n, ki1, ki2, kb1, kb2,
                                o_l, k1, k2, B0, h1, h2, q1, q2, np_pad,
                                half, N, int_ids, bnd_ids, smap) -> bool:
    """One C++ sweep filling a structured batch's int/bnd id maps and its
    parent-S smap (gather.cpp fill_structured_maps); False if unavailable."""
    if not _load():
        return False
    a = [np.ascontiguousarray(x, dtype=np.int64)
         for x in (off_n, ki1, ki2, kb1, kb2, o_l, k1, k2)]
    _lib.fill_structured_maps(
        _pt(pool), _pt(locpool), *(_pt(x) for x in a), B0, h1, h2, q1, q2,
        np_pad, half, N, _pt(int_ids), _pt(bnd_ids), _pt(smap))
    return True


def coo_to_strip_native(pos: np.ndarray, B: int, r: int, c: int,
                        pad: int = 8):
    """Cross-coupling strip layout from one sorted batched COO stream (see
    gather.cpp strip_nrows/strip_fill): returns (rows_idx [B, rcap] int32,
    strip_pos [n] int64, rcap), or None if the native library is missing.
    ``pos`` must be sorted by (b, row, col) - the pooled gather's order."""
    if not _load():
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    n = len(pos)
    nrows = int(_lib.strip_nrows(_pt(pos), n, r, c)) if n else 0
    rcap = -(-max(nrows, 1) // pad) * pad
    rcap = min(rcap, max(r, 1))
    rows_idx = np.empty((B, rcap), dtype=np.int32)
    strip_pos = np.empty(n, dtype=np.int64)
    _lib.strip_fill(_pt(pos), n, B, r, c, rcap, _pt(rows_idx), _pt(strip_pos))
    return rows_idx, strip_pos, rcap


def available() -> bool:
    return bool(_load())
