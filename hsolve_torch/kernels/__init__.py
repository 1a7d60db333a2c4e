"""Build and binding of the port's hand-written CUDA kernels.

``nvcc`` compiles every ``hsolve_torch/csrc/*.cu`` for Hopper (``sm_90a``), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, ``build/hsolve_torch/
libhsolve_kernels.so``, at first use; it rebuilds when a source is newer than
the library.  ``ctypes`` loads it: every pointer and the stream pass as
``c_void_p``, and each entry point returns ``cudaGetLastError()``, which
:func:`launch` turns into an exception.

The Python wrappers, each beside its plain torch version, live with the code
they serve:

- ``front_assemble`` (kernel A) and ``extend_add`` (kernel B) in
  :mod:`hsolve_torch.ops.assembly`,
- ``level_forward`` and ``sweep_update`` (kernel C: a dense level's forward
  step with its pivot solve, and its backward step) and
  ``lowrank_sweep_update`` (kernel E) in :mod:`hsolve_torch.ops.sweep`,
- ``dia_spmv`` (kernel D) in :mod:`hsolve_torch.ops.sparse`,
- ``lowrank_schur_update`` (kernel F) in :mod:`hsolve_torch.ops.schur`,
- ``lowrank_truncate`` (kernel G) and ``cpqr_pivots`` (kernel H) in
  :mod:`hsolve_torch.ops.lowrank`,
- ``hss_entries_prepared`` (kernel I), ``hss_matvec`` (kernel J) and
  ``hss_level_correct`` (kernel K) in :mod:`hsolve_torch.ops.hss`,
- ``arnoldi_cgs2`` (kernel L), ``arnoldi_givens`` (kernel M) and
  ``arnoldi_step`` (L's launch with M's step as its tail, the GMRES loop's
  step) in :mod:`hsolve_torch.ops.arnoldi`,
- the GMRES loop's control kernels ``gmres_init``, ``gmres_cycle_start``,
  ``gmres_cycle_end``, ``gmres_escalate`` and ``gmres_set_cond`` (the
  condition of a WHILE node), with the composition of a solve as one CUDA
  graph (``hs_gmres_graph``), in :mod:`hsolve_torch.ops.gmres_control`.

Kernels A-D, L and M run on every path; E, F and G on the compressed levels;
H-K on the structured (HSS) levels, which also run E on their low-rank
transforms.  A-D, L and M take float32, float64, complex64 or complex128
values (one C entry point per type, ``hs_<name>``, ``hs_<name>_f32``,
``_c64`` and ``_c128``; the complex kernels use the value traits of
``csrc/hs_complex.cuh``); E-K take float64, float32 or complex128
(``hs_<name>``, ``hs_<name>_f32`` and ``hs_<name>_c128``: the float32 ones
serve the JAX bench's device configuration, a float32 factor on compressed
and structured levels; E sums in float64 and rounds once, as C's float32
sweep, H runs its pivot loop and K its solve in float64 on float32
operands; F, G, J and K take float32 and complex128 on the CUDA cores, no
TF32, K as one kernel for every k); the control kernels the
solution's type (the cycle start also float32 cycles in a float64 solve,
``hs_gmres_cycle_start_mixed``, and complex64 cycles in a complex128 one,
``hs_gmres_cycle_start_mixed_c``).  Kernel C's
forward step of a wide front runs on a thread block cluster
(``cudaLaunchKernelEx``), and so do kernel E where a launch's few fronts
leave SMs idle, kernel J where a level's few matrices do, and kernel K with
several right-hand sides, whose operand tiles are TMA boxes of tensor maps
(encoded through the driver entry point the runtime hands out: no link to
libcuda); kernel L is one cooperative launch
(``cudaLaunchCooperativeKernel``) with grid barriers, which raises when the
card cannot hold its grid at once; kernel F's top levels share a row band's
``Abi RU`` across a thread block cluster.

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  Each wrapper counts its launches in
a plain integer attribute, ``wrapper.launches``; the wrappers of A-M
and the control kernels also count them per value type in
``wrapper.launches_by_type`` (:func:`count_launch`).  A wrapper called while
a solve's parts are captured into a CUDA graph counts at capture; the graph
keeps those counts per part and :func:`launch_counts` multiplies them by
the replays, cycles and steps the device summed
(``ops.gmres_control.SolveGraph.fold_counts``), so the counts stay launches
that ran.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import subprocess
import time
from typing import Dict

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(os.path.dirname(_PKG), "build", "hsolve_torch")
LIB = os.path.join(BUILD, "libhsolve_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_V, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_D = ctypes.c_double
_SIGNATURES = {
    "hs_front_assemble": [_V, _V, _V, _V, _LL, _V],
    "hs_extend_add": [_V] * 5 + [_I] * 5 + [_V],
    "hs_level_forward": [_V] * 7 + [_LL] + [_I] * 5 + [_V],
    "hs_level_forward_windowed": [_V] * 9 + [_LL] + [_I] * 4 + [_V],
    "hs_sweep_update": [_V] * 4 + [_LL] + [_I] * 5 + [_V],
    "hs_dia_spmv": [_V, _V, _V, _V, _V, _I, _LL, _I, _V],
    "hs_lowrank_sweep_update": [_V] * 6 + [_LL] + [_I] * 12 + [_LL, _V],
    "hs_lowrank_schur_update": [_V] * 5 + [_LL] + [_I] * 9 + [_V],
    "hs_lowrank_truncate": [_V] * 7 + [_D, _D, _LL] + [_I] * 5 + [_V],
    "hs_cpqr": [_V, _V, _V, _V, _D, _D, _LL, _I, _I, _I, _I, _V],
    "hs_hss_entries": [_V] * 6 + [_LL] * 7 + [_I] * 7 + [_V],
    "hs_hss_matvec": [_V] * 10 + [_LL] + [_I] * 12 + [_LL, _I, _V],
    "hs_hss_level_correct": [_V] * 7 + [_LL] + [_I] * 8 + [_V],
    "hs_hss_level_correct_clusters": [_I] * 4,
    "hs_arnoldi_cgs2": [_V, _V, _V, _V, _V, _I, _LL, _I, _V],
    "hs_arnoldi_givens": [_V] * 8 + [_I, _I, _D, _I, _V],
    "hs_arnoldi_step": [_V] * 14 + [_LL, _I, _I, _V],
    "hs_gmres_init": [_V, _V, _V, _I, _V],
    "hs_gmres_cycle_start": [_V] * 11 + [_LL, _I, _D, _V],
    "hs_gmres_cycle_end": [_V, _V, _V, _I, _V],
    "hs_gmres_escalate": [_V, _V, _V],
    "hs_gmres_graph": [_I, _V, _V, _V, _V],
    "hs_gmres_graph_launch": [_V, _V],
    "hs_gmres_graph_destroy": [_V, _V],
}
# A-D, L, M and the control kernels also take float32: the same signature
# under ``<name>_f32``
TYPED = ("hs_front_assemble", "hs_extend_add", "hs_level_forward",
         "hs_level_forward_windowed", "hs_sweep_update", "hs_dia_spmv",
         "hs_arnoldi_cgs2", "hs_arnoldi_givens", "hs_arnoldi_step",
         "hs_gmres_init", "hs_gmres_cycle_start", "hs_gmres_cycle_end",
         "hs_gmres_escalate")
_SIGNATURES.update({f"{name}_f32": _SIGNATURES[name] for name in TYPED})
_SIGNATURES["hs_gmres_cycle_start_mixed"] = _SIGNATURES["hs_gmres_cycle_start"]
# ... and complex64 / complex128 (``_c64`` / ``_c128``, values interleaved
# (re, im) as torch stores them), all but the run's start, the cycle end and
# the escalation, which read and write only the solve's real scalars
_SIGNATURES.update({f"{name}{sfx}": _SIGNATURES[name] for name in TYPED
                    if name not in ("hs_gmres_init", "hs_gmres_cycle_end",
                                    "hs_gmres_escalate")
                    for sfx in ("_c64", "_c128")})
_SIGNATURES["hs_gmres_cycle_start_mixed_c"] = _SIGNATURES["hs_gmres_cycle_start"]
# E-K take float64, float32 or complex128 (the compressed and structured
# levels' types)
LOWRANK_TYPED = ("hs_lowrank_sweep_update", "hs_lowrank_schur_update",
                 "hs_lowrank_truncate", "hs_cpqr", "hs_hss_entries",
                 "hs_hss_matvec", "hs_hss_level_correct")
_SIGNATURES.update({f"{name}{sfx}": _SIGNATURES[name]
                    for name in LOWRANK_TYPED for sfx in ("_f32", "_c128")})
LOWRANK_TYPES = (torch.float64, torch.float32, torch.complex128)
VALUE_TYPES = (torch.float32, torch.float64, torch.complex64,
               torch.complex128)
_SUFFIX = {torch.float64: "", torch.float32: "_f32", torch.complex64: "_c64",
           torch.complex128: "_c128"}

_lib = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB):
        return True
    deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return os.path.getmtime(LIB) < max(os.path.getmtime(p) for p in deps)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc "
                           "on PATH); the CUDA kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(force: bool = False) -> Dict[str, object]:
    """Compile the kernels if stale (or ``force``).  Returns
    ``{"built": bool, "seconds": float, "log": str}``; ``log`` holds nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills per kernel)."""
    if not force and not _stale():
        return {"built": False, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    tmp = f"{LIB}.{tag}.tmp"
    t0 = time.perf_counter()
    jobs, objs = [], []
    for src in sources():
        obj = os.path.join(BUILD, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
        objs.append(obj)
    log = []
    try:
        for cmd, proc in jobs:
            out, _ = proc.communicate(timeout=900)
            log.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                                   f"{' '.join(cmd)}\n{out}")
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    finally:
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, LIB)
    return {"built": True, "seconds": time.perf_counter() - t0,
            "log": "".join(log)}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if missing or stale)."""
    global _lib
    if _lib is None:
        build()
        handle = ctypes.CDLL(LIB)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.hs_error_string.argtypes = [ctypes.c_int]
        handle.hs_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call ``name`` with ``args`` and the current stream of ``device``; raise
    if the launch was refused."""
    handle = lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(handle, name)(*args, stream)
    if rc != 0:
        raise_launch_error(name, rc)


def raise_launch_error(name: str, rc: int) -> None:
    """Raise for entry point ``name``'s return code ``rc`` (not 0)."""
    msg = lib().hs_error_string(rc).decode()
    raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (cached: a wrapper asks at every
    launch)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def resolve_device(device) -> torch.device:
    """The explicit device of an entry point; asking for a CUDA device that
    is not there raises (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={str(device)!r} requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrappers then run their plain
    versions); False when all lie on one CUDA device; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Check a kernel operand: dtype, contiguity and (where given) shape."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype} (the CUDA "
                        "kernels take int32 indices, and one value type per "
                        "call: float32, float64, complex64 or complex128 for "
                        "A-D, L and M, float64, float32 or complex128 for "
                        "E-K)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.is_conj() or t.is_neg():
        # a lazy view: its memory holds the values unconjugated / unnegated
        raise ValueError(f"{name}: a lazily conjugated or negated view "
                         "(resolve_conj() / resolve_neg() first)")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def value_type(*tensors: torch.Tensor) -> torch.dtype:
    """The one value type of a typed kernel's (A-D, L, M) value operands:
    float32, float64, complex64 or complex128, shared by all of them; raises
    ``TypeError`` otherwise."""
    types = {t.dtype for t in tensors}
    if len(types) != 1 or not types <= set(VALUE_TYPES):
        raise TypeError(f"value operands of types {sorted(map(str, types))}: "
                        "the kernel takes one type per call, float32, "
                        "float64, complex64 or complex128")
    return types.pop()


def materialized(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a kernel reads it: contiguous, with any lazy conjugation
    applied to its memory (``torch.linalg.svd`` on the card may return ``Vh``
    as a conjugated view of V, whose memory holds V's values)."""
    return t.resolve_conj().contiguous()


def lowrank_type(*tensors: torch.Tensor) -> torch.dtype:
    """The one value type of the value operands of a kernel of E-K: float64,
    float32 or complex128, shared by all of them; raises ``TypeError``
    otherwise."""
    types = {t.dtype for t in tensors}
    if len(types) != 1 or not types <= set(LOWRANK_TYPES):
        raise TypeError(f"value operands of types {sorted(map(str, types))}: "
                        "kernels E-K take one type per call, float64, "
                        "float32 or complex128")
    return types.pop()


def symbol(name: str, dtype: torch.dtype) -> str:
    """The C entry point of typed kernel ``name`` for ``dtype``."""
    return name + _SUFFIX[dtype]


def count_launch(fn, dtype: torch.dtype) -> None:
    """Count one launch of wrapper ``fn`` in value type ``dtype``."""
    fn.launches += 1
    key = str(dtype).replace("torch.", "")
    fn.launches_by_type[key] = fn.launches_by_type.get(key, 0) + 1


# the GMRES loop's control kernels on every path (the escalation's on the
# mixed one); gmres_set_cond runs only inside a solve's graph
CONTROL = ("gmres_init", "gmres_cycle_start", "gmres_cycle_end",
           "gmres_set_cond")
EXACT_PATH = ("front_assemble", "extend_add", "level_forward", "sweep_update",
              "dia_spmv", "arnoldi_cgs2", "arnoldi_givens",
              "arnoldi_step") + CONTROL
COMPRESSED_PATH = EXACT_PATH + ("lowrank_sweep_update", "lowrank_schur_update",
                                "lowrank_truncate")
HSS_PATH = COMPRESSED_PATH + ("cpqr_pivots", "hss_entries_prepared",
                              "hss_matvec", "hss_level_correct")
# the float32 factor with mixed-precision GMRES: A-C and the inner matvec in
# float32, the outer residual in float64, the inner cycles' steps (L with M
# as its tail) and their cycle starts in float32, the loop in float64, and
# the escalation
MIXED_PATH = ("front_assemble:float32", "extend_add:float32",
              "level_forward:float32", "sweep_update:float32",
              "dia_spmv:float32", "dia_spmv:float64", "arnoldi_cgs2:float32",
              "arnoldi_givens:float32", "arnoldi_step:float32",
              "gmres_init:float64", "gmres_cycle_start:float32",
              "gmres_cycle_end:float64", "gmres_escalate:float64",
              "gmres_set_cond")
# the complex (damped Helmholtz) exact path in complex128: A-D, the step and
# the cycle start in complex128; the run's start and the cycle end touch only
# the solve's real scalars (sc, hist), so they count in float64
COMPLEX_PATH = ("front_assemble:complex128", "extend_add:complex128",
                "level_forward:complex128", "sweep_update:complex128",
                "dia_spmv:complex128", "arnoldi_cgs2:complex128",
                "arnoldi_givens:complex128", "arnoldi_step:complex128",
                "gmres_init:float64", "gmres_cycle_start:complex128",
                "gmres_cycle_end:float64", "gmres_set_cond")
# the damped system on low-rank compressed levels (hss=False) in complex128:
# the exact path's kernels and E, F and G in complex128
COMPLEX_LOWRANK_PATH = COMPLEX_PATH + ("lowrank_sweep_update:complex128",
                                       "lowrank_schur_update:complex128",
                                       "lowrank_truncate:complex128")
# ... and on structured (HSS) levels (hss=True): H-K in complex128 as well
COMPLEX_HSS_PATH = COMPLEX_LOWRANK_PATH + ("cpqr_pivots:complex128",
                                           "hss_entries_prepared:complex128",
                                           "hss_matvec:complex128",
                                           "hss_level_correct:complex128")
# the JAX bench's device configuration on compressed levels: the mixed
# path's kernels over a float32 factor whose low-rank levels (hss=False)
# run E, F and G in float32
LOWRANK_MIXED_PATH = MIXED_PATH + ("lowrank_sweep_update:float32",
                                   "lowrank_schur_update:float32",
                                   "lowrank_truncate:float32")
# ... and whose structured levels (hss=True, the default, and the bench's:
# it has no hss switch) run H-K in float32 as well
HSS_MIXED_PATH = LOWRANK_MIXED_PATH + ("cpqr_pivots:float32",
                                       "hss_entries_prepared:float32",
                                       "hss_matvec:float32",
                                       "hss_level_correct:float32")
# the bench's complex device configuration: a complex64 factor, complex64
# cycles over a complex64 operator inside a complex128 solve, escalation on
COMPLEX_MIXED_PATH = ("front_assemble:complex64", "extend_add:complex64",
                      "level_forward:complex64", "sweep_update:complex64",
                      "dia_spmv:complex64", "dia_spmv:complex128",
                      "arnoldi_cgs2:complex64", "arnoldi_givens:complex64",
                      "arnoldi_step:complex64", "gmres_init:float64",
                      "gmres_cycle_start:complex64", "gmres_cycle_end:float64",
                      "gmres_escalate:float64", "gmres_set_cond")


def wrappers():
    """The kernel wrappers, by name (A-M; C has two, ``level_forward`` and
    ``sweep_update``), ``arnoldi_step``, the launch of L with M's step as
    its tail (it also counts one launch of L and one of M), the control
    kernels and ``gmres_graph`` (the host's launches of solve graphs)."""
    from hsolve_torch.ops.arnoldi import (arnoldi_cgs2, arnoldi_givens,
                                          arnoldi_step)
    from hsolve_torch.ops.assembly import extend_add, front_assemble
    from hsolve_torch.ops.gmres_control import (gmres_cycle_end,
                                                gmres_cycle_start,
                                                gmres_escalate, gmres_graph,
                                                gmres_init, gmres_set_cond)
    from hsolve_torch.ops.hss import (hss_entries_prepared, hss_level_correct,
                                      hss_matvec)
    from hsolve_torch.ops.lowrank import cpqr_pivots, lowrank_truncate
    from hsolve_torch.ops.schur import lowrank_schur_update
    from hsolve_torch.ops.sparse import dia_spmv
    from hsolve_torch.ops.sweep import (level_forward, lowrank_sweep_update,
                                        sweep_update)

    return {"front_assemble": front_assemble, "extend_add": extend_add,
            "level_forward": level_forward, "sweep_update": sweep_update,
            "dia_spmv": dia_spmv,
            "lowrank_sweep_update": lowrank_sweep_update,
            "lowrank_schur_update": lowrank_schur_update,
            "lowrank_truncate": lowrank_truncate, "cpqr_pivots": cpqr_pivots,
            "hss_entries_prepared": hss_entries_prepared,
            "hss_matvec": hss_matvec, "hss_level_correct": hss_level_correct,
            "arnoldi_cgs2": arnoldi_cgs2, "arnoldi_givens": arnoldi_givens,
            "arnoldi_step": arnoldi_step, "gmres_init": gmres_init,
            "gmres_cycle_start": gmres_cycle_start,
            "gmres_cycle_end": gmres_cycle_end,
            "gmres_escalate": gmres_escalate,
            "gmres_set_cond": gmres_set_cond, "gmres_graph": gmres_graph}


def snapshot_counts() -> Dict[str, int]:
    """The wrappers' counts as they stand (no solve graph folded)."""
    out = {}
    for name, fn in wrappers().items():
        out[name] = fn.launches
        for key, n in getattr(fn, "launches_by_type", {}).items():
            out[f"{name}:{key}"] = n
    return out


def restore_counts(snap: Dict[str, int]) -> None:
    """Set the wrappers' counts back to a :func:`snapshot_counts`."""
    for name, fn in wrappers().items():
        fn.launches = snap.get(name, 0)
        if hasattr(fn, "launches_by_type"):
            fn.launches_by_type = {k.split(":", 1)[1]: v
                                   for k, v in snap.items()
                                   if k.startswith(f"{name}:")}


def counts_delta(before: Dict[str, int], after: Dict[str, int]
                 ) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def add_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (names and ``name:type`` keys) to the wrappers'."""
    fns = wrappers()
    for key, n in counts.items():
        name, _, typ = key.partition(":")
        if typ:
            d = fns[name].launches_by_type
            d[typ] = d.get(typ, 0) + n
        else:
            fns[name].launches += n


def launch_counts() -> Dict[str, int]:
    """Launches per wrapper, and per ``"<name>:<value type>"`` for the typed
    ones, the replays of live solve graphs folded in first (a host read of
    each graph's device-side sums)."""
    from hsolve_torch.ops.gmres_control import fold_all_counts

    fold_all_counts()
    return snapshot_counts()


def reset_launch_counts() -> None:
    from hsolve_torch.ops.gmres_control import zero_all_counts

    zero_all_counts()
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_type"):
            fn.launches_by_type = {}
