"""Build and binding of the port's hand-written CUDA kernels.

``nvcc`` compiles every ``hsolve_torch/csrc/*.cu`` for Hopper (``sm_90a``) into
one shared library with a plain C interface, ``build/hsolve_torch/
libhsolve_kernels.so``, at first use; it rebuilds when a source is newer than
the library.  ``ctypes`` loads it: every pointer and the stream pass as
``c_void_p``, and each entry point returns ``cudaGetLastError()``, which
:func:`launch` turns into an exception.

The Python wrappers, each beside its plain torch version, live with the code
they serve:

- ``front_assemble`` (kernel A) and ``extend_add`` (kernel B) in
  :mod:`hsolve_torch.ops.assembly`,
- ``sweep_update`` (kernel C) in :mod:`hsolve_torch.ops.sweep`,
- ``dia_spmv`` (kernel D) in :mod:`hsolve_torch.ops.sparse`.

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  Each wrapper counts its launches in
a plain integer attribute, ``wrapper.launches``.
"""

from __future__ import annotations

import ctypes
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_V, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "hs_front_assemble": [_V, _V, _V, _V, _LL, _V],
    "hs_extend_add": [_V, _V, _V, _V, _V, _I, _I, _I, _V],
    "hs_sweep_update": [_V, _V, _V, _V, _V, _LL, _I, _I, _I, _I, _V],
    "hs_dia_spmv": [_V, _V, _V, _V, _V, _I, _LL, _I, _V],
}

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
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIB)
    return {"built": True, "seconds": seconds, "log": proc.stdout + proc.stderr}


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
        msg = handle.hs_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


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
                        "kernels take float64 values and int32 indices)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def wrappers():
    """The four kernel wrappers, by name."""
    from hsolve_torch.ops.assembly import extend_add, front_assemble
    from hsolve_torch.ops.sparse import dia_spmv
    from hsolve_torch.ops.sweep import sweep_update

    return {"front_assemble": front_assemble, "extend_add": extend_add,
            "sweep_update": sweep_update, "dia_spmv": dia_spmv}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
