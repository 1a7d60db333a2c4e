#!/usr/bin/env python3
"""Where kernel K's time goes for k > 1 (``csrc/hss_level_correct.cu``'s
block kernel), on one NVIDIA GPU, and what its launch geometry costs.

Builds four copies of the kernel source into ``build/k_breakdown/``: as it
is, without the diagonal-block solves, without the tile products, and
without both (what is left is the tile pipeline: the TMA boxes, the
barriers and the bookkeeping).  Each copy runs on the same random operands
at a few level shapes of the default-caps n=512 structured factor, with the
geometry the wrapper picks, timed on the device (CUDA events, back to back);
the plain torch version runs beside them.  The copies without a part compute
wrong values: only their times are read.  Then the kernel as it is runs at
each shape in three geometries: the wrapper's, one cluster per node of up
to 16 CTAs of the most columns the value type takes (32, complex 16), and
that many columns a CTA with no cluster.  ``--dtype`` picks the value type
(float64 by default; float32, complex64 and complex128 run the same kernel
templated on the value, computing in float64 or complex128).  Run from the
repository root:

    python3 tools/k_breakdown.py [--dtype float32 complex64 ...]
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hsolve_torch.ops import dense as dk  # noqa: E402
from hsolve_torch.ops import hss as H  # noqa: E402

SRC = os.path.join(ROOT, "hsolve_torch", "csrc", "hss_level_correct.cu")
OUT = os.path.join(ROOT, "build", "k_breakdown")
# (nodes, r, blk, k): level shapes of the default-caps n=512 factor
SHAPES = [(1, 192, 128, 400), (3, 192, 197, 192), (24, 192, 24, 400),
          (56, 192, 24, 272), (124, 96, 24, 96)]
DIAG = "        const int nv = ncl > warp ? (ncl - warp + 7) / 8 : 0;"
PROD = "        if (warp * 8 < d.nrows) {  // warp-uniform"
VARIANTS = {"kernel": [], "no diagonal solves": [(DIAG, "        const int nv = 0;")],
            "no products": [(PROD, "        if (false) {")],
            "pipeline only": [(DIAG, "        const int nv = 0;"),
                              (PROD, "        if (false) {")]}


def build():
    os.makedirs(OUT, exist_ok=True)
    src = open(SRC).read()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for a, b in subs:
            if text.count(a) != 1:
                raise SystemExit(f"k_breakdown: the kernel source changed: {a!r}")
            text = text.replace(a, b)
        cu, so = os.path.join(OUT, f"v{i}.cu"), os.path.join(OUT, f"v{i}.so")
        open(cu, "w").write(text)
        procs[name] = (so, subprocess.Popen(
            [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                          "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-I", os.path.dirname(SRC), "-Xcompiler",
             "-fPIC", "-shared", "-o", so, cu]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"k_breakdown: nvcc failed for {name}")
        libs[name] = ctypes.CDLL(so)
    return libs


def entry(lib, symbol):
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    return fn


def device_ms(fn, reps=10):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", nargs="+", default=["float64"],
                    choices=["float64", "float32", "complex64", "complex128"])
    dtypes = ap.parse_args().dtype
    if not torch.cuda.is_available():
        raise SystemExit("k_breakdown: needs an NVIDIA GPU")
    built = build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for dname in dtypes:
        run(built, getattr(torch, dname))


def run(built, dt):
    from hsolve_torch import kernels

    dev = torch.device("cuda", 0)
    libs = {name: entry(lib, kernels.symbol("hs_hss_level_correct", dt))
            for name, lib in built.items()}
    isz, acc = H.level_correct_itemsizes(dt)
    maxc = (H.HSS_CORRECT_MAX_COLS_COMPLEX if dt.is_complex
            else H.HSS_CORRECT_MAX_COLS)
    print(f"value type {str(dt).replace('torch.', '')}", flush=True)
    for m, r, blk, k in SHAPES:
        rng = np.random.default_rng(r + k)

        def t(*shape):
            v = rng.standard_normal(shape)
            if dt.is_complex:
                v = v + 1j * rng.standard_normal(shape)
            return torch.as_tensor(v, device=dev).to(dt)

        M = np.eye(2 * r) + t(1, m, 2 * r, 2 * r).cpu().numpy() / (
            4 * np.sqrt(2 * r))
        lu, piv = (x.contiguous() for x in dk.lu_factor(
            torch.as_tensor(M, device=dev).to(dt)))
        Bl, Br = t(1, m, r, r), t(1, m, r, r)
        Phi = t(1, 2 * m * blk, r)
        Y = t(1, 2 * m * blk, k)
        xi = t(1, 2 * m, r, k)
        nc, cs, groups, ns = H.level_correct_launch(r, k, m, dev, dt)
        cpa = H.level_correct_cp_async(Bl, Br, lu, Phi)
        stream = torch.cuda.current_stream(dev).cuda_stream
        row = []
        for name, fn in libs.items():
            args = (Y.data_ptr(), xi.data_ptr(), Bl.data_ptr(), Br.data_ptr(),
                    lu.data_ptr(), piv.data_ptr(), Phi.data_ptr(), 1, m, r,
                    blk, k, nc, cs, ns, 0, cpa, stream)
            if fn(*args) != 0:
                raise SystemExit(f"k_breakdown: {name} was not launched")
            row.append(f"{name} {device_ms(lambda: fn(*args)):.4f}")
        plain = device_ms(lambda: H.hss_level_correct_plain(
            Y.clone(), xi, Bl, Br, lu, piv, Phi, False))
        print(f"nodes={m} 2r={2 * r} blk={blk} k={k} nc={nc} cs={cs} "
              f"groups={groups} stages={ns} ms: " + ", ".join(row)
              + f", plain {plain:.4f}", flush=True)
        geos = []
        for label, (gnc, gcs) in (("wrapper", (nc, cs)),
                                  ("cluster per node",
                                   (maxc, min(16, -(-k // maxc)))),
                                  ("no cluster", (maxc, 1))):
            gns = max((s_ for s_ in range(2, 5) if H.level_correct_smem(
                r, gnc, s_, isz, acc) <= H.HSS_CORRECT_MAX_SMEM), default=0)
            if gnc and not gns:
                geos.append(f"{label} (nc={gnc}) does not fit")
                continue
            if gcs > 1 and H._active_clusters(gnc, gcs, gns, r, dt) < 1:
                geos.append(f"{label} (nc={gnc} cs={gcs}) not schedulable")
                continue
            fn = libs["kernel"]
            args = (Y.data_ptr(), xi.data_ptr(), Bl.data_ptr(), Br.data_ptr(),
                    lu.data_ptr(), piv.data_ptr(), Phi.data_ptr(), 1, m, r,
                    blk, k, gnc, gcs, gns, 0, cpa, stream)
            if fn(*args) != 0:
                raise SystemExit(f"k_breakdown: {label} was not launched")
            geos.append(f"{label} (nc={gnc} cs={gcs}) "
                        f"{device_ms(lambda: fn(*args)):.4f}")
        print("    geometries, ms: " + "; ".join(geos), flush=True)


if __name__ == "__main__":
    main()
