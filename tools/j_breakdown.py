#!/usr/bin/env python3
"""Kernel J (``hss_matvec``, ``csrc/hss_matvec.cu``) at the n=512 structured
plans' heaviest launch shapes, on one NVIDIA GPU, in several launch
geometries.

For each shape (random generators of that shape, a random x) it times, on
the device (CUDA events around back-to-back calls), the plain torch version
and the kernel at the geometry the wrapper picks (``hss_matvec_geometry``),
then the kernel with its state moved (shared memory against a scratch
region a CTA, where both are possible), with the other forms of a warp's
work (256 or 512 threads a CTA, 2 or 4 row blocks of 8 an item), with half
and twice the columns a chunk, and with half and twice the cluster (the
column groups to match); every variant is checked against the plain
version (float32 and complex64, which the kernel sums in float64 and
complex128: against the plain version on the widened operands, to 1e-5).
``--dtype`` picks the value type (float64 by default).  Run from the
repository root:

    python3 tools/j_breakdown.py [--dtype complex64]
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hsolve_torch import kernels  # noqa: E402
from hsolve_torch.ops import hss as H  # noqa: E402

# (B, nleaves, ls, r, k): launches of the n=512 structured factors (kest=32
# and the default caps) and solves
SHAPES = [(511, 2, 23, 32, 46), (511, 2, 23, 32, 1), (31, 8, 24, 48, 112), (31, 8, 24, 64, 144),
          (15, 8, 32, 96, 208), (7, 16, 24, 128, 272), (3, 16, 24, 192, 202),
          (3, 16, 24, 192, 400), (1, 8, 32, 192, 400), (1, 16, 24, 192, 1),
          (3, 16, 24, 192, 1)]


def ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def random_hss(dev, B, nl, ls, r, seed=0, dtype=torch.float64):
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn((B,) + s, dtype=dtype, device=dev,
                                 generator=g) / s[-1] ** 0.5
    depth = nl.bit_length() - 1
    half = (nl // 2) * ls
    return H.Hss(D=rnd(nl, ls, ls), U=rnd(nl, ls, r), V=rnd(nl, ls, r),
                 Rs=[rnd(nl >> i, r, r) for i in range(depth)],
                 Ws=[rnd(nl >> i, r, r) for i in range(depth)],
                 B12s=[rnd(nl >> (i + 1), r, r) for i in range(depth)],
                 B21s=[rnd(nl >> (i + 1), r, r) for i in range(depth)],
                 plan=H.ClusterPlan(ls=ls, depth=depth, n1=half, n2=half))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32", "complex64", "complex128"])
    dt = getattr(torch, ap.parse_args().dtype)
    wdt = {torch.float32: torch.float64,
           torch.complex64: torch.complex128}.get(dt, dt)
    tol = 1e-13 if wdt == dt else 1e-5
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels.build()
    sms = kernels.sm_count(dev)
    isz = H.hss_matvec_state_itemsize(dt.is_complex)
    print(f"value type {str(dt).replace('torch.', '')}", flush=True)
    for B, nl, ls, r, k in SHAPES:
        h = random_hss(dev, B, nl, ls, r, dtype=dt)
        x = torch.randn(B, nl * ls, k, dtype=dt, device=dev)
        ref = H.hss_matvec_plain(h.map(lambda a: a.to(wdt)), x.to(wdt))
        line = [f"B={B} nleaves={nl} ls={ls} r={r} k={k}: plain "
                f"{ms(lambda: H.hss_matvec_plain(h, x)):.4f}"]
        depth = nl.bit_length() - 1
        geo0 = H.hss_matvec_geometry(B, nl, ls, r, depth, k, sms,
                                     x.element_size(), dt.is_complex)
        cs, kc, groups, smem, th, rb = geo0
        full = H.hss_matvec_smem(nl, depth, r, cs, kc, isz)
        variants = [("wrapper", geo0),
                    ("state moved", (cs, kc, groups, 0 if smem else full, th,
                                     rb))]
        variants += [(f"threads={t} rb={b}", (cs, kc, groups, smem, t, b))
                     for t, b in ((512, 2), (256, 2), (256, 4))
                     if (t, b) != (th, rb)]
        def fit(c, kc_):
            s2 = H.hss_matvec_smem(nl, depth, r, c, kc_, isz)
            g2 = max(1, min(-(-k // kc_), -(-sms // (B * c))))
            return (c, kc_, g2, s2 if smem and s2 <= H.SMEM_LIMIT else 0, th,
                    rb)

        variants += [(f"kc={kc2}", fit(cs, kc2)) for kc2 in (kc // 2, kc * 2)
                     if kc2 in H.J_CHUNKS and kc2 < 2 * k]
        variants += [(f"cs={c2}", fit(c2, kc)) for c2 in (cs // 2, cs * 2)
                     if 1 <= c2 <= min(8, nl)]
        for name, geo in variants:
            # the launches the kernel has: 512 threads at kc 8 only, complex
            # values at rb 2 only
            if geo[3] > H.SMEM_LIMIT or (geo[4] == 512 and geo[1] != 8) or (
                    dt.is_complex and geo[5] != 2):
                continue
            y = H.hss_matvec_launch(h, x, False, *geo)
            err = float((y.to(wdt) - ref).abs().max() / ref.abs().max())
            if not np.isfinite(err) or err > tol:
                print(f"  {name} {geo}: MISMATCH {err:.3e}", flush=True)
                return 1
            t = ms(lambda: H.hss_matvec_launch(h, x, False, *geo))
            line.append(f"{name} (cs={geo[0]} kc={geo[1]} groups={geo[2]} "
                        f"smem={geo[3]} threads={geo[4]} rb={geo[5]}) {t:.4f}")
        print("; ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
