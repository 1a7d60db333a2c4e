#!/usr/bin/env python3
"""Where kernel F's time goes (``csrc/lowrank_schur_update.cu``), on one
NVIDIA GPU, at the launch shapes of the n=512 low-rank factor (or, with
``--plan lowrank3d``, of the helmholtz3d(48, k=10) low-rank factor at the
default caps, 56-560), and what the launches
``ops/schur.py:schur_geometry`` passes over would take.

Builds copies of the kernel source into ``build/f_breakdown/``: as it is,
and each without one part (phase 1, the product W = Abi RU with its depth
chunks' staging; the cluster's exchange of W with its two barriers; phase
2's products; the staging of phase 2's operands, RV's rows and Abb's tile;
the store of S), and with all of them left out (what is left is the launch,
the permutation's load and the CTA barriers).  Each copy runs on random
operands of the plan's shapes (its own ``sperm``), in the geometry the
wrapper picks, read on the device with its launches queued behind a sleep
kernel between two CUDA events.  The copies without a part compute wrong
values: only their times are read.  The copy as it is then runs in the
other launches the kernel takes at each shape (``alternatives``: whole rows
in other bands; tiles in bands of 16 and 32 rows, with and without a row
band's cluster), each held to the plain version within 1e-13 of its
largest entry and timed the same way.  At every shape the wrapper
(``lowrank_schur_update``: where the chosen form is the W form, the batched
GEMM ``W = Abi RU`` and the launch; the copies then run only as
alternatives) is read the same way beside the plain version and the
bound (bytes over 3.35 TB/s against both products on the FP64 tensor
cores, 67 TFLOP/s), and the sums over the plan are printed.  It imports
only the tree's public wrappers and geometry, so it runs unchanged in an
earlier tree copied beside it.  Run from a tree's root:

    python3 tools/f_breakdown.py [--plan lowrank512|lowrank3d] [--no-copies]
                                 [--out DIR]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hsolve_torch as ht  # noqa: E402
from hsolve_torch import kernels  # noqa: E402
from hsolve_torch.interop import plan_to_torch  # noqa: E402
from hsolve_torch.ops.schur import (F_MAX_CLUSTER, F_MAX_KD,  # noqa: E402
                                    F_WHOLE_MAX, SMEM_MAX, _fits, _up,
                                    lowrank_schur_update,
                                    lowrank_schur_update_plain,
                                    schur_geometry, schur_smem)
from hsolve_torch.utils.profiling import _queue_floor, _queued_ms  # noqa: E402

SRC = os.path.join(ROOT, "hsolve_torch", "csrc", "lowrank_schur_update.cu")
OUT = os.path.join(ROOT, "build", "f_breakdown")
P1 = ("for (int n0 = 0; n0 < ncb; n0 += 8 * wpr) {",
      "for (int n0 = ncb; n0 < ncb; n0 += 8 * wpr) {")
EXCH = ("  if (cs > 1) {\n    // the band's W", "  if (false) {\n    // the band's W")
P2 = ("for (int k16 = 0; k16 < kcp / 16; ++k16) {",
      "for (int k16 = 0; k16 < 0; ++k16) {")
STAGE = [("  stage_rows(RVs, ldw, bn,", "  if (false) stage_rows(RVs, ldw, bn,"),
         ("  if (whole) {\n    stage_rows(Ab,", "  if (false) {\n    stage_rows(Ab,"),
         ("    for (int e = tid; e < bm * bn; e += F_THREADS) {\n      const int r = e / bn, c = e - r * bn;\n      const bool ok",
          "    for (int e = tid; e < 0; e += F_THREADS) {\n      const int r = e / bn, c = e - r * bn;\n      const bool ok")]
STORE = ("  if (rows > 0 && cols > 0) store_rows(",
         "  if (false) store_rows(")
VARIANTS = {"kernel": [], "no phase 1": [P1], "no exchange": [EXCH],
            "no phase 2 products": [P2], "no phase 2 staging": STAGE,
            "no store": [STORE],
            "launch only": [P1, EXCH, P2, *STAGE, STORE]}


def launch(B, ni, nb, kc, bm, cs, whole):
    """Kernel F's launch in bands of ``bm`` rows: whole rows, or tiles
    under a row band's cluster of up to ``cs`` CTAs (1: none, each CTA
    computing its band's W: tiles of 64 columns, narrower where a rank cap
    leaves too little shared memory, as the chooser sized them before the
    W form), sized as ``schur_geometry`` sizes them; None where it does not
    fit."""
    nbp = _up(nb)
    for bn_max in ((128,) if whole or cs > 1 else (64, 32, 16, 8)):
        c = cs
        if whole:
            bn, nct = nbp, 1
        else:
            nct = max(min(F_MAX_CLUSTER, -(-nbp // 32)), -(-nbp // bn_max)) \
                if c > 1 else -(-nbp // bn_max)
            bn = _up(-(-nbp // nct))
            nct = -(-nbp // bn)
            c = min(nct, c)
            nct = -(-nct // c) * c
        top = min(F_MAX_KD, _up(max(1, -(-ni // c)), 16))
        for kd in sorted({top, min(top, 32), 16}, reverse=True):
            smem = schur_smem(bm, bn, c, kd, kc, whole, nb)
            if _fits(bm, bn) and smem <= SMEM_MAX:
                return {"bm": bm, "bn": bn, "cs": c, "nct": nct, "kd": kd,
                        "whole": whole, "smem": smem}
    return None


def alternatives(B, ni, nb, kc):
    """The launches kernel F takes at a shape beside the one
    ``schur_geometry`` picks, by name: whole-row shapes in bands of 16 and
    32 rows and, up to 64 rows, one band a front; tiled shapes in bands of
    16 and 32 rows, with a row band's tiles in clusters of 8 or 4 CTAs (4:
    each half of the band's tiles computes its W) or none."""
    nbp = _up(nb)
    chosen = schur_geometry(B, ni, nb, kc)
    chosen = {k: chosen[k] for k in ("bm", "bn", "cs", "nct", "kd", "whole",
                                     "smem")}
    if nbp <= F_WHOLE_MAX:
        forms = {f"whole rows, bands of {bm}": (bm, 1, True)
                 for bm in sorted({16, 32, _up(nbp, 16) if nbp <= 64 else 32})}
    else:
        forms = {f"{bm}-row tiles, {f'clusters of {cs}' if cs > 1 else 'no cluster'}":
                 (bm, cs, False) for bm in (16, 32)
                 for cs in (F_MAX_CLUSTER, F_MAX_CLUSTER // 2, 1)}
    out = {}
    for name, args in forms.items():
        g = launch(B, ni, nb, kc, *args)
        if g is not None and g != chosen:
            out[name] = g
    return out


def build(copies=True):
    """{variant: CDLL}: the kernel as it is and (``copies``) each copy
    without a part."""
    os.makedirs(OUT, exist_ok=True)
    src = open(SRC).read().replace(
        '#include "hs_common.cuh"',
        f'#include "{os.path.join(ROOT, "hsolve_torch", "csrc", "hs_common.cuh")}"')
    texts = {}
    for name, subs in (VARIANTS if copies else {"kernel": []}).items():
        text = src
        for a, b in subs:
            if text.count(a) != 1:
                raise SystemExit(f"f_breakdown: the kernel source changed: {a!r}")
            text = text.replace(a, b)
        texts[name] = text
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu, so = os.path.join(OUT, f"v{i}.cu"), os.path.join(OUT, f"v{i}.so")
        open(cu, "w").write(text)
        procs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
             os.path.join(ROOT, "hsolve_torch", "csrc"), "-shared", cu, "-o",
             so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    try:
        for name, (so, p) in procs.items():
            out, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                raise SystemExit(f"f_breakdown: nvcc failed for {name}:\n{out}")
            lib = ctypes.CDLL(so)
            lib.hs_lowrank_schur_update.argtypes = \
                kernels._SIGNATURES["hs_lowrank_schur_update"]
            libs[name] = lib
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return libs


PLANS = {
    "lowrank512": (lambda: ht.helmholtz2d(512, k=40.0),
                   dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3, kest=32,
                        hss=False)),
    "lowrank3d": (lambda: ht.helmholtz3d(48, k=10.0),
                  dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3,
                       hss=False)),
}


def bound_ms(B, ni, nb, kc):
    """Kernel F's bound: Abb and Abi read, RU, RV and sperm read, S written,
    each once, against both products on the FP64 tensor cores."""
    work = 8 * B * (2 * nb * nb + nb * ni + ni * kc + nb * kc) + 8 * B * nb
    return max(work / 3.35e12, 2 * B * kc * nb * (ni + nb) / 67e12) * 1e3


def events_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plan", choices=sorted(PLANS), default="lowrank512")
    ap.add_argument("--out", default=None,
                    help="a directory for f_breakdown_<plan>.json")
    ap.add_argument("--no-copies", action="store_true",
                    help="build the kernel as it is only (its other "
                    "launches still read)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("f_breakdown: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; tree {ROOT}; plan {args.plan}", flush=True)
    libs = build(not args.no_copies)
    floor = _queue_floor(dev, 20)
    print(f"a queued one-element launch: {floor:.5f} ms", flush=True)
    problem, options = PLANS[args.plan]
    A, _, shape = problem()
    opts = ht.SolverOptions(**options)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 opts)
    tp = plan_to_torch(plan, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for bp, tb in zip(plan.batches, tp.batches):
        if not bp.compress or bp.structured:
            continue
        B, ni, nb, kc = bp.B, bp.ni_pad, bp.nb_pad, bp.rank_cap
        m = ni + nb
        front = torch.randn(B, m, m, dtype=torch.float64, device=dev,
                            generator=g)
        RU = torch.randn(B, ni, kc, dtype=torch.float64, device=dev,
                         generator=g)
        RV = torch.randn(B, nb, kc, dtype=torch.float64, device=dev,
                         generator=g)
        S = torch.empty(B, nb, nb, dtype=torch.float64, device=dev)
        geo = schur_geometry(B, ni, nb, kc)
        row = {"B": B, "nb": nb, "ni_pad": ni, "kc": kc, "geometry": geo,
               "bound": bound_ms(B, ni, nb, kc)}

        def runner(lib, g, name):
            def run():
                rc = lib.hs_lowrank_schur_update(
                    front.data_ptr(), RU.data_ptr(), RV.data_ptr(),
                    tb.sperm.data_ptr(), S.data_ptr(), B, m, ni, kc,
                    g["bm"], g["bn"], g["cs"], g["nct"], g["kd"],
                    int(g["whole"]), stream)
                if rc:
                    raise SystemExit(f"f_breakdown: {name}: CUDA error {rc}")
            return run

        want = lowrank_schur_update_plain(front, ni, RU, RV, tb.sperm)
        scale = float(want.abs().max())
        args_ = (front, ni, RU, RV, tb.sperm)
        row["wrapper_rel"] = float((lowrank_schur_update(*args_) - want)
                                   .abs().max()) / scale
        if not row["wrapper_rel"] <= 1e-13:
            raise SystemExit(f"f_breakdown: [{B},{nb},{nb}] the wrapper is "
                             f"{row['wrapper_rel']:.3g} off the plain version")
        row["wrapper"] = _queued_ms(lambda: lowrank_schur_update(*args_), 20)
        row["plain"] = events_ms(lambda: lowrank_schur_update_plain(*args_))
        print(f"[{B},{nb},{nb}] ni={ni} k={kc} {geo}: wrapper "
              f"{row['wrapper']:.5f} ms, plain {row['plain']:.5f}, bound "
              f"{row['bound']:.5f}", flush=True)
        if not geo.get("w"):
            for name, lib in libs.items():
                row[name] = _queued_ms(runner(lib, geo, name), 20)
            print("    copies: " + ", ".join(f"{k} {row[k]:.5f}"
                                             for k in libs), flush=True)
        row["alternatives"] = {}
        alts = alternatives(B, ni, nb, kc)
        if not geo.get("w"):
            alts = {"chosen": geo, **alts}
        for name, alt in alts.items():
            run = runner(libs["kernel"], alt, name)
            S.fill_(float("nan"))
            run()
            torch.cuda.synchronize()
            rel = float((S - want).abs().max()) / scale
            if not rel <= 1e-13:
                raise SystemExit(f"f_breakdown: [{B},{nb},{nb}] {name} "
                                 f"({alt}) is {rel:.3g} off the plain version")
            row["alternatives"][name] = {"geometry": alt, "rel": rel,
                                         "ms": _queued_ms(run, 20)}
        print("    " + "; ".join(
            f"{k} ({v['geometry']['bm']}x{v['geometry']['bn']}, cluster "
            f"{v['geometry']['cs']}) {v['ms']:.5f}"
            for k, v in row["alternatives"].items()), flush=True)
        rows.append(row)
        del front, RU, RV, S, want
        torch.cuda.empty_cache()
    tot = {k: sum(r[k] for r in rows) for k in ("wrapper", "plain", "bound")}
    slower = sum(r["wrapper"] > r["plain"] for r in rows)
    print(f"{args.plan}: {len(rows)} launches, wrapper {tot['wrapper']:.4f} "
          f"ms summed against plain {tot['plain']:.4f} and bound "
          f"{tot['bound']:.4f}; slower than plain at {slower}", flush=True)
    out = {"card": card, "tree": ROOT, "plan": args.plan,
           "queue_floor_ms": floor, "sums": tot, "rows": rows}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"f_breakdown_{args.plan}.json"),
                  "w") as f:
            json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
