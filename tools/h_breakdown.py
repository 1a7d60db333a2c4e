#!/usr/bin/env python3
"""Kernel H (``csrc/hss_cpqr.cu``, the pivot loop of ``cpqr``) at every
launch shape of the helmholtz2d(512, k=40) structured factors, on one
NVIDIA GPU, device only (card only).

For each value type (float64 and float32 on the undamped system; complex128
and complex64 on the damped one, damping 0.1) and each plan (kest=32 and
the default caps, ``swlevel=-2, swsize=16, atol=rtol=1e-3``) it factors
once, recording the first launch of every shape ``(B, m, n, k)`` of
``cpqr_pivots`` (a copy of its input), then reads each shape: the
wrapper's time (launches queued behind a sleep kernel, between CUDA events),
its plain version's (one call between CUDA events: a Python loop of k
steps), whether the pivots and ranks are the plain version's (``ties``:
matrices whose pivots differ, the ranks equal; chip_smoke's ``cpqr_ties``
judges those), the steps the data needs (a pivot per rank and the step
that finds it, ``min(rank + 1, k)`` per matrix) against k, and the bound
chip_smoke states (bytes or operations, at least a queued launch, plus
a step's least chain, ``ceil(log2 m) + ceil(log2 n) + 3`` dependent
operations, per step at 8 cycles and 1.98 GHz).  It prints one
line per shape and one summary per plan and type (the sums, the widest
shape), and writes ``h_breakdown.json`` under ``--out``.  Run from a
tree's root; it imports only the tree's wrappers, so it runs unchanged in
an earlier tree copied beside it:

    python3 tools/h_breakdown.py [--dtypes complex128 ...] [--plans default]
"""

import argparse
import json
import math
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hsolve_torch as ht  # noqa: E402
from hsolve_torch.ops import lowrank as L  # noqa: E402

COMP = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3)
PLANS = {"kest=32": dict(COMP, kest=32), "default": COMP}
HBM_BPS = 3.35e12
PEAK = {"float64": 34e12, "float32": 34e12, "complex128": 34e12,
        "complex64": 34e12}   # the loop runs in float64 or complex128
CLOCK_HZ, DEP_CYCLES = 1.98e9, 8


def queued_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    cycles = 2_000_000
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("the host's launches did not get ahead of the device")


def once_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def read_shape(Am, atol, rtol, k, floor_ms):
    B, m, n = Am.shape
    dname = str(Am.dtype).replace("torch.", "")
    piv, rank = L.cpqr_pivots(Am, atol, rtol, k)
    (ppiv, prank), plain_ms = once_ms(
        lambda: L.cpqr_pivots_plain(Am, atol, rtol, k))
    one = once_ms(lambda: L.cpqr_pivots(Am, atol, rtol, k))[1]
    ms = queued_ms(lambda: L.cpqr_pivots(Am, atol, rtol, k),
                   int(min(20, max(3, 20.0 / max(one, 1e-3)))))
    need = (rank.double() + 1).clamp(max=k)
    fm = 4 if Am.is_complex() else 1
    nbytes = Am.numel() * Am.element_size() + 4 * (piv.numel() + rank.numel())
    flops = 4 * fm * m * n * float(need.sum())
    top = max(nbytes / HBM_BPS, flops / PEAK[dname], floor_ms / 1e3)
    chain = math.ceil(math.log2(max(m, 2))) + math.ceil(math.log2(max(n, 2))) + 3
    bound = (top + float(need.max()) * chain * DEP_CYCLES / CLOCK_HZ) * 1e3
    cs, resident = L.cpqr_cluster(m, n, L.cpqr_itemsize(Am.dtype))
    return {"key": [B, m, n, k], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "ranks_equal": bool(rank.equal(prank)),
            "ties": int((piv != ppiv).any(-1).sum()),
            "steps_max": int(need.max()), "steps_mean": float(need.mean()),
            "smem_cluster": cs, "resident": resident}


def run(dname, plan_name, floor_ms, report):
    dev = torch.device("cuda", 0)
    dt = getattr(torch, dname)
    A, _, shape = ht.helmholtz2d(512, k=40.0,
                                 damping=0.1 if dt.is_complex else 0.0)
    opts = ht.SolverOptions(**PLANS[plan_name])
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 opts)
    calls, orig = {}, L.cpqr_pivots

    def rec(Am, atol, rtol, k):
        key = (*Am.shape, k)
        if key not in calls:
            calls[key] = (Am.clone(), atol, rtol, k)
        return orig(Am, atol, rtol, k)

    rec.launches, rec.launches_by_type = 0, {}
    L.cpqr_pivots = rec
    try:
        F = ht.factor_with_plan(plan, opts, dtype=dt, device=dev)
        torch.cuda.synchronize()
    finally:
        L.cpqr_pivots = orig
    del F
    rows = []
    for key, (Am, atol, rtol, k) in calls.items():
        r = read_shape(Am, atol, rtol, k, floor_ms)
        rows.append(r)
        print(f"{dname} {plan_name} H {r['key']}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}), steps "
              f"max {r['steps_max']} mean {r['steps_mean']:.1f} of k={k}, "
              f"ranks {'equal' if r['ranks_equal'] else 'DIFFER'}"
              + (f", pivots part at {r['ties']} matrices" if r["ties"] else ""),
              flush=True)
    calls.clear()
    torch.cuda.empty_cache()
    widest = max(rows, key=lambda r: r["key"][1] * r["key"][2] * r["key"][0])
    summ = {"dtype": dname, "plan": plan_name, "shapes": len(rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "ranks_differ": sum(not r["ranks_equal"] for r in rows),
            "tie_shapes": sum(r["ties"] > 0 for r in rows),
            "widest": widest}
    print(f"{dname} {plan_name}: H at {summ['shapes']} shapes, sum "
          f"{summ['ms']:.4f} ms against plain {summ['plain_ms']:.4f} and "
          f"bound {summ['bound_ms']:.4f}; ranks differ at "
          f"{summ['ranks_differ']}, pivots part at {summ['tie_shapes']}; "
          f"widest {widest['key']} {widest['ms']:.4f} ms (bound "
          f"{widest['bound_ms']:.4f}, {widest['steps_max']} steps of k)",
          flush=True)
    report["plans"].append({"summary": summ, "rows": rows})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtypes", nargs="+",
                    default=["complex128", "complex64", "float64", "float32"],
                    choices=["float64", "float32", "complex64", "complex128"])
    ap.add_argument("--plans", nargs="+", default=list(PLANS),
                    choices=list(PLANS))
    ap.add_argument("--out", default=None,
                    help="a directory for h_breakdown.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("h_breakdown: needs an NVIDIA GPU")
    torch.set_num_threads(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    x = torch.zeros(1, device="cuda")
    floor_ms = queued_ms(x.zero_, 50)
    report = {"card": card, "tree": ROOT, "queue_floor_ms": floor_ms,
              "plans": []}
    for dname in args.dtypes:
        for plan_name in args.plans:
            run(dname, plan_name, floor_ms, report)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "h_breakdown.json"), "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
