#!/usr/bin/env python3
"""Warm GMRES solve times of ``chip_smoke.py``'s configurations, for reading
two trees of the port side by side (card only).  Run from a tree's root:

    python3 tools/solve_ab.py [--configs exact:128 mixed:512 ...] [--reps 5]

For each configuration (``<path>:<size>``, chip_smoke's paths and sizes;
all of them by default) it factors once, solves once cold (where the tree
captures its solve graph), then reads the warm solve with
``gmres_compiled`` as the JAX bench calls it (``fetch_info=False`` where the
tree takes it, the diagnostics fetched after the timers):

- ``solve_ms``: the median of ``--reps`` solves, each between two CUDA
  events;
- ``host_ms``: the median host time of one call (from its start, after a
  synchronize, to its return, without waiting for the device);
- ``busy_ms`` and ``idle_share``: the device time of the kernels of
  ``--reps`` back-to-back solves under ``torch.profiler``, per solve,
  against the same solves' wall time between CUDA events (``wall_ms``);
  ``busy_ms`` is None where the profiler saw no kernel.

It prints one JSON line per configuration, with the card's ``nvidia-smi``
name and power limit, and imports nothing of the tree but its public API,
so the same script runs in an earlier tree copied beside it.
"""

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hsolve_torch as ht  # noqa: E402
from hsolve_torch.factor import solve_with_data  # noqa: E402

COMP = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3)
OPTIONS = {"exact": dict(swlevel=0), "mixed": dict(swlevel=0),
           "lowrank": dict(COMP, kest=32, hss=False),
           "hss": dict(COMP, kest=32), "hss-default": COMP,
           "lowrank-default": dict(COMP, hss=False)}
CONFIGS = ["exact:128", "lowrank:128", "hss:128", "hss-default:128",
           "mixed:128", "exact:512", "lowrank:512", "hss:512",
           "hss-default:512", "mixed:512", "exact:1026", "exact:64^3",
           "mixed:64^3", "lowrank-default:48^3", "hss-default:40^3"]


def problem(size):
    if size.endswith("^3"):
        return ht.helmholtz3d(int(size[:-2]), k=10.0)
    return ht.helmholtz2d(int(size), k=40.0)


def median_ms(fn, reps, events=True):
    times = []
    for _ in range(reps):
        if events:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
    return statistics.median(times)


def busy(fn, reps):
    """(device ms of the kernels, wall ms between CUDA events) per solve."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    wall = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = sum(e.self_device_time_total for e in p.key_averages()
              if e.device_type.name == "CUDA") / 1e3 / reps
    return (dev if dev > 0 else None), wall


def run(cfg, reps, card, dev):
    path, size = cfg.split(":")
    A, b, shape = problem(size)
    opts = ht.SolverOptions(**OPTIONS[path])
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 opts)
    mixed = path == "mixed"
    F = ht.factor_with_plan(plan, opts, device=dev,
                            dtype=torch.float32 if mixed else torch.float64)
    op, mv = ht.spmv_format(A, device=dev)
    bt = torch.as_tensor(np.asarray(b), device=dev)
    prec, kw = solve_with_data, {}
    if mixed:
        prec = lambda d, v: solve_with_data(d, v.to(torch.float32)).to(v.dtype)
        kw = dict(inner_dtype="float32", m_eps=1e-6, mv_data_inner=(
            ht.spmv_format(A, dtype=np.float32, device=dev)[0]))
    deferred = "fetch_info" in inspect.signature(ht.gmres_compiled).parameters
    if deferred:
        kw["fetch_info"] = False
    out = {}

    def solve():
        out["x"], out["info"] = ht.gmres_compiled(
            mv, prec, bt, reltol=1e-9, restart=30, maxiter=60, mv_data=op,
            M_data=F.solve_data, **kw)

    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    solve_ms = median_ms(solve, reps)
    host_ms = median_ms(solve, reps, events=False)
    busy_ms, wall_ms = busy(solve, reps)
    info = ht.fetch_gmres_info(out["info"]) if deferred else out["info"]
    x = out["x"].cpu().numpy()
    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    row = {"config": cfg, "graph": deferred, "iters": info["iters"],
           "relres": relres, "cold_s": cold, "solve_ms": solve_ms,
           "host_ms": host_ms, "wall_ms": wall_ms, "busy_ms": busy_ms,
           "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
           "card": card}
    print(json.dumps(row), flush=True)
    del F, out
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=CONFIGS)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("solve_ab: needs an NVIDIA GPU")
    torch.set_num_threads(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    for cfg in args.configs:
        run(cfg, args.reps, card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
