#!/usr/bin/env python3
"""Warm GMRES solve times of ``chip_smoke.py``'s configurations, for reading
two trees of the port side by side (card only).  Run from a tree's root:

    python3 tools/solve_ab.py [--configs exact:128 mixed:512 ...] [--reps 5]

For each configuration (``<path>:<size>``, chip_smoke's paths and sizes;
all of them by default; a path ending in ``-f32`` or ``-c64`` factors in
float32, or in complex64 on the damped system (damping 0.1), inside
mixed-precision GMRES, the JAX bench's device configurations, with up to
160 iterations) it factors once, solves once cold (where the tree
captures its solve graph), then reads the warm solve with
``gmres_compiled`` as the JAX bench calls it (``fetch_info=False`` where the
tree takes it, the diagnostics fetched after the timers):

- ``solve_ms``: the median of ``--reps`` solves, each between two CUDA
  events;
- ``host_ms``: the median host time of one call (from its start, after a
  synchronize, to its return, without waiting for the device);
- ``busy_ms`` and ``idle_share``: the device time of the kernels of the
  same solve launched eagerly (``gmres_host_driven``: the graph's parts
  without its conditional nodes), traced under ``torch.profiler``, against
  the graph solve's ``solve_ms``; ``busy_ms`` is None where the profiler
  saw no kernel, or where ``--no-busy`` leaves the profiler out.  The
  graph solve itself is not traced: at n=512 CUPTI saw 1-8 % of its device
  time, and a second traced graph solve in one process hit an illegal
  memory access on the H100 (ROADMAP section 3, F9), while the same solves
  untraced, and the host-driven ones traced, ran clean.

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
# a path's narrow factor type: the mixed path's float32, and the suffixes
NARROW = {"-f32": torch.float32, "-c64": torch.complex64}


def problem(size, damping=0.0):
    if size.endswith("^3"):
        return ht.helmholtz3d(int(size[:-2]), k=10.0)
    return ht.helmholtz2d(int(size), k=40.0, damping=damping)


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


def busy(fn):
    """Device ms of the kernels of one traced call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    dev = sum(e.self_device_time_total for e in p.key_averages()
              if e.device_type.name == "CUDA") / 1e3
    return dev if dev > 0 else None


def run(cfg, reps, card, dev, profiled=True):
    path, size = cfg.split(":")
    narrow = NARROW.get(path[-4:], torch.float32 if path == "mixed" else None)
    base = path[:-4] if path[-4:] in NARROW else path
    A, b, shape = problem(size, 0.1 if narrow == torch.complex64 else 0.0)
    opts = ht.SolverOptions(**OPTIONS[base])
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 opts)
    F = ht.factor_with_plan(plan, opts, device=dev,
                            dtype=narrow if narrow else torch.float64)
    op, mv = ht.spmv_format(A, device=dev)
    bt = torch.as_tensor(np.asarray(b), device=dev)
    prec, kw, maxiter = solve_with_data, {}, 60
    if narrow:
        nname = str(narrow).replace("torch.", "")
        prec = lambda d, v: solve_with_data(d, v.to(narrow)).to(v.dtype)
        kw = dict(inner_dtype=nname, m_eps=1e-6, mv_data_inner=(
            ht.spmv_format(A, dtype=np.dtype(nname), device=dev)[0]))
        maxiter = 60 if path == "mixed" else 160
    deferred = "fetch_info" in inspect.signature(ht.gmres_compiled).parameters
    if deferred:
        kw["fetch_info"] = False
    out = {}

    def solve():
        out["x"], out["info"] = ht.gmres_compiled(
            mv, prec, bt, reltol=1e-9, restart=30, maxiter=maxiter, mv_data=op,
            M_data=F.solve_data, **kw)

    def solve_eager():
        from hsolve_torch.krylov import gmres_host_driven

        kw_ = {k_: v_ for k_, v_ in kw.items() if k_ != "fetch_info"}
        gmres_host_driven(mv, prec, bt, reltol=1e-9, restart=30,
                          maxiter=maxiter, mv_data=op, M_data=F.solve_data,
                          **kw_)

    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    solve_ms = median_ms(solve, reps)
    host_ms = median_ms(solve, reps, events=False)
    busy_ms = busy(solve_eager) if profiled else None
    info = ht.fetch_gmres_info(out["info"]) if deferred else out["info"]
    x = out["x"].cpu().numpy()
    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    row = {"config": cfg, "graph": deferred, "iters": info["iters"],
           "relres": relres, "cold_s": cold, "solve_ms": solve_ms,
           "host_ms": host_ms, "busy_ms": busy_ms,
           "idle_share": None if busy_ms is None else 1.0 - busy_ms / solve_ms,
           "card": card}
    print(json.dumps(row), flush=True)
    del F, out
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=CONFIGS)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-busy", action="store_true",
                    help="leave out the profiler's busy reading (it traces "
                    "the host-driven solve: minutes at n=512)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("solve_ab: needs an NVIDIA GPU")
    torch.set_num_threads(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    for cfg in args.configs:
        run(cfg, args.reps, card, dev, not args.no_busy)
    return 0


if __name__ == "__main__":
    sys.exit(main())
