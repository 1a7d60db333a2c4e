"""Device-time breakdown of the PyTorch/CUDA port's main path on one GPU.

Usage, from the repository root on a machine with one CUDA card:

    python3 -m hsolve_torch.utils.profiling [--sizes 128 512] [--reps 5]
                                            [--out build/profile]

For each size n it plans helmholtz2d(n, k=40) with leafmax=100 and swlevel=0,
then times two warm phases, the numeric factorization and the GMRES solve
(reltol 1e-9, the factor as right preconditioner, the DIA matvec):

- wall time per phase without the profiler (CUDA events around ``reps`` runs),
- device busy time per phase under ``torch.profiler`` (sum of kernel self
  time), and the device idle share 1 - busy / wall,
- the kernels that take the most device time, by name.

Chrome traces go to ``--out``; the last line of output is one JSON object with
every number printed above.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _events_ms(fn, reps):
    import torch

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


def _profile(fn, reps, trace):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    rows = []
    for e in prof.key_averages():
        t = e.self_device_time_total
        if t > 0 and e.device_type.name == "CUDA":   # kernels, not the host ops
            rows.append({"name": e.key, "ms": t / 1e3 / reps,
                         "calls": e.count / reps})
    rows.sort(key=lambda r: -r["ms"])
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[128, 512])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profiling: no CUDA device", file=sys.stderr)
        return 2
    import hsolve_torch as ht
    from hsolve_torch import kernels
    from hsolve_torch.factor import solve_with_data

    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    kernels.build()
    report = {"card": card, "sizes": []}
    for n in args.sizes:
        A, b, shape = ht.helmholtz2d(n, k=40.0)
        opts = ht.SolverOptions(swlevel=0)
        plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                     opts)
        holder = {"F": ht.factor_with_plan(plan, opts, device=dev)}
        op, mv = ht.spmv_format(A, device=dev)
        bt = torch.as_tensor(np.asarray(b), device=dev)

        def factor():
            holder["F"] = ht.factor_with_plan(plan, opts, device=dev)

        def solve():
            holder["x"], holder["info"] = ht.gmres_compiled(
                mv, solve_with_data, bt, reltol=1e-9, restart=30, maxiter=60,
                mv_data=op, M_data=holder["F"].solve_data)

        entry = {"n": n, "N": int(A.shape[0]), "phases": {}}
        for name, fn in (("factor", factor), ("solve", solve)):
            wall = _events_ms(fn, args.reps)
            rows = _profile(fn, args.reps,
                            os.path.join(args.out, f"n{n}_{name}.json"))
            busy = sum(r["ms"] for r in rows)
            entry["phases"][name] = {
                "wall_ms": wall, "device_busy_ms": busy,
                "idle_share": 1.0 - busy / wall if wall > 0 else None,
                "top": rows[:args.top]}
            print(f"n={n} {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
                  f"idle share {1.0 - busy / wall:.3f}", flush=True)
            for r in rows[:args.top]:
                print(f"    {r['ms']:9.4f} ms  {r['calls']:7.1f} calls  "
                      f"{r['name'][:110]}", flush=True)
        entry["iters"] = holder["info"]["iters"]
        report["sizes"].append(entry)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
