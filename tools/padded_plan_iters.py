#!/usr/bin/env python3
"""GMRES iterations of one card's structured factor on the unpadded plan and
on the plan padded for a 2-rank tree mesh (``batch_multiple=2``, the plan
``factor(..., mesh=)`` factors): helmholtz2d(n, k=40), leafmax 100,
chip_smoke.py's structured options (``swlevel=-2, swsize=16, atol=rtol=1e-3,
kest=32``), both GMRES forms (``gmres_compiled`` and the host loop
``gmres``; reltol 1e-9, restart 30, maxiter 150); one line per plan.  A
padded plan's real fronts draw the unpadded plan's sketches, so the two
plans give the same counts.

    python3 tools/padded_plan_iters.py --n 512          # the card
    python3 tools/padded_plan_iters.py --cpu --n 128
"""

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import hsolve_torch as ht  # noqa: E402
from hsolve_torch import kernels  # noqa: E402
from hsolve_torch.factor import solve_with_data  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        print(f"built in {kernels.build()['seconds']:.1f} s",
              flush=True)
        dev = torch.device("cuda", 0)
    A, b, shape = ht.helmholtz2d(args.n, k=40.0)
    opts = ht.SolverOptions(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3,
                            kest=32)
    op, mv = ht.spmv_format(A, device=dev)
    bt = torch.as_tensor(b, device=dev)
    for bm in (1, 2):
        plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                     opts, batch_multiple=bm)
        F = ht.factor_with_plan(plan, opts, device=dev)
        _, cinfo = ht.gmres_compiled(mv, solve_with_data, bt, reltol=1e-9,
                                     restart=30, maxiter=150,
                                     M_data=F.solve_data, mv_data=op)
        t0 = time.perf_counter()
        _, hinfo = ht.gmres(lambda v: mv(op, v), bt, M=F.solve, reltol=1e-9,
                            restart=30, maxiter=150)
        print(f"batch_multiple={bm}: gmres_compiled {cinfo['iters']} "
              f"(converged {cinfo['converged']}), gmres {hinfo['iters']} "
              f"(converged {hinfo['converged']}, {time.perf_counter() - t0:.3f}"
              f" s), max rank {F.maxrank()}", flush=True)
        del F
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
