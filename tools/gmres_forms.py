#!/usr/bin/env python3
"""The two GMRES forms on one factor, step by step: ``krylov.gmres`` (MGS
Arnoldi, Givens on the host) and ``gmres_compiled``'s program (CGS2, kernels
L and M; here its host-driven run, which reads the Givens estimate after
every step), each step's residual estimate beside the tolerance ``reltol
||b||`` (``krylov.gmres``'s last step: its true residual), then both forms' counts and ``gmres_compiled``'s graph count.
helmholtz2d(n, k=40), leafmax 100, chip_smoke.py's structured options
(``swlevel=-2, swsize=16, atol=rtol=1e-3, kest=32``; ``--exact``: the exact
path), reltol 1e-9, restart 30, maxiter 36; ``--batch-multiple 2``: the
plan padded for a 2-rank tree mesh.

    python3 tools/gmres_forms.py --n 512                # the card
    python3 tools/gmres_forms.py --cpu --n 128
"""

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import hsolve_torch as ht  # noqa: E402
from hsolve_torch import kernels, krylov  # noqa: E402
from hsolve_torch.factor import solve_with_data  # noqa: E402

RELTOL, RESTART, MAXITER = 1e-9, 30, 36


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--exact", action="store_true")
    ap.add_argument("--batch-multiple", type=int, default=1)
    args = ap.parse_args()
    if args.cpu:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        kernels.build()
        dev = torch.device("cuda", 0)
    A, b, shape = ht.helmholtz2d(args.n, k=40.0)
    opts = ht.SolverOptions(swlevel=0) if args.exact else ht.SolverOptions(
        swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3, kest=32)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 opts, batch_multiple=args.batch_multiple)
    F = ht.factor_with_plan(plan, opts, device=dev)
    op, mv = ht.spmv_format(A, device=dev)
    bt = torch.as_tensor(b, device=dev)
    tol = RELTOL * float(torch.linalg.vector_norm(bt))

    _, info = ht.gmres(lambda v: mv(op, v), bt, M=solve_with_data,
                       M_data=F.solve_data, reltol=RELTOL, restart=RESTART,
                       maxiter=MAXITER)
    mgs = list(info["resnorm"][1:])     # per step; the last: the true residual

    prog = krylov._Program(bt, mv, solve_with_data, RELTOL, RESTART, MAXITER,
                           F.solve_data, op, 0.0, None, None, True)
    cgs2 = []
    ph = prog.phases[0]
    step = ph.step

    def recorded():
        step()
        cgs2.append(float(ph.s.st[0]))
    ph.step = recorded
    prog.run_host()
    it_host = int(prog.packed[0])
    _, cinfo = ht.gmres_compiled(mv, solve_with_data, bt, reltol=RELTOL,
                                 restart=RESTART, maxiter=MAXITER, mv_data=op,
                                 M_data=F.solve_data)
    print(f"n={args.n} {'exact' if args.exact else 'structured kest=32'}, "
          f"batch_multiple={args.batch_multiple}: krylov.gmres {info['iters']}"
          f" iterations (converged {info['converged']}), the compiled "
          f"program host-driven {it_host}, gmres_compiled {cinfo['iters']}; "
          f"tol {tol:.6e}", flush=True)
    for j in range(max(len(mgs), len(cgs2))):
        e1 = mgs[j] if j < len(mgs) else float("nan")
        e2 = cgs2[j] if j < len(cgs2) else float("nan")
        print(f"  step {j + 1:2d}: MGS estimate / tol {e1 / tol:.15f}, CGS2 "
              f"{e2 / tol:.15f}, relative difference "
              f"{abs(e1 - e2) / max(abs(e2), 1e-300):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
