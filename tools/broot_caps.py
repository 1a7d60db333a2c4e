#!/usr/bin/env python3
"""The boundary-root tree's root rank against its cap: helmholtz2d(n, k=40),
nested dissection (leafmax 100) with the root's separator moved into its
boundary, chip_smoke.py's structured options (``swlevel=-2, swsize=16,
atol=rtol=1e-3, kest=32``) with the root level's cap set by ``level_caps =
(cap, 48)`` (every deeper level keeps kest=32's cap of 48), factored and
solved by ``gmres_compiled`` (reltol 1e-9, restart 30, maxiter 60) for each
cap given; one JSON line per (n, cap): the root's n_pad, cap and rank, the
iterations, relres, whether a level saturated its cap, the factor's seconds
(host clock after a synchronise; the first call in the process includes the
kernels' first launches).

    python3 tools/broot_caps.py --sizes 512 --caps 48 192 256   # the card
    python3 tools/broot_caps.py --cpu --sizes 128 --caps 48 192
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import hsolve_torch as ht  # noqa: E402
from chip_smoke import HSS, boundary_root  # noqa: E402
from hsolve_torch.factor import RootHss, solve_with_data  # noqa: E402
from hsolve_torch.ops.hss import hss_rank  # noqa: E402


def run(n: int, cap: int, dev) -> dict:
    A, b, shape = ht.helmholtz2d(n, k=40.0)
    tree = boundary_root(ht.nested_dissection(shape, leafmax=100))
    opts = ht.SolverOptions(**HSS, level_caps=(cap, 48))
    plan = ht.plan_factorization(A, tree, opts)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    F = ht.factor_with_plan(plan, opts, device=dev)
    sync()
    factor_s = time.perf_counter() - t0
    op, mv = ht.spmv_format(A, device=dev)
    x, info = ht.gmres_compiled(mv, solve_with_data,
                                torch.as_tensor(b, device=dev), reltol=1e-9,
                                restart=30, maxiter=60, mv_data=op,
                                M_data=F.solve_data)
    xh = x.cpu().numpy()
    out = {"n": n, "root_cap_asked": cap, "nb_root": plan.nb_root,
           "root": type(F.root).__name__, "iters": info["iters"],
           "converged": bool(info["converged"]),
           "relres": float(np.linalg.norm(b - A @ xh) / np.linalg.norm(b)),
           "saturated": F.rank_report()["saturated"], "factor_s": factor_s,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else "cpu"}
    if isinstance(F.root, RootHss):
        h = F.root.solver.h
        out.update(root_n_pad=h.plan.n_pad, root_depth=h.plan.depth,
                   root_cap=h.r, root_rank=hss_rank(h))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[512])
    ap.add_argument("--caps", type=int, nargs="+", default=[48, 192, 256])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    dev = ht.kernels.resolve_device("cpu" if args.cpu else "cuda")
    if args.cpu:
        torch.set_num_threads(1)     # MKL's threaded batched LU hangs here
    for n in args.sizes:
        for cap in args.caps:
            print(json.dumps(run(n, cap, dev)), flush=True)


if __name__ == "__main__":
    main()
