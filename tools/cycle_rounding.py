#!/usr/bin/env python3
"""Which rounding of a GMRES cycle moves the structured n=512 iteration
counts (card only, about two minutes).  Run from the repository root:

    python3 tools/cycle_rounding.py [--configs hss:512 hss-default:512]

Two of a cycle's operations round differently from an earlier form of the
port's loop, which the host drove, though each is the same value in exact
arithmetic:

- the update: ``y @ V[:m]`` over all ``m`` rows of the basis with ``y``
  zero past the cycle's ``j`` steps (JAX's form, the one a graph can
  replay), where the earlier loop formed ``y[:j] @ V[:j]``;
- the cycle's first basis vector: ``V[0] = r / beta``, a division (JAX's,
  and the cycle-start kernel's), where the earlier loop divided by a host
  float, which torch's CUDA division carries out as a product with the
  reciprocal.

For each configuration (``<path>:<n>``, helmholtz2d(n, k=40),
chip_smoke's options) this factors once and runs ``gmres_host_driven``
with each combination, and prints one JSON line with the iterations and
relres of each, beside the card's ``nvidia-smi`` name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hsolve_torch as ht  # noqa: E402
import hsolve_torch.krylov as K  # noqa: E402
from hsolve_torch.factor import solve_with_data  # noqa: E402
from hsolve_torch.ops.arnoldi import J  # noqa: E402

COMP = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3)
OPTIONS = {"exact": dict(swlevel=0), "lowrank": dict(COMP, kest=32, hss=False),
           "hss": dict(COMP, kest=32), "hss-default": COMP}


def end_over_j_rows(self):
    """``_Phase.end`` with the update summed over the cycle's j rows."""
    j = int(self.s.loop[J])
    upd = self.s.y[:j] @ self.s.V[:j]
    self.x.add_(self.prec(upd).to(self.x.dtype))
    self.r.copy_(self.resid(self.x))
    torch.linalg.vector_norm(self.r, out=self.sc[K.gc.BETA])
    K.gc.gmres_cycle_end(self.sc, self.hist, self.s.loop)


def start_by_reciprocal(self):
    """``_Phase.start`` with ``V[0]`` as ``r`` divided by a host float."""
    K.gc.gmres_cycle_start(self.r, self.sc, self.s, self.m_eps)
    beta = float(self.sc[K.gc.BETA])
    v0 = (self.r / (beta if beta > 0 else 1.0)).to(self.s.V.dtype)
    self.s.V[0] = v0
    self.s.vj.copy_(v0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+",
                    default=["hss:512", "hss-default:512"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cycle_rounding: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    start0, end0 = K._Phase.start, K._Phase.end
    variants = {"as is": (start0, end0), "update over j rows": (
        start0, end_over_j_rows), "V[0] by the reciprocal": (
        start_by_reciprocal, end0), "both": (start_by_reciprocal,
                                             end_over_j_rows)}
    for cfg in args.configs:
        path, n = cfg.split(":")
        A, b, shape = ht.helmholtz2d(int(n), k=40.0)
        F = ht.factor(A, ht.nested_dissection(shape, leafmax=100),
                      device=dev, **OPTIONS[path])
        op, mv = ht.spmv_format(A, device=dev)
        bt = torch.as_tensor(np.asarray(b), device=dev)
        row = {"config": cfg, "card": card}
        for name, (start, end) in variants.items():
            K._Phase.start, K._Phase.end = start, end
            try:
                x, info = K.gmres_host_driven(
                    mv, solve_with_data, bt, reltol=1e-9, restart=30,
                    maxiter=60, mv_data=op, M_data=F.solve_data)
            finally:
                K._Phase.start, K._Phase.end = start0, end0
            xh = x.cpu().numpy()
            row[name] = {"iters": info["iters"], "relres": float(
                np.linalg.norm(b - A @ xh) / np.linalg.norm(b))}
        print(json.dumps(row), flush=True)
        del F
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
