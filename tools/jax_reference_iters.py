#!/usr/bin/env python3
"""GMRES iteration counts of the JAX package (``hsolve``) on the CPU for the
configurations that ``chip_smoke.py`` drives on the GPU; its ``MAX_ITERS``
bounds are twice these counts.

    JAX_PLATFORMS=cpu python tools/jax_reference_iters.py --sizes 128 512

Each run: helmholtz2d(n, k=40) -> nested_dissection(leafmax=100) ->
plan_factorization(swlevel=0) -> factor_with_plan(dtype=float32) ->
gmres_compiled(b float64, the float64 DIA operator outside, the float32 one
inside, inner_dtype="float32", m_eps=1e-6, escalate=True, reltol 1e-9,
restart 30, maxiter 60), with M(data, v) = solve_with_data(data,
v.astype(float32)).astype(v.dtype): the JAX bench's device configuration
(bench.py:174-179, :263-276).  A phase-1 count of 60 means the float32 cycles
did not converge and the float64 phase took the rest.  The n=512 factor holds
about 0.5 GB of float32 fronts.

``--config hss-default``: the structured (HSS) preconditioner with every
option at its default but ``swlevel=-2, swsize=16, atol=rtol=1e-3`` (no
kest: the default rank caps), factored in float64 with the JAX package's own
sketches, then float64 GMRES (reltol 1e-9, restart 30, maxiter 60).

Prints one JSON line per size.
"""

import argparse
import importlib
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import hsolve  # noqa: E402

solve_with_data = importlib.import_module("hsolve.factor").solve_with_data


def _mv(op, v):
    return hsolve.dia_matvec(op, v)


def _precond(data, v):
    return solve_with_data(data, v.astype(jnp.float32)).astype(v.dtype)


def run(n: int) -> dict:
    A, b, shape = hsolve.helmholtz2d(n, k=40.0)
    b = np.asarray(b)
    opts = hsolve.SolverOptions(swlevel=0)
    plan = hsolve.plan_factorization(A, hsolve.nested_dissection(shape, leafmax=100),
                                     opts)
    t0 = time.perf_counter()
    F = hsolve.factor_with_plan(plan, opts, dtype=jnp.float32)
    jax.block_until_ready(F.solve_data)
    factor_s = time.perf_counter() - t0
    op64, _ = hsolve.spmv_format(A, dtype=np.float64)
    op32, _ = hsolve.spmv_format(A, dtype=np.float32)
    t0 = time.perf_counter()
    x, info = hsolve.gmres_compiled(
        _mv, _precond, jnp.asarray(b, jnp.float64), reltol=1e-9, restart=30,
        maxiter=60, mv_data=op64, M_data=F.solve_data, inner_dtype="float32",
        mv_data_inner=op32, m_eps=1e-6, escalate=True)
    solve_s = time.perf_counter() - t0
    x = np.asarray(x)
    iters = int(info["iters"])
    return {"n": n, "N": int(A.shape[0]), "config": "exact-f32-mixed",
            "iters": iters, "float32_iters": min(iters, 60),
            "float64_iters": max(iters - 60, 0),
            "converged": bool(info["converged"]),
            "relres": float(np.linalg.norm(b - A @ x) / np.linalg.norm(b)),
            "cpu_factor_s": factor_s, "cpu_solve_s": solve_s}


def run_hss_default(n: int) -> dict:
    A, b, shape = hsolve.helmholtz2d(n, k=40.0)
    b = np.asarray(b)
    tree = hsolve.nested_dissection(shape, leafmax=100)
    t0 = time.perf_counter()
    F = hsolve.factor(A, tree, swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3)
    jax.block_until_ready(F.solve_data)
    factor_s = time.perf_counter() - t0
    op, _ = hsolve.spmv_format(A, dtype=np.float64)
    t0 = time.perf_counter()
    x, info = hsolve.gmres_compiled(
        _mv, solve_with_data, jnp.asarray(b), reltol=1e-9, restart=30,
        maxiter=60, mv_data=op, M_data=F.solve_data)
    solve_s = time.perf_counter() - t0
    x = np.asarray(x)
    report = F.rank_report()
    return {"n": n, "N": int(A.shape[0]), "config": "hss-default",
            "iters": int(info["iters"]), "converged": bool(info["converged"]),
            "relres": float(np.linalg.norm(b - A @ x) / np.linalg.norm(b)),
            "max_rank": F.maxrank(), "saturated": report["saturated"],
            "cpu_factor_s": factor_s, "cpu_solve_s": solve_s}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[128, 512])
    ap.add_argument("--config", choices=("exact-f32-mixed", "hss-default"),
                    default="exact-f32-mixed")
    args = ap.parse_args()
    fn = run if args.config == "exact-f32-mixed" else run_hss_default
    for n in args.sizes:
        print(json.dumps(fn(n)), flush=True)


if __name__ == "__main__":
    main()
