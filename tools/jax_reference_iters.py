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
sketches, then float64 GMRES (reltol 1e-9, restart 30, maxiter 60);
``--config hss`` chip_smoke.py's structured configuration, the same with
``kest=32``; ``--config lowrank-default`` the default caps with
``hss=False``; ``--config lowrank`` chip_smoke.py's low-rank compressed
configuration (``swlevel=-2, swsize=16, atol=rtol=1e-3, kest=32,
hss=False``).  With ``--damping`` these factor the complex system in
complex128 (the JAX package's own sketches, real draws cast) under
complex128 GMRES:

    JAX_PLATFORMS=cpu python tools/jax_reference_iters.py --damping 0.1 \
        --sizes 128 512 --config lowrank
    JAX_PLATFORMS=cpu python tools/jax_reference_iters.py --damping 0.1 \
        --sizes 128 512 --config hss       # or hss-default

``--damping D`` > 0 (helmholtz2d) runs the damped, complex system
helmholtz2d(n, k, damping=D) in the JAX bench's complex rule: with the
default config a complex64 factor, complex64 cycles over the complex64 DIA
operator inside a complex128 solve (``exact-complex-mixed``, the device
configuration, bench.py:175-179, :335-345 without the TPU's split-real
system); with ``--config exact`` complex128 throughout
(``exact-complex``).  chip_smoke.py's complex paths are held to these:

    JAX_PLATFORMS=cpu python tools/jax_reference_iters.py --damping 0.1 \
        --sizes 128 512 [--config exact]

``--config exact`` without ``--damping`` is the float64 exact run.

``--config lowrank-f32-mixed``, ``hss-f32-mixed`` and
``hss-default-f32-mixed`` run the compressed configurations above (``lowrank``,
``hss``, ``hss-default``) in the JAX bench's device configuration: a float32
factor (the JAX package's own float32 sketches) as the preconditioner of the
mixed-precision GMRES of the exact run above.  ``hss-f32-mixed`` is
``bench.py --swlevel -2 --swsize 16 --atol 1e-3 --kest 32`` on a device
(the bench has no ``hss`` switch: its compressed plans are structured):

    JAX_PLATFORMS=cpu python tools/jax_reference_iters.py --sizes 128 512 \
        --config hss-f32-mixed      # or lowrank-f32-mixed, hss-default-f32-mixed
    JAX_PLATFORMS=cpu python tools/jax_reference_iters.py --problem helmholtz3d \
        --k 10 --sizes 32 --config hss-default-f32-mixed

``--problem helmholtz3d --k 10`` runs the 3D problems instead (7-point
helmholtz3d(n, k) on an n^3 mesh, the same leafmax):

    JAX_PLATFORMS=cpu python tools/jax_reference_iters.py --problem helmholtz3d \
        --k 10 --sizes 64
    JAX_PLATFORMS=cpu python tools/jax_reference_iters.py --problem helmholtz3d \
        --k 10 --sizes 48 --config lowrank-default

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


def problem(args, n: int):
    if args.damping > 0:
        return hsolve.helmholtz2d(n, k=args.k, damping=args.damping)
    return getattr(hsolve, args.problem)(n, k=args.k)


# the compressed options of each config (chip_smoke.py's COMPRESSED, HSS and
# HSS_DEFAULT; LOWRANK_DEFAULT for lowrank-default)
COMPRESSED_OPTIONS = {
    "lowrank": dict(kest=32, hss=False), "hss": dict(kest=32, hss=True),
    "hss-default": dict(hss=True), "lowrank-default": dict(hss=False)}


def compressed_options(config: str) -> dict:
    base = config[:-len("-f32-mixed")] if config.endswith("-f32-mixed") \
        else config
    return dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3,
                **COMPRESSED_OPTIONS[base])


def run(args, n: int) -> dict:
    """The mixed device configuration on the exact path or, for the
    ``*-f32-mixed`` compressed configs, on their compressed options; or
    (``--config exact``) the wide type throughout; complex types with
    ``--damping``."""
    A, b, shape = problem(args, n)
    b = np.asarray(b)
    cplx = args.damping > 0
    narrow, wide = (np.complex64, np.complex128) if cplx else \
        (np.float32, np.float64)
    mixed = args.config.endswith("-f32-mixed")
    opts = hsolve.SolverOptions(swlevel=0) if args.config.startswith(
        "exact") else hsolve.SolverOptions(**compressed_options(args.config))
    plan = hsolve.plan_factorization(A, hsolve.nested_dissection(shape, leafmax=100),
                                     opts)
    fdt = narrow if mixed else wide
    t0 = time.perf_counter()
    F = hsolve.factor_with_plan(plan, opts, dtype=fdt)
    jax.block_until_ready(F.solve_data)
    factor_s = time.perf_counter() - t0
    op_w, _ = hsolve.spmv_format(A, dtype=wide)
    inner = {}
    if mixed:
        inner = dict(inner_dtype=np.dtype(narrow).name, m_eps=1e-6,
                     mv_data_inner=hsolve.spmv_format(A, dtype=narrow)[0],
                     escalate=True)

    def precond(data, v):
        return solve_with_data(data, v.astype(fdt)).astype(v.dtype)

    t0 = time.perf_counter()
    x, info = hsolve.gmres_compiled(
        _mv, precond, jnp.asarray(b, wide), reltol=1e-9, restart=30,
        maxiter=60, mv_data=op_w, M_data=F.solve_data, **inner)
    solve_s = time.perf_counter() - t0
    x = np.asarray(x)
    iters = int(info["iters"])
    config = {(False, False): "exact", (False, True): "exact-f32-mixed",
              (True, False): "exact-complex",
              (True, True): "exact-complex-mixed"}[cplx, mixed]
    if not args.config.startswith("exact"):
        config = args.config
    extra = {}
    if not args.config.startswith("exact"):
        report = F.rank_report()
        extra = {"max_rank": F.maxrank(), "saturated": report["saturated"]}
    return {**extra, "n": n, "N": int(A.shape[0]), "problem": args.problem,
            "config": config, "damping": args.damping,
            "iters": iters, "float32_iters": min(iters, 60),
            "float64_iters": max(iters - 60, 0),
            "converged": bool(info["converged"]),
            "relres": float(np.linalg.norm(b - A @ x) / np.linalg.norm(b)),
            "cpu_factor_s": factor_s, "cpu_solve_s": solve_s}


def run_compressed_default(args, n: int) -> dict:
    A, b, shape = problem(args, n)
    b = np.asarray(b)
    tree = hsolve.nested_dissection(shape, leafmax=100)
    t0 = time.perf_counter()
    F = hsolve.factor(A, tree, **compressed_options(args.config))
    jax.block_until_ready(F.solve_data)
    factor_s = time.perf_counter() - t0
    op, _ = hsolve.spmv_format(
        A, dtype=np.complex128 if args.damping > 0 else np.float64)
    t0 = time.perf_counter()
    x, info = hsolve.gmres_compiled(
        _mv, solve_with_data, jnp.asarray(b), reltol=1e-9, restart=30,
        maxiter=60, mv_data=op, M_data=F.solve_data)
    solve_s = time.perf_counter() - t0
    x = np.asarray(x)
    report = F.rank_report()
    return {"n": n, "N": int(A.shape[0]), "problem": args.problem,
            "config": args.config, "damping": args.damping,
            "iters": int(info["iters"]), "converged": bool(info["converged"]),
            "relres": float(np.linalg.norm(b - A @ x) / np.linalg.norm(b)),
            "max_rank": F.maxrank(), "saturated": report["saturated"],
            "cpu_factor_s": factor_s, "cpu_solve_s": solve_s}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[128, 512])
    ap.add_argument("--config", choices=("exact-f32-mixed", "exact",
                                         "hss", "hss-default",
                                         "lowrank-default", "lowrank",
                                         "lowrank-f32-mixed", "hss-f32-mixed",
                                         "hss-default-f32-mixed"),
                    default="exact-f32-mixed")
    ap.add_argument("--problem", choices=("helmholtz2d", "helmholtz3d"),
                    default="helmholtz2d")
    ap.add_argument("--k", type=float, default=40.0)
    ap.add_argument("--damping", type=float, default=0.0,
                    help="helmholtz2d's impedance damping: > 0 gives the "
                         "complex system")
    args = ap.parse_args()
    if args.damping > 0 and args.problem != "helmholtz2d":
        ap.error("--damping runs the helmholtz2d configs")
    fn = run if args.config.startswith("exact") or \
        args.config.endswith("-f32-mixed") else run_compressed_default
    for n in args.sizes:
        print(json.dumps(fn(args, n)), flush=True)


if __name__ == "__main__":
    main()
