"""The port's benchmark: setup + GMRES solve of one problem on one CUDA card,
printed as one JSON line with the keys of the JAX package's ``bench.py``.

Usage, from the repository root:

    python -m hsolve_torch.bench [--problem helmholtz2d] [--n 128] [--k 40]
                                 [--leafmax 100] [--reps 10] [--swlevel 0]
                                 [--swsize 1] [--atol TOL] [--kest K]
                                 [--rank-cap R] [--level-caps C1,C2,...]
                                 [--reltol 1e-9] [--maxiter 60]
                                 [--explicit-inverse 0|1] [--inner f32|f64]
                                 [--factor-dtype f32|f64] [--damping D]
                                 [--cpu]

The flags and their defaults are ``bench.py``'s.  Left out: ``--sprec`` (the
TPU's matmul passes; the port has no such option).  Added:
``--factor-dtype``; the factor is float32 on the card and float64 with
``--cpu``, as in ``bench.py``, on exact and compressed plans alike: with
``--swlevel`` < 0 (structured, as the bench has no ``hss`` switch) the card
runs kernels E-K in float32, the JAX bench's device configuration, e.g.
``python -m hsolve_torch.bench --n 128 --swlevel -2 --swsize 16 --atol 1e-3
--kest 32`` (``--cpu --factor-dtype f32``: the same on the CPU).  A factor
in another type than that default adds ``_f64`` (card) or ``_f32``
(``--cpu``) to the metric's tag.

``--damping D`` > 0 (helmholtz2d only) builds the complex impedance system
``K - k^2 M - i k D M`` and runs it with ``bench.py``'s complex rule: the
solve in complex128; on the card a complex64 factor with complex64 Arnoldi
cycles over the complex64 operator (``--inner f32``: ``m_eps=1e-6``,
escalation to complex128 cycles), with ``--cpu`` complex128 throughout;
``--factor-dtype f64`` / ``--inner f64`` give complex128 on the card, and
``f32`` / ``f32`` complex64 with ``--cpu``.  This bench has no ``hss``
switch, so its compressed plans (``--swlevel`` < 0) are structured: a
complex system factors there in complex128 (``--cpu``, or ``--factor-dtype
f64`` on the card, which has no complex64 kernels E-K yet, slice 16 of the
port, and refuses its default complex64 factor on such a plan).  The tag puts ``_damp<D>`` first, as
``bench.py`` does.  The roofline fields take the complex value's bytes
(16 or 8) and its parts' peak; the FLOP model is the JAX package's, which
counts a complex multiply-add as one operation, so a complex run's
``achieved_gflop_s`` and ``sol_fraction`` understate the real arithmetic
about fourfold.

Protocol (``bench.py``'s): the plan is timed on the host clock, best of
``--reps``, split into its symbolic half (``plan.timings``) and the
schedule; the factor and the solve each run once cold, then ``--reps`` times
back to back between one pair of CUDA events (the host clock with
``--cpu``), divided by the count.  The solve is ``gmres_compiled`` (restart
30, ``fetch_info=False``: one CUDA graph a solve on the card, whose
diagnostics are fetched with ``fetch_gmres_info`` after the timers, as
``bench.py`` does; the graph lives with the factor, so the last factor rep's
first solve captures it again, outside the timers) over the float64 DIA
operator with the factor as right preconditioner;
on the card with ``--inner f32`` its Arnoldi cycles run in float32 over the
float32 operator (``m_eps=1e-6``, escalation on).  ``value`` = schedule +
factor + solve.  ``relres`` is ``||b - A x|| / ||b||`` computed by scipy on
the host from the CSR matrix; the roofline fields come from
:func:`hsolve_torch.utils.profiling.roofline_report` (the H100's peaks) and
a speed-of-light violation is logged as an error and kept in the line.  The
scipy SuperLU baseline (one core, best of ``min(reps, 3)``) runs after the
timed reps and is the only part allowed to fail.  Without ``--cpu`` and
without a card the bench raises; it never falls back to the CPU.  Logs go to
stderr, the JSON line to stdout.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m hsolve_torch.bench",
        description="setup + GMRES solve of one problem on one CUDA card, as "
                    "bench.py's JSON line",
        epilog="Not ported: --sprec (TPU matmul passes).")
    ap.add_argument("--problem", default="helmholtz2d",
                    choices=["helmholtz2d", "poisson2d", "helmholtz3d",
                             "poisson3d"])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--k", type=float, default=40.0)
    ap.add_argument("--leafmax", type=int, default=100)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--swlevel", type=int, default=0)
    ap.add_argument("--swsize", type=int, default=1)
    ap.add_argument("--atol", type=float, default=None,
                    help="compression tolerance (atol = rtol; default: "
                         "SolverOptions' default)")
    ap.add_argument("--kest", type=int, default=None,
                    help="rank estimate: the planner's static rank caps are "
                         "kest + stepsize")
    ap.add_argument("--rank-cap", type=int, default=None,
                    help="hard static rank cap override")
    ap.add_argument("--level-caps", default=None,
                    help="comma-separated per-tree-level rank caps, root first; "
                         "the last entry extends deeper")
    ap.add_argument("--reltol", type=float, default=1e-9)
    ap.add_argument("--maxiter", type=int, default=60)
    ap.add_argument("--damping", type=float, default=0.0,
                    help="impedance damping for helmholtz2d: > 0 gives the "
                         "complex system (complex64 factor and cycles on the "
                         "card, complex128 with --cpu; exact plans only)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--explicit-inverse", default=None, choices=["0", "1"],
                    help="override the explicit-inverse solve mode (default: "
                         "auto)")
    ap.add_argument("--inner", default="f32", choices=["f32", "f64"],
                    help="GMRES Arnoldi precision on the card: f32 cycles "
                         "over the float32 operator with float64 escalation, "
                         "or f64 cycles")
    ap.add_argument("--factor-dtype", default=None, choices=["f32", "f64"],
                    help="factor type (default: f32 on the card, f64 with "
                         "--cpu); a complex system's compressed plans take "
                         "f64 (complex128) on the card")
    return ap.parse_args(argv)


def metric_tag(args: argparse.Namespace, factor_f64: bool) -> str:
    """``bench.py``'s tag rules, and the factor type where it is not the
    device's default."""
    tag = f"_damp{args.damping:g}" if args.damping else ""
    if args.swlevel != 0:
        tag += f"_sw{args.swlevel}"
        if args.atol is not None:
            tag += f"_tol{args.atol:g}"
        if args.kest is not None:
            tag += f"_k{args.kest}"
        if args.rank_cap is not None:
            tag += f"_cap{args.rank_cap}"
        if args.level_caps is not None:
            tag += "_lc" + args.level_caps.replace(",", "-")
    if not args.cpu and factor_f64:
        tag += "_f64"
    elif args.cpu and not factor_f64:
        tag += "_f32"
    return tag


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def main(argv=None) -> int:
    args = parse_args(argv)
    cplx = args.damping > 0
    if cplx and args.problem != "helmholtz2d":
        raise ValueError("--damping applies to helmholtz2d only")

    import scipy.sparse.linalg as spla
    import torch

    import hsolve_torch as ht
    from hsolve_torch.factor import solve_with_data
    from hsolve_torch.interop import resolve_device
    from hsolve_torch.utils.profiling import roofline_report

    dev = resolve_device("cpu" if args.cpu else "cuda")
    on_card = dev.type == "cuda"
    if on_card:
        card = card_line()
        log(f"device: cuda {torch.cuda.get_device_name(dev)}; {card}")
    else:
        # MKL's threaded batched LU hangs on the CPU on 3D fronts
        torch.set_num_threads(1)
        card = None
        log("device: cpu")

    gen = {"helmholtz2d": lambda: ht.helmholtz2d(args.n, k=args.k,
                                                 damping=args.damping),
           "poisson2d": lambda: ht.poisson2d(args.n),
           "helmholtz3d": lambda: ht.helmholtz3d(args.n, k=args.k),
           "poisson3d": lambda: ht.poisson3d(args.n)}[args.problem]
    A, b, shape = gen()
    b = np.asarray(b, dtype=np.complex128 if cplx else np.float64)
    log(f"{args.problem} n={args.n}: N={A.shape[0]}, nnz={A.nnz} "
        f"dtype={A.dtype}")

    fdt_name = args.factor_dtype or ("f32" if on_card else "f64")
    narrow, wide = (torch.complex64, torch.complex128) if cplx else \
        (torch.float32, torch.float64)
    fdtype = narrow if fdt_name == "f32" else wide
    opts = ht.SolverOptions(swlevel=args.swlevel, swsize=args.swsize)
    if args.atol is not None:
        opts = opts.replace(atol=args.atol, rtol=args.atol)
    if args.kest is not None:
        opts = opts.replace(kest=args.kest)
    if args.rank_cap is not None:
        opts = opts.replace(rank_cap=args.rank_cap)
    if args.level_caps is not None:
        opts = opts.replace(level_caps=tuple(
            int(c) for c in args.level_caps.split(",")))
    if args.explicit_inverse is not None:
        opts = opts.replace(explicit_inverse=args.explicit_inverse == "1")

    tree = ht.nested_dissection(shape, leafmax=args.leafmax)
    # warm the planner's code paths on a tiny problem, as bench.py does
    Aw, _, sw = ht.poisson2d(8)
    ht.plan_factorization(Aw, ht.nested_dissection(sw, leafmax=16), opts)

    def amortised(fn) -> float:
        """Seconds per call of ``reps`` calls back to back (after a cold one
        the caller made): one pair of CUDA events on the card, the host
        clock on the CPU."""
        if not on_card:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn()
            return (time.perf_counter() - t0) / args.reps
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / args.reps

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # plan: host clock, best of reps, split into symbolic and schedule
    t_sym = t_sched = float("inf")
    plan, first = None, {}
    for _ in range(args.reps):
        t0 = time.perf_counter()
        p = ht.plan_factorization(A, tree, opts)
        dt = time.perf_counter() - t0
        first.setdefault("plan", dt)
        sym = p.timings["symbolic_s"]
        t_sym, t_sched = min(t_sym, sym), min(t_sched, dt - sym)
        plan = plan or p
    log(f"  plan: sym={t_sym * 1e3:.1f}ms sched={t_sched * 1e3:.1f}ms")

    holder = {}

    def run_factor():
        holder["F"] = ht.factor_with_plan(plan, opts, dtype=fdtype, device=dev)

    if on_card:
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        base_mem = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    run_factor()
    sync()
    first["factor"] = time.perf_counter() - t0
    peak_mb = (torch.cuda.max_memory_allocated(dev) - base_mem) / 2 ** 20 \
        if on_card else None
    log(f"  factor cold: {first['factor']:.3f}s")

    wname, nname = (str(t).replace("torch.", "") for t in (wide, narrow))
    op_outer, mv = ht.spmv_format(A, dtype=np.dtype(wname), device=dev)
    bt = torch.as_tensor(b, device=dev)
    inner = {}
    if on_card and args.inner == "f32":
        inner = dict(inner_dtype=nname, m_eps=1e-6, mv_data_inner=(
            ht.spmv_format(A, dtype=np.dtype(nname), device=dev)[0]))

    def precond(data, v):
        return solve_with_data(data, v.to(fdtype)).to(v.dtype)

    def run_solve():
        # fetch_info=False, as bench.py: the diagnostics stay on the device
        # and are fetched once after the timers
        holder["x"], holder["info"] = ht.gmres_compiled(
            mv, precond, bt, reltol=args.reltol, restart=30,
            maxiter=args.maxiter, mv_data=op_outer,
            M_data=holder["F"].solve_data, fetch_info=False, **inner)

    t0 = time.perf_counter()
    run_solve()
    sync()
    first["solve"] = time.perf_counter() - t0
    log(f"  solve cold: {first['solve']:.3f}s")

    t_factor = amortised(run_factor)
    log(f"  factor(numeric): {t_factor * 1e3:.1f}ms/rep")
    # the solve's CUDA graph lives with the factor it reads: the last rep's
    # factor is new, so its first solve captures (outside the timers, as the
    # cold solve above)
    t0 = time.perf_counter()
    run_solve()
    sync()
    log(f"  solve cold on the last factor: {time.perf_counter() - t0:.3f}s")
    t_solve = amortised(run_solve)
    log(f"  solve: {t_solve * 1e3:.2f}ms/rep")

    # diagnostics, outside the timers
    x, info = holder["x"], ht.fetch_gmres_info(holder["info"])
    xh = x.cpu().numpy()
    if xh.shape != b.shape or not np.all(np.isfinite(xh)):
        raise RuntimeError(f"the solution has shape {xh.shape} or values that "
                           "are not finite")
    iters = int(info["iters"])
    res = float(np.linalg.norm(b - A @ xh) / np.linalg.norm(b))
    cond_dev, cond_thresh = holder["F"].max_diag_ratio_device()
    cond = float(cond_dev)
    log(f"best: plan={t_sym + t_sched:.4f}s factor={t_factor:.4f}s "
        f"solve={t_solve:.4f}s iters={iters} relres={res:.2e} "
        f"max_diag_ratio={cond:.2e}")

    # the baseline proxy: single-core scipy SuperLU, after the timed reps
    t_base = float("inf")
    try:
        Ac = A.tocsc()
        for _ in range(min(args.reps, 3)):
            t0 = time.perf_counter()
            lu = spla.splu(Ac)
            lu.solve(b)
            t_base = min(t_base, time.perf_counter() - t0)
        del lu
        log(f"baseline proxy (scipy splu factor+solve, 1 CPU core, best of "
            f"{min(args.reps, 3)}): {t_base:.3f}s")
    except Exception as e:             # 3D fill-in may exhaust host memory
        log(f"baseline proxy FAILED ({e!r}); vs_baseline unavailable")

    best_total = t_sched + t_factor + t_solve
    roofline = roofline_report(plan, measured_factor_s=max(t_factor, 1e-9),
                               dtype_bytes=fdtype.itemsize)
    log("roofline: " + json.dumps({k: v for k, v in roofline.items()
                                   if k != "per_level"}))
    if roofline["sol_violation"]:
        log("ERROR: roofline physics violation - the measured factor time is "
            "faster than the model's speed-of-light bound (or the achieved "
            "GFLOP/s exceed the card's peak).  The FLOP model over-counts or "
            "the timing under-measures; this row is NOT a valid performance "
            "result and is flagged in the line.")
    tag = metric_tag(args, fdtype == wide)
    base_ok = math.isfinite(t_base)
    result = {
        "metric": f"{args.problem}_h{args.n}{tag}_setup_plus_gmres_solve",
        "value": round(best_total, 4),
        "unit": "seconds",
        "vs_baseline": round(t_base / best_total, 3) if base_ok else None,
        "detail": {
            "setup_s": round(t_sched + t_factor, 4),
            "solve_s": round(t_solve, 4),
            "factor_s": round(t_factor, 4),
            "plan_s": round(t_sym + t_sched, 4),
            "plan_symbolic_s": round(t_sym, 4),
            "plan_schedule_s": round(t_sched, 4),
            "total_incl_symbolic_s": round(t_sym + best_total, 4),
            "vs_baseline_incl_symbolic": round(t_base / (t_sym + best_total), 3)
            if base_ok else None,
            "gmres_iters": iters, "relres": res,
            "max_diag_ratio": cond,
            "cond_risky": None if cond_thresh == float("inf")
            else bool(cond > cond_thresh),
            "cond_risk_threshold": None if cond_thresh == float("inf")
            else round(float(cond_thresh), 1),
            "factor_gflops": roofline["factor_gflops"],
            "achieved_gflop_s": roofline["achieved_gflop_s"],
            "nnz_per_s": roofline["nnz_per_s"],
            "speed_of_light_s": roofline["speed_of_light_s"],
            "sol_fraction": roofline["sol_fraction"],
            "sol_violation": roofline["sol_violation"],
            "baseline_proxy": "scipy_splu_1core_seconds",
            "baseline_proxy_s": round(t_base, 4) if base_ok else None,
            "first_rep_setup_s": round(first["plan"] + first["factor"], 4),
            "first_rep_solve_s": round(first["solve"], 4),
            "device": dev.type,
            "card": card,
            "factor_dtype": str(fdtype).replace("torch.", ""),
            "factor_peak_mb": None if peak_mb is None else round(peak_mb, 1),
        },
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
