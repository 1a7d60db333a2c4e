#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hsolve_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line is printed):

1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and power
   limit;
2. build: the four CUDA kernels are compiled from ``hsolve_torch/csrc/`` for
   ``sm_90a``;
3. kernels: each kernel's wrapper runs on the card at the n=512 plan's real
   shapes and is held against its plain torch version on the same inputs
   (A and B bitwise, C and D to a relative error of 1e-13, since only the
   summation order differs); each is timed with CUDA events beside its plain
   version (median of 10 runs after warm-up);
4. main path at n=128 and n=512: helmholtz2d (k=40) -> nested_dissection
   (leafmax=100) -> plan_factorization (swlevel=0) -> factor_with_plan (float64,
   cuda) -> gmres_compiled (reltol 1e-9, restart 30, maxiter 60, the factor as
   right preconditioner, the DIA matvec).  It must converge, pass an independent
   scipy check ||b - A x|| / ||b|| <= 1e-9 on the host, and launch every kernel
   (the launch counters are reset just before the run and read just after);
5. output: a JSON line with one entry per kernel, then the card line, then
   ``{"ok": true, "device": {...}}`` as the last line.

The script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
RTOL_SUM = 1e-13      # C and D: the kernel and plain sums differ only in order
RELRES = 1e-9         # GMRES target and the independent residual check
FWD_N128 = 1e-6       # forward error against scipy's spsolve at n=128


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median over ``reps`` runs of ``fn`` timed with CUDA events (ms)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def errors(a, b):
    """(max abs difference, that over max |b|)."""
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    return err, err / (scale if scale > 0 else 1.0)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    if not out:
        fail("nvidia-smi printed nothing")
    return out


class Problems:
    """helmholtz2d(n, k=40) per n, generated once per run."""

    def __init__(self):
        self._cache = {}

    def get(self, n: int):
        import hsolve_torch as ht

        if n not in self._cache:
            t0 = time.perf_counter()
            self._cache[n] = ht.helmholtz2d(n, k=40.0)
            log(f"  helmholtz2d({n}): N={self._cache[n][0].shape[0]} "
                f"nnz={self._cache[n][0].nnz} generated in "
                f"{time.perf_counter() - t0:.2f} s (host)")
        return self._cache[n]


def check_kernels(problems: Problems, n: int, dev) -> list:
    """Phase 3: every kernel against its plain version at the n-plan's shapes."""
    import numpy as np
    import torch

    import hsolve_torch as ht
    from hsolve_torch.factor import _factor_levels
    from hsolve_torch.interop import plan_to_torch
    from hsolve_torch.ops.assembly import (extend_add, extend_add_plain,
                                           front_assemble, front_assemble_plain)
    from hsolve_torch.ops.sparse import dia_spmv, dia_spmv_plain
    from hsolve_torch.ops.sweep import sweep_update, sweep_update_plain

    A, b, shape = problems.get(n)
    opts = ht.SolverOptions(swlevel=0)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 opts)
    tp = plan_to_torch(plan, dev)
    levels, _, stacks = _factor_levels(plan, tp, opts, torch.float64)
    torch.cuda.synchronize()
    nb = len(plan.batches)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    def record(name, shape_desc, errs, limit, ms, plain_ms):
        err, rel = errs
        ok = rel <= limit
        log(f"  {name:15s} {shape_desc:44s} max_abs_err={err:.3e} rel={rel:.3e}"
            f" (limit {limit:g})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
            f"{'' if ok else '  MISMATCH'}")
        if not ok:
            fail(f"{name} disagrees with its plain version at {shape_desc}")
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": ms,
                                      "plain_ms": plain_ms})
        r["max_abs_err"] = max(r["max_abs_err"], err)

    # A: front assembly, leaf batch and root batch (real values)
    for bidx in (0, nb - 1):
        bp, tb = plan.batches[bidx], tp.batches[bidx]
        args = (bp.B, bp.m_pad, tb.pos, tb.src, tp.adata)
        ker = front_assemble(*args)
        ref = front_assemble_plain(*args)
        if not torch.equal(ker, ref):
            fail(f"front_assemble is not bitwise equal at batch {bidx}")
        record("front_assemble", f"batch {bidx} [{bp.B},{bp.m_pad},{bp.m_pad}] "
               f"nnz={len(bp.front_pos)}", errors(ker, ref), 0.0,
               time_ms(lambda: front_assemble(*args)),
               time_ms(lambda: front_assemble_plain(*args)))

    # B: extend-add, first branch batch and root batch (real Schur stacks)
    for bidx in (1, nb - 1):
        bp, tb = plan.batches[bidx], tp.batches[bidx]
        base = front_assemble_plain(bp.B, bp.m_pad, tb.pos, tb.src, tp.adata)
        calls = [(stacks[s], sr, dr, imap)
                 for groups, imap in ((tb.groups_l, tb.map_l),
                                      (tb.groups_r, tb.map_r))
                 for s, sr, dr in groups]
        ker, ref = base.clone(), base.clone()
        for c in calls:
            extend_add(ker, *c)
            extend_add_plain(ref, *c)
        if not torch.equal(ker, ref):
            fail(f"extend_add is not bitwise equal at batch {bidx}")
        scratch = base.clone()

        def run_k():
            for c in calls:
                extend_add(scratch, *c)

        def run_p():
            for c in calls:
                extend_add_plain(scratch, *c)

        record("extend_add", f"batch {bidx} [{bp.B},{bp.m_pad},{bp.m_pad}] "
               f"{len(calls)} groups", errors(ker, ref), 0.0, time_ms(run_k),
               time_ms(run_p))

    # C: sweep update, leaf level and the top level with a boundary (the root
    # front has nb_pad = 0); forward (X given) and backward (ids_in) forms
    N = plan.N
    top = max(i for i, bp in enumerate(plan.batches) if bp.nb_pad > 0)
    C0 = torch.randn(N + 1, 1, dtype=torch.float64, device=dev, generator=gen)
    C0[N] = 0.0
    for bidx in (0, top):
        lev = levels[bidx]
        x = C0[lev.int_ids]
        for form, M, ids_out, kw in (
                ("fwd", lev.L, lev.bnd_ids, {"X": x}),
                ("bwd", lev.R, lev.int_ids, {"ids_in": lev.bnd_ids})):
            ker = sweep_update(C0.clone(), ids_out, M, N, **kw)
            ref = sweep_update_plain(C0.clone(), ids_out, M, N, **kw)
            scratch = C0.clone()
            record("sweep_update", f"level {bidx} {form} M={list(M.shape)} k=1",
                   errors(ker, ref), RTOL_SUM,
                   time_ms(lambda: sweep_update(scratch, ids_out, M, N, **kw)),
                   time_ms(lambda: sweep_update_plain(scratch, ids_out, M, N,
                                                      **kw)))

    # D: DIA matvec and fused residual on the original matrix
    op, _ = ht.spmv_format(A, device=dev)
    xv = torch.randn(A.shape[0], 1, dtype=torch.float64, device=dev,
                     generator=gen)
    bv = torch.as_tensor(np.asarray(b)[:, None], device=dev)
    for form, extra in (("A x", ()), ("b - A x", (bv,))):
        ker = dia_spmv(op, xv, *extra)
        ref = dia_spmv_plain(op, xv, *extra)
        record("dia_spmv", f"{form} N={A.shape[0]} ndiag={len(op.offsets)} k=1",
               errors(ker, ref), RTOL_SUM,
               time_ms(lambda: dia_spmv(op, xv, *extra)),
               time_ms(lambda: dia_spmv_plain(op, xv, *extra)))
    torch.cuda.synchronize()
    return results


def main_path(problems: Problems, n: int, dev) -> dict:
    """Phase 4: the user's workflow at size n; returns its timings and checks."""
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    import hsolve_torch as ht
    from hsolve_torch.factor import solve_with_data

    A, b, shape = problems.get(n)
    opts = ht.SolverOptions(swlevel=0)
    tree = ht.nested_dissection(shape, leafmax=100)
    plan_s = []
    for _ in range(2):                       # the second call is warm
        t0 = time.perf_counter()
        plan = ht.plan_factorization(A, tree, opts)
        plan_s.append(time.perf_counter() - t0)
    shapes = [(bp.B, bp.ni_pad, bp.nb_pad) for bp in plan.batches]
    log(f"  n={n}: {len(plan.batches)} batches (B, ni_pad, nb_pad): {shapes}")

    F = ht.factor_with_plan(plan, opts, device=dev)            # cold
    torch.cuda.synchronize()
    factor_ms = time_ms(lambda: ht.factor_with_plan(plan, opts, device=dev),
                        reps=3, warmup=1)
    op, mv = ht.spmv_format(A, device=dev)
    bt = torch.as_tensor(np.asarray(b), device=dev)
    out = {}

    def solve():
        out["x"], out["info"] = ht.gmres_compiled(
            mv, solve_with_data, bt, reltol=RELRES, restart=30, maxiter=60,
            mv_data=op, M_data=F.solve_data)

    solve()                                                    # cold
    torch.cuda.synchronize()
    solve_ms = time_ms(solve, reps=3, warmup=1)
    x, info = out["x"], out["info"]
    xh = x.cpu().numpy()
    if xh.shape != (A.shape[0],) or not np.all(np.isfinite(xh)):
        fail(f"n={n}: solution has shape {xh.shape} or non-finite values")
    relres = float(np.linalg.norm(b - A @ xh) / np.linalg.norm(b))
    res = {"n": n, "N": int(A.shape[0]), "plan_s": plan_s[1],
           "plan_cold_s": plan_s[0], "factor_s": factor_ms / 1e3,
           "solve_s": solve_ms / 1e3, "iters": info["iters"],
           "converged": info["converged"], "relres_scipy": relres,
           "gmres_resnorm_last": float(info["resnorm"][-1]) / float(
               np.linalg.norm(b))}
    if n <= 128:
        x_ref = spla.spsolve(A.tocsc(), b)
        res["fwd_err_vs_spsolve"] = float(np.linalg.norm(xh - x_ref)
                                          / np.linalg.norm(x_ref))
    log(f"  n={n}: plan {res['plan_s']:.4f} s (warm; cold "
        f"{res['plan_cold_s']:.4f} s, host)  factor {res['factor_s']:.4f} s  "
        f"solve {res['solve_s']:.4f} s (warm, CUDA events)  iters "
        f"{res['iters']}  converged {res['converged']}  relres(scipy) "
        f"{relres:.3e}" + (f"  fwd err vs spsolve {res['fwd_err_vs_spsolve']:.3e}"
                           if "fwd_err_vs_spsolve" in res else ""))
    if not info["converged"]:
        fail(f"n={n}: GMRES did not converge ({info})")
    if not relres <= RELRES:
        fail(f"n={n}: independent residual {relres:.3e} > {RELRES}")
    if res.get("fwd_err_vs_spsolve", 0.0) > FWD_N128:
        fail(f"n={n}: forward error {res['fwd_err_vs_spsolve']:.3e} > {FWD_N128}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[128, 512],
                    help="main-path sizes n (helmholtz2d on an n x n mesh)")
    ap.add_argument("--kernel-n", type=int, default=512,
                    help="size whose plan gives the kernel-check shapes")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import hsolve_torch  # noqa: F401  (fails outside a checkout of the repo)
    from hsolve_torch import kernels

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = card_line()
    log(f"[1] device: {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    info = kernels.build(force=True)
    log(f"[2] built {len(kernels.sources())} CUDA sources for sm_90a in "
        f"{info['seconds']:.1f} s -> {os.path.relpath(kernels.LIB, HERE)}")
    for line in str(info["log"]).splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")

    problems = Problems()
    log(f"[3] kernels against their plain versions at the n={args.kernel_n} "
        "plan's shapes")
    kres = check_kernels(problems, args.kernel_n, dev)

    runs = []
    for n in args.sizes:
        log(f"[4] main path n={n}")
        kernels.reset_launch_counts()
        runs.append(main_path(problems, n, dev))
        counts = kernels.launch_counts()
        log(f"  n={n}: kernel launches {counts}")
        missing = [k for k, v in counts.items() if v <= 0]
        if missing:
            fail(f"n={n}: the main path never launched {missing}")
        runs[-1]["launches"] = counts

    sources = {"front_assemble": "front_assemble.cu",
               "extend_add": "extend_add.cu",
               "sweep_update": "sweep_update.cu", "dia_spmv": "dia_spmv.cu"}
    replaces = {"front_assemble": "hsolve/factor.py:409",
                "extend_add": "hsolve/factor.py:390",
                "sweep_update": "hsolve/factor.py:509",
                "dia_spmv": "hsolve/ops/sparse.py:98"}
    last = runs[-1]["launches"]
    table = [{"name": k, "route": "cuda",
              "source": f"hsolve_torch/csrc/{sources[k]}",
              "replaces": replaces[k], "launches": last[k],
              "max_abs_err": kres[k]["max_abs_err"], "ms": kres[k]["ms"],
              "plain_ms": kres[k]["plain_ms"]} for k in sources]
    log("[5] main path runs: " + json.dumps(
        [{k: v for k, v in r.items() if k != "launches"} for r in runs]))
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
