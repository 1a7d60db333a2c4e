#!/usr/bin/env python3
"""Where kernel C's forward step spends its time on the damped n=512 exact
plan, on one NVIDIA GPU, per value type and level (card only).

Builds copies of ``hsolve_torch/csrc/sweep_update.cu`` into
``build/c_breakdown/``, with ``-Xptxas -v``: as it is and, where the source
still has the lines they replace, without the panel updates of the
substitution, without its diagonal-block solves, and with its per-panel
barrier over the front's CTAs cut to a warp's (those copies compute wrong
values: only their times are read).  It prints each ``level_forward``
instance's registers, stack and spills, then times every level of the
helmholtz2d(512, k=40) exact plan's forward step (the damped system,
damping 0.1, for complex128 and complex64; the undamped one for float64
and float32) in the lu form, and at the leaf and the top level in the dinv
form too: each copy, the wrapper, the library sequence chip_smoke times
(gather, bmm, ``index_put_``, ``lu_solve`` or the dinv product,
``index_put_``) and the plain version, device only (launches queued behind
a sleep kernel, between CUDA events).  With ``--wide`` it reads instead the fronts wider than 2048 rows
the plans take (helmholtz2d(1026)'s 2056-row root, helmholtz3d(64)'s two
3912-row fronts with their 3976 boundary rows and its 7944-row root, and
chip_smoke's 4424-row hand front, the helmholtz3d(48) exact root's width),
made by hand (a well-conditioned pivot block, LU with pivoting), each type:
the wrapper, the library sequence, the plain version and the bound,
device only.  Run from a tree's root; it imports only the tree's public
wrappers, so it runs unchanged in an earlier tree copied beside it:

    python3 tools/c_breakdown.py [--dtypes complex128 ...] [--no-copies]
                                 [--wrapper-only] [--wide] [--out DIR]
"""

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hsolve_torch as ht  # noqa: E402
from hsolve_torch import kernels  # noqa: E402
from hsolve_torch.factor import DenseLevel  # noqa: E402
from hsolve_torch.ops import dense as dk  # noqa: E402
from hsolve_torch.ops.sweep import (forward_windows, level_forward,  # noqa: E402
                                    level_forward_plain)

SRC = os.path.join(ROOT, "hsolve_torch", "csrc", "sweep_update.cu")
OUT = os.path.join(ROOT, "build", "c_breakdown")
UPDATE = ("    if (takes(p)) zr -= panel_update<T, VEC>(seg, ys + (p0 - y0), "
          "ni, p0, lane);")
SOLVE_F = "          if (lane > i) v -= hs_wide(dgw[lane * HS_C_DG_LD + i]) * yi;"
SOLVE_B = "          if (lane < i) v -= hs_wide(dgw[lane * HS_C_DG_LD + i]) * yi;"
SYNC = "    front_sync(cs);\n    if (takes(p))"
VARIANTS = {"no panel updates": [(UPDATE, "")],
            "no diagonal solves": [(SOLVE_F, ""), (SOLVE_B, "")],
            "warp barrier": [(SYNC, "    __syncwarp();\n    if (takes(p))")]}
HBM_BPS = 3.35e12
PEAK = {"float64": 34e12, "float32": 67e12, "complex128": 34e12,
        "complex64": 67e12}


def nvcc():
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")


def build(copies=True):
    """{variant: CDLL}, and the ptxas report of the kernel as it is
    (``copies``: also the copies without a part)."""
    os.makedirs(OUT, exist_ok=True)
    src = open(SRC).read()
    procs = {}
    for i, (name, subs) in enumerate(
            {"kernel": [], **(VARIANTS if copies else {})}.items()):
        text = src
        if any(text.count(a) != 1 for a, _ in subs):
            print(f"c_breakdown: this tree has no {name!r} copy (its lines "
                  "changed)", flush=True)
            continue
        for a, b in subs:
            text = text.replace(a, b)
        cu, so = os.path.join(OUT, f"v{i}.cu"), os.path.join(OUT, f"v{i}.so")
        open(cu, "w").write(text)
        procs[name] = (so, subprocess.Popen(
            [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-I", os.path.dirname(SRC), "-Xcompiler", "-fPIC",
             "-shared", "-o", so, cu] + (["-Xptxas", "-v"] if name == "kernel"
                                         else []),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, report = {}, ""
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"c_breakdown: nvcc failed for {name}:\n{out}")
        if name == "kernel":
            report = out
        libs[name] = ctypes.CDLL(so)
    return libs, report


def ptxas_lines(report):
    """The ptxas lines of the forward step's kernels, demangled."""
    lines, cur, keep = [], None, []
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(_Z\w+)", line)
        if m:
            cur = m.group(1)
        if cur and ("level_forward_kernel" in cur or "window_solve" in cur):
            keep.append((cur, line.strip()))
    names = sorted({c for c, _ in keep})
    try:
        dem = subprocess.run([os.path.join(os.path.dirname(nvcc()), "cu++filt")],
                             input="\n".join(names), capture_output=True,
                             text=True).stdout.split("\n")
        pretty = dict(zip(names, dem))
    except OSError:
        pretty = {}
    for c, line in keep:
        if "Compiling entry" in line:
            lines.append(pretty.get(c, c) or c)
        elif "spill" in line or "Used" in line:
            lines.append("    " + line.split("info    : ")[-1])
    return lines


def fmt(ms):
    return "not read" if ms is None else f"{ms:.4f}"


def queued_ms(fn, reps=20):
    """Device ms per call of ``fn``, queued behind a sleep kernel; None
    where the host's launches never got ahead of the device."""
    fn()
    torch.cuda.synchronize()
    cycles = 2_000_000
    for _ in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4
    return None


def events_ms(fn, reps=5):
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


def run(libs, dname, out_rows):
    dev = torch.device("cuda", 0)
    dt = getattr(torch, dname)
    damping = 0.1 if dt.is_complex else 0.0
    A, _, shape = ht.helmholtz2d(512, k=40.0, damping=damping)
    opts = ht.SolverOptions(swlevel=0)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 opts)
    F = ht.factor_with_plan(plan, opts, dtype=dt, device=dev)
    N = plan.N
    levels = [lv for lv in F.levels if getattr(lv, "L", None) is not None
              and getattr(lv, "lu", None) is not None]
    g = torch.Generator(device=dev).manual_seed(0)
    C0 = torch.randn(N + 1, 1, dtype=dt, device=dev, generator=g)
    C0[N] = 0.0
    e = C0.element_size()
    fm = 4 if dt.is_complex else 1
    fns = {name: getattr(lib, kernels.symbol("hs_level_forward", dt))
           for name, lib in libs.items()}
    for fn in fns.values():
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    last = len(levels) - 1
    for bidx, lev in enumerate(levels):
        recs = [("lu", lev)]
        if bidx in (0, last):
            recs.append(("dinv", dataclasses.replace(
                lev, lu=None, perm=None,
                dinv=dk.lu_inverse(lev.lu, lev.perm).contiguous())))
        B, nb, ni = lev.L.shape
        wins = forward_windows(ni)
        int_l = lev.int_ids.long().reshape(-1)
        bnd_l = lev.bnd_ids.long().reshape(-1)
        for form, lv in recs:
            scratch = C0.clone()
            row = {"dtype": dname, "level": bidx, "form": form, "B": B,
                   "ni": ni, "nb": nb, "cluster": wins[0][2]}
            M = lv.dinv if lv.dinv is not None else lv.lu
            nbytes = sum(t.numel() * t.element_size() for t in
                         (M, lv.L, lv.int_ids, lv.bnd_ids)) \
                + (lv.perm.numel() * 8 if lv.dinv is None else 0) \
                + 2 * B * ni * e + 2 * B * nb * e
            flops = 2 * fm * (M.numel() + lv.L.numel())
            row["bound_ms"] = max(nbytes / HBM_BPS, flops / PEAK[dname]) * 1e3
            ref = level_forward_plain(C0.clone(), lv, N)
            got = level_forward(C0.clone(), lv, N)
            row["max_abs_err"] = float((got - ref).abs().max())
            row["ms"] = queued_ms(lambda: level_forward(scratch, lv, N))
            if len(wins) == 1:
                args = (scratch.data_ptr(), lv.int_ids.data_ptr(),
                        lv.bnd_ids.data_ptr(), lv.L.data_ptr(),
                        None if lv.dinv is not None else lv.lu.data_ptr(),
                        None if lv.dinv is not None else lv.perm.data_ptr(),
                        None if lv.dinv is None else lv.dinv.data_ptr(),
                        B, ni, nb, 1, N, wins[0][2], stream)
                for name, fn in fns.items():
                    if fn(*args) != 0:
                        raise SystemExit(f"c_breakdown: {name} was not "
                                         "launched")
                    row[name] = queued_ms(lambda: fn(*args))

            def library():
                x = scratch[lv.int_ids]
                scratch.index_put_((bnd_l,), -(lv.L @ x).reshape(-1, 1),
                                   accumulate=True)
                xs = lv.dinv @ x if lv.dinv is not None else \
                    dk.lu_solve(lv.lu, lv.perm, x)
                scratch.index_put_((int_l,), xs.reshape(-1, 1))

            # the library sequence may wait on the host (then back to back
            # between CUDA events, the host's rate: "library_hb")
            row["library_ms"] = queued_ms(library)
            if row["library_ms"] is None:
                row["library_ms"], row["library_hb"] = events_ms(library), True
            row["plain_ms"] = events_ms(lambda: level_forward_plain(
                scratch, lv, N))
            out_rows.append(row)
            parts = ", ".join(f"{k} {fmt(row[k])}" for k in
                              ["kernel", *VARIANTS] if k in row)
            print(f"{dname} level {bidx} {form} B={B} ni={ni} nb={nb} "
                  f"cluster {row['cluster']}: wrapper {fmt(row['ms'])} ms"
                  + (f" ({parts})" if parts else "")
                  + f", library {fmt(row['library_ms'])}"
                  + (" (host's rate)" if row.get("library_hb") else "")
                  + ", plain "
                  f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f}, "
                  f"max abs err {row['max_abs_err']:.3e}", flush=True)
    del F
    torch.cuda.empty_cache()


# (B, ni_pad, nb_pad) of the fronts above 2048 rows: helmholtz2d(1026)'s
# root, chip_smoke's hand front, helmholtz3d(64)'s two levels
WIDE_SHAPES = ((1, 2056, 0), (1, 4424, 24), (2, 3912, 3976), (1, 7944, 0))


def wide_level(dev, dt, B, ni, nb, N, seed):
    """``B`` dense fronts of ``ni`` interior and ``nb`` boundary rows made by
    hand: well-conditioned pivot blocks (LU with pivoting), random Gauss
    transforms, distinct ids below N."""
    g = torch.Generator(device=dev).manual_seed(seed)
    D = torch.randn(B, ni, ni, dtype=dt, device=dev, generator=g) / ni ** 0.5 \
        + 2.0 * torch.eye(ni, dtype=dt, device=dev)
    lu, perm = dk.lu_factor(D)
    del D
    ids = torch.randperm(N, device=dev, generator=g)[:B * (ni + nb)].to(
        torch.int32).reshape(B, ni + nb)
    return DenseLevel(lu=lu, perm=perm,
                      L=torch.randn(B, nb, ni, dtype=dt, device=dev,
                                    generator=g),
                      R=torch.zeros(B, ni, nb, dtype=dt, device=dev),
                      int_ids=ids[:, :ni].contiguous(),
                      bnd_ids=ids[:, ni:].contiguous())


def run_wide(dname, out_rows):
    dev = torch.device("cuda", 0)
    dt = getattr(torch, dname)
    fm = 4 if dt.is_complex else 1
    for B, ni, nb in WIDE_SHAPES:
        N = B * (ni + nb) + 64
        lev = wide_level(dev, dt, B, ni, nb, N, seed=ni)
        g = torch.Generator(device=dev).manual_seed(1)
        C0 = torch.randn(N + 1, 1, dtype=dt, device=dev, generator=g)
        C0[N] = 0.0
        e = C0.element_size()
        int_l = lev.int_ids.long().reshape(-1)
        bnd_l = lev.bnd_ids.long().reshape(-1)
        nbytes = sum(t.numel() * t.element_size() for t in
                     (lev.lu, lev.L, lev.int_ids, lev.bnd_ids)) \
            + lev.perm.numel() * 8 + 2 * B * ni * e + 2 * B * nb * e
        flops = 2 * fm * (lev.lu.numel() + lev.L.numel())
        row = {"dtype": dname, "wide": True, "B": B, "ni": ni, "nb": nb,
               "bound_ms": max(nbytes / HBM_BPS, flops / PEAK[dname]) * 1e3}
        ref = level_forward_plain(C0.clone(), lev, N)
        got = level_forward(C0.clone(), lev, N)
        scale = float(ref[int_l].abs().max())
        row["max_abs_err"] = float((got - ref).abs().max())
        row["rel_interior"] = float((got[int_l] - ref[int_l]).abs().max()) \
            / scale
        scratch = C0.clone()
        row["ms"] = queued_ms(lambda: level_forward(scratch, lev, N))

        def library():
            x = scratch[lev.int_ids]
            scratch.index_put_((bnd_l,), -(lev.L @ x).reshape(-1, 1),
                               accumulate=True)
            scratch.index_put_((int_l,), dk.lu_solve(lev.lu, lev.perm, x)
                               .reshape(-1, 1))

        row["library_ms"] = queued_ms(library)
        if row["library_ms"] is None:
            row["library_ms"], row["library_hb"] = events_ms(library), True
        row["plain_ms"] = events_ms(lambda: level_forward_plain(
            scratch, lev, N))
        out_rows.append(row)
        print(f"{dname} wide [{B}, {ni}, {nb}]: wrapper {fmt(row['ms'])} ms, "
              f"library {fmt(row['library_ms'])}"
              + (" (host's rate)" if row.get("library_hb") else "")
              + f", plain {row['plain_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f}, interior rel err "
              f"{row['rel_interior']:.3e}, max abs err "
              f"{row['max_abs_err']:.3e}", flush=True)
        del lev, scratch, ref, got
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtypes", nargs="+",
                    default=["complex128", "complex64", "float64", "float32"],
                    choices=["float64", "float32", "complex64", "complex128"])
    ap.add_argument("--out", default=None,
                    help="a directory for c_breakdown.json")
    ap.add_argument("--no-copies", action="store_true",
                    help="build and read the kernel as it is only")
    ap.add_argument("--wrapper-only", action="store_true",
                    help="build no copy: read the wrapper, the library "
                    "sequence and the plain version")
    ap.add_argument("--wide", action="store_true",
                    help="read the fronts above 2048 rows (WIDE_SHAPES) "
                    "instead of the n=512 plan's levels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("c_breakdown: needs an NVIDIA GPU")
    torch.set_num_threads(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    rows = []
    if args.wide:
        kernels.lib()
        for dname in args.dtypes:
            run_wide(dname, rows)
    else:
        libs, report = ({}, "") if args.wrapper_only else \
            build(not args.no_copies)
        for line in ptxas_lines(report):
            print(line, flush=True)
        for dname in args.dtypes:
            run(libs, dname, rows)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = "c_breakdown_wide.json" if args.wide else "c_breakdown.json"
        with open(os.path.join(args.out, name), "w") as f:
            json.dump({"card": card, "tree": ROOT, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
