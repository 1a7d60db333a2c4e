#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hsolve_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line is printed):

1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and power
   limit;
2. build: the eleven CUDA kernels are compiled from ``hsolve_torch/csrc/`` for
   ``sm_90a``, one nvcc process per source, all started together;
3. kernels: each kernel's wrapper runs on the card at the n=512 plans' real
   shapes and is held against its plain torch version on the same inputs
   (A, B and G bitwise, H with equal pivots and ranks, C, D, E, F, I, J and K
   to a relative error of 1e-13, since only the summation order differs);
   each is timed with CUDA events beside its plain version (median of 10 runs
   after warm-up).  A-D run on the exact plan; E (forward and backward) and F
   on the first and the top compressed batch of the compressed plan, G on
   both sides of the first; H-K on the structured (HSS) plan: H on the inputs
   of the leaf and of an upper level of the first and the top structured
   batch and of the first transition batch, captured while that plan is
   factored, I-K on the HSS operands of those two batches (I on a leaf and a
   B12 extraction, J forward and adjoint at the sketch width and at k=1, K
   forward and adjoint as hss_factor runs it, k=r, and as hss_solve does,
   k=1);
4. main paths at n=128 and n=512: helmholtz2d (k=40) -> nested_dissection
   (leafmax=100) -> plan_factorization -> factor_with_plan (float64, cuda) ->
   gmres_compiled (reltol 1e-9, restart 30, maxiter 60, the factor as right
   preconditioner, the DIA matvec), first exact (swlevel=0), then low-rank
   compressed (swlevel=-2, swsize=16, atol=rtol=1e-3, kest=32, hss=False),
   then structured (the same options with hss=True, the default).  Each run
   must converge, pass an independent scipy check ||b - A x|| / ||b|| <= 1e-9
   on the host, and launch every kernel of its path (the launch counters are
   reset just before the run and read just after: A-D on the exact path, A-G
   on the compressed one, A-K on the structured one).  A compressed or
   structured run must also stay within twice the JAX package's CPU iteration
   counts (compressed 6 at n=128 and 7 at n=512, structured 5 and 18) and
   saturate no rank cap;
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
RTOL_SUM = 1e-13      # C-F: the kernel and plain sums differ only in order
RELRES = 1e-9         # GMRES target and the independent residual check
FWD_N128 = 1e-6       # forward error against scipy's spsolve at n=128 (exact)
# the slice's compressed configuration (README's switching level, the
# tolerance policy of CROSSOVER.md for compressed runs)
COMPRESSED = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3, kest=32,
                  hss=False)
HSS = {**COMPRESSED, "hss": True}
OPTIONS = {"exact": dict(swlevel=0), "compressed": COMPRESSED, "hss": HSS}
# twice the JAX package's GMRES iterations on the CPU for the same runs
MAX_ITERS = {"compressed": {128: 12, 512: 14}, "hss": {128: 10, 512: 36}}
SOURCES = {"front_assemble": ("front_assemble.cu", "hsolve/factor.py:409"),
           "extend_add": ("extend_add.cu", "hsolve/factor.py:390"),
           "sweep_update": ("sweep_update.cu", "hsolve/factor.py:509"),
           "dia_spmv": ("dia_spmv.cu", "hsolve/ops/sparse.py:98"),
           "lowrank_sweep_update": ("lowrank_sweep_update.cu",
                                    "hsolve/factor.py:528"),
           "lowrank_schur_update": ("lowrank_schur_update.cu",
                                    "hsolve/factor.py:378"),
           "lowrank_truncate": ("lowrank_truncate.cu",
                                "hsolve/ops/lowrank.py:157"),
           "cpqr_pivots": ("hss_cpqr.cu", "hsolve/ops/lowrank.py:195"),
           "hss_entries_prepared": ("hss_entries.cu", "hsolve/ops/hss.py:293"),
           "hss_matvec": ("hss_matvec.cu", "hsolve/ops/hss.py:207"),
           "hss_level_correct": ("hss_level_correct.cu",
                                 "hsolve/ops/hss.py:641")}


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg`` behind the seconds since the script started."""
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


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


class Results(dict):
    """Per kernel: the largest error against its plain version over the
    checked shapes, and the times at the first shape checked."""

    def record(self, name, shape_desc, errs, limit, ms, plain_ms):
        err, rel = errs
        ok = rel <= limit
        log(f"  {name:20s} {shape_desc:48s} max_abs_err={err:.3e} "
            f"rel={rel:.3e} (limit {limit:g})  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms{'' if ok else '  MISMATCH'}")
        if not ok:
            fail(f"{name} disagrees with its plain version at {shape_desc}")
        r = self.setdefault(name, {"max_abs_err": 0.0, "ms": ms,
                                   "plain_ms": plain_ms})
        r["max_abs_err"] = max(r["max_abs_err"], err)


def check_kernels(problems: Problems, n: int, dev, results: Results) -> None:
    """Phase 3, kernels A-D against their plain versions at the exact
    n-plan's shapes."""
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
    record = results.record

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


def check_compressed_kernels(problems: Problems, n: int, dev,
                             results: Results) -> None:
    """Phase 3, kernels E-G against their plain versions at the compressed
    n-plan's shapes: the fronts, sketches and factors of a real compressed
    factorization."""
    import torch

    import hsolve_torch as ht
    from hsolve_torch.factor import _factor_levels, torch_sketch
    from hsolve_torch.interop import plan_to_torch
    from hsolve_torch.ops.assembly import extend_add_plain, front_assemble_plain
    from hsolve_torch.ops.lowrank import (lowrank_truncate,
                                          lowrank_truncate_plain, sketch_width)
    from hsolve_torch.ops.schur import (lowrank_schur_update,
                                        lowrank_schur_update_plain)
    from hsolve_torch.ops.sweep import (lowrank_sweep_update,
                                        lowrank_sweep_update_plain)

    A, _, shape = problems.get(n)
    opts = ht.SolverOptions(**COMPRESSED)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 opts)
    tp = plan_to_torch(plan, dev)
    f64 = torch.float64
    levels, _, stacks = _factor_levels(plan, tp, opts, f64)
    torch.cuda.synchronize()
    comp = [i for i, bp in enumerate(plan.batches) if bp.compress]
    first, top = comp[0], comp[-1]
    record = results.record

    # E: both forms on the first and the top compressed level
    N = plan.N
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    C0 = torch.randn(N + 1, 1, dtype=f64, device=dev, generator=gen)
    C0[N] = 0.0
    for bidx in (first, top):
        lev = levels[bidx]
        x = C0[lev.int_ids]
        for form, U, V, ids_out, kw in (
                ("fwd", lev.LU_, lev.LV_, lev.bnd_ids, {"X": x}),
                ("bwd", lev.RU_, lev.RV_, lev.int_ids, {"ids_in": lev.bnd_ids})):
            ker = lowrank_sweep_update(C0.clone(), ids_out, U, V, N, **kw)
            ref = lowrank_sweep_update_plain(C0.clone(), ids_out, U, V, N, **kw)
            scratch = C0.clone()
            record("lowrank_sweep_update",
                   f"batch {bidx} {form} U={list(U.shape)} V={list(V.shape)[1:]}",
                   errors(ker, ref), RTOL_SUM,
                   time_ms(lambda: lowrank_sweep_update(scratch, ids_out, U, V,
                                                        N, **kw)),
                   time_ms(lambda: lowrank_sweep_update_plain(
                       scratch, ids_out, U, V, N, **kw)))

    def front_of(bidx):
        bp, tb = plan.batches[bidx], tp.batches[bidx]
        front = front_assemble_plain(bp.B, bp.m_pad, tb.pos, tb.src,
                                     tp.adata.to(f64))
        for groups, imap in ((tb.groups_l, tb.map_l), (tb.groups_r, tb.map_r)):
            for src, sr, dr in groups:
                extend_add_plain(front, stacks[src], sr, dr, imap)
        return bp, tb, front

    # F: the Schur update on the first and the top compressed level
    for bidx in (first, top):
        bp, tb, front = front_of(bidx)
        lev = levels[bidx]
        W = (front[:, bp.ni_pad:, :bp.ni_pad] @ lev.RU_).contiguous()
        args = (front, bp.ni_pad, W, lev.RV_, tb.sperm)
        ker = lowrank_schur_update(*args)
        ref = lowrank_schur_update_plain(*args)
        record("lowrank_schur_update",
               f"batch {bidx} [{bp.B},{bp.nb_pad},{bp.nb_pad}] k={bp.rank_cap}",
               errors(ker, ref), RTOL_SUM,
               time_ms(lambda: lowrank_schur_update(*args)),
               time_ms(lambda: lowrank_schur_update_plain(*args)))

    # G: the truncation of both sides of the first compressed level, with the
    # factorization's own sketches
    bp, tb, front = front_of(first)
    shapes = [(m, sketch_width(bp.rank_cap, m)) for m in (bp.ni_pad, bp.nb_pad)]
    om_bi, om_ib = torch_sketch(opts.seed, dev, f64)(first, *shapes)
    for side, blk, om in (("Abi", front[:, bp.ni_pad:, :bp.ni_pad], om_bi),
                          ("Aib", front[:, :bp.ni_pad, bp.ni_pad:], om_ib)):
        Q, _ = torch.linalg.qr(blk @ om)
        Uw, sv, Vh = torch.linalg.svd(Q.transpose(-1, -2) @ blk,
                                      full_matrices=False)
        args = ((Q @ Uw).contiguous(), sv.contiguous(), Vh.contiguous(),
                opts.c_tol * opts.atol, opts.c_tol * opts.rtol, bp.rank_cap)
        ker = lowrank_truncate(*args)
        ref = lowrank_truncate_plain(*args)
        if not all(torch.equal(a, b) for a, b in zip(ker, ref)):
            fail(f"lowrank_truncate is not bitwise equal at batch {first} {side}")
        record("lowrank_truncate",
               f"batch {first} {side} QU={list(args[0].shape)} cap={bp.rank_cap}",
               errors(ker[0], ref[0]), 0.0,
               time_ms(lambda: lowrank_truncate(*args)),
               time_ms(lambda: lowrank_truncate_plain(*args)))
    torch.cuda.synchronize()


def check_hss_kernels(problems: Problems, n: int, dev, results: Results) -> None:
    """Phase 3, kernels H-K against their plain versions at the structured
    n-plan's shapes: H on inputs captured while that plan is factored, I-K on
    the HSS operands of the factorization."""
    import importlib

    import torch

    import hsolve_torch as ht
    from hsolve_torch.factor import _factor_levels, torch_sketch
    from hsolve_torch.interop import plan_to_torch
    from hsolve_torch.ops import hss as H
    from hsolve_torch.ops import lowrank as L

    fm = importlib.import_module("hsolve_torch.factor")  # ht.factor: the function
    A, _, shape = problems.get(n)
    opts = ht.SolverOptions(**HSS)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 opts)
    tp = plan_to_torch(plan, dev)
    f64 = torch.float64
    struct = [i for i, bp in enumerate(plan.batches) if bp.structured]
    trans = [i for i, bp in enumerate(plan.batches)
             if bp.compress and not bp.structured and bp.cplan is not None]
    if not struct or not trans:
        fail(f"n={n}: the HSS plan has no structured or no transition batch")
    first, top = struct[0], struct[-1]

    # H's inputs: per compression of interest, its first call (the leaf level)
    # and its first call on a [s, 2r] panel (an upper level)
    where = {"tag": None, "calls": 0, "cap": 0}
    captured = []
    orig = (L.cpqr_pivots, fm._run_structured, fm.transition_compress)

    def cpqr_rec(Am, atol, rtol, k):
        tag = where["tag"]
        kind = "leaf" if where["calls"] == 0 else \
            "upper" if Am.shape[-1] == 2 * where["cap"] else None
        if tag is not None and kind is not None and \
                (tag, kind) not in {c[:2] for c in captured}:
            captured.append((tag, kind, Am.clone(), atol, rtol, k))
        where["calls"] += 1
        return orig[0](Am, atol, rtol, k)

    # the wrapper counts its launches on whatever its module name holds
    cpqr_rec.launches = 0

    def run_rec(bp, tb, s_stacks, opts_, dtype, bidx, sketch):
        where.update(tag=f"batch {bidx} (structured)" if bidx in (first, top)
                     else None, calls=0, cap=bp.rank_cap)
        try:
            return orig[1](bp, tb, s_stacks, opts_, dtype, bidx, sketch)
        finally:
            where["tag"] = None

    def trans_rec(S, n1, n2, cplan, atol, rtol, cap):
        where.update(tag="transition" if not any(
            c[0] == "transition" for c in captured) else None, calls=0, cap=cap)
        try:
            return orig[2](S, n1, n2, cplan, atol, rtol, cap)
        finally:
            where["tag"] = None

    L.cpqr_pivots, fm._run_structured, fm.transition_compress = \
        cpqr_rec, run_rec, trans_rec
    try:
        levels, _, _ = _factor_levels(plan, tp, opts, f64)
    finally:
        L.cpqr_pivots, fm._run_structured, fm.transition_compress = orig
    torch.cuda.synchronize()
    record = results.record

    # H: equal pivots and ranks
    tags = {f"batch {b} (structured)" for b in (first, top)} | {"transition"}
    if {c[:2] for c in captured} != {(t, k) for t in tags
                                     for k in ("leaf", "upper")}:
        fail(f"captured cpqr inputs {sorted(c[:2] for c in captured)}")
    for tag, kind, Am, atol, rtol, k in captured:
        ker = L.cpqr_pivots(Am, atol, rtol, k)
        ref = L.cpqr_pivots_plain(Am, atol, rtol, k)
        if not all(torch.equal(a, b) for a, b in zip(ker, ref)):
            fail(f"cpqr_pivots selects other pivots or ranks than its plain "
                 f"version at {tag} {kind} {list(Am.shape)}")
        record("cpqr_pivots", f"{tag} {kind} A={list(Am.shape)} k={k}",
               (0.0, 0.0), 0.0, time_ms(lambda: L.cpqr_pivots(Am, atol, rtol, k)),
               time_ms(lambda: L.cpqr_pivots_plain(Am, atol, rtol, k)))

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    for bidx in (first, top):
        bp, lev = plan.batches[bidx], levels[bidx]
        h2 = lev.H2
        p2 = h2.plan
        # I: the leaf D blocks and a level-1 B12 block of S22''s operand
        ef = H.hss_entry_factors(h2)
        leaf = torch.arange(p2.n_pad, device=dev).reshape(1, p2.nleaves,
                                                         p2.ls).expand(h2.B, -1, -1)
        m1 = p2.nleaves // 2
        off = torch.arange(m1, device=dev)[None, :, None] * (2 * p2.ls)
        rows = off + torch.randint(0, p2.ls, (h2.B, m1, h2.r), device=dev,
                                   generator=gen)
        cols = off + p2.ls + torch.randint(0, p2.ls, (h2.B, m1, h2.r),
                                           device=dev, generator=gen)
        for what, rr, cc in (("leaf D", leaf, leaf), ("B12", rows, cols)):
            ker = H.hss_entries_prepared(ef, rr, cc)
            ref = H.hss_entries_prepared_plain(ef, rr, cc)
            record("hss_entries_prepared",
                   f"batch {bidx} {what} out={list(ker.shape)}",
                   errors(ker, ref), RTOL_SUM,
                   time_ms(lambda: H.hss_entries_prepared(ef, rr, cc)),
                   time_ms(lambda: H.hss_entries_prepared_plain(ef, rr, cc)))
        # J: S22''s operand at the sketch width (the factor's own sketch) and
        # at k=1
        s = min(H.sample_width(bp.child_cplans[1], bp.rank_cap, opts.kest,
                               max(opts.stepsize, 8)), p2.n_pad)
        Om, _ = torch_sketch(opts.seed, dev, f64)((7000 + bidx, 203),
                                                  (h2.B, p2.n_pad, s),
                                                  (h2.B, p2.n_pad, s))
        for X in (Om, Om[..., :1].contiguous()):
            for adj in (False, True):
                ker = H.hss_matvec(h2, X, adj)
                ref = H.hss_matvec_plain(h2, X, adj)
                record("hss_matvec",
                       f"batch {bidx} {'adj' if adj else 'fwd'} "
                       f"n_pad={p2.n_pad} depth={p2.depth} B={h2.B} "
                       f"k={X.shape[-1]}", errors(ker, ref), RTOL_SUM,
                       time_ms(lambda: H.hss_matvec(h2, X, adj)),
                       time_ms(lambda: H.hss_matvec_plain(h2, X, adj)))
        # K: the interior solver, level 1 as hss_factor runs it (k = r, the
        # next level's bases) and the root level as hss_solve runs it (k = 1)
        sol = lev.solver1
        h1 = sol.h
        depth = h1.plan.depth
        Ubig, Vbig = H.materialize_bases(h1)
        for adj in (False, True):
            one = torch.randn(h1.B, h1.plan.n_pad, 1, dtype=f64, device=dev,
                              generator=gen)
            bases = Vbig if adj else Ubig
            for lvl, X in ((1, bases[min(1, depth - 1)]), (depth, one)):
                Y0 = H._leaf_solve(sol, X.contiguous(), adj)
                xi = H._upsweep(h1, Y0, lvl - 1, adj).contiguous()
                Bl, Br = h1.B12s[lvl - 1], h1.B21s[lvl - 1]
                lu, piv, Phi = (sol.coresT_lu, sol.coresT_piv, sol.PhisT) \
                    if adj else (sol.cores_lu, sol.cores_piv, sol.Phis)
                args = (xi, *((Br, Bl) if adj else (Bl, Br)), lu[lvl - 1],
                        piv[lvl - 1], Phi[lvl - 1], adj)
                ker = H.hss_level_correct(Y0.clone(), *args)
                ref = H.hss_level_correct_plain(Y0.clone(), *args)
                scratch = Y0.clone()
                record("hss_level_correct",
                       f"batch {bidx} {'adj' if adj else 'fwd'} level {lvl}/"
                       f"{h1.plan.depth} B={h1.B} 2r={2 * h1.r} "
                       f"k={X.shape[-1]}", errors(ker, ref), RTOL_SUM,
                       time_ms(lambda: H.hss_level_correct(scratch, *args)),
                       time_ms(lambda: H.hss_level_correct_plain(scratch,
                                                                 *args)))
    torch.cuda.synchronize()


def main_path(problems: Problems, n: int, dev, path: str) -> dict:
    """Phase 4: the user's workflow at size n; returns its timings and checks."""
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    import hsolve_torch as ht
    from hsolve_torch.factor import solve_with_data

    A, b, shape = problems.get(n)
    opts = ht.SolverOptions(**OPTIONS[path])
    compressed = path != "exact"
    tree = ht.nested_dissection(shape, leafmax=100)
    plan_s = []
    for _ in range(2):                       # the second call is warm
        t0 = time.perf_counter()
        plan = ht.plan_factorization(A, tree, opts)
        plan_s.append(time.perf_counter() - t0)
    shapes = [(bp.B, bp.ni_pad, bp.nb_pad)
              + ((bp.rank_cap,) if bp.compress else ())
              + (("structured" if bp.structured else "to HSS", bp.cplan.ls,
                  bp.cplan.depth, bp.cplan.n_pad) if bp.cplan is not None
                 else ()) for bp in plan.batches]
    log(f"  n={n} {path}: {len(plan.batches)} batches (B, ni_pad, nb_pad"
        f"{', rank cap' if compressed else ''}"
        f"{', HSS kind, ls, depth, n_pad' if path == 'hss' else ''}): {shapes}")

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
    res = {"path": path, "n": n, "N": int(A.shape[0]), "plan_s": plan_s[1],
           "plan_cold_s": plan_s[0], "factor_s": factor_ms / 1e3,
           "solve_s": solve_ms / 1e3, "iters": info["iters"],
           "converged": info["converged"], "relres_scipy": relres,
           "gmres_resnorm_last": float(info["resnorm"][-1]) / float(
               np.linalg.norm(b))}
    if n <= 128 and not compressed:
        x_ref = spla.spsolve(A.tocsc(), b)
        res["fwd_err_vs_spsolve"] = float(np.linalg.norm(xh - x_ref)
                                          / np.linalg.norm(x_ref))
    if compressed:
        report = F.rank_report()
        res["max_rank"] = max(lv["max_rank"] for lv in report["levels"])
        res["saturated"] = report["saturated"]
    log(f"  n={n} {path}: plan {res['plan_s']:.4f} s (warm; cold "
        f"{res['plan_cold_s']:.4f} s, host)  factor {res['factor_s']:.4f} s  "
        f"solve {res['solve_s']:.4f} s (warm, CUDA events)  iters "
        f"{res['iters']}  converged {res['converged']}  relres(scipy) "
        f"{relres:.3e}" + (f"  fwd err vs spsolve {res['fwd_err_vs_spsolve']:.3e}"
                           if "fwd_err_vs_spsolve" in res else "")
        + (f"  max rank {res['max_rank']}  saturated {res['saturated']}"
           if compressed else ""))
    if not info["converged"]:
        fail(f"n={n} {path}: GMRES did not converge ({info})")
    if not relres <= RELRES:
        fail(f"n={n} {path}: independent residual {relres:.3e} > {RELRES}")
    if res.get("fwd_err_vs_spsolve", 0.0) > FWD_N128:
        fail(f"n={n}: forward error {res['fwd_err_vs_spsolve']:.3e} > {FWD_N128}")
    if compressed and info["iters"] > MAX_ITERS[path].get(n, 60):
        fail(f"n={n} {path}: {info['iters']} GMRES iterations > "
             f"{MAX_ITERS[path].get(n, 60)}")
    if compressed and res["saturated"]:
        fail(f"n={n} {path}: a rank saturated its cap ({report})")
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
        "plans' shapes")
    kres = Results()
    check_kernels(problems, args.kernel_n, dev, kres)
    check_compressed_kernels(problems, args.kernel_n, dev, kres)
    check_hss_kernels(problems, args.kernel_n, dev, kres)

    runs = []
    for path, path_kernels in (("exact", kernels.EXACT_PATH),
                               ("compressed", kernels.COMPRESSED_PATH),
                               ("hss", kernels.HSS_PATH)):
        for n in args.sizes:
            log(f"[4] main path n={n} {path}")
            kernels.reset_launch_counts()
            runs.append(main_path(problems, n, dev, path))
            counts = kernels.launch_counts()
            log(f"  n={n}: kernel launches {counts}")
            missing = [k for k in path_kernels if counts[k] <= 0]
            if missing:
                fail(f"n={n}: the main path never launched {missing}")
            runs[-1]["launches"] = counts

    # the launch counts of the last run, the structured path at the largest n,
    # which runs all eleven kernels
    last = runs[-1]["launches"]
    table = [{"name": k, "route": "cuda", "source": f"hsolve_torch/csrc/{src}",
              "replaces": rep, "launches": last[k],
              "max_abs_err": kres[k]["max_abs_err"], "ms": kres[k]["ms"],
              "plain_ms": kres[k]["plain_ms"]}
             for k, (src, rep) in SOURCES.items()]
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
