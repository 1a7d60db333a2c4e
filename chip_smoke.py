#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hsolve_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line is printed):

1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and power
   limit;
2. build: the thirteen CUDA kernels (A-M) are compiled from ``hsolve_torch/csrc/``
   for ``sm_90a``, one nvcc process per source, all started together;
3. kernels: each kernel's wrapper runs on the card at the n=512 plans' real
   shapes and is held against its plain torch version on the same inputs
   (A, B and G bitwise, H with equal pivots and ranks, C's backward step, D,
   F, I, J and K to a relative error of 1e-13, since only the summation
   order differs (float32: 1e-5; C accumulates in float64 in both types);
   C's forward step, whose substitution rounds in another order than
   cuBLAS's, to 1e-12 of max |x'| times the level's pivot-growth proxy,
   printed beside it; E (which sums in double-double at the top levels) to
   1e-13 of the update computed in long double on the host, and to its plain version
   within 1e-13 plus the plain version's own distance from that update,
   printed beside it with the update's cancellation); each is timed on the device (back-to-back calls
   between one pair of CUDA events, divided by the count, after warm-up)
   beside its plain version, beside its bound (the larger of its bytes over
   3.35 TB/s and its operations over the data sheet's peak, from this run's
   shapes) and, for C, D and L, beside the library calls that compute the
   same function (C: the gather, ``bmm``, ``index_put_`` and triangular
   solves the solve ran before the fused step; D: cuSPARSE CSR ``torch.mv``;
   L: ``torch.mv``/``addmv``).  A-D run on the exact plan, in float64 and in
   float32 (A, B bitwise, C, D to 1e-5; C's forward step at the leaf level,
   a level of ni_pad 256, the top level and a hand-made 4424-row front (in
   windows of 2048 rows), with lu records and, at the leaf and the top, as
   dinv records; its backward step at the leaf, the ni_pad 256 level and the
   top level with a boundary); B also at every launch of the exact
   factor (both types) and of the compressed one, bitwise, with a summary
   line each (launches, ms range, sums of kernel, plain and bound); E
   (forward and backward) at every distinct launch shape of the compressed
   plan's factor and of both structured plans' (kest=32, default caps), a
   log line per shape and a summary line per plan (shapes, ranges of
   kernel, plain and bound ms, the shapes slower than plain, sums); F at
   every launch shape of the three compressed factors (low-rank, both
   structured), on inputs captured there, a log line per shape and a
   summary line per plan; G on both sides of the first compressed batch of
   the low-rank plan; H and K at every distinct
   launch shape of the structured (HSS) plans' factor and of one
   preconditioner application, kest=32 and the default rank caps, on inputs
   captured there (one log line per shape, then the count of shapes where
   the kernel is slower than its plain version and the times summed over the
   shapes), I and J likewise (J's capture patches
   ``hsolve_torch.structured.hss_matvec``, which the structured code calls;
   I's NaN for out-of-range indices where its plain version has them), after
   I and J on the HSS operands of the first and the top structured batch of
   the kest=32 plan (I on a leaf and a B12 extraction, J forward and adjoint
   at the sketch width and at k=1: the kernel table's shapes); the Arnoldi
   step at j = 0, 14 and 29 captured from a 30-step cycle on the n=512
   operator, in float64 and float32: L alone (1e-13 and 1e-5), the step as
   GMRES runs it (its own row, ``arnoldi_step``), one launch of L with M's
   step and V[j+1] as its tail, with the loop going on and ending (hc bit
   for bit L's alone, the same code; H, cs, sn, g, st, done, y and V[j+1]
   bit for bit M's plain version and the division on L's hc and w; hc and
   V[j+1] to 1e-13 and 1e-5 of the step's plain version), timed beside its
   plain version and the three launches it replaces, and M alone (bit for
   bit); the rows of L and M read them alone (``"timed": "alone"``: on the
   main path they run inside the step's launch, whose launches they count);
   the bounds of the latency-bound kernels (M, K, H, the step) add their
   chain of dependent operations (``DEP_CYCLES`` at ``CLOCK_HZ``) to a
   queued one-element launch read in this run;
4. main paths at n=128 and n=512: helmholtz2d (k=40) -> nested_dissection
   (leafmax=100) -> plan_factorization -> factor_with_plan (cuda) ->
   gmres_compiled (reltol 1e-9, restart 30, maxiter 60, the factor as right
   preconditioner, the DIA matvec), first exact (swlevel=0, float64), then
   low-rank compressed (swlevel=-2, swsize=16, atol=rtol=1e-3, kest=32,
   hss=False), then structured (the same options with hss=True, the default),
   then structured at the default rank caps (the same without kest), then
   exact-f32-mixed (the JAX bench's device configuration: a float32
   exact factor, float32 Arnoldi cycles over a float32 DIA operator with
   m_eps=1e-6 inside a float64 solve, escalation on), then one exact run at
   n=1026, whose 2056-row top front takes kernel C's forward step in
   windows, in one iteration.  Each run must
   converge, pass an independent scipy check ||b - A x|| / ||b|| <= 1e-9 on
   the host, and launch every kernel of its path (the launch counters are
   reset just before the run and read just after: A-D, L and M on the exact
   path, A-G, L, M on the compressed one, A-M on the structured one, A-D in
   float32, D in float64 and L, M and the step in float32 on the mixed one;
   every launch of L and M one Arnoldi step's single launch).  A compressed,
   structured or mixed run must also stay within twice the JAX package's CPU
   iteration counts (``MAX_ITERS``), and a compressed one saturate no rank
   cap;
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
RTOL_SUM32 = 1e-5     # the same in float32
# C's forward step: its substitution rounds in another order than cuBLAS's
# triangular solves; relative to max |x'|, times the level's pivot growth
RTOL_SOLVE = {"float64": 1e-12, "float32": 1e-5}
RELRES = 1e-9         # GMRES target and the independent residual check
FWD_N128 = 1e-6       # forward error against scipy's spsolve at n=128 (exact)
# the slice's compressed configuration (README's switching level, the
# tolerance policy of CROSSOVER.md for compressed runs)
COMPRESSED = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3, kest=32,
                  hss=False)
HSS = {**COMPRESSED, "hss": True}
# the structured path with every option at its default but the switching
# level and the tolerances: no kest, so the planner's default rank caps
# (boundary / 4, up to 192 at n=512)
HSS_DEFAULT = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3)
# the smallest helmholtz2d size above 1024 whose exact top front passes
# 2048 interior rows (2056: kernel C's forward step in windows)
WIDE_N = 1026
OPTIONS = {"exact": dict(swlevel=0), "compressed": COMPRESSED, "hss": HSS,
           "hss-default": HSS_DEFAULT, "exact-f32-mixed": dict(swlevel=0),
           "exact-wide": dict(swlevel=0)}
# twice the JAX package's GMRES iterations on the CPU for the same runs; the
# mixed and hss-default ones from tools/jax_reference_iters.py (mixed: 5 at
# n=128, 80 at n=512; hss-default: 5 at n=128, 40 at n=512)
MAX_ITERS = {"compressed": {128: 12, 512: 14}, "hss": {128: 10, 512: 36},
             "hss-default": {128: 10, 512: 80},
             "exact-f32-mixed": {128: 10, 512: 160}, "exact-wide": {WIDE_N: 1}}
HBM_BPS = 3.35e12     # H100 SXM device memory (the data sheet)
# the data sheet's peaks, FLOP/s: (without, with) the tensor cores; float32
# without TF32, which the port keeps off
PEAK = {"float64": (34e12, 67e12), "float32": (67e12, 67e12)}
# latency floors of a chain of dependent operations: the H100 SXM's highest
# SM clock (the data sheet's boost) and an assumed least latency of one
# dependent floating-point operation, in cycles
CLOCK_HZ = 1.98e9
DEP_CYCLES = {"float64": 8, "float32": 4}
# a queued one-element launch on the device, ms: read in phase 3 of this run
QUEUED = {"ms": None}
SOURCES = {"front_assemble": ("front_assemble.cu", "hsolve/factor.py:409"),
           "extend_add": ("extend_add.cu", "hsolve/factor.py:390"),
           "level_forward": ("sweep_update.cu", "hsolve/factor.py:527"),
           "sweep_update": ("sweep_update.cu", "hsolve/factor.py:553"),
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
                                 "hsolve/ops/hss.py:641"),
           "arnoldi_cgs2": ("arnoldi_cgs2.cu", "hsolve/krylov.py:231"),
           "arnoldi_givens": ("arnoldi_givens.cuh", "hsolve/krylov.py:241"),
           "arnoldi_step": ("arnoldi_cgs2.cu", "hsolve/krylov.py:223")}
TYPED = ("front_assemble", "extend_add", "level_forward", "sweep_update",
         "dia_spmv", "arnoldi_cgs2", "arnoldi_givens", "arnoldi_step")
# kernels whose rows read them alone: on the main path they run inside the
# fused Arnoldi step's launch, whose launches their counts are
RUN_IN_STEP = ("arnoldi_cgs2", "arnoldi_givens")


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg`` behind the seconds since the script started."""
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_ms(fn, budget_ms: float = 20.0, max_reps: int = 200) -> float:
    """Time of one call of ``fn`` on the device (ms): after warm-up,
    back-to-back calls between one pair of CUDA events, divided by their
    count (enough calls to fill about ``budget_ms``, at least 5), so no
    call's launch latency or event overhead is counted.  Where ``fn``'s host
    work takes longer than its kernels, this still reads the host's rate."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = start.elapsed_time(end)
    reps = int(min(max_reps, max(5, budget_ms / max(once, 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_: float, flops: float, dtype: str = "float64",
          products: bool = False, chain: float = 0.0) -> dict:
    """The least time the card could take for work that moves ``nbytes_``
    (each input read once, each output written once) and does ``flops`` in
    ``dtype`` (on the tensor cores where ``products``): the larger of the two
    times, and which of them it is.  Work whose result waits on a chain of
    ``chain`` dependent operations (a latency-bound kernel: M, K, H, the
    Arnoldi step's tail) takes at least a queued launch and then the chain
    (``DEP_CYCLES`` each at ``CLOCK_HZ``): the larger of the bytes' and the
    operations' times and the queued launch, plus the chain; ``bound_by``
    is then "latency" unless the bytes or the operations outweigh both the
    queued launch and the chain."""
    tb = nbytes_ / HBM_BPS
    tf = flops / PEAK[dtype][int(products)]
    if chain <= 0:
        return {"bound_ms": max(tb, tf) * 1e3,
                "bound_by": "bytes" if tb >= tf else "operations"}
    tl = chain * DEP_CYCLES[dtype] / CLOCK_HZ
    floor = QUEUED["ms"] / 1e3
    top = max(tb, tf, floor)
    by = "latency" if floor == top or tl > top else \
        ("bytes" if tb >= tf else "operations")
    return {"bound_ms": (top + tl) * 1e3, "bound_by": by}


def queued_ms(fn, reps: int = 50) -> float:
    """Device ms per call of ``fn`` (launches only, no wait on the device):
    ``reps`` calls between two CUDA events, queued behind a sleep kernel
    that outlasts the host's launches, so no host time is in the reading."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 2_000_000
    for _ in range(6):
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
    fail("the host's launches did not get ahead of the device")


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
    """Per kernel (``name``, or ``name:float32`` for a typed kernel's float32
    instance): the largest error against its plain version over the checked
    shapes, and the times, the bound and the library call's time at the
    first shape checked."""

    def record(self, name, shape_desc, errs, limit, ms, plain_ms, work,
               library_ms=None):
        err, rel = errs
        ok = rel <= limit
        log(f"  {name:22s} {shape_desc:48s} max_abs_err={err:.3e} "
            f"rel={rel:.3e} (limit {limit:g})  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {work['bound_ms']:.5f} ms "
            f"({work['bound_by']})"
            + ("" if library_ms is None else f"  library {library_ms:.4f} ms")
            + ("" if ok else "  MISMATCH"))
        if not ok:
            fail(f"{name} disagrees with its plain version at {shape_desc}")
        r = self.setdefault(name, {"max_abs_err": 0.0, "ms": ms,
                                   "plain_ms": plain_ms, **work,
                                   "library_ms": library_ms})
        r["max_abs_err"] = max(r["max_abs_err"], err)


def csr_of(A, dtype, dev):
    """A's CSR copy on the card in ``dtype``: the library yardstick of D."""
    import numpy as np
    import torch

    A = A.tocsr()
    return torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr.astype(np.int64)),
        torch.as_tensor(A.indices.astype(np.int64)),
        torch.as_tensor(A.data), size=A.shape).to(device=dev, dtype=dtype)


def _wide_level(dev, dt, ni: int, nb: int, N: int, seed: int):
    """One dense front of ``ni`` interior rows made by hand: a
    well-conditioned pivot block (LU with pivoting), a random Gauss
    transform, distinct ids below N."""
    import torch

    from hsolve_torch.factor import DenseLevel
    from hsolve_torch.ops import dense as dk

    g = torch.Generator(device=dev).manual_seed(seed)
    D = torch.randn(1, ni, ni, dtype=dt, device=dev, generator=g) / ni ** 0.5 \
        + 2.0 * torch.eye(ni, dtype=dt, device=dev)
    lu, perm = dk.lu_factor(D)
    ids = torch.randperm(N, device=dev, generator=g)[:ni + nb].to(torch.int32)
    return DenseLevel(lu=lu, perm=perm,
                      L=torch.randn(1, nb, ni, dtype=dt, device=dev, generator=g),
                      R=torch.randn(1, ni, nb, dtype=dt, device=dev, generator=g),
                      int_ids=ids[None, :ni].contiguous(),
                      bnd_ids=ids[None, ni:].contiguous())


def check_kernels(problems: Problems, n: int, dev, results: Results,
                  dtype_name: str = "float64") -> None:
    """Phase 3, kernels A-D against their plain versions at the exact
    n-plan's shapes, in ``dtype_name``: a float64 run and a float32 run, the
    latter recorded as ``<name>:float32``."""
    import dataclasses

    import numpy as np
    import torch

    import hsolve_torch as ht
    from hsolve_torch.factor import _factor_levels
    from hsolve_torch.interop import plan_to_torch
    from hsolve_torch.ops.assembly import (extend_add, extend_add_plain,
                                           front_assemble, front_assemble_plain)
    from hsolve_torch.ops.sparse import dia_spmv, dia_spmv_plain
    from hsolve_torch.ops import dense as dk
    from hsolve_torch.ops.sweep import (level_forward, level_forward_plain,
                                        sweep_update, sweep_update_plain)

    dt = getattr(torch, dtype_name)
    e = torch.empty(0, dtype=dt).element_size()
    tag = "" if dtype_name == "float64" else f":{dtype_name}"
    rtol = RTOL_SUM if dtype_name == "float64" else RTOL_SUM32
    A, b, shape = problems.get(n)
    opts = ht.SolverOptions(swlevel=0)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 opts)
    tp = plan_to_torch(plan, dev)
    adata = tp.adata.to(dt)
    levels, _, stacks = _factor_levels(plan, tp, opts, dt)
    torch.cuda.synchronize()
    nb = len(plan.batches)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    record = results.record

    # A: front assembly, leaf batch and root batch (real values)
    for bidx in (0, nb - 1):
        bp, tb = plan.batches[bidx], tp.batches[bidx]
        args = (bp.B, bp.m_pad, tb.pos, tb.src, adata)
        ker = front_assemble(*args)
        ref = front_assemble_plain(*args)
        if ker.dtype != dt or not torch.equal(ker, ref):
            fail(f"front_assemble{tag} is not bitwise equal at batch {bidx}")
        record(f"front_assemble{tag}", f"batch {bidx} [{bp.B},{bp.m_pad},"
               f"{bp.m_pad}] nnz={len(bp.front_pos)}", errors(ker, ref), 0.0,
               device_ms(lambda: front_assemble(*args)),
               device_ms(lambda: front_assemble_plain(*args)),
               bound(nbytes(tb.pos, tb.src, adata, ker), 0, dtype_name))

    # B: extend-add, first branch batch and root batch (real Schur stacks)
    for bidx in (1, nb - 1):
        bp, tb = plan.batches[bidx], tp.batches[bidx]
        base = front_assemble_plain(bp.B, bp.m_pad, tb.pos, tb.src, adata)
        calls = [(stacks[s], sr, dr, imap, rows)
                 for groups, counts, imap in (
                     (tb.groups_l, tb.rows_l, tb.map_l),
                     (tb.groups_r, tb.rows_r, tb.map_r))
                 for (s, sr, dr), rows in zip(groups, counts)]
        ker, ref = base.clone(), base.clone()
        for c in calls:
            extend_add(ker, *c)
            extend_add_plain(ref, *c[:4])
        if not torch.equal(ker, ref):
            fail(f"extend_add{tag} is not bitwise equal at batch {bidx}")
        # the entries a group covers: S read once, the front read and written
        cover = flops = 0.0
        for S, sr, dr, imap, _ in calls:
            rows = imap[dr.long()]
            cnt = ((rows >= 0) & (rows < S.shape[-1])).sum(1).double()
            c2 = float((cnt * cnt).sum())
            flops += c2
            cover += 3 * c2 * e + nbytes(rows, sr, dr)
        scratch = base.clone()

        def run_k():
            for c in calls:
                extend_add(scratch, *c)

        def run_p():
            for c in calls:
                extend_add_plain(scratch, *c[:4])

        record(f"extend_add{tag}", f"batch {bidx} [{bp.B},{bp.m_pad},"
               f"{bp.m_pad}] {len(calls)} groups", errors(ker, ref), 0.0,
               device_ms(run_k), device_ms(run_p), bound(cover, flops, dtype_name))
    check_extend_add_launches("exact", plan, tp, stacks, adata, results)

    # C: the fused forward step (pivot solve included) at the leaf level, a
    # level of ni_pad 256 and the top level, with lu records and, at the leaf
    # and the top, as dinv records; the backward step at the leaf, the ni_pad
    # 256 level and the top level with a boundary (the root front has
    # nb_pad = 0).  The library yardstick is the sequence the solve ran before
    # the fused step: gather, bmm, index_put_ (accumulate), lu_solve (a row
    # gather and two batched triangular solves) or the dinv GEMM, index_put_
    N = plan.N
    wide = [i for i, bp in enumerate(plan.batches) if bp.ni_pad == 256]
    mid = wide[0] if wide else nb // 2
    top = max(i for i, bp in enumerate(plan.batches) if bp.nb_pad > 0)
    C0 = torch.randn(N + 1, 1, dtype=dt, device=dev, generator=gen)
    C0[N] = 0.0
    for bidx in (0, mid, nb - 1):
        lev = levels[bidx]
        recs = [("lu", lev)]
        if bidx in (0, nb - 1):
            recs.append(("dinv", dataclasses.replace(
                lev, lu=None, perm=None,
                dinv=dk.lu_inverse(lev.lu, lev.perm).contiguous())))
        growth = float(dk._diag_ratio(lev.lu).max())
        keep = lev.int_ids < N
        int_l = lev.int_ids.long().reshape(-1)
        bnd_l = lev.bnd_ids.long().reshape(-1)
        Bm, nbp, ni = lev.L.shape
        for rec, lv in recs:
            ker = level_forward(C0.clone(), lv, N)
            ref = level_forward_plain(C0.clone(), lv, N)
            if float(ker[N].abs().max()) != 0.0:
                fail(f"level_forward{tag} wrote the sentinel row at level "
                     f"{bidx} ({rec})")
            err = float((ker - ref).abs().max())
            scale = float(ref[lev.int_ids[keep].long()].abs().max())
            limit = RTOL_SOLVE[dtype_name] * max(1.0, growth)
            scratch = C0.clone()

            def library():
                x = scratch[lv.int_ids]
                scratch.index_put_((bnd_l,), -(lv.L @ x).reshape(-1, 1),
                                   accumulate=True)
                xs = lv.dinv @ x if lv.dinv is not None else \
                    dk.lu_solve(lv.lu, lv.perm, x)
                scratch.index_put_((int_l,), xs.reshape(-1, 1))

            A_ = lv.dinv if lv.dinv is not None else lv.lu
            work = nbytes(A_, lv.L, lv.int_ids, lv.bnd_ids) \
                + (nbytes(lv.perm) if lv.dinv is None else 0) \
                + 2 * Bm * ni * e + 2 * Bm * nbp * e
            record(f"level_forward{tag}", f"level {bidx} {rec} "
                   f"B={Bm} ni={ni} nb={nbp} k=1 growth={growth:.3g}",
                   (err, err / (scale if scale > 0 else 1.0)), limit,
                   device_ms(lambda: level_forward(scratch, lv, N)),
                   device_ms(lambda: level_forward_plain(scratch, lv, N)),
                   bound(work, 2 * (A_.numel() + lv.L.numel()), dtype_name),
                   library_ms=device_ms(library))
    for bidx in (0, mid, top):
        lev = levels[bidx]
        ker = sweep_update(C0.clone(), lev.int_ids, lev.R, N, ids_in=lev.bnd_ids)
        ref = sweep_update_plain(C0.clone(), lev.int_ids, lev.R, N,
                                 ids_in=lev.bnd_ids)
        if float(ker[N].abs().max()) != 0.0:
            fail(f"sweep_update{tag} wrote the sentinel row at level {bidx}")
        scratch = C0.clone()
        Bm, ni, nbp = lev.R.shape
        int_l = lev.int_ids.long().reshape(-1)

        def library():
            upd = lev.R @ scratch[lev.bnd_ids]
            scratch.index_put_((int_l,), -upd.reshape(-1, 1), accumulate=True)

        record(f"sweep_update{tag}", f"level {bidx} bwd R={list(lev.R.shape)} k=1",
               errors(ker, ref), rtol,
               device_ms(lambda: sweep_update(scratch, lev.int_ids, lev.R, N,
                                              ids_in=lev.bnd_ids)),
               device_ms(lambda: sweep_update_plain(scratch, lev.int_ids,
                                                    lev.R, N,
                                                    ids_in=lev.bnd_ids)),
               bound(nbytes(lev.R, lev.int_ids, lev.bnd_ids)
                     + Bm * nbp * e + 2 * Bm * ni * e, 2 * lev.R.numel(),
                     dtype_name),
               library_ms=device_ms(library))

    # C's forward step on a front wider than one cluster (4424 rows, the
    # helmholtz3d(48) exact top front: three windows), made by hand, against
    # its plain version, and both against a float64 solve of the same
    # (rounded) front: in float32 the kernel may be no further from that
    # solve than the plain version, beyond 1e-7 of max |x'|
    wide = _wide_level(dev, dt, ni=4424, nb=24, N=N, seed=SEED)
    growth = float(dk._diag_ratio(wide.lu).max())
    ker = level_forward(C0.clone(), wide, N)
    ref = level_forward_plain(C0.clone(), wide, N)
    rows = wide.int_ids[wide.int_ids < N].long()
    note = ""
    if dtype_name != "float64":
        f64 = torch.float64
        x64 = level_forward_plain(C0.to(f64), dataclasses.replace(
            wide, lu=wide.lu.to(f64), L=wide.L.to(f64)), N)[rows]
        s64 = float(x64.abs().max())
        d_ker = float((ker[rows].to(f64) - x64).abs().max()) / s64
        d_ref = float((ref[rows].to(f64) - x64).abs().max()) / s64
        note = (f" from float64: kernel {d_ker:.3e}, plain {d_ref:.3e}")
        if d_ker > d_ref + 1e-7:
            fail(f"level_forward{tag} on the 4424-row front is further from "
                 f"the float64 solve than its plain version:{note}")
    # the interior rows (the solve) against max |x'|, the boundary rows
    # (C[bnd] -= L x, sums of 4424 products) against their own largest value
    bnd = wide.bnd_ids[wide.bnd_ids < N].long()
    scratch = C0.clone()
    ms = device_ms(lambda: level_forward(scratch, wide, N))
    plain_ms = device_ms(lambda: level_forward_plain(scratch, wide, N))
    for part, idx, limit in (
            ("interior", rows, RTOL_SOLVE[dtype_name] * max(1.0, growth)),
            ("boundary", bnd, rtol)):
        record(f"level_forward{tag}", f"hand front lu B=1 ni=4424 nb=24 k=1 "
               f"(windows) {part} rows growth={growth:.3g}"
               + (note if part == "interior" else ""),
               errors(ker[idx], ref[idx]), limit, ms, plain_ms,
               bound(nbytes(wide.lu, wide.L, wide.int_ids, wide.bnd_ids,
                            wide.perm) + 2 * 4424 * e + 2 * 24 * e,
                     2 * (wide.lu.numel() + wide.L.numel()), dtype_name))

    # D: DIA matvec and fused residual on the original matrix; the library
    # yardstick is cuSPARSE's CSR matvec (and b - A x through addmv)
    op, _ = ht.spmv_format(A, dtype=np.dtype(dtype_name), device=dev)
    csr = csr_of(A, dt, dev)
    xv = torch.randn(A.shape[0], 1, dtype=dt, device=dev, generator=gen)
    bv = torch.as_tensor(np.asarray(b)[:, None], dtype=dt, device=dev)
    for form, extra, lib in (
            ("A x", (), lambda: torch.mv(csr, xv[:, 0])),
            ("b - A x", (bv,), lambda: torch.addmv(bv[:, 0], csr, xv[:, 0],
                                                   alpha=-1.0))):
        ker = dia_spmv(op, xv, *extra)
        ref = dia_spmv_plain(op, xv, *extra)
        record(f"dia_spmv{tag}", f"{form} N={A.shape[0]} "
               f"ndiag={len(op.offsets)} k=1", errors(ker, ref), rtol,
               device_ms(lambda: dia_spmv(op, xv, *extra)),
               device_ms(lambda: dia_spmv_plain(op, xv, *extra)),
               bound(nbytes(op.values, op.offs, xv, ker, *extra),
                     2 * op.values.numel(), dtype_name),
               library_ms=device_ms(lib))
    torch.cuda.synchronize()


def check_extend_add_launches(label, plan, tp, stacks, adata,
                              results: Results) -> None:
    """Kernel B at every launch of a factor (each group of each batch, left
    before right, on the factor's own Schur stacks and the plan's valid-row
    counts): bitwise its plain version, timed beside it; one summary line
    (launches, ms range, the sums of kernel, plain and bound)."""
    import torch

    from hsolve_torch.ops.assembly import (extend_add, extend_add_plain,
                                           front_assemble_plain)

    dt = adata.dtype
    e = adata.element_size()
    tag = "" if dt == torch.float64 else ":float32"
    rows_ = []
    for bidx, (bp, tb) in enumerate(zip(plan.batches, tp.batches)):
        if bp.structured:
            continue
        base = None
        for side, groups, counts, imap in (
                ("l", tb.groups_l, tb.rows_l, tb.map_l),
                ("r", tb.groups_r, tb.rows_r, tb.map_r)):
            for (src, sr, dr), cnt in zip(groups, counts, strict=True):
                S = stacks[src]
                if not isinstance(S, torch.Tensor):
                    continue              # an HSS child: densified first
                if base is None:
                    base = front_assemble_plain(bp.B, bp.m_pad, tb.pos, tb.src,
                                                adata)
                ker = extend_add(base.clone(), S, sr, dr, imap, cnt)
                ref = extend_add_plain(base.clone(), S, sr, dr, imap)
                if not torch.equal(ker, ref):
                    fail(f"extend_add{tag} is not bitwise equal at {label} "
                         f"batch {bidx} {side} (source batch {src})")
                m_ = imap[dr.long()]
                c = ((m_ >= 0) & (m_ < S.shape[-1])).sum(1).double()
                c2 = float((c * c).sum())
                scratch = base.clone()
                ms = device_ms(lambda: extend_add(scratch, S, sr, dr, imap, cnt))
                plain_ms = device_ms(lambda: extend_add_plain(scratch, S, sr, dr,
                                                              imap))
                work = bound(3 * c2 * e + nbytes(m_, sr, dr), c2,
                             str(dt).replace("torch.", ""))
                log(f"  extend_add{tag} {label} batch {bidx} {side} G={sr.numel()}"
                    f" m={bp.m_pad} w={S.shape[-1]} valid rows <= {cnt}: "
                    f"bitwise; kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                    f"bound {work['bound_ms']:.5f} ms")
                rows_.append((ms, plain_ms, work["bound_ms"]))
    if not rows_:
        fail(f"extend_add{tag}: no launch at {label}")
    ms_, plain_, bound_ = zip(*rows_)
    log(f"  {label}: B{tag} at {len(rows_)} launches, bitwise; kernel "
        f"{min(ms_):.4f}-{max(ms_):.4f} ms, slower than its plain version at "
        f"{sum(a > b for a, b in zip(ms_, plain_))}; sum {sum(ms_):.4f} ms "
        f"against plain {sum(plain_):.4f} and bound {sum(bound_):.4f}")


def sweep_forms(lev, x):
    """Kernel E's two launches on a compressed or structured level: the
    forward update (``X`` the gathered interior values) and the backward
    one (``ids_in`` the boundary ids)."""
    return (("fwd", lev.LU_, lev.LV_, lev.bnd_ids, {"X": x}),
            ("bwd", lev.RU_, lev.RV_, lev.int_ids, {"ids_in": lev.bnd_ids}))


def sweep_exact(C0, ids_out, U, V, N, kw):
    """Kernel E's update in long double on the host: ``(C after it,
    cancellation)``, the cancellation being the largest sum over a row of
    the magnitudes of its terms ``|U_ri t_i|`` over the largest entry of
    the result."""
    import numpy as np
    import torch

    if "X" in kw:
        Y = kw["X"]
    else:
        ids = kw["ids_in"]
        Y = torch.where((ids < N)[..., None], C0[ids.clamp(max=N).long()], 0.0)
    ld = lambda t: t.cpu().numpy().astype(np.longdouble)
    Ul = ld(U)
    t = np.einsum("bck,bcr->bkr", ld(V), ld(Y))
    C = ld(C0)
    out = ids_out.cpu().numpy()
    keep = out < N
    upd = np.einsum("brk,bkq->brq", Ul, t)
    np.subtract.at(C, out[keep], upd[keep])
    mag = np.einsum("brk,bkq->brq", np.abs(Ul), np.abs(t))
    scale = float(np.abs(C).max())
    return C, float(mag.max()) / (scale if scale > 0 else 1.0)


def check_sweep_shape(desc, C0, ids_out, U, V, N, kw, results: Results):
    """Kernel E at one launch against the update computed in long double
    (``RTOL_SUM`` of the largest entry) and against its plain version
    (``RTOL_SUM`` plus the plain version's own distance from the long-double
    update: it rounds t = V^T Y to doubles, and where a row's terms of U t
    sum to hundreds of times its result that alone moves it by about
    1e-13), timed beside it; returns ``(ms, plain ms, bound ms)``."""
    import numpy as np

    from hsolve_torch.ops.sweep import (lowrank_sweep_geometry,
                                        lowrank_sweep_update,
                                        lowrank_sweep_update_plain)

    ker = lowrank_sweep_update(C0.clone(), ids_out, U, V, N, **kw)
    ref = lowrank_sweep_update_plain(C0.clone(), ids_out, U, V, N, **kw)
    if float(ker[N].abs().max()) != 0.0:
        fail(f"lowrank_sweep_update wrote the sentinel row at {desc}")
    exact, canc = sweep_exact(C0, ids_out, U, V, N, kw)
    scale = float(np.abs(exact).max())
    e_ker = float(np.abs(ker.cpu().numpy() - exact).max()) / scale
    e_ref = float(np.abs(ref.cpu().numpy() - exact).max()) / scale
    if not e_ker <= RTOL_SUM:
        fail(f"lowrank_sweep_update is {e_ker:.3e} of the largest entry off "
             f"the long-double update at {desc} (limit {RTOL_SUM:g})")
    scratch = C0.clone()
    Bu, R, kc = U.shape
    Cc = V.shape[1]
    k = C0.shape[1]
    work = bound(nbytes(U, V, ids_out, *kw.values()) + 2 * Bu * R * 8 * k
                 + (Bu * Cc * 8 * k if "ids_in" in kw else 0),
                 2 * Bu * kc * (R + Cc) * k, products=True)
    cs, threads, _, _, vec, _, dd, _ = lowrank_sweep_geometry(Bu, R, Cc, kc,
                                                              k)
    ms = device_ms(lambda: lowrank_sweep_update(scratch, ids_out, U, V, N, **kw))
    plain_ms = device_ms(lambda: lowrank_sweep_update_plain(scratch, ids_out, U,
                                                            V, N, **kw))
    results.record("lowrank_sweep_update",
                   f"{desc} U={list(U.shape)} V={list(V.shape)[1:]} cs={cs} "
                   f"threads={threads} vec={vec} dd={dd}; off the long-double "
                   f"update: "
                   f"kernel {e_ker:.1e}, plain {e_ref:.1e}, cancellation "
                   f"{canc:.3g}", errors(ker, ref), RTOL_SUM + e_ref, ms,
                   plain_ms, work)
    return ms, plain_ms, work["bound_ms"]


def check_sweep_levels(label, levels, N, results: Results) -> None:
    """Kernel E at every distinct launch shape of a factor's compressed and
    structured levels (both forms, k = 1), then one summary line: the
    shapes, the range of kernel, plain and bound ms, the shapes slower than
    the plain version and the sums."""
    import torch

    lev0 = next(lv for lv in levels if getattr(lv, "LU_", None) is not None)
    dev = lev0.LU_.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    C0 = torch.randn(N + 1, 1, dtype=torch.float64, device=dev, generator=gen)
    C0[N] = 0.0
    seen, rows_ = set(), []
    for bidx, lev in enumerate(levels):
        if getattr(lev, "LU_", None) is None:
            continue
        for form, U, V, ids_out, kw in sweep_forms(lev, C0[lev.int_ids]):
            key = (form, *U.shape, V.shape[1])
            if key in seen:
                continue
            seen.add(key)
            rows_.append(check_sweep_shape(f"{label} batch {bidx} {form}", C0,
                                           ids_out, U, V, N, kw, results))
    ms_, plain_, bound_ = zip(*rows_)
    slow = [a / b for a, b in zip(ms_, plain_) if a > b]
    log(f"  {label}: E at {len(rows_)} shapes, kernel {min(ms_):.4f}-"
        f"{max(ms_):.4f} ms, plain {min(plain_):.4f}-{max(plain_):.4f}, bound "
        f"{min(bound_):.5f}-{max(bound_):.5f}; slower than its plain version "
        f"at {len(slow)}" + (f" (worst {max(slow):.2f}x)" if slow else "")
        + f"; sum {sum(ms_):.4f} ms against plain {sum(plain_):.4f} and bound "
        f"{sum(bound_):.4f}")


def schur_recorder(fm, fcalls: dict, where: dict):
    """A stand-in for ``factor.py``'s kernel F wrapper that records the
    first inputs of every distinct launch shape ``(B, m_pad, ni_pad, kc)``
    into ``fcalls``, tagged ``where["tag"]``, and calls the wrapper."""
    orig = fm.lowrank_schur_update

    def rec(front, ni_pad, RU, RV, sperm):
        key = (front.shape[0], front.shape[1], ni_pad, RU.shape[-1])
        if key not in fcalls:
            fcalls[key] = (where["tag"], front.clone(), ni_pad, RU.clone(),
                           RV.clone(), sperm)
        return orig(front, ni_pad, RU, RV, sperm)

    rec.launches = 0
    return orig, rec


def schur_bound(B, m_pad, ni_pad, kc) -> dict:
    """Kernel F's bound: Abb and Abi read, RU, RV and sperm read, S
    written, each once; both products' operations on the tensor cores."""
    nb = m_pad - ni_pad
    work = 8 * B * (2 * nb * nb + nb * ni_pad + ni_pad * kc + nb * kc + nb)
    return bound(work, 2 * B * kc * nb * (ni_pad + nb), products=True)


def check_schur_captured(label, fcalls, results: Results) -> None:
    """F at every captured launch shape of one plan, against its plain
    version (1e-13 of the largest entry), a log line per shape and a
    summary line: the shapes, the shapes slower than the plain version and
    within 2x of the bound, the times summed."""
    from hsolve_torch.ops.schur import (lowrank_schur_update,
                                        lowrank_schur_update_plain,
                                        schur_geometry)

    rows_ = []
    for (B, m_pad, ni_pad, kc), (tag, front, _, RU, RV, sperm) in sorted(
            fcalls.items(), key=lambda kv: -kv[0][0]):
        args = (front, ni_pad, RU, RV, sperm)
        ker = lowrank_schur_update(*args)
        ref = lowrank_schur_update_plain(*args)
        nb = m_pad - ni_pad
        g = schur_geometry(B, ni_pad, nb, kc)
        work = schur_bound(B, m_pad, ni_pad, kc)
        ms = device_ms(lambda: lowrank_schur_update(*args))
        plain_ms = device_ms(lambda: lowrank_schur_update_plain(*args))
        results.record(
            "lowrank_schur_update",
            f"{label} {tag} [{B},{nb},{nb}] ni={ni_pad} k={kc} "
            + (f"bands of {g['bm']}, whole rows" if g["whole"] else
               f"{g['bm']}x{g['bn']} tiles, cluster {g['cs']}"),
            errors(ker, ref), RTOL_SUM, ms, plain_ms, work)
        rows_.append((ms, plain_ms, work["bound_ms"]))
    ms_, plain_, bound_ = zip(*rows_)
    log(f"  {label}: F at {len(rows_)} shapes, kernel {min(ms_):.4f}-"
        f"{max(ms_):.4f} ms; slower than its plain version at "
        f"{sum(a > b for a, b in zip(ms_, plain_))}; within 2x of its bound "
        f"at {sum(a <= 2 * c for a, c in zip(ms_, bound_))}; sum "
        f"{sum(ms_):.4f} ms against plain {sum(plain_):.4f} and bound "
        f"{sum(bound_):.4f}")


def check_compressed_kernels(problems: Problems, n: int, dev,
                             results: Results) -> None:
    """Phase 3, kernels E-G against their plain versions at the compressed
    n-plan's shapes: the fronts, sketches and factors of a real compressed
    factorization (F at every launch shape, on its captured inputs)."""
    import torch

    import hsolve_torch as ht
    from hsolve_torch.factor import _factor_levels, torch_sketch
    from hsolve_torch.interop import plan_to_torch
    from hsolve_torch.ops.assembly import extend_add_plain, front_assemble_plain
    from hsolve_torch.ops.lowrank import (lowrank_truncate,
                                          lowrank_truncate_plain, sketch_width)
    from hsolve_torch.ops.schur import (lowrank_schur_update,
                                        lowrank_schur_update_plain)

    import importlib

    A, _, shape = problems.get(n)
    opts = ht.SolverOptions(**COMPRESSED)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 opts)
    tp = plan_to_torch(plan, dev)
    f64 = torch.float64
    fm = importlib.import_module("hsolve_torch.factor")  # ht.factor: the function
    fcalls = {}
    orig, rec = schur_recorder(fm, fcalls, {"tag": "factor"})
    fm.lowrank_schur_update = rec
    try:
        levels, _, stacks = _factor_levels(plan, tp, opts, f64)
    finally:
        fm.lowrank_schur_update = orig
    torch.cuda.synchronize()
    comp = [i for i, bp in enumerate(plan.batches) if bp.compress]
    first = comp[0]

    # E: both forms at every launch shape, the first compressed level first
    check_sweep_levels("low-rank", levels, plan.N, results)

    # B at every launch of the compressed factor
    check_extend_add_launches("low-rank", plan, tp, stacks, tp.adata.to(f64),
                              results)

    def front_of(bidx):
        bp, tb = plan.batches[bidx], tp.batches[bidx]
        front = front_assemble_plain(bp.B, bp.m_pad, tb.pos, tb.src,
                                     tp.adata.to(f64))
        for groups, imap in ((tb.groups_l, tb.map_l), (tb.groups_r, tb.map_r)):
            for src, sr, dr in groups:
                extend_add_plain(front, stacks[src], sr, dr, imap)
        return bp, tb, front

    # F: the Schur update at every launch shape of the factor
    check_schur_captured("low-rank", fcalls, results)
    record = results.record

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
               device_ms(lambda: lowrank_truncate(*args)),
               device_ms(lambda: lowrank_truncate_plain(*args)),
               bound(nbytes(*args[:3], *ker), args[0].numel() + args[2].numel()))
    torch.cuda.synchronize()


def _hss_captures(plan, tp, opts, dev, b):
    """Factor ``plan`` (structured) and apply the factor once to ``b``,
    recording the first inputs of every distinct launch shape of kernels H,
    K, J and I (H: ``(B, m, n, k)``; K: ``(nodes, r, blk, k, transpose)``;
    J: ``(B, nleaves, ls, r, depth, k, adjoint)``; I: ``(B, M, p, q, n_pad,
    ls, r, depth)``), each tagged with the batch that first gave it; returns
    ``(levels, cpqr calls, level-correction calls, matvec calls, entries
    calls, Schur-update calls)``; the last keyed ``(B, m_pad, ni_pad,
    kc)`` for kernel F on the plan's compressed batches that are not
    structured."""
    import importlib

    import torch

    import hsolve_torch.structured as S
    from hsolve_torch.factor import Factorization, _factor_levels
    from hsolve_torch.ops import hss as H
    from hsolve_torch.ops import lowrank as L

    fm = importlib.import_module("hsolve_torch.factor")  # ht.factor: the function
    where = {"tag": "solve"}
    hcalls, kcalls, jcalls, icalls, fcalls = {}, {}, {}, {}, {}
    orig_f, schur_rec = schur_recorder(fm, fcalls, {"tag": "factor"})
    orig = (L.cpqr_pivots, H.hss_level_correct, fm._run_structured,
            fm.transition_compress, S.hss_matvec, S.hss_entries_prepared)

    def cpqr_rec(Am, atol, rtol, k):
        key = (*Am.shape, k)
        if key not in hcalls:
            hcalls[key] = (where["tag"], Am.clone(), atol, rtol, k)
        return orig[0](Am, atol, rtol, k)

    def correct_rec(Y, xi, Bl, Br, lu, piv, Phi, transpose):
        key = (Bl.shape[0] * Bl.shape[1], Bl.shape[-1],
               Y.shape[1] // (2 * Bl.shape[1]), Y.shape[-1], bool(transpose))
        if key not in kcalls:
            kcalls[key] = (where["tag"], Y.clone(),
                           (xi, Bl, Br, lu, piv, Phi, transpose))
        return orig[1](Y, xi, Bl, Br, lu, piv, Phi, transpose)

    def matvec_rec(h, x, adjoint=False):
        p_ = h.plan
        key = (h.B, p_.nleaves, p_.ls, h.r, p_.depth, x.shape[-1],
               bool(adjoint))
        if key not in jcalls:
            jcalls[key] = (where["tag"], h, x.clone(), bool(adjoint))
        return orig[4](h, x, adjoint)

    def entries_rec(ef, rows, cols):
        key = (*rows.shape, cols.shape[-1], *ef.T.shape[2:], ef.D.shape[-1],
               ef.T.shape[1])
        if key not in icalls:
            icalls[key] = (where["tag"], ef, rows.clone(), cols.clone())
        return orig[5](ef, rows, cols)

    def run_rec(bp, tb, s_stacks, opts_, dtype, bidx, sketch):
        where["tag"] = f"batch {bidx}"
        return orig[2](bp, tb, s_stacks, opts_, dtype, bidx, sketch)

    def trans_rec(S, n1, n2, cplan, atol, rtol, cap):
        where["tag"] = "transition"
        return orig[3](S, n1, n2, cplan, atol, rtol, cap)

    # the wrappers count their launches on whatever their module names hold
    cpqr_rec.launches = correct_rec.launches = 0
    L.cpqr_pivots, H.hss_level_correct = cpqr_rec, correct_rec
    fm._run_structured, fm.transition_compress = run_rec, trans_rec
    fm.lowrank_schur_update = schur_rec
    # structured.py imports J's and I's wrappers by name
    S.hss_matvec, S.hss_entries_prepared = matvec_rec, entries_rec
    try:
        levels, root, _ = _factor_levels(plan, tp, opts, torch.float64)
        where["tag"] = "solve"
        F = Factorization(N=plan.N, perm=plan.perm, levels=levels, root=root,
                          opts=opts, plan=plan, device=dev)
        F.solve(b)
    finally:
        (L.cpqr_pivots, H.hss_level_correct, fm._run_structured,
         fm.transition_compress, S.hss_matvec, S.hss_entries_prepared) = orig
        fm.lowrank_schur_update = orig_f
    torch.cuda.synchronize()
    return levels, hcalls, kcalls, jcalls, icalls, fcalls


def entries_bound(ef, rows, cols, out) -> dict:
    """Kernel I's bound: the least bytes of ``out = entries(ef, rows,
    cols)``: per index block and LCA level present, its distinct T rows and
    V rows (r doubles each), one D entry per same-leaf entry, the indices and
    the output; 2 r flops per entry off the leaves."""
    D, T, V = ef
    _, depth, n_pad, r = T.shape
    ls = D.shape[-1]
    rows, cols = rows.long(), cols.long()
    valid = ((rows >= 0) & (rows < n_pad))[..., :, None] \
        & ((cols >= 0) & (cols < n_pad))[..., None, :]
    x = (rows.clamp(0, n_pad - 1) // ls)[..., :, None] \
        ^ (cols.clamp(0, n_pad - 1) // ls)[..., None, :]
    lev = sum(((x >> l) > 0).long() for l in range(depth))
    lev = lev.masked_fill(~valid, -1)

    def distinct(idx, mask):
        s_ = idx.masked_fill(~mask, -1).sort(-1).values
        return int(((s_[..., 1:] != s_[..., :-1]) & (s_[..., 1:] >= 0)).sum()
                   + (s_[..., 0] >= 0).sum())

    rows_read = 0
    for L in range(1, depth + 1):
        at = lev == L
        rows_read += distinct(rows, at.any(-1)) + distinct(cols, at.any(-2))
    work = nbytes(rows, cols, out) + 8 * int((lev == 0).sum()) \
        + 8 * r * rows_read
    return bound(work, 2 * r * int((lev > 0).sum()))


def check_hss_kernels(problems: Problems, n: int, dev, results: Results) -> None:
    """Phase 3, kernels H-K against their plain versions at the structured
    n-plans' shapes: H and K at every distinct launch shape of the factor
    and of one preconditioner application, on inputs captured there, for the
    kest=32 plan and the default-caps plan (one log line each), and so are
    J and I (their first rows: the HSS operands of the kest=32
    factorization's first and top structured batch, the kernel table's
    shapes)."""
    import torch

    import hsolve_torch as ht
    from hsolve_torch.interop import plan_to_torch
    from hsolve_torch.ops import hss as H
    from hsolve_torch.ops import lowrank as L

    A, b, shape = problems.get(n)
    f64 = torch.float64
    record = results.record
    bt = torch.as_tensor(b, dtype=f64, device=dev)
    for label, kw in (("kest=32", HSS), ("default caps", HSS_DEFAULT)):
        opts = ht.SolverOptions(**kw)
        opts = opts.replace(explicit_inverse=opts.resolve_explicit_inverse())
        plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                     opts)
        tp = plan_to_torch(plan, dev)
        t0 = time.perf_counter()
        levels, hcalls, kcalls, jcalls, icalls, fcalls = _hss_captures(
            plan, tp, opts, dev, bt)
        log(f"  {label}: {len(hcalls)} H shapes, {len(kcalls)} K shapes, "
            f"{len(jcalls)} J shapes, {len(icalls)} I shapes captured in "
            f"{time.perf_counter() - t0:.1f} s")
        # H: equal pivots and ranks at every shape
        for (Bm, m, nn, k), (tag, Am, atol, rtol, _) in sorted(hcalls.items()):
            ker = L.cpqr_pivots(Am, atol, rtol, k)
            ref = L.cpqr_pivots_plain(Am, atol, rtol, k)
            if not all(torch.equal(a, b_) for a, b_ in zip(ker, ref)):
                fail(f"cpqr_pivots selects other pivots or ranks than its "
                     f"plain version at {label} {tag} {list(Am.shape)}")
            # the steps this data needs: a pivot per rank, and the step that
            # finds the rank, per matrix; each projects and downdates every
            # column
            need = (ker[1].double() + 1).clamp(max=k)
            steps = float(need.sum())
            ms = device_ms(lambda: L.cpqr_pivots(Am, atol, rtol, k))
            plain_ms = device_ms(lambda: L.cpqr_pivots_plain(Am, atol, rtol, k),
                                 max_reps=20)
            # latency: each step's coefficients are dots of m terms in order
            # (kept for the plain version's pivots), one step after another
            work = bound(nbytes(Am, *ker), 4 * m * nn * steps,
                         chain=float(need.max()) * m)
            cs, resident = L.cpqr_cluster(m, nn)
            desc = (f"{label} {tag} A=[{Bm},{m},{nn}] k={k} cluster {cs}"
                    + ("" if resident else " (columns in global memory)"))
            record("cpqr_pivots", desc, (0.0, 0.0), 0.0, ms, plain_ms, work)
        # K: every level shape, forward and adjoint, at the factor's k and
        # the solve's k = 1; the shapes where it is slower than its plain
        # version, per k = 1 and k > 1
        slower = {"k = 1": [], "k > 1": []}
        for key, (tag, Y0, args) in sorted(kcalls.items()):
            nodes, r, blk, k, adj = key
            ker = H.hss_level_correct(Y0.clone(), *args)
            ref = H.hss_level_correct_plain(Y0.clone(), *args)
            scratch = Y0.clone()
            ms = device_ms(lambda: H.hss_level_correct(scratch, *args))
            plain_ms = device_ms(lambda: H.hss_level_correct_plain(scratch,
                                                                   *args))
            xi, Bl, Br, lu, piv, Phi, _ = args
            # latency: the LU's two substitutions, 2 ceil(2r / 32) diagonal
            # blocks of 32 rows, each row a product and a sum on the last
            work = bound(nbytes(Y0, Y0, xi, Bl, Br, lu, piv, Phi),
                         2 * k * (Bl.numel() + Br.numel() + lu.numel()
                                  + Phi.numel()), products=True,
                         chain=2 * -(-2 * r // 32) * 32 * 2)
            geo = ("one CTA per node" if k == 1 else
                   "nc={} cs={} groups={} stages={}".format(
                       *H.level_correct_launch(r, k, nodes, dev)))
            desc = (f"{label} {tag} {'adj' if adj else 'fwd'} nodes={nodes} "
                    f"2r={2 * r} blk={blk} k={k} {geo}")
            record("hss_level_correct", desc, errors(ker, ref), RTOL_SUM, ms,
                   plain_ms, work)
            if ms > plain_ms:
                slower["k = 1" if k == 1 else "k > 1"].append(ms / plain_ms)
        log(f"  {label}: K at {len(kcalls)} shapes, slower than its plain "
            "version at " + ", ".join(
                f"{len(v)} with {kk}" + (f" (worst {max(v):.2f}x)" if v else "")
                for kk, v in slower.items()))
        if label == "kest=32":
            check_hss_table_shapes(plan, levels, opts, dev, results)
        check_hss_captured(label, jcalls, icalls, results)
        check_sweep_levels(f"structured {label}", levels, plan.N, results)
        check_schur_captured(f"structured {label}", fcalls, results)
    torch.cuda.synchronize()


def check_hss_captured(label, jcalls, icalls, results: Results) -> None:
    """J and I at every captured launch shape of one structured plan: one log
    line per shape, then the shapes where each is slower than its plain
    version, per k = 1 and k > 1 for J, and the time summed over the
    shapes."""
    import torch

    from hsolve_torch.ops import hss as H

    record = results.record
    slower = {"k = 1": [], "k > 1": []}
    sums = {"k = 1": [0.0, 0.0], "k > 1": [0.0, 0.0]}
    for key, (tag, h, X, adj) in sorted(jcalls.items(),
                                        key=lambda kv: kv[0]):
        Bm, nl, ls, r, depth, k, _ = key
        ker = H.hss_matvec(h, X, adj)
        ref = H.hss_matvec_plain(h, X, adj)
        ms = device_ms(lambda: H.hss_matvec(h, X, adj))
        plain_ms = device_ms(lambda: H.hss_matvec_plain(h, X, adj))
        cs, kc, groups, smem, th, rb = H.hss_matvec_geometry(Bm, nl, ls, r,
                                                             depth, k)
        work = bound(nbytes(*h.arrays(), X, ker),
                     2 * k * sum(a.numel() for a in h.arrays()), products=True)
        record("hss_matvec", f"{label} {tag} {'adj' if adj else 'fwd'} B={Bm} "
               f"nleaves={nl} ls={ls} r={r} k={k} cs={cs} kc={kc} "
               f"groups={groups} threads={th} rb={rb}"
               + ("" if smem else " (state in L2)"), errors(ker, ref),
               RTOL_SUM, ms, plain_ms,
               work)
        kk = "k = 1" if k == 1 else "k > 1"
        sums[kk][0] += ms
        sums[kk][1] += plain_ms
        if ms > plain_ms:
            slower[kk].append(ms / plain_ms)
    log(f"  {label}: J at {len(jcalls)} shapes, slower than its plain "
        "version at " + ", ".join(
            f"{len(v)} with {kk}" + (f" (worst {max(v):.2f}x)" if v else "")
            + f"; sum {sums[kk][0]:.4f} ms against {sums[kk][1]:.4f}"
            for kk, v in slower.items()))
    slow_i, sum_i = [], [0.0, 0.0]
    for key, (tag, ef, rr, cc) in sorted(icalls.items(), key=lambda kv: kv[0]):
        ker = H.hss_entries_prepared(ef, rr, cc)
        ref = H.hss_entries_prepared_plain(ef, rr, cc)
        nan = ref.isnan()
        if not torch.equal(ker.isnan(), nan):
            fail(f"hss_entries_prepared puts NaN elsewhere than its plain "
                 f"version at {label} {tag} {key}")
        ms = device_ms(lambda: H.hss_entries_prepared(ef, rr, cc))
        plain_ms = device_ms(lambda: H.hss_entries_prepared_plain(ef, rr, cc))
        record("hss_entries_prepared",
               f"{label} {tag} out={list(ker.shape)} r={ef.T.shape[-1]} "
               f"depth={ef.T.shape[1]} nan={int(nan.sum())}",
               errors(ker[~nan], ref[~nan]) if (~nan).any() else (0.0, 0.0),
               RTOL_SUM, ms, plain_ms, entries_bound(ef, rr, cc, ker))
        sum_i[0] += ms
        sum_i[1] += plain_ms
        if ms > plain_ms:
            slow_i.append(ms / plain_ms)
    log(f"  {label}: I at {len(icalls)} shapes, slower than its plain "
        f"version at {len(slow_i)}"
        + (f" (worst {max(slow_i):.2f}x)" if slow_i else "")
        + f"; sum {sum_i[0]:.4f} ms against {sum_i[1]:.4f}")


def check_hss_table_shapes(plan, levels, opts, dev, results: Results) -> None:
    """I and J on the HSS operands of the first and the top structured batch
    of the kest=32 plan (the kernel table's shapes: I on a leaf and a B12
    extraction, J forward and adjoint at the sketch width and at k=1)."""
    import torch

    from hsolve_torch.factor import torch_sketch
    from hsolve_torch.ops import hss as H

    f64 = torch.float64
    record = results.record
    struct = [i for i, bp in enumerate(plan.batches) if bp.structured]
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    for bidx in (struct[0], struct[-1]):
        bp, lev = plan.batches[bidx], levels[bidx]
        h2 = lev.H2
        p2 = h2.plan
        # I: the leaf D blocks and a level-1 B12 block of S22''s operand
        ef = H.hss_entry_factors(h2)
        leaf = torch.arange(p2.n_pad, device=dev).reshape(
            1, p2.nleaves, p2.ls).expand(h2.B, -1, -1)
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
                   device_ms(lambda: H.hss_entries_prepared(ef, rr, cc)),
                   device_ms(lambda: H.hss_entries_prepared_plain(ef, rr, cc)),
                   entries_bound(ef, rr, cc, ker))
        # J: S22''s operand at the sketch width (the factor's own sketch)
        # and at k=1
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
                       device_ms(lambda: H.hss_matvec(h2, X, adj)),
                       device_ms(lambda: H.hss_matvec_plain(h2, X, adj)),
                       bound(nbytes(*h2.arrays(), X, ker),
                             2 * X.shape[-1] * sum(a.numel()
                                                   for a in h2.arrays()),
                             products=True))
    torch.cuda.synchronize()


def givens_chain(j: int, done: bool) -> int:
    """Kernel M's dependent operations at step j: the j earlier rotations
    (a product and a sum each on the running entry), rotation j (|a|, a
    square, a sum, the root, a quotient, the rotated entry's product and
    sum, g's product: 9), and at the cycle end the back substitution on J =
    j + 1 rows: for row i a product with y[i+1], J - 1 - i subtractions in
    order and a quotient."""
    J = j + 1
    return 2 * j + 9 + ((J * (J - 1)) // 2 + 2 * J if done else 0)


def check_arnoldi_kernels(problems: Problems, n: int, dev,
                          results: Results) -> None:
    """Phase 3, the Arnoldi step on steps j = 0, 14 and 29 captured from one
    30-step GMRES cycle on the n-operator (unpreconditioned, so the cycle
    runs all its steps), in float64 and, as the inner cycle of the mixed
    solve, in float32: kernel L alone (its tail off) against its plain
    version (1e-13 and 1e-5); the step as GMRES runs it, one launch of L
    with M's step and V[j+1] as its tail, with the captured loop test and
    as the cycle's end (done): hc bit for bit kernel L's alone (the same
    passes), H, cs, sn, g, st, done, y and V[j+1] bit for bit M's plain
    version and the division on L's hc and w, w untouched, the ticket back
    at rest, hc and V[j+1] within 1e-13 / 1e-5 of the step's plain version;
    timed beside that and the three launches it replaces (L, M and the
    division), bound by L's bytes (V[:j+1] and w read, V[j+1] written) or
    the queued launch, plus M's chain; kernel M alone against its plain
    version, bit for bit."""
    import dataclasses

    import numpy as np
    import torch

    import hsolve_torch as ht
    import hsolve_torch.krylov as K
    from hsolve_torch.ops import arnoldi as AR

    A, b, _ = problems.get(n)
    bt = torch.as_tensor(np.asarray(b), device=dev)
    op64, mv = ht.spmv_format(A, device=dev)
    op32, _ = ht.spmv_format(A, dtype=np.float32, device=dev)
    steps = (0, 14, 29)
    clone = lambda s: dataclasses.replace(s, **{
        f.name: getattr(s, f.name).clone() for f in dataclasses.fields(s)})
    captured = {}
    orig = K.arnoldi_step

    def rec(s, w, j, floor, cont):
        key = (str(s.V.dtype).replace("torch.", ""), j)
        if j in steps and key not in captured:
            captured[key] = {"s": clone(s), "w": w.clone(), "floor": floor,
                             "cont": cont}
        return orig(s, w, j, floor, cont)

    K.arnoldi_step = rec
    try:
        for inner in (None, "float32"):
            ht.gmres_compiled(mv, None, bt, reltol=1e-14, restart=30,
                              maxiter=30, mv_data=op64, inner_dtype=inner,
                              mv_data_inner=op32 if inner else None,
                              escalate=False)
    finally:
        K.arnoldi_step = orig
    torch.cuda.synchronize()
    if sorted(captured) != sorted((d, j) for d in ("float32", "float64")
                                  for j in steps):
        fail(f"captured Arnoldi steps {sorted(captured)}")
    record = results.record
    for (dname, j), c in sorted(captured.items(), key=lambda kv: kv[0][0],
                                reverse=True):
        tag = "" if dname == "float64" else f":{dname}"
        rtol = RTOL_SUM if dname == "float64" else RTOL_SUM32
        s0, w0, floor = c["s"], c["w"], c["floor"]
        m1, N = s0.V.shape
        m = m1 - 1
        e = s0.V.element_size()
        sk, sp_ = clone(s0), clone(s0)
        wk, wp = w0.clone(), w0.clone()
        AR.arnoldi_cgs2(sk, wk, j)
        AR.arnoldi_cgs2_plain(sp_, wp, j)
        torch.cuda.synchronize()
        if int(sk.ticket[0]) != 0:
            fail(f"arnoldi_cgs2{tag} left its ticket armed at j={j}")
        herr = errors(sk.hc[: j + 2], sp_.hc[: j + 2])
        werr = errors(wk, wp)
        err = max(herr, werr, key=lambda t: t[1])
        scratch_s, scratch_w = clone(s0), w0.clone()
        Vj = s0.V[: j + 1]

        def library():
            h1 = torch.mv(Vj, scratch_w)
            w1 = torch.addmv(scratch_w, Vj.T, h1, alpha=-1.0)
            h2 = torch.mv(Vj, w1)
            w2 = torch.addmv(w1, Vj.T, h2, alpha=-1.0)
            return torch.linalg.vector_norm(w2)

        l_bytes = (j + 1) * N * e + 2 * N * e + (j + 2) * e
        record(f"arnoldi_cgs2{tag}", f"j={j} V=[{m1},{N}]", err, rtol,
               device_ms(lambda: AR.arnoldi_cgs2(scratch_s, scratch_w, j)),
               device_ms(lambda: AR.arnoldi_cgs2_plain(scratch_s, scratch_w, j)),
               bound(l_bytes, 8 * (j + 1) * N + 2 * N, dname),
               library_ms=device_ms(library))
        for cont in dict.fromkeys((c["cont"], False)):
            # the step as GMRES runs it, one launch: its passes are L's (the
            # same code with the tail off), so hc is L's bit for bit, and
            # M's tail and V[j+1] are M's plain version and the division on
            # L's hc and w, bit for bit; w is left as the matvec gave it
            fk, wf = clone(s0), w0.clone()
            AR.arnoldi_step(fk, wf, j, floor, cont)
            torch.cuda.synchronize()
            if int(fk.ticket[0]) != 0:
                fail(f"arnoldi_step{tag} left its ticket armed at j={j}")
            if not torch.equal(fk.hc, sk.hc):
                fail(f"arnoldi_step{tag}: hc differs from kernel L's at j={j}")
            if not torch.equal(wf, w0):
                fail(f"arnoldi_step{tag}: w written at j={j}")
            mp = clone(s0)
            mp.hc.copy_(sk.hc)
            AR.arnoldi_givens_plain(mp, j, floor, cont)
            torch.div(wk, mp.st[1], out=mp.V[j + 1])
            for what in ("H", "cs", "sn", "g", "st", "done", "y"):
                if not torch.equal(getattr(fk, what), getattr(mp, what)):
                    fail(f"arnoldi_step{tag}: M's tail differs from its plain "
                         f"version in {what} at j={j} (cont={cont})")
            if not torch.equal(fk.V[j + 1], mp.V[j + 1]):
                fail(f"arnoldi_step{tag}: V[j+1] differs from w / st[1] at "
                     f"j={j} (cont={cont})")
            # and against the step's plain version on the same inputs
            pp, wpp = clone(s0), w0.clone()
            AR.arnoldi_step_plain(pp, wpp, j, floor, cont)
            step_err = max(errors(fk.V[j + 1], pp.V[j + 1]),
                           errors(fk.hc[: j + 2], pp.hc[: j + 2]),
                           key=lambda t: t[1])
            done = bool(mp.done[0])
            ss, sw = clone(s0), w0.clone()
            # repeated steps rotate g[j] further each time: a floor of -1
            # keeps a step that went on going on
            tfloor = floor if done else -1.0

            def three():
                AR.arnoldi_cgs2(ss, sw, j)
                AR.arnoldi_givens(ss, j, tfloor, cont)
                torch.div(sw, ss.st[1], out=ss.V[j + 1])

            step_ms = device_ms(lambda: AR.arnoldi_step(ss, sw, j, tfloor,
                                                        cont))
            three_ms = device_ms(three)
            ps, pw = clone(s0), w0.clone()
            record(f"arnoldi_step{tag}", f"j={j} m={m} done={int(done)} "
                   f"V=[{m1},{N}]", step_err, rtol, step_ms,
                   device_ms(lambda: AR.arnoldi_step_plain(ps, pw, j, tfloor,
                                                           cont)),
                   bound(l_bytes, 8 * (j + 1) * N + 3 * N, dname,
                         chain=givens_chain(j, done)))
            log(f"  arnoldi_step{tag:14s} j={j} done={int(done)}: bitwise "
                f"(hc, H, cs, sn, g, st, done, y, V[j+1]); one launch "
                f"{step_ms:.4f} ms, L + M + division {three_ms:.4f} ms")
            # M alone, on L's column (bit for bit)
            mk, mp2 = clone(sp_), clone(sp_)
            mk.hc.copy_(sk.hc)
            mp2.hc.copy_(sk.hc)
            AR.arnoldi_givens(mk, j, floor, cont)
            AR.arnoldi_givens_plain(mp2, j, floor, cont)
            torch.cuda.synchronize()
            for what in ("H", "cs", "sn", "g", "st", "done", "y"):
                if not torch.equal(getattr(mk, what), getattr(mp2, what)):
                    fail(f"arnoldi_givens{tag} differs from its plain version "
                         f"in {what} at j={j} (cont={cont})")
            done = bool(mp2.done[0])
            scratch_m = clone(mk)
            tfloor = floor if done else -1.0
            work = e * ((j + 2) + 2 * j + 2 + (m + 1) + 2) + 4 \
                + (e * (m + (j + 1) * (j + 2) // 2) if done else 0)
            record(f"arnoldi_givens{tag}", f"j={j} m={m} done={int(done)}",
                   errors(mk.y, mp2.y) if done else (0.0, 0.0), rtol,
                   device_ms(lambda: AR.arnoldi_givens(scratch_m, j, tfloor,
                                                     cont)),
                   device_ms(lambda: AR.arnoldi_givens_plain(
                       scratch_m, j, tfloor, cont)),
                   bound(work, 6 * j + 12 + ((j + 1) ** 2 if done else 0),
                         dname, chain=givens_chain(j, done)))
    torch.cuda.synchronize()


def factor_bytes(F) -> int:
    """Bytes of the tensors the factorization's dense levels and root keep."""
    import torch

    keep = list(F.levels) + ([F.root] if F.root is not None else [])
    return sum(t.numel() * t.element_size() for lev in keep
               for t in vars(lev).values() if isinstance(t, torch.Tensor))


def main_path(problems: Problems, n: int, dev, path: str) -> dict:
    """Phase 4: the user's workflow at size n; returns its timings and checks."""
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    import hsolve_torch as ht
    from hsolve_torch.factor import solve_with_data

    A, b, shape = problems.get(n)
    opts = ht.SolverOptions(**OPTIONS[path])
    compressed = path in ("compressed", "hss", "hss-default")
    mixed = path == "exact-f32-mixed"
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
        f"{', HSS kind, ls, depth, n_pad' if path.startswith('hss') else ''}):"
        f" {shapes}")

    fdt = torch.float32 if mixed else torch.float64
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    F = ht.factor_with_plan(plan, opts, dtype=fdt, device=dev)  # cold
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 20
    # the default-caps structured factor takes seconds: one warm run
    reps = 1 if path == "hss-default" else 3
    factor_ms = time_ms(lambda: ht.factor_with_plan(plan, opts, dtype=fdt,
                                                    device=dev),
                        reps=reps, warmup=reps // 3)
    op, mv = ht.spmv_format(A, device=dev)
    bt = torch.as_tensor(np.asarray(b), device=dev)
    out = {}
    if mixed:
        # the JAX bench's device configuration (bench.py:263-276): float32
        # cycles over the float32 operator, the float32 factor behind casts
        op32, _ = ht.spmv_format(A, dtype=np.float32, device=dev)
        prec = lambda data, v: solve_with_data(
            data, v.to(torch.float32)).to(v.dtype)
        inner = dict(inner_dtype="float32", mv_data_inner=op32, m_eps=1e-6)
    else:
        prec, inner = solve_with_data, {}

    def solve():
        out["x"], out["info"] = ht.gmres_compiled(
            mv, prec, bt, reltol=RELRES, restart=30, maxiter=60,
            mv_data=op, M_data=F.solve_data, **inner)

    solve()                                                    # cold
    torch.cuda.synchronize()
    solve_ms = time_ms(solve, reps=reps, warmup=reps // 3)
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
               np.linalg.norm(b)),
           "factor_peak_mb": peak_mb}
    if not compressed:
        res["factor_kept_mb"] = factor_bytes(F) / 2 ** 20
    if n <= 128 and path == "exact":
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
           if compressed else "")
        + f"  factor peak {peak_mb:.1f} MiB"
        + (f", kept {res['factor_kept_mb']:.1f} MiB" if not compressed else ""))
    if not info["converged"]:
        fail(f"n={n} {path}: GMRES did not converge ({info})")
    if not relres <= RELRES:
        fail(f"n={n} {path}: independent residual {relres:.3e} > {RELRES}")
    if res.get("fwd_err_vs_spsolve", 0.0) > FWD_N128:
        fail(f"n={n}: forward error {res['fwd_err_vs_spsolve']:.3e} > {FWD_N128}")
    if path in MAX_ITERS and info["iters"] > MAX_ITERS[path].get(n, 60):
        fail(f"n={n} {path}: {info['iters']} GMRES iterations > "
             f"{MAX_ITERS[path].get(n, 60)}")
    if compressed and res["saturated"]:
        fail(f"n={n} {path}: a rank saturated its cap ({report})")
    return res


def kernel_table(runs, kres: Results) -> list:
    """One row per kernel: its launches summed over the main-path runs (each
    counted from zero), and phase 3's numbers; a typed kernel's float32
    numbers ride along in its row."""
    total = {}
    for r in runs:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    table = []
    for k, (src, rep) in SOURCES.items():
        row = {"name": k, "route": "cuda", "source": f"hsolve_torch/csrc/{src}",
               "replaces": rep, "launches": total.get(k, 0),
               **{key: kres[k][key] for key in keys}}
        if k in RUN_IN_STEP:
            row.update(timed="alone", runs_in="arnoldi_step")
        if k in TYPED:
            row["float32"] = {"launches": total.get(f"{k}:float32", 0),
                              **{key: kres[f"{k}:float32"][key]
                                 for key in keys}}
        table.append(row)
    return table


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
    one = torch.zeros(1, device=dev)
    QUEUED["ms"] = queued_ms(one.zero_)
    log(f"[3] kernels against their plain versions at the n={args.kernel_n} "
        f"plans' shapes; a queued one-element launch takes {QUEUED['ms']:.5f} "
        "ms on the device (the floor of the latency bounds)")
    kres = Results()
    check_kernels(problems, args.kernel_n, dev, kres)
    check_kernels(problems, args.kernel_n, dev, kres, "float32")
    check_compressed_kernels(problems, args.kernel_n, dev, kres)
    check_hss_kernels(problems, args.kernel_n, dev, kres)
    check_arnoldi_kernels(problems, args.kernel_n, dev, kres)

    runs = []
    for path, path_kernels in (("exact", kernels.EXACT_PATH),
                               ("compressed", kernels.COMPRESSED_PATH),
                               ("hss", kernels.HSS_PATH),
                               ("hss-default", kernels.HSS_PATH),
                               ("exact-f32-mixed", kernels.MIXED_PATH),
                               ("exact-wide", kernels.EXACT_PATH)):
        for n in (args.sizes if path != "exact-wide" else [WIDE_N]):
            log(f"[4] main path n={n} {path}")
            kernels.reset_launch_counts()
            runs.append(main_path(problems, n, dev, path))
            counts = kernels.launch_counts()
            log(f"  n={n}: kernel launches {counts}")
            missing = [k for k in path_kernels if counts.get(k, 0) <= 0]
            if missing:
                fail(f"n={n}: the main path never launched {missing}")
            # every Arnoldi step one launch: L and M only as the step's
            step = counts.get("arnoldi_step", 0)
            if not step == counts["arnoldi_cgs2"] == counts["arnoldi_givens"]:
                fail(f"n={n} {path}: {step} Arnoldi step launches for "
                     f"{counts['arnoldi_cgs2']} of L and "
                     f"{counts['arnoldi_givens']} of M")
            log(f"  n={n} {path}: {step} Arnoldi steps, one launch each")
            runs[-1]["launches"] = counts

    table = kernel_table(runs, kres)
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
