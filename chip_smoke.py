#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hsolve_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line is printed):

1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and power
   limit;
2. build: the thirteen CUDA kernels (A-M; A-D, L and M also for complex
   values, E-K for float32 and complex128) and the GMRES loop's control
   kernels
   are compiled from ``hsolve_torch/csrc/`` for ``sm_90a``, one nvcc
   process per source, all started together;
3. kernels: each kernel's wrapper runs on the card at the n=512 plans' real
   shapes, then at the 3D plans' (below), and is held against its plain
   torch version on the same inputs (A, B bitwise, G's rank and V bitwise,
   H with equal pivots and ranks, C's backward step, D, F, G's U, I, J and
   K to a relative error of 1e-13, since only the summation
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
   summary line per plan; G at every launch of the low-rank factor, read on
   the device alone (queued behind a sleep kernel), a summary line per plan
   with the sums against the bound; H and K at every distinct
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
   operator, in float64 and float32 (and, below, complex): L alone (1e-13 and 1e-5), the step as
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
   queued one-element launch read in this run.  Then the same checks at
   the 3D plans' shapes (helmholtz3d, k=10, leafmax 100): A-D on the exact
   64^3 plan in both types (fronts 7944 wide, C's forward step at the top
   in four windows, its backward step at [2, 3912, 3976], D at N =
   250,047), B and E-G on the 48^3 low-rank plan at the default caps
   (nb_pad up to 2216, caps up to 560), H-K, I and J on the 40^3
   structured plan at the default caps, the Arnoldi step at N = 250,047;
   before those, A-D and the Arnoldi step on the damped, complex system
   helmholtz2d(512, k=40, damping=0.1) (``DAMPING``) in complex128 and
   complex64, the same checks as in float64 and float32 (A and B bitwise at
   both checked batches and at every launch of its exact factor; C, D and
   L to 1e-13 / 1e-5, C's forward step to 1e-12 / 1e-5 of max |x'| times
   the pivot growth, the 4424-row hand front in windows too, complex64
   against a complex128 solve; M, the step's tail and V[j+1] bit for bit
   their plain versions; a complex multiply-add counts as four real ones,
   a value as 16 or 8 bytes); E, F and G in complex128 at the damped
   system's low-rank n=512 factor (the compressed options below with
   hss=False), on its captured inputs as for float64: E (forward and
   backward) at every launch shape to 1e-13 of the update computed in
   complex long double on the host, F at every launch shape and G at every
   launch (its rank and V bit for bit, U to 1e-13), each with a summary
   line; H-K in complex128 at the damped system's structured n=512
   factors (kest=32 and the default caps), at every distinct launch shape
   of the factor and of one preconditioner application, as for float64 (H's
   pivots and ranks up to a rounding tie, I, J and K to 1e-13), with E and F
   at those factors' shapes, rows ``<name>:complex128``; E-K in float32
   (the JAX bench's device configuration on compressed levels) at the n=512
   low-rank factor and both structured ones, as in complex128, to 1e-5 (E
   and K, which compute in float64 on their float32 operands, also to 1e-5
   of the result computed in float64 from the same operands, and to their
   float32 plain versions within 1e-5 plus the plain version's own distance
   from it; H, whose pivot loop runs in float64, with equal pivots and
   ranks up to a rounding tie), rows ``<name>:float32``; and the GMRES
   loop's control kernels (``csrc/gmres_control.cu``) at the
   n=512 N, bit for bit their plain versions, from states that go on and
   that stop: the run's start, the cycle start in its six type pairs (the
   real three and complex128 cycles, complex64 cycles in a complex64 and
   in a complex128 solve), the cycle end, the escalation; ``gmres_set_cond`` in a composed graph of
   nested WHILE nodes against the host loop reading the same flags;
4. main paths at n=128 and n=512: helmholtz2d (k=40) -> nested_dissection
   (leafmax=100) -> plan_factorization -> factor_with_plan (cuda) ->
   gmres_compiled (reltol 1e-9, restart 30, maxiter 60, the factor as right
   preconditioner, the DIA matvec), first exact (swlevel=0, float64), then
   low-rank compressed (swlevel=-2, swsize=16, atol=rtol=1e-3, kest=32,
   hss=False), then structured (the same options with hss=True, the default),
   then structured at the default rank caps (the same without kest), then
   exact-f32-mixed (the JAX bench's device configuration: a float32
   exact factor, float32 Arnoldi cycles over a float32 DIA operator with
   m_eps=1e-6 inside a float64 solve, escalation on), then the damped,
   complex system helmholtz2d(n, k=40, damping=0.1) at n=128 and n=512:
   exact-complex (a complex128 factor and solve, one iteration) and
   exact-complex-mixed (the bench's complex configuration: a complex64
   factor, complex64 cycles over a complex64 operator inside a complex128
   solve, m_eps=1e-6, escalation on), each launching every kernel of
   ``kernels.COMPLEX_PATH`` / ``COMPLEX_MIXED_PATH`` in its complex type,
   and lowrank-complex (the low-rank compressed options above on the
   damped system: a complex128 factor with E, F and G in complex128,
   complex128 cycles, every kernel of ``kernels.COMPLEX_LOWRANK_PATH``),
   then hss-complex and hss-complex-default (the structured options,
   kest=32 and the default caps, on the damped system: a complex128 factor
   with E-K in complex128, every kernel of ``kernels.COMPLEX_HSS_PATH``),
   then the JAX bench's device configuration on compressed levels,
   lowrank-f32-mixed, hss-f32-mixed and hss-default-f32-mixed (a float32
   factor with E-G, and on structured levels H-K, in float32 inside the
   mixed GMRES of exact-f32-mixed; ``kernels.LOWRANK_MIXED_PATH`` /
   ``HSS_MIXED_PATH``; at n=512 the two structured ones do not reach 1e-9
   in the JAX package either, ``JAX_UNCONVERGED``: there the run may not
   end further off than JAX's relres and logs both),
   then one exact run at
   n=1026, whose 2056-row top front takes kernel C's forward step in
   windows, in one iteration; then the 3D runs: exact-3d (helmholtz3d(64,
   k=10), float64, one iteration), exact-3d-f32-mixed (the same system in
   the bench's device configuration), lowrank-3d (helmholtz3d(48, k=10),
   swlevel=-2, swsize=16, atol=rtol=1e-3, hss=False, the default caps) and
   hss-3d (helmholtz3d(40, k=10), the same with hss=True: at 48^3 the
   structured factor, every HSS record kept at its level's cap, outgrows
   the card's 80 GB) and hss-3d-f32-mixed (the same in the bench's device
   configuration), each line with the card's name and power limit;
   then four runs of the port's bench in a subprocess (``python -m
   hsolve_torch.bench --n 128 --reps 5``, ``--problem helmholtz3d --n 32
   --k 10 --inner f64 --reps 1``, ``--n 128 --reps 5 --damping 0.1`` and
   ``--n 128 --reps 3 --swlevel -2 --swsize 16 --atol 1e-3 --kest 32``, the
   bench's default float32 factor on its structured plan),
   each line held to relres <= 1e-9, no speed-of-light violation, the
   card's line present and, in 2D, the mixed count within ``MAX_ITERS``.  Every solve is ``gmres_compiled(...,
   fetch_info=False)``, the JAX bench's call: one CUDA graph, captured at the
   cold call (its private pool's size is logged), then replayed; a warm one
   runs under ``torch.cuda.set_sync_debug_mode("error")`` (no host read),
   the host operations it issues are counted (the same on every path,
   whatever the iteration count), and the same solve through the
   host-driven loop (``gmres_host_driven``, untimed, its launches not
   counted) must take the same iterations and give x within ``XDIFF``
   relative.  Each run must
   converge, pass an independent scipy check ||b - A x|| / ||b|| <= 1e-9 on
   the host, and launch every kernel of its path (the launch counters are
   reset just before the run and read just after: A-D, L and M on the exact
   path, A-G, L, M on the compressed one, A-M on the structured one, A-D in
   float32, D in float64 and L, M and the step in float32 on the mixed one;
   every launch of L and M one Arnoldi step's single launch; the control
   kernels on every path and the escalation on the mixed one; a graph's
   launches counted at its capture and multiplied by the replays, cycles
   and steps the device summed).  A compressed,
   structured or mixed run must also stay within twice the JAX package's CPU
   iteration counts (``MAX_ITERS``), and a compressed one saturate no rank
   cap (a 3D one no cap below its block's full rank, min(ni_pad, nb_pad):
   a rank at a full-rank cap truncates nothing and is logged as such);
5. output: a JSON line with one entry per kernel (a typed kernel's float32
   numbers in its row, its complex128 and complex64 instances and E-K's
   float32 ones in rows of their own, ``<name>:complex128``,
   ``<name>:float32``), then the card line, then
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
RTOL_SOLVE = {"float64": 1e-12, "float32": 1e-5, "complex128": 1e-12,
              "complex64": 1e-5}
# the complex (damped Helmholtz) system: helmholtz2d(n, k=40, damping=0.1),
# tests/test_complex.py's damping at the bench's k
DAMPING = 0.1
COMPLEX = ("complex128", "complex64")
RELRES = 1e-9         # GMRES target and the independent residual check
# H-K's checks at every launch shape of the structured factors (some 4,800
# shapes over the 2D, damped, float32 and 3D plans): a smaller timing budget
# a shape, and H's plain version (a Python loop of k steps) read over one
# call after the check's own, which keeps the script within its time limit
SHAPE_BUDGET_MS = 5.0
# the graph's x against the host-driven loop's: the same kernels on the same
# inputs, so only launches that sum in a run-dependent order (atomics) part
XDIFF = 1e-10
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
# the 3D problems (helmholtz3d, k=10, leafmax 100): exact at 64^3, where
# the FLOP model puts exact and compressed level (CROSSOVER.md:56-66), and
# low-rank compressed at 48^3 at the default caps (56-560)
K3D = 10.0
EXACT3D = "64^3"
LOWRANK3D = "48^3"
# the structured factor at the default caps keeps every HSS generator,
# translation and Woodbury core at its level's cap (up to 576 at 48^3)
# whatever its node's size: at 48^3 the card's 80 GB run out at the 31
# fronts of batch 7 (44^3: at batch 5); 40^3 keeps 31 GiB at a 49 GiB peak
HSS3D = "40^3"
LOWRANK_DEFAULT = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3, hss=False)
OPTIONS = {"exact": dict(swlevel=0), "compressed": COMPRESSED, "hss": HSS,
           "hss-default": HSS_DEFAULT, "exact-f32-mixed": dict(swlevel=0),
           "exact-wide": dict(swlevel=0), "exact-3d": dict(swlevel=0),
           "exact-3d-f32-mixed": dict(swlevel=0),
           "lowrank-3d": LOWRANK_DEFAULT, "hss-3d": HSS_DEFAULT,
           "exact-complex": dict(swlevel=0),
           "exact-complex-mixed": dict(swlevel=0),
           "lowrank-complex": COMPRESSED, "hss-complex": HSS,
           "hss-complex-default": HSS_DEFAULT,
           "lowrank-f32-mixed": COMPRESSED, "hss-f32-mixed": HSS,
           "hss-default-f32-mixed": HSS_DEFAULT,
           "hss-3d-f32-mixed": HSS_DEFAULT}
# the JAX bench's device configuration (a float32 factor inside mixed
# GMRES) on compressed and structured levels: the bench's own structured
# plans (it has no hss switch; ``bench.py --swlevel -2 --swsize 16 --atol
# 1e-3 --kest 32`` on a device is hss-f32-mixed), the low-rank ones, the
# default caps and the 3D structured plan
F32_COMPRESSED = ("lowrank-f32-mixed", "hss-f32-mixed",
                  "hss-default-f32-mixed", "hss-3d-f32-mixed")
MIXED = ("exact-f32-mixed", "exact-3d-f32-mixed", "exact-complex-mixed") \
    + F32_COMPRESSED
COMPLEX_PATHS = ("exact-complex", "exact-complex-mixed", "lowrank-complex",
                 "hss-complex", "hss-complex-default")
COMPRESSED_PATHS = ("compressed", "hss", "hss-default", "lowrank-3d", "hss-3d",
                    "lowrank-complex", "hss-complex", "hss-complex-default") \
    + F32_COMPRESSED
# twice the JAX package's GMRES iterations on the CPU for the same runs; the
# mixed, hss-default and 3D ones from tools/jax_reference_iters.py (mixed: 5
# at n=128, 80 at n=512, 5 at 64^3; hss-default: 5 at n=128, 40 at n=512;
# low-rank at the default caps: 4 at 48^3; the damped system's mixed
# complex64 configuration: 5 at n=128, 10 at n=512, and 1 in complex128;
# its low-rank complex128 run, lowrank-complex: 4 at n=128, 6 at n=512,
# --damping 0.1 --config lowrank; its structured complex128 runs,
# hss-complex and hss-complex-default: 4 and 4 at n=128, 10 and 10 at
# n=512, --damping 0.1 --config hss / hss-default; the bench's device
# configuration on compressed levels, a float32 factor in mixed GMRES:
# lowrank-f32-mixed 11 at n=128, 79 at n=512 (60 float32, 19 after the
# escalation), hss-f32-mixed 10 at n=128, hss-default-f32-mixed 9 at n=128,
# --config lowrank-f32-mixed / hss-f32-mixed / hss-default-f32-mixed; at
# n=512 the two structured ones do not converge in JAX either: JAX_UNCONVERGED);
# hss-3d and hss-3d-f32-mixed within maxiter (the JAX package's 40^3
# structured run was not measured: its CPU factor would need some 49 GiB)
MAX_ITERS = {"compressed": {128: 12, 512: 14}, "hss": {128: 10, 512: 36},
             "hss-default": {128: 10, 512: 80},
             "exact-f32-mixed": {128: 10, 512: 160}, "exact-wide": {WIDE_N: 1},
             "exact-3d": {EXACT3D: 1},
             "exact-3d-f32-mixed": {EXACT3D: 10},
             "lowrank-3d": {LOWRANK3D: 8}, "hss-3d": {HSS3D: 60},
             "exact-complex": {128: 1, 512: 1},
             "exact-complex-mixed": {128: 10, 512: 20},
             "lowrank-complex": {128: 8, 512: 12},
             "hss-complex": {128: 8, 512: 20},
             "hss-complex-default": {128: 8, 512: 20},
             "lowrank-f32-mixed": {128: 22, 512: 158},
             "hss-f32-mixed": {128: 20}, "hss-default-f32-mixed": {128: 18},
             "hss-3d-f32-mixed": {HSS3D: 60}}
# runs where the JAX package's CPU run does not reach RELRES either (its
# float32 structured factor at n=512 in mixed GMRES: 60 float32 iterations,
# then 60 after the escalation; tools/jax_reference_iters.py): their relres
# by scipy, which the port's run may not exceed; such a run checks its
# kernels and its graph as any other, and logs its relres beside JAX's
JAX_UNCONVERGED = {("hss-f32-mixed", 512): 154.01484097430944,
                   ("hss-default-f32-mixed", 512): 1.9432700693081788}
# the port's bench on the card: the JAX bench's default (helmholtz2d h=128,
# the mixed device configuration) and a small 3D exact run in float64
# cycles (at 64^3 scipy's SuperLU baseline alone takes minutes of host time)
BENCH_RUNS = (("--n", "128", "--reps", "5"),
              ("--problem", "helmholtz3d", "--n", "32", "--k", "10",
               "--inner", "f64", "--reps", "1"),
              ("--n", "128", "--reps", "5", "--damping", "0.1"),
              ("--n", "128", "--reps", "3", "--swlevel", "-2", "--swsize",
               "16", "--atol", "1e-3", "--kest", "32"))
HBM_BPS = 3.35e12     # H100 SXM device memory (the data sheet)
# the data sheet's peaks, FLOP/s: (without, with) the tensor cores; float32
# without TF32, which the port keeps off
PEAK = {"float64": (34e12, 67e12), "float32": (67e12, 67e12)}
PEAK.update(complex128=PEAK["float64"], complex64=PEAK["float32"])
# latency floors of a chain of dependent operations: the H100 SXM's highest
# SM clock (the data sheet's boost) and an assumed least latency of one
# dependent floating-point operation, in cycles
CLOCK_HZ = 1.98e9
DEP_CYCLES = {"float64": 8, "float32": 4}
DEP_CYCLES.update(complex128=DEP_CYCLES["float64"],
                  complex64=DEP_CYCLES["float32"])
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
           "arnoldi_step": ("arnoldi_cgs2.cu", "hsolve/krylov.py:223"),
           "gmres_init": ("gmres_control.cu", "hsolve/krylov.py:310"),
           "gmres_cycle_start": ("gmres_control.cu", "hsolve/krylov.py:282"),
           "gmres_cycle_end": ("gmres_control.cu", "hsolve/krylov.py:301"),
           "gmres_escalate": ("gmres_control.cu", "hsolve/krylov.py:340"),
           "gmres_set_cond": ("gmres_control.cu", "hsolve/krylov.py:314")}
TYPED = ("front_assemble", "extend_add", "level_forward", "sweep_update",
         "dia_spmv", "arnoldi_cgs2", "arnoldi_givens", "arnoldi_step",
         "gmres_init", "gmres_cycle_start", "gmres_cycle_end",
         "gmres_escalate")
# ... of which these have complex instances (the others read and write only
# the solve's real scalars)
TYPED_COMPLEX = ("front_assemble", "extend_add", "level_forward",
                 "sweep_update", "dia_spmv", "arnoldi_cgs2", "arnoldi_givens",
                 "arnoldi_step", "gmres_cycle_start")
# E-K: float64, float32 (the bench's device configuration on compressed
# levels) and complex128 (the damped system's low-rank and structured
# levels)
TYPED_LOWRANK = ("lowrank_sweep_update", "lowrank_schur_update",
                   "lowrank_truncate", "cpqr_pivots", "hss_entries_prepared",
                   "hss_matvec", "hss_level_correct")
# kernels whose rows read them alone: on the main path they run inside the
# fused Arnoldi step's launch, whose launches their counts are
RUN_IN_STEP = ("arnoldi_cgs2", "arnoldi_givens")


def type_tag(dtype_name: str) -> str:
    """A typed kernel's record suffix: none for float64, else ``:<type>``."""
    return "" if dtype_name == "float64" else f":{dtype_name}"


def sum_rtol(dtype_name: str) -> float:
    """RTOL_SUM in the double types, RTOL_SUM32 in the single ones."""
    return RTOL_SUM if dtype_name in ("float64", "complex128") else RTOL_SUM32


def flop_factor(dtype_name: str) -> int:
    """Real operations per multiply-add of the type: a complex one is four
    real multiply-adds."""
    return 4 if dtype_name in COMPLEX else 1


def damped(n: int) -> tuple:
    """The Problems key of the damped, complex helmholtz2d(n)."""
    return ("damped", n)


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg`` behind the seconds since the script started."""
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_ms(fn, budget_ms: float = 20.0, max_reps: int = 200,
              warmup: int = 3) -> float:
    """Time of one call of ``fn`` on the device (ms): after ``warmup``
    calls, back-to-back calls between one pair of CUDA events, divided by
    their count (enough calls to fill about ``budget_ms``, at least 5 unless
    ``max_reps`` is lower), so no call's launch latency or event overhead is
    counted.  Where ``fn``'s host work takes longer than its kernels, this
    still reads the host's rate."""
    import torch

    for _ in range(warmup):
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
    """The problems per size key, generated once per run: an int n is
    helmholtz2d(n, k=40) on an n x n mesh, ``"<n>^3"`` helmholtz3d(n, k=10)
    (7-point, the unit cube)."""

    def __init__(self):
        self._cache = {}

    def get(self, n):
        import hsolve_torch as ht

        if n not in self._cache:
            t0 = time.perf_counter()
            if isinstance(n, tuple):
                self._cache[n] = ht.helmholtz2d(n[1], k=40.0, damping=DAMPING)
            else:
                self._cache[n] = ht.helmholtz3d(int(n[:-2]), k=K3D) \
                    if is_3d(n) else ht.helmholtz2d(n, k=40.0)
            log(f"  {problem_name(n)}: N={self._cache[n][0].shape[0]} "
                f"nnz={self._cache[n][0].nnz} generated in "
                f"{time.perf_counter() - t0:.2f} s (host)")
        return self._cache[n]


def is_3d(n) -> bool:
    return isinstance(n, str) and n.endswith("^3")


def problem_name(n) -> str:
    if isinstance(n, tuple):
        return f"helmholtz2d({n[1]}, damping={DAMPING:g})"
    return f"helmholtz3d({n[:-2]}, k={K3D:g})" if is_3d(n) else \
        f"helmholtz2d({n})"


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
    latter recorded as ``<name>:float32``; on the damped system
    (``damped(n)``) a complex128 and a complex64 run (``<name>:complex128``,
    ``<name>:complex64``; a complex multiply-add counts as four real
    ones)."""
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
    tag = type_tag(dtype_name)
    rtol = sum_rtol(dtype_name)
    fm = flop_factor(dtype_name)
    fadd = 2 if dt.is_complex else 1          # real adds per value add
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
            flops += fadd * c2
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
    check_extend_add_launches("exact damped" if isinstance(n, tuple) else
                              "exact", plan, tp, stacks, adata, results)

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
                   bound(work, 2 * fm * (A_.numel() + lv.L.numel()),
                         dtype_name),
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
                     + Bm * nbp * e + 2 * Bm * ni * e,
                     2 * fm * lev.R.numel(), dtype_name),
               library_ms=device_ms(library))

    # C's forward step on a front wider than one cluster (4424 rows, the
    # helmholtz3d(48) exact top front: three windows), made by hand, against
    # its plain version, and both against a float64 (complex128) solve of
    # the same (rounded) front: in float32 (complex64) the kernel may be no
    # further from that solve than the plain version, beyond 1e-7 of
    # max |x'|
    wide = _wide_level(dev, dt, ni=4424, nb=24, N=N, seed=SEED)
    growth = float(dk._diag_ratio(wide.lu).max())
    ker = level_forward(C0.clone(), wide, N)
    ref = level_forward_plain(C0.clone(), wide, N)
    rows = wide.int_ids[wide.int_ids < N].long()
    note = ""
    if dtype_name in ("float32", "complex64"):
        f64 = torch.complex128 if dt.is_complex else torch.float64
        x64 = level_forward_plain(C0.to(f64), dataclasses.replace(
            wide, lu=wide.lu.to(f64), L=wide.L.to(f64)), N)[rows]
        s64 = float(x64.abs().max())
        d_ker = float((ker[rows].to(f64) - x64).abs().max()) / s64
        d_ref = float((ref[rows].to(f64) - x64).abs().max()) / s64
        note = (f" from {str(f64)[6:]}: kernel {d_ker:.3e}, plain "
                f"{d_ref:.3e}")
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
                     2 * fm * (wide.lu.numel() + wide.L.numel()), dtype_name))

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
                     2 * fm * op.values.numel(), dtype_name),
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
    tag = type_tag(str(dt).replace("torch.", ""))
    fadd = 2 if dt.is_complex else 1
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
                work = bound(3 * c2 * e + nbytes(m_, sr, dr), fadd * c2,
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
    wide = np.clongdouble if C0.is_complex() else np.longdouble
    ld = lambda t: t.cpu().numpy().astype(wide)
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
    1e-13), timed beside it; in float32 (float64 sums rounded once, in
    both) to ``RTOL_SUM32`` of each; returns ``(ms, plain ms, bound ms)``."""
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
    dname = str(U.dtype).replace("torch.", "")
    rtol = sum_rtol(dname)
    if not e_ker <= rtol:
        fail(f"lowrank_sweep_update is {e_ker:.3e} of the largest entry off "
             f"the long-double update at {desc} (limit {rtol:g})")
    scratch = C0.clone()
    Bu, R, kc = U.shape
    Cc = V.shape[1]
    k = C0.shape[1]
    e = U.element_size()
    work = bound(nbytes(U, V, ids_out, *kw.values()) + 2 * Bu * R * e * k
                 + (Bu * Cc * e * k if "ids_in" in kw else 0),
                 2 * flop_factor(dname) * Bu * kc * (R + Cc) * k, dname,
                 products=True)
    cs, threads, _, _, vec, _, dd, _ = lowrank_sweep_geometry(Bu, R, Cc, kc,
                                                              k, itemsize=e)
    ms = device_ms(lambda: lowrank_sweep_update(scratch, ids_out, U, V, N, **kw))
    plain_ms = device_ms(lambda: lowrank_sweep_update_plain(scratch, ids_out, U,
                                                            V, N, **kw))
    results.record("lowrank_sweep_update" + type_tag(dname),
                   f"{desc} U={list(U.shape)} V={list(V.shape)[1:]} cs={cs} "
                   f"threads={threads} vec={vec} dd={dd}; off the long-double "
                   f"update: "
                   f"kernel {e_ker:.1e}, plain {e_ref:.1e}, cancellation "
                   f"{canc:.3g}", errors(ker, ref), rtol + e_ref, ms,
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
    C0 = torch.randn(N + 1, 1, dtype=lev0.LU_.dtype, device=dev, generator=gen)
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
    tag = type_tag(str(lev0.LU_.dtype).replace("torch.", ""))
    log(f"  {label}: E{tag} at {len(rows_)} shapes, kernel {min(ms_):.4f}-"
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


def schur_bound(B, m_pad, ni_pad, kc, dname="float64") -> dict:
    """Kernel F's bound: Abb and Abi read, RU, RV and sperm read, S
    written, each once; both products' operations on the tensor cores (a
    complex value 16 bytes, a float32 one 4, a complex multiply-add four
    real ones; float32 without TF32 at the CUDA cores' rate)."""
    nb = m_pad - ni_pad
    e = {"complex128": 16, "float32": 4}.get(dname, 8)
    work = e * B * (2 * nb * nb + nb * ni_pad + ni_pad * kc + nb * kc) \
        + 8 * B * nb
    return bound(work, 2 * flop_factor(dname) * B * kc * nb * (ni_pad + nb),
                 dname, products=True)


def check_schur_captured(label, fcalls, results: Results) -> None:
    """F at every captured launch shape of one plan, against its plain
    version (1e-13 of the largest entry; float32 1e-5), a log line per
    shape and a
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
        dname = str(front.dtype).replace("torch.", "")
        g = schur_geometry(B, ni_pad, nb, kc, itemsize=front.element_size())
        work = schur_bound(B, m_pad, ni_pad, kc, dname)
        ms = device_ms(lambda: lowrank_schur_update(*args))
        plain_ms = device_ms(lambda: lowrank_schur_update_plain(*args))
        results.record(
            "lowrank_schur_update" + type_tag(dname),
            f"{label} {tag} [{B},{nb},{nb}] ni={ni_pad} k={kc} "
            + (f"bands of {g['bm']}, whole rows" if g["whole"] else
               f"{g['bm']}x{g['bn']} tiles, cluster {g['cs']}"
               + (f", {g['nct']} CTAs a band walking {g['walk']} tiles"
                  if "walk" in g else "")),
            errors(ker, ref), sum_rtol(dname), ms, plain_ms, work)
        rows_.append((ms, plain_ms, work["bound_ms"]))
    ms_, plain_, bound_ = zip(*rows_)
    log(f"  {label}: F at {len(rows_)} shapes, kernel {min(ms_):.4f}-"
        f"{max(ms_):.4f} ms; slower than its plain version at "
        f"{sum(a > b for a, b in zip(ms_, plain_))}; within 2x of its bound "
        f"at {sum(a <= 2 * c for a, c in zip(ms_, bound_))}; sum "
        f"{sum(ms_):.4f} ms against plain {sum(plain_):.4f} and bound "
        f"{sum(bound_):.4f}")


def truncate_recorder(fm, gcalls: list):
    """A stand-in for ``factor.py``'s ``rand_lowrank`` that records the inputs
    of kernel G at every launch (``Q``, ``Uw``, ``sv``, ``Vh`` and the
    truncation) into ``gcalls`` and calls it."""
    import torch

    orig = fm.rand_lowrank

    from hsolve_torch import kernels

    def rec(A, omega, atol, rtol, cap):
        Q, _ = torch.linalg.qr(A @ omega)
        Uw, sv, Vh = torch.linalg.svd(Q.mH @ A, full_matrices=False)
        gcalls.append(tuple(map(kernels.materialized, (Q, Uw, sv, Vh)))
                      + (atol, rtol, cap))
        return orig(A, omega, atol, rtol, cap)

    return orig, rec


def check_truncate_captured(label, gcalls, results: Results) -> None:
    """G at every captured launch of one plan against its plain version
    (the rank and V bit for bit, U within 1e-13 of its largest entry, 1e-5
    in float32: the product ``Q @ Uw`` sums in another order), read on the
    device alone
    (queued behind a sleep kernel), a log line per launch and a summary
    line: the launches, the time summed against the plain version's and the
    bound (Q, Uw, sv and Vh read, U and V written, once; the product's
    2 m s rank operations a front on the tensor cores)."""
    import torch

    from hsolve_torch.ops.lowrank import (lowrank_truncate,
                                          lowrank_truncate_plain)

    rows_ = []
    for i, args in enumerate(gcalls):
        Q, Uw, sv, Vh, atol, rtol, cap = args
        ker = lowrank_truncate(*args)
        ref = lowrank_truncate_plain(*args)
        if not (torch.equal(ker[2], ref[2]) and torch.equal(ker[1], ref[1])):
            fail(f"lowrank_truncate: rank or V differ from its plain version "
                 f"at {label} launch {i}")
        B, m, s_ = Q.shape
        dname = str(Q.dtype).replace("torch.", "")
        work = bound(nbytes(Q, Uw, sv, Vh, ker[0], ker[1]),
                     2.0 * flop_factor(dname) * m * s_
                     * float(ker[2].double().sum()), dname, products=True)
        ms = queued_ms(lambda: lowrank_truncate(*args))
        plain_ms = device_ms(lambda: lowrank_truncate_plain(*args))
        results.record("lowrank_truncate" + type_tag(dname),
                       f"{label} launch {i} Q=[{B},{m},{s_}] n={Vh.shape[-1]} "
                       f"cap={cap} rank<={int(ker[2].max())} (device only)",
                       errors(ker[0], ref[0]), sum_rtol(dname), ms, plain_ms,
                       work)
        rows_.append((ms, plain_ms, work["bound_ms"]))
    ms_, plain_, bound_ = zip(*rows_)
    log(f"  {label}: G at {len(rows_)} launches, kernel {min(ms_):.4f}-"
        f"{max(ms_):.4f} ms (device only); slower than its plain version at "
        f"{sum(a > b for a, b in zip(ms_, plain_))}; sum {sum(ms_):.4f} ms "
        f"against plain {sum(plain_):.4f} and bound {sum(bound_):.4f} "
        f"({sum(bound_) / sum(ms_):.2f} of it)")


def check_compressed_kernels(problems: Problems, n, dev, results: Results,
                             kw=COMPRESSED, label="low-rank",
                             dtype_name="float64") -> None:
    """Phase 3, kernels B and E-G against their plain versions at the shapes
    of the low-rank factor of the n-problem with options ``kw``: the
    fronts, sketches and factors of a real compressed factorization (B at
    every launch, E at every launch shape, F at every launch shape and G at
    every launch, on their captured inputs).  In complex128 (the damped
    system) and float32 (the JAX bench's device configuration) E, F and G
    only: B's complex and float32 instances are checked at every launch of
    the exact complex and float32 factors."""
    import importlib

    import torch

    import hsolve_torch as ht
    from hsolve_torch.factor import _factor_levels
    from hsolve_torch.interop import plan_to_torch

    A, _, shape = problems.get(n)
    opts = ht.SolverOptions(**kw)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 opts)
    tp = plan_to_torch(plan, dev)
    fdt = getattr(torch, dtype_name)
    fm = importlib.import_module("hsolve_torch.factor")  # ht.factor: the function
    fcalls, gcalls = {}, []
    orig, rec = schur_recorder(fm, fcalls, {"tag": "factor"})
    orig_g, rec_g = truncate_recorder(fm, gcalls)
    fm.lowrank_schur_update, fm.rand_lowrank = rec, rec_g
    try:
        levels, _, stacks = _factor_levels(plan, tp, opts, fdt)
    finally:
        fm.lowrank_schur_update, fm.rand_lowrank = orig, orig_g
    torch.cuda.synchronize()

    # E: both forms at every launch shape, the first compressed level first
    check_sweep_levels(label, levels, plan.N, results)
    # B at every launch of the compressed factor
    if fdt == torch.float64:
        check_extend_add_launches(label, plan, tp, stacks, tp.adata.to(fdt),
                                  results)
    # F: the Schur update at every launch shape of the factor
    check_schur_captured(label, fcalls, results)
    del levels, stacks, fcalls
    # G: the product and truncation at every launch, on the factor's own
    # blocks and sketches
    check_truncate_captured(label, gcalls, results)
    torch.cuda.synchronize()


def check_cpqr_shape(desc, Am, atol, rtol, k, results: Results):
    """H at one launch shape: equal pivots and ranks; returns (ms, plain)."""
    from hsolve_torch.ops import lowrank as L

    m, nn = Am.shape[-2:]
    dname = str(Am.dtype).replace("torch.", "")
    ker = L.cpqr_pivots(Am, atol, rtol, k)
    ref = L.cpqr_pivots_plain(Am, atol, rtol, k)
    ties = cpqr_ties(Am, ker, ref, f"{desc} {list(Am.shape)}")
    # the steps this data needs: a pivot per rank, and the step that finds
    # the rank, per matrix; each projects and downdates every column
    need = (ker[1].double() + 1).clamp(max=k)
    steps = float(need.sum())
    ms = device_ms(lambda: L.cpqr_pivots(Am, atol, rtol, k),
                   budget_ms=SHAPE_BUDGET_MS)
    plain_ms = device_ms(lambda: L.cpqr_pivots_plain(Am, atol, rtol, k),
                         max_reps=1, warmup=0)
    # latency: each step's coefficients are dots of m terms in order (kept
    # for the plain version's pivots), one step after another
    work = bound(nbytes(Am, *ker), 4 * flop_factor(dname) * m * nn * steps,
                 dname, chain=float(need.max()) * m)
    cs, resident = L.cpqr_cluster(m, nn, L.cpqr_itemsize(Am.dtype))
    results.record("cpqr_pivots" + type_tag(dname),
                   f"{desc} A={list(Am.shape)} k={k} cluster "
                   f"{cs}" + ("" if resident else " (columns in global memory)")
                   + (f" ({ties} matrices part at a rounding tie)" if ties
                      else ""), (0.0, 0.0), 0.0, ms, plain_ms, work)
    return ms, plain_ms


def cpqr_ties(Am, ker, ref, desc) -> int:
    """H's pivots against its plain version's: equal, or parting at a
    rounding tie.  The two sum the column norms and coefficients in other
    orders (and the plain version's own order depends on the batch's
    shape), so columns whose norms are equal in exact arithmetic (the 3D
    stencil's symmetries) may go either way, and the two runs go on from
    there.  Where a matrix's pivots differ, the ranks must be equal, and
    replaying the kernel's pivots in the matrix's type (forced pivots, the
    plain version's steps), each must be a largest downdated norm^2 of its step
    within the downdating's rounding (2 m (j + 1) eps times the column's
    norm^2 before step 0: each step subtracts a coefficient summed over m
    products; the replay, and eps, in the type of H's loop: float64 for a
    float32 matrix, ``cpqr_loop_type``), the plain version's first
    differing pivot too; returns the number of such matrices."""
    import torch

    from hsolve_torch.ops.lowrank import _abs2, _div_real, cpqr_loop_type

    piv_k, rank_k = ker
    piv_p, rank_p = ref
    if not rank_k.equal(rank_p):
        fail(f"cpqr_pivots finds other ranks than its plain version at {desc}")
    bad = (piv_k != piv_p).any(-1)
    if not bad.any():
        return 0
    idx = bad.nonzero().flatten()
    X = Am[idx].to(cpqr_loop_type(Am.dtype))
    pk, pp = piv_k[idx].long(), piv_p[idx].long()
    first = (pk != pp).int().argmax(-1)
    rows = torch.arange(len(idx), device=X.device)
    m = X.shape[-2]
    eps = torch.finfo(X.real.dtype).eps
    n2 = _abs2(X).sum(-2)
    n20 = n2.clone()
    for j in range(pk.shape[-1]):
        p = pk[:, j]
        live = p >= 0
        top = n2.max(-1).values
        for pj, on in ((p, live), (pp[:, j], (first == j) & live)):
            c = pj.clamp(min=0)
            off = top - n2[rows, c] > 2 * m * (j + 1) * eps * n20[rows, c]
            if bool((off & on).any()):
                fail(f"cpqr_pivots parts from its plain version's pivots "
                     f"other than at a rounding tie at {desc} (step {j})")
        a = X[rows, :, p.clamp(min=0)]
        nrm = _abs2(a).sum(-1).clamp(min=1e-300).sqrt()
        q = torch.where(live[:, None], _div_real(a, nrm), 0.0)
        coef = (q.conj()[:, :, None] * X).sum(-2)
        X -= q[:, :, None] * coef[:, None, :]
        n2 = torch.clamp(n2 - _abs2(coef), min=0.0)
        n2[rows[live], p[live]] = -float("inf")
    return len(idx)


def check_correct_shape(desc, key, Y0, args, results: Results):
    """K at one launch shape (``Y0`` its input, which it overwrites);
    returns (ms, plain).  K's float32 instance computes in float64 on its
    float32 operands, as E's float32 sums do: it is held, as E is, to the
    correction computed in float64 from the same operands (``RTOL_SUM32``
    of max |Y|) and to its float32 plain version within ``RTOL_SUM32`` plus
    the plain version's own distance from that correction (its float32
    solve with the core's LU lands cond(core) float32 epsilons off)."""
    from hsolve_torch.ops import hss as H

    nodes, r, blk, k, adj = key
    ker = H.hss_level_correct(Y0.clone(), *args)
    ref = H.hss_level_correct_plain(Y0.clone(), *args)
    dname = str(Y0.dtype).replace("torch.", "")
    limit, note = sum_rtol(dname), ""
    if dname == "float32":
        wide = [a.double() if a.is_floating_point() else a
                for a in args[:-1]]
        exact = H.hss_level_correct_plain(Y0.double(), *wide, args[-1])
        e_ker, e_ref = (errors(t.double(), exact)[1] for t in (ker, ref))
        if not e_ker <= limit:
            fail(f"hss_level_correct:float32 is {e_ker:.3e} of max |Y| off "
                 f"the float64 correction at {desc} {key} (limit {limit:g})")
        note = (f"; off the float64 correction: kernel {e_ker:.1e}, plain "
                f"{e_ref:.1e}")
        limit += e_ref
    scratch = Y0.clone()
    ms = device_ms(lambda: H.hss_level_correct(scratch, *args),
                   budget_ms=SHAPE_BUDGET_MS)
    plain_ms = device_ms(lambda: H.hss_level_correct_plain(scratch, *args),
                         budget_ms=SHAPE_BUDGET_MS)
    xi, Bl, Br, lu, piv, Phi, _ = args
    # latency: the LU's two substitutions, 2 ceil(2r / 32) diagonal blocks of
    # 32 rows, each row a product and a sum on the last
    work = bound(nbytes(Y0, Y0, xi, Bl, Br, lu, piv, Phi),
                 2 * flop_factor(dname) * k * (Bl.numel() + Br.numel()
                                               + lu.numel() + Phi.numel()),
                 dname, products=True, chain=2 * -(-2 * r // 32) * 32 * 2)
    if dname != "float64":
        isz = H.level_correct_itemsize(Y0.dtype)
        geo = f"nc={H.level_correct_geometry_cc(r, k, isz)} (CUDA cores)"
    else:
        geo = ("one CTA per node" if k == 1 else
               "nc={} cs={} groups={} stages={}".format(
                   *H.level_correct_launch(r, k, nodes, Y0.device)))
    results.record("hss_level_correct" + type_tag(dname),
                   f"{desc} {'adj' if adj else 'fwd'} "
                   f"nodes={nodes} 2r={2 * r} blk={blk} k={k} {geo}{note}",
                   errors(ker, ref), limit, ms, plain_ms, work)
    return ms, plain_ms


def check_matvec_shape(desc, key, h, X, adj, results: Results):
    """J at one launch shape; returns (ms, plain)."""
    from hsolve_torch.ops import hss as H

    Bm, nl, ls, r, depth, k, _ = key
    dname = str(X.dtype).replace("torch.", "")
    ker = H.hss_matvec(h, X, adj)
    ref = H.hss_matvec_plain(h, X, adj)
    ms = device_ms(lambda: H.hss_matvec(h, X, adj), budget_ms=SHAPE_BUDGET_MS)
    plain_ms = device_ms(lambda: H.hss_matvec_plain(h, X, adj),
                         budget_ms=SHAPE_BUDGET_MS)
    cs, kc, groups, smem, th, rb = H.hss_matvec_geometry(
        Bm, nl, ls, r, depth, k, itemsize=X.element_size())
    work = bound(nbytes(*h.arrays(), X, ker),
                 2 * flop_factor(dname) * k * sum(a.numel()
                                                  for a in h.arrays()),
                 dname, products=True)
    results.record("hss_matvec" + type_tag(dname),
                   f"{desc} {'adj' if adj else 'fwd'} B={Bm} "
                   f"nleaves={nl} ls={ls} r={r} k={k} cs={cs} kc={kc} "
                   f"groups={groups} threads={th} rb={rb}"
                   + ("" if smem else " (state in L2)"), errors(ker, ref),
                   sum_rtol(dname), ms, plain_ms, work)
    return ms, plain_ms


def check_entries_shape(desc, key, ef, rr, cc, results: Results):
    """I at one launch shape (NaN where its plain version has NaN: indices
    out of range); returns (ms, plain)."""
    from hsolve_torch.ops import hss as H

    ker = H.hss_entries_prepared(ef, rr, cc)
    ref = H.hss_entries_prepared_plain(ef, rr, cc)
    dname = str(ef.D.dtype).replace("torch.", "")
    nan = ref.isnan()
    if not ker.isnan().equal(nan):
        fail(f"hss_entries_prepared puts NaN elsewhere than its plain version "
             f"at {desc} {key}")
    ms = device_ms(lambda: H.hss_entries_prepared(ef, rr, cc),
                   budget_ms=SHAPE_BUDGET_MS)
    plain_ms = device_ms(lambda: H.hss_entries_prepared_plain(ef, rr, cc),
                         budget_ms=SHAPE_BUDGET_MS)
    results.record("hss_entries_prepared" + type_tag(dname),
                   f"{desc} out={list(ker.shape)} r={ef.T.shape[-1]} "
                   f"depth={ef.T.shape[1]} nan={int(nan.sum())}",
                   errors(ker[~nan], ref[~nan]) if (~nan).any() else (0.0, 0.0),
                   sum_rtol(dname), ms, plain_ms,
                   entries_bound(ef, rr, cc, ker))
    return ms, plain_ms


def _hss_checked(plan, tp, opts, dev, b, label, results: Results, dtype):
    """Factor ``plan`` (structured) and apply the factor once to ``b``,
    holding kernels H, K, J and I to their plain versions at the first
    launch of every distinct shape, right there (H: ``(B, m, n, k)``; K:
    ``(nodes, r, blk, k, transpose)``; J: ``(B, nleaves, ls, r, depth, k,
    adjoint)``; I: ``(B, M, p, q, n_pad, ls, r, depth)``; each tagged with
    the batch that first gave it), so that no input outlives its launch;
    returns ``(levels, {kernel: [(key, ms, plain_ms)]}, Schur-update
    calls)``, the last keyed ``(B, m_pad, ni_pad, kc)`` for kernel F on the
    plan's compressed batches that are not structured.  The factor runs in
    ``dtype`` (``b`` in the same type)."""
    import importlib

    import torch

    import hsolve_torch.structured as S
    from hsolve_torch.factor import Factorization, _factor_levels
    from hsolve_torch.ops import hss as H
    from hsolve_torch.ops import lowrank as L

    fm = importlib.import_module("hsolve_torch.factor")  # ht.factor: the function
    where = {"tag": "solve"}
    rows = {"H": [], "K": [], "J": [], "I": []}
    seen, fcalls = set(), {}
    orig_f, schur_rec = schur_recorder(fm, fcalls, {"tag": "factor"})
    orig = (L.cpqr_pivots, H.hss_level_correct, fm._run_structured,
            fm.transition_compress, S.hss_matvec, S.hss_entries_prepared)

    def first(kind, key):
        if (kind, key) in seen:
            return False
        seen.add((kind, key))
        return True

    def cpqr_rec(Am, atol, rtol, k):
        key = (*Am.shape, k)
        if first("H", key):
            rows["H"].append((key, *check_cpqr_shape(
                f"{label} {where['tag']}", Am, atol, rtol, k, results)))
        return orig[0](Am, atol, rtol, k)

    def correct_rec(Y, xi, Bl, Br, lu, piv, Phi, transpose):
        key = (Bl.shape[0] * Bl.shape[1], Bl.shape[-1],
               Y.shape[1] // (2 * Bl.shape[1]), Y.shape[-1], bool(transpose))
        if first("K", key):
            rows["K"].append((key, *check_correct_shape(
                f"{label} {where['tag']}", key, Y,
                (xi, Bl, Br, lu, piv, Phi, transpose), results)))
        return orig[1](Y, xi, Bl, Br, lu, piv, Phi, transpose)

    def matvec_rec(h, x, adjoint=False):
        p_ = h.plan
        key = (h.B, p_.nleaves, p_.ls, h.r, p_.depth, x.shape[-1],
               bool(adjoint))
        if first("J", key):
            rows["J"].append((key, *check_matvec_shape(
                f"{label} {where['tag']}", key, h, x, bool(adjoint),
                results)))
        return orig[4](h, x, adjoint)

    def entries_rec(ef, rows_, cols):
        key = (*rows_.shape, cols.shape[-1], *ef.T.shape[2:], ef.D.shape[-1],
               ef.T.shape[1])
        if first("I", key):
            rows["I"].append((key, *check_entries_shape(
                f"{label} {where['tag']}", key, ef, rows_, cols, results)))
        return orig[5](ef, rows_, cols)

    def run_rec(bp, tb, s_stacks, opts_, dtype, bidx, sketch):
        where["tag"] = f"batch {bidx}"
        return orig[2](bp, tb, s_stacks, opts_, dtype, bidx, sketch)

    def trans_rec(S_, n1, n2, cplan, atol, rtol, cap):
        where["tag"] = "transition"
        return orig[3](S_, n1, n2, cplan, atol, rtol, cap)

    # the wrappers count their launches on whatever their module names hold
    cpqr_rec.launches = correct_rec.launches = 0
    cpqr_rec.launches_by_type, correct_rec.launches_by_type = {}, {}
    L.cpqr_pivots, H.hss_level_correct = cpqr_rec, correct_rec
    fm._run_structured, fm.transition_compress = run_rec, trans_rec
    fm.lowrank_schur_update = schur_rec
    # structured.py imports J's and I's wrappers by name
    S.hss_matvec, S.hss_entries_prepared = matvec_rec, entries_rec
    try:
        levels, root, _ = _factor_levels(plan, tp, opts, dtype)
        where["tag"] = "solve"
        F = Factorization(N=plan.N, perm=plan.perm, levels=levels, root=root,
                          opts=opts, plan=plan, device=dev)
        F.solve(b)
    finally:
        (L.cpqr_pivots, H.hss_level_correct, fm._run_structured,
         fm.transition_compress, S.hss_matvec, S.hss_entries_prepared) = orig
        fm.lowrank_schur_update = orig_f
    torch.cuda.synchronize()
    return levels, rows, fcalls


def entries_bound(ef, rows, cols, out) -> dict:
    """Kernel I's bound: the least bytes of ``out = entries(ef, rows,
    cols)``: per index block and LCA level present, its distinct T rows and
    V rows (r values each), one D entry per same-leaf entry, the indices and
    the output; 2 r flops per entry off the leaves (a complex multiply-add
    four real ones, a value 16 bytes)."""
    D, T, V = ef
    dname = str(D.dtype).replace("torch.", "")
    e = D.element_size()
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
    work = nbytes(rows, cols, out) + e * int((lev == 0).sum()) \
        + e * r * rows_read
    return bound(work, 2 * flop_factor(dname) * r * int((lev > 0).sum()),
                 dname)


def check_hss_kernels(problems: Problems, n, dev, results: Results,
                      configs=(("kest=32", HSS, True),
                               ("default caps", HSS_DEFAULT, False)),
                      dtype_name="float64") -> None:
    """Phase 3, kernels H-K against their plain versions at the structured
    n-plans' shapes: H, K, J and I at the first launch of every distinct
    shape of the factor and of one preconditioner application, checked
    there, for each of ``configs`` (``(label, options, table)``; 2D: the
    kest=32 plan and the default-caps plan), a summary line per kernel; J
    and I also (where ``table``) on the HSS operands of the factorization's
    first and top structured batch: the kernel table's shapes for kest=32;
    E and F at the structured factor's shapes.  On the damped system
    (``damped(n)``) in complex128: the rows ``<name>:complex128``."""
    import torch

    import hsolve_torch as ht
    from hsolve_torch.interop import plan_to_torch

    A, b, shape = problems.get(n)
    fdt = getattr(torch, dtype_name)
    bt = torch.as_tensor(b, dtype=fdt, device=dev)
    for label, kw, table in configs:
        opts = ht.SolverOptions(**kw)
        opts = opts.replace(explicit_inverse=opts.resolve_explicit_inverse())
        plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                     opts)
        tp = plan_to_torch(plan, dev)
        t0 = time.perf_counter()
        levels, rows, fcalls = _hss_checked(plan, tp, opts, dev, bt, label,
                                            results, fdt)
        log(f"  {label}: " + ", ".join(f"{len(v)} {k} shapes"
                                       for k, v in rows.items())
            + f" checked in {time.perf_counter() - t0:.1f} s")
        for kernel in ("K", "J", "I"):
            log(f"  {label}: {kernel} at {len(rows[kernel])} shapes, "
                + hss_summary(kernel, rows[kernel]))
        if table:
            check_hss_table_shapes(plan, levels, opts, dev, results)
        check_sweep_levels(f"structured {label}", levels, plan.N, results)
        check_schur_captured(f"structured {label}", fcalls, results)
        del levels, fcalls
    torch.cuda.synchronize()


def hss_summary(kernel, rows_) -> str:
    """The shapes where ``kernel`` is slower than its plain version (K and
    J: per k = 1 and k > 1) and, for J and I, the times summed."""
    k_of = {"K": lambda key: key[3], "J": lambda key: key[5]}.get(kernel)
    parts = []
    for kk, sel in ((("k = 1", lambda k: k == 1), ("k > 1", lambda k: k > 1))
                    if k_of else (("", lambda k: True),)):
        got = [(ms, pl) for key, ms, pl in rows_
               if sel(k_of(key) if k_of else 1)]
        slow = [ms / pl for ms, pl in got if ms > pl]
        parts.append(f"{len(slow)}" + (f" with {kk}" if kk else "")
                     + (f" (worst {max(slow):.2f}x)" if slow else "")
                     + ("" if kernel == "K" else
                        f"; sum {sum(m for m, _ in got):.4f} ms against "
                        f"{sum(p for _, p in got):.4f}"))
    return "slower than its plain version at " + ", ".join(parts)


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
    solve, in float32 (on the damped system, ``damped(n)``: complex128 and
    complex64, recorded as ``<name>:complex128`` and ``:complex64``): kernel L alone (its tail off) against its plain
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
    wide, narrow = COMPLEX if isinstance(n, tuple) else ("float64", "float32")
    bt = torch.as_tensor(np.asarray(b), device=dev)
    op64, mv = ht.spmv_format(A, device=dev)
    op32, _ = ht.spmv_format(A, dtype=np.dtype(narrow), device=dev)
    steps = (0, 14, 29)
    clone = lambda s: dataclasses.replace(s, **{
        f.name: getattr(s, f.name).clone() for f in dataclasses.fields(s)})
    captured = {}
    orig = K.arnoldi_step

    def rec(s, w):
        j = int(s.loop[AR.J])
        key = (str(s.V.dtype).replace("torch.", ""), j)
        if j in steps and key not in captured:
            captured[key] = {"s": clone(s), "w": w.clone(),
                             "floor": float(s.floor[0]),
                             "cont": AR.step_cont(s, j)}
        return orig(s, w)

    # the host-driven loop: the steps are launched from Python, one by one
    K.arnoldi_step = rec
    try:
        for inner in (None, narrow):
            K.gmres_host_driven(mv, None, bt, reltol=1e-14, restart=30,
                                maxiter=30, mv_data=op64, inner_dtype=inner,
                                mv_data_inner=op32 if inner else None,
                                escalate=False)
    finally:
        K.arnoldi_step = orig
    torch.cuda.synchronize()
    if sorted(captured) != sorted((d, j) for d in (narrow, wide)
                                  for j in steps):
        fail(f"captured Arnoldi steps {sorted(captured)}")
    record = results.record
    for (dname, j), c in sorted(captured.items(), key=lambda kv: kv[0][0],
                                reverse=True):
        tag = type_tag(dname)
        rtol = sum_rtol(dname)
        fm = flop_factor(dname)
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

        Vc = Vj.conj()

        def library():
            h1 = torch.mv(Vc, scratch_w)
            w1 = torch.addmv(scratch_w, Vj.T, h1, alpha=-1.0)
            h2 = torch.mv(Vc, w1)
            w2 = torch.addmv(w1, Vj.T, h2, alpha=-1.0)
            return torch.linalg.vector_norm(w2)

        l_bytes = (j + 1) * N * e + 2 * N * e + (j + 2) * e
        record(f"arnoldi_cgs2{tag}", f"j={j} V=[{m1},{N}]", err, rtol,
               device_ms(lambda: AR.arnoldi_cgs2(scratch_s, scratch_w, j)),
               device_ms(lambda: AR.arnoldi_cgs2_plain(scratch_s, scratch_w, j)),
               bound(l_bytes, fm * (8 * (j + 1) * N + 2 * N), dname),
               library_ms=device_ms(library))
        it0 = int(s0.loop[AR.IT])

        def at(st, cont, fl):
            # the loop at step j; a budget that ends the cycle after it
            # where not cont
            AR.set_loop(st, j, it0, None if cont else it0 + j + 1, fl)
            return st

        for cont in dict.fromkeys((c["cont"], False)):
            # the step as GMRES runs it, one launch: its passes are L's (the
            # same code with the tail off), so hc is L's bit for bit, and
            # M's tail and V[j+1] are M's plain version and the division on
            # L's hc and w, bit for bit; w is left as the matvec gave it;
            # the loop advances to j + 1 with vj = V[j+1]
            fk, wf = at(clone(s0), cont, floor), w0.clone()
            AR.arnoldi_step(fk, wf)
            torch.cuda.synchronize()
            if int(fk.loop[AR.J]) != j + 1 or not torch.equal(fk.vj,
                                                              fk.V[j + 1]):
                fail(f"arnoldi_step{tag}: the loop did not advance at j={j}")
            if int(fk.ticket[0]) != 0:
                fail(f"arnoldi_step{tag} left its ticket armed at j={j}")
            if not torch.equal(fk.hc, sk.hc):
                fail(f"arnoldi_step{tag}: hc differs from kernel L's at j={j}")
            if not torch.equal(wf, w0):
                fail(f"arnoldi_step{tag}: w written at j={j}")
            mp = clone(s0)
            mp.hc.copy_(sk.hc)
            AR.arnoldi_givens_plain(mp, j, floor, cont)
            AR.div_real(wk, mp.st[1], out=mp.V[j + 1])
            for what in ("H", "cs", "sn", "g", "st", "done", "y"):
                if not torch.equal(getattr(fk, what), getattr(mp, what)):
                    fail(f"arnoldi_step{tag}: M's tail differs from its plain "
                         f"version in {what} at j={j} (cont={cont})")
            if not torch.equal(fk.V[j + 1], mp.V[j + 1]):
                fail(f"arnoldi_step{tag}: V[j+1] differs from w / st[1] at "
                     f"j={j} (cont={cont})")
            # and against the step's plain version on the same inputs
            pp, wpp = at(clone(s0), cont, floor), w0.clone()
            AR.arnoldi_step_plain(pp, wpp)
            step_err = max(errors(fk.V[j + 1], pp.V[j + 1]),
                           errors(fk.hc[: j + 2], pp.hc[: j + 2]),
                           key=lambda t: t[1])
            done = bool(mp.done[0])
            # repeated steps rotate g[j] further each time: a floor of -1
            # keeps a step that went on going on; each repeat puts the loop
            # back at j with a one-element fill, whose queued time is taken
            # off the step's
            tfloor = floor if done else -1.0
            ss, sw = at(clone(s0), cont, tfloor), w0.clone()
            jr = ss.loop[AR.J:AR.J + 1]

            def three():
                AR.arnoldi_cgs2(ss, sw, j)
                AR.arnoldi_givens(ss, j, tfloor, cont)
                AR.div_real(sw, ss.st[1], out=ss.V[j + 1])

            def one():
                jr.fill_(j)
                AR.arnoldi_step(ss, sw)

            step_ms = device_ms(one) - queued_ms(lambda: jr.fill_(j))
            three_ms = device_ms(three)
            ps, pw = at(clone(s0), cont, tfloor), w0.clone()
            pj = ps.loop[AR.J:AR.J + 1]

            def plain():
                pj.fill_(j)
                AR.arnoldi_step_plain(ps, pw)

            record(f"arnoldi_step{tag}", f"j={j} m={m} done={int(done)} "
                   f"V=[{m1},{N}]", step_err, rtol, step_ms,
                   device_ms(plain),
                   bound(l_bytes, fm * (8 * (j + 1) * N + 3 * N), dname,
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
                   bound(work, fm * (6 * j + 12 + ((j + 1) ** 2 if done
                                                    else 0)),
                         dname, chain=givens_chain(j, done)))
    torch.cuda.synchronize()


def check_control_kernels(problems: Problems, n, dev, results: Results) -> None:
    """Phase 3, the GMRES loop's control kernels (``csrc/gmres_control.cu``)
    on the n-problem's N, each against its plain version on the same inputs,
    bit for bit (``max_abs_err`` 0): the run's start (``gmres_init``), the
    cycle start over N in each of its six type pairs (float64 cycles,
    float32 cycles in a float32 and in a float64 solve, and the same in
    complex128 and complex64), the cycle end and
    the escalation's reltol2, each from a state that goes on and one that
    stops; timed beside their plain versions, bound by a queued launch
    (and, for the cycle start, its bytes).  Then ``gmres_set_cond`` in a
    composed graph of nested WHILE nodes whose parts count cycles and steps
    on the device, against the host loop reading the same flags (its plain
    version): the same counts, and the time per condition set."""
    import dataclasses

    import numpy as np
    import torch

    from hsolve_torch.ops import arnoldi as AR
    from hsolve_torch.ops import gmres_control as GC

    A, _, _ = problems.get(n)
    N, m, maxiter = A.shape[0], 30, 60
    rng = np.random.default_rng(SEED + 7)
    clone = lambda s: dataclasses.replace(s, **{
        f.name: getattr(s, f.name).clone() for f in dataclasses.fields(s)})
    fields = ("V", "vj", "H", "cs", "sn", "g", "y", "floor", "loop")
    record = results.record

    def rnd(shape, dt):
        v = rng.standard_normal(shape)
        if dt.is_complex:
            v = v + 1j * rng.standard_normal(shape)
        return torch.as_tensor(v, dtype=dt, device=dev)

    c128, c64 = torch.complex128, torch.complex64
    for to, ti in ((torch.float64, torch.float64),
                   (torch.float32, torch.float32),
                   (torch.float64, torch.float32),
                   (c128, c128), (c64, c64), (c128, c64)):
        oname, iname = (str(t).replace("torch.", "") for t in (to, ti))
        ikey = type_tag(iname)
        r = rnd(N, to)
        for go, (beta, it) in (("goes on", (3.0, 10)), ("stops", (1e-12, 10)),
                               ("budget spent", (3.0, maxiter))):
            s0 = AR.arnoldi_state(m, N, ti, dev)
            for t in (s0.V, s0.H, s0.sn, s0.g, s0.y):
                t.copy_(rnd(t.shape, ti))
            s0.loop[AR.IT], s0.loop[AR.MAXITER] = it, maxiter
            sc = torch.tensor([2.0, 1e-9, beta, 1e-9], dtype=to.to_real(),
                              device=dev)
            sk, sp = clone(s0), clone(s0)
            GC.gmres_cycle_start(r, sc, sk, 1e-6)
            GC.gmres_cycle_start_plain(r, sc, sp, 1e-6)
            torch.cuda.synchronize()
            if not all(torch.equal(getattr(sk, k), getattr(sp, k))
                       for k in fields):
                fail(f"gmres_cycle_start ({oname} solve, {iname} cycles, "
                     f"{go}) differs from its plain version")
            if go != "goes on" and int(sk.loop[AR.DONE]) != 1:
                fail(f"gmres_cycle_start let a cycle step with {go}")
        if (to, ti) in ((torch.float32, torch.float32), (c64, c64)):
            continue            # checked; the mixed pair is the narrow row
        e = ti.itemsize
        work = bound(N * to.itemsize + 2 * N * e + ((m + 1) * m + 4 * m) * e,
                     N * (2 if ti.is_complex else 1), iname, chain=4)
        ss = clone(s0)
        record(f"gmres_cycle_start{ikey}", f"N={N} m={m} {oname} solve",
               (0.0, 0.0), 0.0,
               device_ms(lambda: GC.gmres_cycle_start(r, sc, ss, 1e-6)),
               device_ms(lambda: GC.gmres_cycle_start_plain(r, sc, ss, 1e-6)),
               work)
    for to in (torch.float64, torch.float32):
        tname = str(to).replace("torch.", "")
        key = "" if to == torch.float64 else ":float32"
        for case, (j, it, beta) in (("goes on", (30, 10, 1e-3)),
                                    ("converged", (12, 10, 1e-12)),
                                    ("budget spent", (30, 30, 1e-3)),
                                    ("no step", (0, 10, 1e-3))):
            loop = torch.tensor([j, it, maxiter, 1, 2, maxiter, 0, 0],
                                dtype=torch.int32, device=dev)
            sc = torch.tensor([2.0, 2e-9, beta, 1e-9], dtype=to, device=dev)
            hist = torch.as_tensor(rng.standard_normal(maxiter + 1), dtype=to,
                                   device=dev)
            outs = []
            for fn in (GC.gmres_cycle_end, GC.gmres_cycle_end_plain):
                lk, sk, hk = loop.clone(), sc.clone(), hist.clone()
                fn(sk, hk, lk)
                outs.append((lk, sk, hk))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                fail(f"gmres_cycle_end ({tname}, {case}) differs from its "
                     "plain version")
            want = int(case == "goes on")
            if int(outs[0][0][AR.GO]) != want:
                fail(f"gmres_cycle_end ({tname}, {case}): go flag "
                     f"{int(outs[0][0][AR.GO])}, want {want}")
        for case, bn in (("||b|| > 0", 2.0), ("||b|| = 0", 0.0)):
            sc = torch.tensor([bn, 0.0, 0.0, 1e-9], dtype=to, device=dev)
            loop = torch.tensor([5, 5, maxiter, 0, 3, maxiter, 1, 0],
                                dtype=torch.int32, device=dev)
            hist = torch.as_tensor(rng.standard_normal(maxiter + 1), dtype=to,
                                   device=dev)
            pairs = []
            for fn in (GC.gmres_init, GC.gmres_init_plain):
                lk, sk, hk = loop.clone(), sc.clone(), hist.clone()
                fn(sk, hk, lk)
                pairs.append((lk, sk, hk))
            for b1 in (0.25, 0.0):
                sc1 = torch.tensor([bn, 2e-9, 0.0, 1e-9], dtype=to, device=dev)
                outs = []
                for fn in (GC.gmres_escalate, GC.gmres_escalate_plain):
                    sc2 = torch.tensor([b1, 0.0, 0.0, 0.0], dtype=to,
                                       device=dev)
                    fn(sc1, sc2)
                    outs.append((sc2,))
                pairs.extend(outs)
            torch.cuda.synchronize()
            for a, b in zip(pairs[::2], pairs[1::2]):
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    fail(f"gmres_init / gmres_escalate ({tname}, {case}) "
                         "differ from their plain versions")
        # timed from a cycle that took no step: repeats leave it in place
        hist = torch.zeros(maxiter + 1, dtype=to, device=dev)
        loop = torch.tensor([0, 10, maxiter, 1, 2, maxiter, 0, 0],
                            dtype=torch.int32, device=dev)
        sc = torch.tensor([2.0, 2e-9, 1e-3, 1e-9], dtype=to, device=dev)
        sc2 = torch.tensor([0.25, 0.0, 0.0, 0.0], dtype=to, device=dev)
        scb = 4 * to.itemsize
        lat = lambda chain, nb: bound(nb, chain, tname, chain=chain)
        record(f"gmres_cycle_end{key}", f"{tname}", (0.0, 0.0), 0.0,
               device_ms(lambda: GC.gmres_cycle_end(sc, hist, loop)),
               device_ms(lambda: GC.gmres_cycle_end_plain(sc, hist, loop)),
               lat(3, scb + 32 + to.itemsize))
        record(f"gmres_init{key}", f"{tname} hist [{maxiter + 1}]",
               (0.0, 0.0), 0.0,
               device_ms(lambda: GC.gmres_init(sc, hist, loop)),
               device_ms(lambda: GC.gmres_init_plain(sc, hist, loop)),
               lat(2, scb + 32 + (maxiter + 1) * to.itemsize))
        record(f"gmres_escalate{key}", f"{tname}", (0.0, 0.0), 0.0,
               device_ms(lambda: GC.gmres_escalate(sc, sc2)),
               device_ms(lambda: GC.gmres_escalate_plain(sc, sc2)),
               lat(2, 2 * scb))
    check_set_cond(dev, results)


def check_set_cond(dev, results: Results, kout: int = 6, kin: int = 9) -> None:
    """``gmres_set_cond`` in a composed graph (``SolveGraph``: nested WHILE
    nodes, the parts captured by torch): ``kout`` cycles of ``kin`` steps
    counted on the device, against the host loop that reads the same flags
    (``go_on``, its plain version)."""
    import torch

    from hsolve_torch.ops import arnoldi as AR
    from hsolve_torch.ops import gmres_control as GC

    loop = torch.zeros(AR.LOOP_LEN, dtype=torch.int32, device=dev)
    steps = torch.zeros(1, dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)

    def pre():
        loop.zero_()
        steps.zero_()
        loop[AR.GO:AR.GO + 1].copy_(one)

    def start():
        loop[AR.J:AR.J + 1].zero_()
        loop[AR.DONE:AR.DONE + 1].zero_()

    def step():
        loop[AR.J:AR.J + 1].add_(1)
        steps.add_(1)
        loop[AR.DONE:AR.DONE + 1].copy_((loop[AR.J:AR.J + 1] >= kin).int())

    def end():
        loop[AR.CYC:AR.CYC + 1].add_(1)
        loop[AR.GO:AR.GO + 1].copy_((loop[AR.CYC:AR.CYC + 1] < kout).int())

    def host():
        pre()
        while GC.go_on(loop, AR.GO):
            start()
            while GC.go_on(loop, AR.DONE, negate=True):
                step()
            end()

    host()
    want = (loop.clone(), steps.clone())
    g = GC.SolveGraph([(loop, pre, start, step, end)], lambda: None,
                      [loop, steps, one], dev)
    loop.fill_(-1)
    g.launch()
    torch.cuda.synchronize()
    if not (torch.equal(loop, want[0]) and torch.equal(steps, want[1])
            and int(steps[0]) == kout * kin):
        fail(f"gmres_set_cond: the graph counted {loop.tolist()} / "
             f"{steps.tolist()}, the host loop {want[0].tolist()} / "
             f"{want[1].tolist()}")
    conds = 1 + kout * (kin + 2)
    results.record("gmres_set_cond", f"{kout} cycles of {kin} steps",
                   (0.0, 0.0), 0.0, device_ms(g.launch) / conds,
                   device_ms(host) / conds, bound(4, 0, chain=1))
    del g


class HostOps:
    """Counts what the host issues inside a ``with`` block: torch operations
    (a dispatch mode sees each), the port's kernel launches from Python and
    its graph launches (the wrappers' counts, before any graph's replays are
    folded in)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        from hsolve_torch import kernels

        class Count(TorchDispatchMode):
            n = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                Count.n += 1
                return func(*args, **(kwargs or {}))

        self._kernels = kernels
        self._before = kernels.snapshot_counts()
        self._mode = Count()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        after = self._kernels.snapshot_counts()
        names = self._kernels.wrappers()
        self.launches = sum(v - self._before.get(k, 0)
                            for k, v in after.items()
                            if k in names and k not in ("arnoldi_cgs2",
                                                        "arnoldi_givens"))
        self.torch_ops = type(self._mode).n
        self.total = self.torch_ops + self.launches
        return False

    def __str__(self):
        return (f"{self.total} ({self.torch_ops} torch operations, "
                f"{self.launches} kernel and graph launches)")


def factor_bytes(F) -> int:
    """Bytes of the tensors the factorization's dense levels and root keep."""
    import torch

    keep = list(F.levels) + ([F.root] if F.root is not None else [])
    return sum(t.numel() * t.element_size() for lev in keep
               for t in vars(lev).values() if isinstance(t, torch.Tensor))


def main_path(problems: Problems, n, dev, path: str, card: str) -> dict:
    """Phase 4: the user's workflow at size n; returns its timings and checks."""
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    import hsolve_torch as ht
    import hsolve_torch.krylov as K
    from hsolve_torch import kernels
    from hsolve_torch.factor import solve_with_data

    cplx = path in COMPLEX_PATHS
    A, b, shape = problems.get(damped(n) if cplx else n)
    opts = ht.SolverOptions(**OPTIONS[path])
    compressed = path in COMPRESSED_PATHS
    mixed = path in MIXED
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
        f"{', HSS kind, ls, depth, n_pad' if 'hss' in path else ''}):"
        f" {shapes}")

    narrow, wide = (torch.complex64, torch.complex128) if cplx else \
        (torch.float32, torch.float64)
    fdt = narrow if mixed else wide
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    held = {"F": ht.factor_with_plan(plan, opts, dtype=fdt, device=dev)}
    torch.cuda.synchronize()                                   # cold
    peak_mb = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 20
    # the default-caps structured, the n=512 structured and the 3D
    # compressed factors take seconds: one warm run
    # (and, to keep the script within its time limit, the n=512 low-rank
    # ones)
    reps = 1 if path in ("hss-default", "lowrank-3d", "hss-3d",
                         "hss-complex-default", "hss-default-f32-mixed",
                         "hss-3d-f32-mixed") or (
        path in ("hss", "hss-complex", "hss-f32-mixed", "compressed",
                 "lowrank-complex", "lowrank-f32-mixed") and n == 512) else 3

    def refactor():
        held["F"] = None        # the last factor goes before the next comes
        held["F"] = ht.factor_with_plan(plan, opts, dtype=fdt, device=dev)

    factor_ms = time_ms(refactor, reps=reps, warmup=reps // 3)
    F = held.pop("F")
    op, mv = ht.spmv_format(A, device=dev)
    bt = torch.as_tensor(np.asarray(b), device=dev)
    out = {}
    if mixed:
        # the JAX bench's device configuration (bench.py:263-276): float32
        # (complex64) cycles over the narrow operator, the narrow factor
        # behind casts
        nname = str(narrow).replace("torch.", "")
        op32, _ = ht.spmv_format(A, dtype=np.dtype(nname), device=dev)
        prec = lambda data, v: solve_with_data(data, v.to(narrow)).to(v.dtype)
        inner = dict(inner_dtype=nname, mv_data_inner=op32, m_eps=1e-6)
    else:
        prec, inner = solve_with_data, {}

    kw = dict(reltol=RELRES, restart=30, maxiter=60, mv_data=op,
              M_data=F.solve_data, **inner)

    def solve():
        # the JAX bench's call: one CUDA graph a solve, nothing read back
        out["x"], out["info"] = ht.gmres_compiled(mv, prec, bt,
                                                  fetch_info=False, **kw)

    t0 = time.perf_counter()
    solve()                                          # cold: the capture
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    graphs = K.graph_stats(F.solve_data)
    if len(graphs) != 1:
        fail(f"n={n} {path}: {len(graphs)} solve graphs on the factor")
    solve_ms = time_ms(solve, reps=reps, warmup=reps // 3)
    # a warm solve that may not read the device: torch raises on a sync
    torch.cuda.set_sync_debug_mode("error")
    try:
        with HostOps() as graph_ops:
            solve()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    x, info = out["x"], ht.fetch_gmres_info(out["info"])
    # the yardstick: the same functions launched eagerly, the host reading
    # the loop's flags; untimed, and its launches are not the main path's
    snap = kernels.launch_counts()
    with HostOps() as host_ops:
        xd, idrv = K.gmres_host_driven(mv, prec, bt, **kw)
    kernels.restore_counts(snap)
    if idrv["iters"] != info["iters"]:
        fail(f"n={n} {path}: the graph took {info['iters']} iterations, the "
             f"host-driven loop {idrv['iters']}")
    xdiff = float(torch.linalg.vector_norm(x - xd)
                  / torch.linalg.vector_norm(xd))
    if not xdiff <= XDIFF:
        fail(f"n={n} {path}: x of the graph and of the host-driven loop "
             f"differ by {xdiff:.3e} > {XDIFF:g}")
    xh = x.cpu().numpy()
    if xh.shape != (A.shape[0],) or not np.all(np.isfinite(xh)):
        fail(f"n={n}: solution has shape {xh.shape} or non-finite values")
    relres = float(np.linalg.norm(b - A @ xh) / np.linalg.norm(b))
    res = {"path": path, "n": n, "N": int(A.shape[0]), "plan_s": plan_s[1],
           "plan_cold_s": plan_s[0], "factor_s": factor_ms / 1e3,
           "solve_s": solve_ms / 1e3, "iters": info["iters"],
           "converged": info["converged"], "relres_scipy": relres,
           "solve_cold_s": cold_s, "x_vs_host_driven": xdiff,
           "host_ops_graph": graph_ops.total,
           "host_ops_host_driven": host_ops.total,
           "graph_pool_mb": graphs[0]["pool_bytes"] / 2 ** 20,
           "graph_state_mb": graphs[0]["state_bytes"] / 2 ** 20,
           "gmres_resnorm_last": float(info["resnorm"][-1]) / float(
               np.linalg.norm(b)),
           "factor_peak_mb": peak_mb}
    if not compressed:
        res["factor_kept_mb"] = factor_bytes(F) / 2 ** 20
    if not is_3d(n) and n <= 128 and path == "exact":
        x_ref = spla.spsolve(A.tocsc(), b)
        res["fwd_err_vs_spsolve"] = float(np.linalg.norm(xh - x_ref)
                                          / np.linalg.norm(x_ref))
    if compressed:
        report = F.rank_report()
        res["max_rank"] = max(lv["max_rank"] for lv in report["levels"])
        res["saturated"] = report["saturated"]
        if is_3d(n):
            # a cap of a block's full rank, min(ni_pad, nb_pad), truncates
            # nothing: a rank that reaches it is full, not saturated
            full = [min(plan.batches[lv["level"]].ni_pad,
                        plan.batches[lv["level"]].nb_pad)
                    for lv in report["levels"]]
            res["full_rank_levels"] = [
                lv["level"] for lv, f in zip(report["levels"], full)
                if lv["max_rank"] >= lv["cap"] >= f]
            res["saturated"] = any(
                lv["max_rank"] >= lv["cap"] and lv["cap"] < f
                for lv, f in zip(report["levels"], full))
            if res["full_rank_levels"]:
                log(f"  n={n} {path}: levels {res['full_rank_levels']} reach "
                    "a cap of their blocks' full rank (not saturated)")
    log(f"  n={n} {path} on {card}: plan {res['plan_s']:.4f} s (warm; cold "
        f"{res['plan_cold_s']:.4f} s, host)  factor {res['factor_s']:.4f} s  "
        f"solve {res['solve_s']:.4f} s (warm, CUDA events)  iters "
        f"{res['iters']}  converged {res['converged']}  relres(scipy) "
        f"{relres:.3e}" + (f"  fwd err vs spsolve {res['fwd_err_vs_spsolve']:.3e}"
                           if "fwd_err_vs_spsolve" in res else "")
        + (f"  max rank {res['max_rank']}  saturated {res['saturated']}"
           if compressed else "")
        + f"  factor peak {peak_mb:.1f} MiB"
        + (f", kept {res['factor_kept_mb']:.1f} MiB" if not compressed else ""))
    log(f"  n={n} {path}: solve graph captured in {cold_s:.3f} s (cold call); "
        f"private pool {res['graph_pool_mb']:.1f} MiB reserved "
        f"({graphs[0]['pool_live_bytes'] / 2 ** 20:.1f} MiB live), static "
        f"state {res['graph_state_mb']:.1f} MiB; host operations per warm "
        f"solve: graph {graph_ops} (no sync), host-driven loop {host_ops}; "
        f"x against the host-driven loop {xdiff:.2e}, equal iterations")
    jax_relres = JAX_UNCONVERGED.get((path, n))
    if jax_relres is not None:
        # the JAX package does not converge here either: the run must not
        # end further off than JAX's
        log(f"  n={n} {path}: the JAX package's CPU run does not reach "
            f"{RELRES:g} here (relres {jax_relres:.3e} after 120 "
            f"iterations); the port's: converged {info['converged']}, "
            f"relres {relres:.3e} after {info['iters']} iterations, "
            f"{'no worse' if relres <= jax_relres else 'WORSE'} than JAX's")
        res["jax_relres"] = jax_relres
        if not relres <= jax_relres:
            fail(f"n={n} {path}: relres {relres:.3e} worse than the JAX "
                 f"package's {jax_relres:.3e}")
    elif not info["converged"]:
        fail(f"n={n} {path}: GMRES did not converge ({info})")
    elif not relres <= RELRES:
        fail(f"n={n} {path}: independent residual {relres:.3e} > {RELRES}")
    if res.get("fwd_err_vs_spsolve", 0.0) > FWD_N128:
        fail(f"n={n}: forward error {res['fwd_err_vs_spsolve']:.3e} > {FWD_N128}")
    if path in MAX_ITERS and jax_relres is None and \
            info["iters"] > MAX_ITERS[path].get(n, 60):
        fail(f"n={n} {path}: {info['iters']} GMRES iterations > "
             f"{MAX_ITERS[path].get(n, 60)}")
    if compressed and res["saturated"]:
        fail(f"n={n} {path}: a rank saturated its cap ({report})")
    return res


def check_bench(argv) -> dict:
    """One run of ``python -m hsolve_torch.bench`` in a subprocess: its last
    line must be ``bench.py``'s JSON line from the card, relres <= 1e-9, no
    speed-of-light violation, the card's line present and, on the 2D default
    run, the mixed count within ``MAX_ITERS``."""
    out = subprocess.run([sys.executable, "-m", "hsolve_torch.bench", *argv],
                         cwd=HERE, capture_output=True, text=True, timeout=600)
    for line in out.stderr.splitlines()[-12:]:
        log(f"    bench: {line}")
    if out.returncode != 0:
        fail(f"the bench {argv} exited with {out.returncode}")
    try:
        res = json.loads(out.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"the bench {argv} printed no JSON line: {out.stdout[-500:]!r}")
    d = res["detail"]
    if d["device"] != "cuda" or not d.get("card"):
        fail(f"the bench {argv} ran on {d['device']} (card {d.get('card')})")
    if not d["relres"] <= RELRES:
        fail(f"the bench {argv}: relres {d['relres']:.3e} > {RELRES}")
    if d["sol_violation"]:
        fail(f"the bench {argv}: speed-of-light violation ({d})")
    if "--problem" not in argv:
        n = int(argv[argv.index("--n") + 1])
        # the bench's compressed plans are structured (it has no hss switch)
        limit = MAX_ITERS["exact-complex-mixed" if "--damping" in argv
                          else "hss-f32-mixed" if "--swlevel" in argv
                          else "exact-f32-mixed"][n]
        if d["gmres_iters"] > limit:
            fail(f"the bench {argv}: {d['gmres_iters']} iterations > {limit}")
    return {"metric": res["metric"], "value": res["value"],
            **{k: d[k] for k in ("factor_s", "solve_s", "gmres_iters",
                                 "relres", "factor_dtype", "factor_peak_mb",
                                 "sol_fraction", "card")}}


def kernel_table(runs, kres: Results) -> list:
    """One row per kernel: its launches summed over the main-path runs (each
    counted from zero), and phase 3's numbers; a typed kernel's float32
    numbers ride along in its row, and its complex instances have rows of
    their own (``<name>:complex128``, ``<name>:complex64``: their launches
    on the complex paths), as do E-K's float32 instances
    (``<name>:float32``: their launches on the float32 compressed paths)."""
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
        for ct in COMPLEX if k in TYPED_COMPLEX else (
                ("float32", "complex128") if k in TYPED_LOWRANK else ()):
            crow = {**row, "name": f"{k}:{ct}",
                    "launches": total.get(f"{k}:{ct}", 0),
                    **{key: kres[f"{k}:{ct}"][key] for key in keys}}
            crow.pop("float32", None)
            table.append(crow)
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
    fn = ""
    for line in str(info["log"]).splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif "registers" in line or "spill" in line:
            log(f"    ptxas: {fn}: {line.strip()}")

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
    log(f"[3] A-D and the Arnoldi step on the damped n={args.kernel_n} "
        f"system, complex128 and complex64")
    for dname in COMPLEX:
        check_kernels(problems, damped(args.kernel_n), dev, kres, dname)
    check_arnoldi_kernels(problems, damped(args.kernel_n), dev, kres)
    log(f"[3] E, F and G in complex128 on the damped n={args.kernel_n} "
        "system's low-rank factor")
    check_compressed_kernels(problems, damped(args.kernel_n), dev, kres,
                             COMPRESSED, "damped low-rank", "complex128")
    log(f"[3] H-K (and E, F) in complex128 on the damped n={args.kernel_n} "
        "system's structured factors, kest=32 and the default caps")
    check_hss_kernels(problems, damped(args.kernel_n), dev, kres,
                      (("damped kest=32", HSS, False),
                       ("damped default caps", HSS_DEFAULT, False)),
                      "complex128")
    log(f"[3] E-K in float32 (the bench's device configuration) on the "
        f"n={args.kernel_n} low-rank and structured factors")
    check_compressed_kernels(problems, args.kernel_n, dev, kres, COMPRESSED,
                             "low-rank float32", "float32")
    check_hss_kernels(problems, args.kernel_n, dev, kres,
                      (("float32 kest=32", HSS, False),
                       ("float32 default caps", HSS_DEFAULT, False)),
                      "float32")
    check_control_kernels(problems, args.kernel_n, dev, kres)
    log(f"[3] the same kernels at the 3D plans' shapes: exact {EXACT3D}, "
        f"low-rank {LOWRANK3D}, structured {HSS3D}")
    check_kernels(problems, EXACT3D, dev, kres)
    check_kernels(problems, EXACT3D, dev, kres, "float32")
    check_compressed_kernels(problems, LOWRANK3D, dev, kres, LOWRANK_DEFAULT,
                             "3d low-rank")
    check_hss_kernels(problems, HSS3D, dev, kres,
                      (("3d default caps", HSS_DEFAULT, True),))
    check_arnoldi_kernels(problems, EXACT3D, dev, kres)

    runs = []
    for path, path_kernels, sizes in (
            ("exact", kernels.EXACT_PATH, args.sizes),
            ("compressed", kernels.COMPRESSED_PATH, args.sizes),
            ("hss", kernels.HSS_PATH, args.sizes),
            ("hss-default", kernels.HSS_PATH, args.sizes),
            ("exact-f32-mixed", kernels.MIXED_PATH, args.sizes),
            ("exact-complex", kernels.COMPLEX_PATH, args.sizes),
            ("exact-complex-mixed", kernels.COMPLEX_MIXED_PATH, args.sizes),
            ("lowrank-complex", kernels.COMPLEX_LOWRANK_PATH, args.sizes),
            ("hss-complex", kernels.COMPLEX_HSS_PATH, args.sizes),
            ("hss-complex-default", kernels.COMPLEX_HSS_PATH, args.sizes),
            ("lowrank-f32-mixed", kernels.LOWRANK_MIXED_PATH, args.sizes),
            ("hss-f32-mixed", kernels.HSS_MIXED_PATH, args.sizes),
            ("hss-default-f32-mixed", kernels.HSS_MIXED_PATH, args.sizes),
            ("exact-wide", kernels.EXACT_PATH, [WIDE_N]),
            ("exact-3d", kernels.EXACT_PATH, [EXACT3D]),
            ("exact-3d-f32-mixed", kernels.MIXED_PATH, [EXACT3D]),
            ("lowrank-3d", kernels.COMPRESSED_PATH, [LOWRANK3D]),
            ("hss-3d", kernels.HSS_PATH, [HSS3D]),
            ("hss-3d-f32-mixed", kernels.HSS_MIXED_PATH, [HSS3D])):
        for n in sizes:
            log(f"[4] main path n={n} {path}")
            kernels.reset_launch_counts()
            runs.append(main_path(problems, n, dev, path, smi))
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
            # every solve one graph launch: the cold one, the timed ones,
            # the one under the sync check
            solves = counts.get("gmres_graph", 0)
            if solves < 3 or counts.get("gmres_set_cond", 0) < solves:
                fail(f"n={n} {path}: {solves} graph launches, "
                     f"{counts.get('gmres_set_cond', 0)} conditions set")
            runs[-1]["launches"] = counts
    ops = sorted({r["host_ops_graph"] for r in runs})
    its = sorted(r["iters"] for r in runs)
    log(f"[4] host operations per warm solve through the graph: {ops} over "
        f"{len(runs)} runs of {its[0]} to {its[-1]} iterations; the "
        f"host-driven loop: "
        f"{sorted(r['host_ops_host_driven'] for r in runs)}")
    if len(ops) != 1:
        fail(f"host operations per warm solve depend on the run: {ops}")
    for argv in BENCH_RUNS:
        log(f"[4] bench: python -m hsolve_torch.bench {' '.join(argv)}")
        runs_bench = check_bench(argv)
        log(f"  bench: {json.dumps(runs_bench)}")

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
