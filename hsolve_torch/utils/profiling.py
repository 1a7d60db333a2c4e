"""FLOP model and device-time breakdown of the PyTorch/CUDA port on one GPU.

:func:`analyze_plan`, :func:`factor_flops`, :func:`solve_flops` and
:func:`roofline_report` are the JAX package's FLOP model (``LevelStats`` per
level batch, the speed-of-light bound against :data:`H100_PEAKS`); the bench
(``python -m hsolve_torch.bench``) reports them.  The rest of the module is
the device-time breakdown.  Usage, from the repository root on a machine with one CUDA card:

    python3 -m hsolve_torch.utils.profiling [--sizes 128 512] [--reps 5]
                                            [--problem helmholtz3d]
                                            [--compressed | --hss | --mixed
                                             | --spmv | --hss-kernels
                                             | --sweep-kernels
                                             | --arnoldi-kernels
                                             | --schur-kernels
                                             | --truncate-kernels]
                                            [--plain-forward] [--damping D]
                                            [--out build/profile]

For each size n it plans helmholtz2d(n, k=40) (with ``--problem
helmholtz3d``: helmholtz3d(n, k=10) on an n^3 mesh) with leafmax=100 and
swlevel=0 (with ``--compressed``: the low-rank compressed configuration
swlevel=-2, swsize=16, atol=rtol=1e-3, kest=32, hss=False, in 3D without
kest: the default rank caps; with ``--hss``: the same with hss=True, the
structured HSS path; with ``--mixed``: swlevel=0 with a
float32 factor inside mixed-precision GMRES, float32 Arnoldi cycles over a
float32 DIA operator with m_eps=1e-6; with ``--damping D`` > 0 the damped,
complex helmholtz2d(n, k=40, damping=D) on the exact path, in complex128 or,
with ``--mixed``, in the bench's complex configuration: a complex64 factor,
complex64 cycles over a complex64 operator, escalation on), then times two
warm phases,
the numeric factorization and the GMRES solve (reltol 1e-9, the factor as
right preconditioner, the DIA matvec):

- wall time per phase without the profiler (CUDA events around ``reps`` runs),
- device busy time per phase under ``torch.profiler`` (sum of kernel self
  time), and the device idle share 1 - busy / wall,
- the kernels that take the most device time, by name.

``--spmv`` instead times the matvec alone on the device: kernel D
(``dia_spmv``) and cuSPARSE's CSR ``torch.mv`` on the same x, in float32 and
float64, as the sum of their kernels' device time under the profiler over
``--reps`` back-to-back calls (at least 100), so no host time is in the
reading.

``--hss-kernels`` times kernels J (``hss_matvec``) and I
(``hss_entries_prepared``) and their plain versions alone, device time only,
at the first shapes ``chip_smoke.py`` checks them at (the kest=32 n=512
plan's first structured batch: 511 matrices of 2 leaves of 23 rows, rank 32;
J at k = 46, the sketch width, and k = 1; I on the leaf blocks and on one
level-1 coupling block a matrix), on random generators of those shapes.

``--sweep-kernels`` times kernels E (``lowrank_sweep_update``) and B
(``extend_add``) and their plain versions alone, device time only, at every
launch shape the n-plans give them: E in both forms (forward, ``X`` given;
backward, ``ids_in``) at k = 1 on the levels of a low-rank factor and of the
two structured factors (kest=32 and the default rank caps), B at every
launch of the exact factor in float64 and float32, on the factors' own
operands.  A kernel is read with its launches queued behind a sleep kernel
between two CUDA events (the device runs them back to back; the reading
holds the launches' gaps on the device, printed first as the time of a
queued one-element launch, and no host time); a plain version (which waits
for the device inside) as its kernels' time under the profiler, one
session per plan and type.  Each shape's numbers, with its bound (bytes
over 3.35 TB/s against operations over the data sheet's peak), go to
``<out>/sweep_kernels.json``, and a summary per plan and kernel is
printed.

``--arnoldi-kernels`` reads one Arnoldi step on the device at j = 0, 14
and 29, with the loop going on (cont) and ending (done), in float64 and
float32, on the states of a 30-step cycle on the n-operator: as three
launches (kernel L alone, kernel M alone, the division into ``V[j+1]``) and,
where the tree has ``arnoldi_step``, as its one launch; each queued as
``--sweep-kernels`` queues, and the host ms per step of the wrappers over
200 calls (a host clock).  Under the profiler it counts the kernels one
step launches in each form.  ``--schur-kernels`` reads kernel F at every
launch shape of the n-plans' compressed factors (low-rank, structured
kest=32, structured default caps), on the factor's own inputs: where the
tree's F takes ``W`` (the earlier design), the bmm that forms it and F;
else F alone (``tools/f_breakdown.py`` reads the launches its geometry
passes over).  Both run unchanged in a checkout of an earlier tree (copy
this file in), so the two designs can be read in one call: a JSON report
each, ``<out>/arnoldi_kernels.json`` and ``<out>/schur_kernels.json``.

``--truncate-kernels`` reads kernel G (``lowrank_truncate``) at every
launch of the n=512 low-rank plan (kest=32) and of helmholtz3d(48, k=10)'s
low-rank plan at the default caps (leafmax 100, swlevel=-2, swsize=16,
atol=rtol=1e-3, hss=False), on the factor's own blocks and sketches: where
the tree's G takes ``Q @ Uw`` (the earlier design), G alone and the bmm
that forms its input with it; where it takes ``Q`` and ``Uw``, G, queued as
``--sweep-kernels`` queues.  It runs unchanged in an earlier tree; a JSON
report, ``<out>/truncate_kernels.json``.

``--plain-forward`` runs each dense level's forward step as its plain torch
version (the gather, GEMM, index_put and triangular solves that kernel C's
``level_forward`` replaces), to compare the two on the same factor.

Chrome traces go to ``--out``; the last line of output is one JSON object with
every number printed above.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import os
import subprocess
import sys
from typing import List

# ---------------------------------------------------------------------------
# FLOP model: per-level stats and the roofline (speed-of-light) bound
# (``hsolve/utils/profiling.py:27-352``, jax-free; the H100's peaks)
# ---------------------------------------------------------------------------

# NVIDIA H100 SXM (the data sheet): float64 on the tensor cores, float32
# without TF32 (which the port keeps off), HBM3
H100_PEAKS = {
    "f64_flops": 67e12,
    "f32_flops": 67e12,
    "hbm_bps": 3.35e12,
}


@dataclasses.dataclass
class LevelStats:
    kind: str
    B: int
    ni_pad: int
    nb_pad: int
    flops: float          # factor-time floating point ops
    bytes_moved: float    # rough HBM traffic of the factor kernels
    solve_flops: float    # per right-hand side application
    # share of ``flops`` spent in LU / triangular-solve kernels.  XLA's CPU
    # cost_analysis reports 0 flops for the LAPACK custom calls these lower
    # to, so model-vs-XLA validation compares ``flops - lapack_flops``
    # (the JAX package's tests); on a card they are kernels and count fully.
    lapack_flops: float = 0.0


def _dense_level_flops(B, ni, nb):
    lu = 2.0 / 3.0 * ni ** 3
    trsm = 2.0 * ni * ni * nb * 2          # L and R solves
    schur = 2.0 * nb * nb * ni
    return B * (lu + trsm + schur)


def _compressed_level_flops(B, ni, nb, k):
    lu = 2.0 / 3.0 * ni ** 3
    sample = 2.0 * nb * ni * (k + 8) * 2    # randomized range finding both sides
    fold = 2.0 * ni * ni * k * 2            # D-solves on k columns
    schur = 2.0 * nb * ni * k + 2.0 * nb * nb * k
    return B * (lu + sample + fold + schur)


# ---------------------------------------------------------------------------
# Derived HSS / structured kernel FLOP model (round-3 verdict item 6).
#
# Each helper mirrors the loop structure of the kernel it models (ops/hss.py,
# structured.py) and sums GEMM (2mnk) / LU (2/3 n^3) / triangular-solve (2n^2 k)
# costs level by level - no hand-waved constants.  The JAX package validates it against
# XLA's cost_analysis of the compiled structured batch.
# ---------------------------------------------------------------------------

def _gemm(b, m, n, k):
    return 2.0 * b * m * n * k


def _lu(b, n):
    return 2.0 / 3.0 * b * n ** 3


def _lu_solve(b, n, k):
    return 2.0 * b * n * n * k             # two triangular solves


def _hss_upsweep_flops(n, ls, r, to_level, k):
    """_upsweep (ops/hss.py): leaf V^T Y + to_level W-translations."""
    nl = max(n // max(ls, 1), 1)
    f = _gemm(nl, r, ls, k)
    m2 = nl
    for _ in range(to_level):
        f += _gemm(m2, r, r, k)
        m2 = max(m2 // 2, 1)
    return f


def _hss_matvec_flops(n, ls, r, d, k):
    """hss_matvec: upsweep + per-level couplings + downsweep + D x + U acc."""
    nl = max(n // max(ls, 1), 1)
    f = _hss_upsweep_flops(n, ls, r, d - 1, k)
    for lev in range(1, d + 1):
        m = max(nl >> lev, 1)
        f += 2 * _gemm(m, r, r, k)          # B12 / B21
    for lev in range(d - 1, 0, -1):
        f += _gemm(max(nl >> (lev - 1), 1), r, r, k)   # R downsweep
    f += _gemm(nl, ls, ls, k)               # D @ x
    f += _gemm(nl, ls, r, k)                # U @ acc
    return f


def _hss_solve_flops(n, ls, r, d, k, upto=None):
    """_solve_upto: leaf LU solve + one Woodbury correction per level."""
    nl = max(n // max(ls, 1), 1)
    f = _lu_solve(nl, ls, k)
    for lev in range(1, (d if upto is None else upto) + 1):
        m = max(nl >> lev, 1)
        f += _hss_upsweep_flops(n, ls, r, lev - 1, k)
        f += 2 * _gemm(m, r, r, k)          # eta = B @ xi
        f += _lu_solve(m, 2 * r, k)         # Woodbury core solve
        f += _gemm(1, n, r, k)              # Phi correction (2m x blk x r, k)
    return f


def _hss_factor_flops(n, ls, r, d):
    """hss_factor: leaf LU + per level (2 partial solves + 2 upsweeps on r columns,
    core assembly, 2 core LUs) + materialize_bases."""
    nl = max(n // max(ls, 1), 1)
    f = _lu(nl, ls)
    f += 2 * _gemm(1, n, r, r) * max(d - 1, 0)          # materialize_bases (U and V)
    for lev in range(1, d + 1):
        m = max(nl >> lev, 1)
        f += _hss_solve_flops(n, ls, r, d, r, upto=lev - 1) * 2
        f += _hss_upsweep_flops(n, ls, r, lev - 1, r) * 2
        f += 4 * _gemm(m, r, r, r)          # B @ G core assembly (M and N)
        f += 2 * _lu(m, 2 * r)
    return f


def _hss_entry_factors_flops(n, ls, r, d):
    """hss_entry_factors: materialize_bases + per-level T einsum."""
    return 2 * _gemm(1, n, r, r) * max(d - 1, 0) + _gemm(1, n, r, r) * d


def _hss_entries_flops(a, b, r, d):
    """hss_entries_prepared on an [a, b] block: one T @ V^T product per level
    (computed for every level, then masked by LCA)."""
    return _gemm(1, a, r, b) * d


def _interp_decomp_flops(a, b, cap):
    """interp_decomp of [a, b] truncated at cap: CPQR sweep + T solve."""
    return 4.0 * a * b * min(cap, a, b)


def _randcompress_flops(n, ls, r, d, s, sample_flops, entry_flops):
    """_hss_randcompress_once (telescoping sketch-residual scheme): 2 sketches,
    leaf D extraction + leaf IDs, then per level exact [r, r] couplings +
    r x s / r x r panel algebra + interpolative decomposition of [2r, s]
    candidate panels (O(n r s) total - no n-wide panels)."""
    nl = max(n // max(ls, 1), 1)
    f = 2 * sample_flops(s)
    f += nl * entry_flops(ls, ls)                    # leaf D blocks
    f += 2 * _gemm(nl, ls, ls, s)                    # Y -= D Om (both sides)
    f += 2 * nl * _interp_decomp_flops(ls, s, r)
    f += 2 * _gemm(nl, r, ls, s)                     # leaf OmP / PsP projections
    for lev in range(1, d + 1):
        m = max(nl >> lev, 1)
        f += 2 * m * entry_flops(r, r)               # B12/B21 exact blocks
        if lev == d:
            break
        # candidate panels (8 r x r x s GEMMs), projection updates (4), basis
        # updates (4 r x r x r), two [2r, s] IDs
        f += m * (12 * _gemm(1, r, r, s) + 4 * _gemm(1, r, r, r))
        f += 2 * m * _interp_decomp_flops(2 * r, s, r)
    return f


def _structured_batch_flops(bp, child_rank: int, opts) -> tuple:
    """Mirror of _structured_factor_jit + d_apply (structured.py): returns
    (factor_flops, solve_flops_per_rhs) for ONE node; multiply by B outside."""
    cpl, cpr = bp.child_cplans
    h1, h2 = cpl.half, cpr.half
    q1, q2 = cpl.n_pad - cpl.half, cpr.n_pad - cpr.half
    r = child_rank
    ls1, d1 = cpl.ls, cpl.depth - 1          # hss_sub plans of the child halves
    ls2, d2 = cpr.ls, cpr.depth - 1
    cr = bp.cross
    r12 = cr["ci12"]["rcap"]
    rib = cr["cib12"]["rcap"] + cr["cib21"]["rcap"]
    rbi = cr["cbi12"]["rcap"] + cr["cbi21"]["rcap"]
    kk_ib = 2 * r + rib
    kk_bi = 2 * r + rbi
    stepsize = max(opts.stepsize, 8) if opts else 16
    kest = opts.kest if opts else -1
    cap = bp.rank_cap
    s = min((kest if kest > 0 else max(cap // 2, 16)) + stepsize, bp.cplan.n_pad)

    def solve1(k):
        return _hss_solve_flops(h1, ls1, r, d1, k)

    def solve22(k):
        return _hss_solve_flops(h2, ls2, cap, d2, k)

    def mv2(k):
        return _hss_matvec_flops(h2, ls2, r, d2, k)

    def d_apply_flops(k):
        # solve1 + C21 skinny + 2x solve22 (refinement) + s22_mv + WU correction
        f = solve1(k)
        f += _gemm(1, r12, h1, k) + _gemm(1, h2, r12, k)        # C21 y1
        f += 2 * solve22(k)
        f += mv2(k) + _gemm(1, r12, h2, k) + _gemm(1, h1, r12, k) \
            + _gemm(1, r12, h1, k) + _gemm(1, h2, r12, k)       # s22_mv skinny
        f += _gemm(1, r12, h2, k) + _gemm(1, h1, r12, k)        # WU (V12^T y2)
        return f

    f = 0.0
    # generators: materialize_bases per child + root coupling folds
    f += 2 * (2 * _gemm(1, cpl.n_pad, r, r) * max(cpl.depth - 1, 0))
    f += _gemm(1, h1, r, r) + _gemm(1, q1, r, r) \
        + _gemm(1, h2, r, r) + _gemm(1, q2, r, r)               # U @ B12 root folds
    # pivot: hss_factor(H1) + WU + G21
    f += _hss_factor_flops(h1, ls1, r, d1)
    f += solve1(r12)                                            # WU
    f += _gemm(1, r12, h1, r12) + _gemm(1, h2, r12, r12)        # G21
    # S22' recompression: entry factors + randomized interpolative build + factor
    f += _hss_entry_factors_flops(h2, ls2, r, d2)
    f += _randcompress_flops(
        h2, ls2, cap, d2, s,
        sample_flops=lambda k: mv2(k) + _gemm(1, r12, h2, k) + _gemm(1, h2, r12, k),
        entry_flops=lambda a, b: _hss_entries_flops(a, b, r, d2)
        + _gemm(1, a, r12, b))
    f += _hss_factor_flops(h2, ls2, cap, d2)
    # Gauss transforms: R = D^{-1} AibU, L^T = D^{-T} AbiV
    f += d_apply_flops(kk_ib) + d_apply_flops(kk_bi)
    # KU = AbiU (AbiV^T RU)
    h = h1 + h2
    q = q1 + q2
    f += _gemm(1, kk_bi, h, kk_ib) + _gemm(1, q, kk_bi, kk_ib)
    # parent S sampling: 2 boundary-half matvecs + couplings + KU/RV correction
    rbb = cr["cbb12"]["rcap"] + cr["cbb21"]["rcap"]

    def s_sample(k):
        return (_hss_matvec_flops(q1, ls1, r, d1, k)
                + _hss_matvec_flops(q2, ls2, r, d2, k)
                + _gemm(1, rbb, q, k) + _gemm(1, q, rbb, k)
                + _gemm(1, kk_ib, q, k) + _gemm(1, q, kk_ib, k))

    f += _hss_entry_factors_flops(q1, ls1, r, d1) \
        + _hss_entry_factors_flops(q2, ls2, r, d2)
    f += _randcompress_flops(
        bp.cplan.n_pad, bp.cplan.ls, cap, bp.cplan.depth, s,
        sample_flops=s_sample,
        entry_flops=lambda a, b: _hss_entries_flops(a, b, r, max(d1, d2))
        + _gemm(1, a, rbb + kk_ib, b))

    # solve sweep per rhs: skinny L/R (rank kk) + pivot block substitution
    solve = d_apply_flops(1) + 2 * (_gemm(1, kk_bi, h, 1) + _gemm(1, q, kk_bi, 1))
    return f, solve


def analyze_plan(plan, dtype_bytes: int = 4) -> List[LevelStats]:
    """Static per-batch accounting from the planner's schedule."""
    out = []
    for idx, bp in enumerate(plan.batches):
        ni, nb, B = bp.ni_pad, bp.nb_pad, bp.B
        if bp.structured:
            # derived per-kernel model (mirrors _structured_factor_jit level by
            # level; validated against XLA cost_analysis in the JAX package's tests).
            # The child generator rank is the SOURCE batch's planned cap.
            child_rank = max((plan.batches[g.src_batch].rank_cap
                              for g in bp.groups_l + bp.groups_r), default=16)
            f1, s1 = _structured_batch_flops(bp, child_rank,
                                             getattr(plan, "opts", None))
            flops = B * f1
            solve = B * s1
            kind = "structured"
            # LU work on the structured path happens in [m, ls, ls] / [m, 2r, 2r]
            # leaf blocks - a small share (the measured whole-program ratio vs
            # XLA:CPU is ~1.0 with lapack=0 here)
            lapack = 0.0
        elif bp.compress:
            flops = _compressed_level_flops(B, ni, nb, bp.rank_cap)
            solve = B * (2.0 * ni * ni + 4.0 * (ni + nb) * bp.rank_cap)
            kind = "compressed"
            lapack = B * (_lu(1, ni) + 2.0 * ni * ni * bp.rank_cap * 2)
        else:
            flops = _dense_level_flops(B, ni, nb)
            solve = B * (2.0 * ni * ni + 4.0 * ni * nb)
            kind = "leaf" if bp.is_leaf else "dense"
            lapack = B * (_lu(1, ni) + 2.0 * ni * ni * nb * 2)
        m = ni + nb
        if bp.structured:
            # no dense [m, m] buffer exists on the structured path: traffic is
            # linear in the HSS representations (leaf D blocks + generators +
            # level translations), a few passes each
            cpl, cpr = bp.child_cplans
            r = bp.rank_cap
            rep = (cpl.n_pad * (cpl.ls + 6 * r) + cpr.n_pad * (cpr.ls + 6 * r))
            bytes_moved = B * 4.0 * rep * dtype_bytes
        else:
            bytes_moved = B * (3.0 * m * m) * dtype_bytes
        out.append(LevelStats(kind=kind, B=B, ni_pad=ni, nb_pad=nb, flops=flops,
                              bytes_moved=bytes_moved, solve_flops=solve,
                              lapack_flops=lapack))
    return out


def factor_flops(plan, dtype_bytes: int = 4) -> float:
    return float(sum(s.flops for s in analyze_plan(plan, dtype_bytes)))


def solve_flops(plan, dtype_bytes: int = 4) -> float:
    return float(sum(s.solve_flops for s in analyze_plan(plan, dtype_bytes)))


def roofline_report(plan, measured_factor_s: float,
                    dtype_bytes: int = 8) -> dict:
    """Speed-of-light accounting: achieved GFLOP/s + nnz/s vs the per-level roofline
    bound (max of compute-limit and bandwidth-limit times, summed over levels), on
    one H100 (:data:`H100_PEAKS`) in the factor's type (``dtype_bytes`` 8: float64,
    4: float32; a complex factor passes its value's 16 or 8 bytes, which the
    model moves, against the same peak: the FLOP count stays the JAX
    package's, which counts a complex operation as one)."""
    stats = analyze_plan(plan, dtype_bytes)
    total_flops = sum(s.flops for s in stats)
    peak = H100_PEAKS["f64_flops" if dtype_bytes == 8 else "f32_flops"]
    bw = H100_PEAKS["hbm_bps"]
    sol_time = sum(max(s.flops / peak, s.bytes_moved / bw) for s in stats)
    per_level = [{
        "kind": s.kind, "B": s.B, "front": [s.ni_pad, s.nb_pad],
        "gflops": round(s.flops / 1e9, 3),
        "sol_ms": round(max(s.flops / peak, s.bytes_moved / bw) * 1e3, 3),
    } for s in stats]
    sol_fraction = sol_time / max(measured_factor_s, 1e-12)
    achieved = total_flops / max(measured_factor_s, 1e-12)
    # physics guard: a measurement faster than the model's own speed-of-light
    # bound (sol_fraction > 1) or above the card's peak means the FLOP model
    # over-counts or the timing under-measures - either way the row is not a
    # result and must be flagged, never published as-is
    violation = bool(sol_fraction > 1.0 or achieved > peak)
    return {
        "factor_gflops": round(total_flops / 1e9, 3),
        "achieved_gflop_s": round(achieved / 1e9, 2),
        "speed_of_light_s": round(sol_time, 6),
        "sol_fraction": round(sol_fraction, 4),
        "sol_violation": violation,
        "nnz_per_s": round(plan.nnz / max(measured_factor_s, 1e-12), 1),
        "per_level": per_level,
    }


# ---------------------------------------------------------------------------
# the device-time breakdown (the command line above)
# ---------------------------------------------------------------------------


def _events_ms(fn, reps):
    import torch

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


def _profile(fn, reps, trace):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    rows = []
    for e in prof.key_averages():
        t = e.self_device_time_total
        if t > 0 and e.device_type.name == "CUDA":   # kernels, not the host ops
            rows.append({"name": e.key, "ms": t / 1e3 / reps,
                         "calls": e.count / reps})
    rows.sort(key=lambda r: -r["ms"])
    return rows


def _spmv(args, card, dev) -> int:
    """``--spmv``: device ms per call of kernel D and of the CSR ``mv``."""
    import numpy as np
    import torch

    import hsolve_torch as ht
    from hsolve_torch.ops.sparse import dia_spmv

    reps = max(args.reps, 100)
    report = {"card": card, "path": "spmv", "reps": reps, "sizes": []}
    for n in args.sizes:
        A, _, _ = ht.helmholtz2d(n, k=40.0)
        Ac = A.tocsr()
        entry = {"n": n, "N": int(A.shape[0]), "nnz": int(Ac.nnz)}
        for dname in ("float32", "float64"):
            dt = getattr(torch, dname)
            op, _ = ht.spmv_format(A, dtype=np.dtype(dname), device=dev)
            csr = torch.sparse_csr_tensor(
                torch.as_tensor(Ac.indptr.astype(np.int64)),
                torch.as_tensor(Ac.indices.astype(np.int64)),
                torch.as_tensor(Ac.data), size=Ac.shape).to(device=dev, dtype=dt)
            x = torch.randn(A.shape[0], 1, dtype=dt, device=dev)
            for name, fn in (("dia_spmv", lambda: dia_spmv(op, x)),
                             ("csr_mv", lambda: torch.mv(csr, x[:, 0]))):
                fn()
                rows = _profile(fn, reps, os.path.join(
                    args.out, f"spmv_n{n}_{name}_{dname}.json"))
                ms = sum(r["ms"] for r in rows)
                entry[f"{name}:{dname}"] = {"device_ms": ms, "kernels": rows}
                print(f"spmv n={n} {name} {dname}: {ms:.5f} ms device per call "
                      f"({', '.join(r['name'][:40] for r in rows)})", flush=True)
        report["sizes"].append(entry)
    print(json.dumps(report), flush=True)
    return 0


def _hss_kernels(args, card, dev) -> int:
    """``--hss-kernels``: device ms per call of J and I and of their plain
    versions at chip_smoke's first shapes."""
    import torch

    from hsolve_torch.ops import hss as H

    reps = max(args.reps, 100)
    B, depth, ls, r = 511, 1, 23, 32
    nl = 1 << depth
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn((B,) + s, dtype=torch.float64, device=dev,
                                 generator=g)
    h = H.Hss(D=rnd(nl, ls, ls), U=rnd(nl, ls, r), V=rnd(nl, ls, r),
              Rs=[rnd(2, r, r)], Ws=[rnd(2, r, r)], B12s=[rnd(1, r, r)],
              B21s=[rnd(1, r, r)],
              plan=H.ClusterPlan(ls=ls, depth=depth, n1=ls, n2=ls))
    ef = H.hss_entry_factors(h)
    n = nl * ls
    leaf = torch.arange(n, device=dev).reshape(1, nl, ls).expand(B, -1, -1) \
        .contiguous()
    rows = torch.randint(0, ls, (B, 1, r), device=dev, generator=g)
    cols = ls + torch.randint(0, ls, (B, 1, r), device=dev, generator=g)
    cases = []
    for k in (46, 1):
        x = torch.randn(B, n, k, dtype=torch.float64, device=dev, generator=g)
        cases += [(f"hss_matvec k={k}", lambda x=x: H.hss_matvec(h, x)),
                  (f"hss_matvec_plain k={k}",
                   lambda x=x: H.hss_matvec_plain(h, x))]
    for what, rr, cc in (("leaf D", leaf, leaf), ("B12", rows, cols)):
        cases += [(f"hss_entries_prepared {what}",
                   lambda rr=rr, cc=cc: H.hss_entries_prepared(ef, rr, cc)),
                  (f"hss_entries_prepared_plain {what}",
                   lambda rr=rr, cc=cc: H.hss_entries_prepared_plain(ef, rr, cc))]
    report = {"card": card, "path": "hss-kernels", "reps": reps,
              "shape": {"B": B, "nleaves": nl, "ls": ls, "r": r}, "calls": {}}
    for name, fn in cases:
        fn()
        rows_ = _profile(fn, reps, os.path.join(
            args.out, f"hss_kernels_{name.replace(' ', '_')}.json"))
        ms = sum(r_["ms"] for r_ in rows_)
        report["calls"][name] = {"device_ms": ms, "wall_ms": _events_ms(fn, reps),
                                 "kernels": rows_}
        print(f"{name}: {ms:.5f} ms device per call, "
              f"{report['calls'][name]['wall_ms']:.5f} ms back to back "
              f"({len(rows_)} kernels)", flush=True)
    print(json.dumps(report), flush=True)
    return 0


HBM_BPS = 3.35e12          # H100 SXM device memory (the data sheet)
PEAK_F64_TC = 67e12        # float64 on the tensor cores (the data sheet)


def _bound_ms(nbytes, flops, peak=PEAK_F64_TC):
    """The larger of bytes over the memory rate and operations over the
    peak, in ms, and which of the two it is."""
    tb, tf = nbytes / HBM_BPS, flops / peak
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def _labelled_ms(cases, reps):
    """Device ms per call of each plain version in ``cases`` (``[(label,
    fn)]``): one profiler session over all of them, each case's ``reps``
    calls inside a ``record_function`` range of its label, the kernels
    launched under the range summed (None where none was recorded).  One
    session, not one per case: on the H100 the profiler recorded no kernel
    after a few dozen sessions in one process."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for _, fn in cases:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, fn in cases:
            with record_function(label):
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
    total = {}
    for e in prof.events():
        if e.device_type.name == "CPU":
            total[e.name] = total.get(e.name, 0.0) + e.device_time_total
    return {label: total[label] / 1e3 / reps if total.get(label) else None
            for label, _ in cases}


def _queued_ms(fn, reps):
    """Device ms per call of ``fn`` (a kernel wrapper that never waits for
    the device): ``reps`` calls between two CUDA events, queued behind a
    sleep kernel that outlasts the host's launches, so the device runs them
    back to back and no host time is in the reading (the launches' own gaps
    on the device are; :func:`_queue_floor` reads them)."""
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
        held = not start.query()     # the device was still asleep: no gaps
        end.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("the host's launches did not get ahead of the device")


def _plain_into(rows, plains, reps):
    """Each row's ``plain_ms``: its plain version's device time, all of
    them read in one profiler session (:func:`_labelled_ms`)."""
    got = _labelled_ms(plains, reps)
    for r, (label, _) in zip(rows, plains, strict=True):
        r["plain_ms"] = got[label]


def _ms(x):
    return "not read" if x is None else f"{x:.5f}"


def _queue_floor(dev, reps):
    """ms per launch of a one-element kernel queued as :func:`_queued_ms`
    queues: the least a queued launch takes on the device."""
    import torch

    x = torch.zeros(1, device=dev)
    return _queued_ms(x.zero_, reps)


def _sweep_kernels(args, card, dev) -> int:
    """``--sweep-kernels``: device ms of kernels E and B and of their plain
    versions at every launch shape of the n-plans."""
    import torch

    import hsolve_torch as ht
    from hsolve_torch.factor import _factor_levels
    from hsolve_torch.interop import plan_to_torch
    from hsolve_torch.ops.assembly import (extend_add, extend_add_plain,
                                           front_assemble_plain)
    from hsolve_torch.ops.sweep import (lowrank_sweep_update,
                                        lowrank_sweep_update_plain)

    reps = max(args.reps, 20)
    floor = _queue_floor(dev, reps)
    print(f"a queued one-element launch: {floor:.5f} ms on the device",
          flush=True)
    comp = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3)
    configs = (("low-rank", dict(comp, kest=32, hss=False)),
               ("structured kest=32", dict(comp, kest=32)),
               ("structured default caps", comp))
    report = {"card": card, "path": "sweep-kernels", "reps": reps,
              "queue_floor_ms": floor, "sizes": []}
    summary = []
    for n in args.sizes:
        A, _, shape = ht.helmholtz2d(n, k=40.0)
        tree = ht.nested_dissection(shape, leafmax=100)
        entry = {"n": n, "E": [], "B": []}
        g = torch.Generator(device=dev).manual_seed(0)
        for label, kw in configs:
            opts = ht.SolverOptions(**kw)
            plan = ht.plan_factorization(A, tree, opts)
            F = ht.factor_with_plan(plan, opts, device=dev)
            N = plan.N
            C0 = torch.randn(N + 1, 1, dtype=torch.float64, device=dev,
                             generator=g)
            C0[N] = 0.0
            seen, plains = set(), []
            for bidx, lev in enumerate(F.levels):
                if getattr(lev, "LU_", None) is None:
                    continue
                x = C0[lev.int_ids]
                for form, U, V, ids_out, kwe in (
                        ("fwd", lev.LU_, lev.LV_, lev.bnd_ids, {"X": x}),
                        ("bwd", lev.RU_, lev.RV_, lev.int_ids,
                         {"ids_in": lev.bnd_ids})):
                    B, R, kc = U.shape
                    Cc = V.shape[1]
                    key = (form, B, R, Cc, kc)
                    if key in seen:
                        continue
                    seen.add(key)
                    C = C0.clone()
                    ms = _queued_ms(lambda: lowrank_sweep_update(
                        C, ids_out, U, V, N, **kwe), reps)
                    plains.append((f"E plain {len(plains)}",
                                   lambda C=C, o=ids_out, U=U, V=V, kwe=kwe:
                                   lowrank_sweep_update_plain(C, o, U, V, N,
                                                              **kwe)))
                    nbytes = sum(t.numel() * t.element_size() for t in
                                 (U, V, ids_out, *kwe.values())) \
                        + 2 * B * R * 8 + (B * Cc * 8 if "ids_in" in kwe else 0)
                    bms, by = _bound_ms(nbytes, 2 * B * kc * (R + Cc))
                    entry["E"].append({"plan": label, "batch": bidx,
                                       "form": form, "B": B, "R": R, "Cc": Cc,
                                       "kc": kc, "ms": ms, "bound_ms": bms,
                                       "bound_by": by})
            _plain_into(entry["E"][-len(plains):], plains, reps)
            for r in entry["E"][-len(plains):]:
                print(f"E {label} batch {r['batch']} {r['form']} B={r['B']} "
                      f"R={r['R']} Cc={r['Cc']} kc={r['kc']}: {r['ms']:.5f} ms "
                      f"device (plain {_ms(r['plain_ms'])}, bound "
                      f"{r['bound_ms']:.5f} {r['bound_by']})", flush=True)
            del F
        opts = ht.SolverOptions(swlevel=0)
        plan = ht.plan_factorization(A, tree, opts)
        tp = plan_to_torch(plan, dev)
        for dname in ("float64", "float32"):
            dt = getattr(torch, dname)
            e = torch.empty(0, dtype=dt).element_size()
            _, _, stacks = _factor_levels(plan, tp, opts, dt)
            adata = tp.adata.to(dt)
            plains = []
            for bidx, (bp, tb) in enumerate(zip(plan.batches, tp.batches)):
                front = None
                for side, groups, counts, imap in (
                        ("l", tb.groups_l, tb.rows_l, tb.map_l),
                        ("r", tb.groups_r, tb.rows_r, tb.map_r)):
                    for (src, sr, dr), cnt_plan in zip(groups, counts):
                        if front is None:
                            front = front_assemble_plain(bp.B, bp.m_pad, tb.pos,
                                                         tb.src, adata)
                        S = stacks[src]
                        rows = imap[dr.long()]
                        cnt = ((rows >= 0) & (rows < S.shape[-1])).sum(1)
                        c2 = float((cnt.double() ** 2).sum())
                        ms = _queued_ms(lambda: extend_add(
                            front, S, sr, dr, imap, cnt_plan), reps)
                        plains.append((f"B plain {len(plains)}",
                                       lambda f=front, S=S, sr=sr, dr=dr,
                                       mp=imap: extend_add_plain(f, S, sr, dr,
                                                                 mp)))
                        bms, by = _bound_ms(
                            3 * c2 * e + 4 * (rows.numel() + 2 * sr.numel()),
                            c2, 67e12 if dname == "float32" else 34e12)
                        entry["B"].append({
                            "dtype": dname, "batch": bidx, "side": side,
                            "groups": int(sr.numel()), "m": bp.m_pad,
                            "w": int(S.shape[-1]),
                            "valid_rows": [int(cnt.min()), int(cnt.max())],
                            "ms": ms, "bound_ms": bms, "bound_by": by})
            _plain_into(entry["B"][-len(plains):], plains, reps)
            for r in entry["B"][-len(plains):]:
                print(f"B {dname} batch {r['batch']} {r['side']} "
                      f"G={r['groups']} m={r['m']} w={r['w']} valid rows "
                      f"{r['valid_rows'][0]}-{r['valid_rows'][1]}: "
                      f"{r['ms']:.5f} ms device (plain {_ms(r['plain_ms'])}, "
                      f"bound {r['bound_ms']:.5f} {r['bound_by']})",
                      flush=True)
            del stacks
        for kname, key, groups in (
                ("E", "plan", [c[0] for c in configs]),
                ("B", "dtype", ["float64", "float32"])):
            for grp in groups:
                rows_ = [r for r in entry[kname] if r[key] == grp]
                if not rows_:
                    continue
                tot = {f: sum(r[f] for r in rows_ if r[f] is not None)
                       for f in ("ms", "plain_ms", "bound_ms")}
                lost = sum(r["plain_ms"] is None for r in rows_)
                half = sum(r["ms"] <= 2 * r["bound_ms"] for r in rows_)
                line = (f"{kname} n={n} {grp}: {len(rows_)} shapes, ms "
                        f"{min(r['ms'] for r in rows_):.5f}-"
                        f"{max(r['ms'] for r in rows_):.5f}, sum "
                        f"{tot['ms']:.5f} against plain {tot['plain_ms']:.5f} "
                        f"and bound {tot['bound_ms']:.5f}; within 2x of the "
                        f"bound at {half}; slower than plain at "
                        f"{sum(r['ms'] > (r['plain_ms'] or 1e9) for r in rows_)}"
                        + (f"; plain not read at {lost}" if lost else ""))
                summary.append(line)
                print(line, flush=True)
        report["sizes"].append(entry)
    path = os.path.join(args.out, "sweep_kernels.json")
    with open(path, "w") as f:
        json.dump(report, f)
    print(json.dumps({"card": card, "path": "sweep-kernels", "report": path,
                      "summary": summary}), flush=True)
    return 0


def _host_ms(fn, calls=200):
    """Host ms per call of ``fn`` (a wrapper that never waits for the
    device): a host clock over ``calls`` calls, the device drained before
    and after."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def _arnoldi_kernels(args, card, dev) -> int:
    """``--arnoldi-kernels``: device ms of one Arnoldi step at j = 0, 14 and
    29, cont and done, float64 and float32, on states of a 30-step cycle on
    the n-operator: as three launches (kernel L, kernel M, the division) and,
    where the tree has it, as one (``arnoldi_step``); the kernels a step
    launches, counted under the profiler; the host ms per step of the
    wrappers."""
    import dataclasses
    import inspect

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import hsolve_torch as ht
    from hsolve_torch.ops import arnoldi as AR

    reps = max(args.reps, 20)
    floor = _queue_floor(dev, reps)
    print(f"a queued one-element launch: {floor:.5f} ms on the device",
          flush=True)
    fused = hasattr(AR, "arnoldi_step")
    # a step that takes no j reads j, the budget and the floor from the
    # state's device loop and advances j: each repeat puts j back with a
    # one-element fill, whose own time is read and taken off
    loop_state = fused and "j" not in inspect.signature(
        AR.arnoldi_step).parameters
    clone = lambda s: dataclasses.replace(s, **{
        f.name: getattr(s, f.name).clone() for f in dataclasses.fields(s)})

    def one_step(ss, sw, j, floor, cont):
        """The fused step at j as a callable, and its repeat's reset (or
        None)."""
        if not loop_state:
            return (lambda: AR.arnoldi_step(ss, sw, j, floor, cont)), None
        it0 = int(ss.loop[AR.IT])
        AR.set_loop(ss, j, it0, None if cont else it0 + j + 1, floor)
        jr = ss.loop[AR.J:AR.J + 1]
        reset = lambda: jr.fill_(j)
        return (lambda: (reset(), AR.arnoldi_step(ss, sw))), reset
    report = {"card": card, "path": "arnoldi-kernels", "reps": reps,
              "queue_floor_ms": floor, "fused": fused, "rows": []}
    steps, m = (0, 14, 29), 30
    for n in args.sizes:
        A, b, _ = ht.helmholtz2d(n, k=40.0)
        for dname in ("float64", "float32"):
            dt = getattr(torch, dname)
            op, mv_fn = ht.spmv_format(A, dtype=np.dtype(dname), device=dev)
            mv = lambda v: mv_fn(op, v)
            bt = torch.as_tensor(np.asarray(b), device=dev).to(dt)
            N = bt.shape[0]
            s = AR.arnoldi_state(m, N, dt, dev)
            beta = float(torch.linalg.vector_norm(bt))
            s.V[0] = bt / beta
            s.g[0] = beta
            states = {}
            for j in range(max(steps) + 1):
                w = mv(s.V[j]).contiguous()
                if j in steps:
                    states[j] = (clone(s), w.clone())
                AR.arnoldi_cgs2_plain(s, w, j)
                AR.arnoldi_givens_plain(s, j, 0.0, True)
                torch.div(w, s.st[1], out=s.V[j + 1])
            if n == args.sizes[0] and dname == "float64":
                # the kernels one step launches, under the profiler
                s0, w0 = states[0]
                ss, sw = clone(s0), w0.clone()
                forms = [("three", lambda: (
                    AR.arnoldi_cgs2(ss, sw, 0), AR.arnoldi_givens(ss, 0, 0.0,
                                                                  True),
                    torch.div(sw, ss.st[1], out=ss.V[1])))]
                if fused:
                    forms.append(("one", one_step(ss, sw, 0, 0.0, True)[0]))
                for label, fn in forms:
                    fn()
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(10):
                            fn()
                        torch.cuda.synchronize()
                    names = {}
                    for e in prof.events():
                        if e.device_type.name == "CUDA" and \
                                e.device_time_total > 0 and \
                                "Fill" not in e.name:   # a repeat's reset
                            names[e.name] = names.get(e.name, 0) + 1
                    per = sum(names.values()) / 10
                    report[f"kernels_per_step_{label}"] = per
                    print(f"step as {label}: {per:g} kernels a step "
                          f"({sorted(names)})", flush=True)
            for j in steps:
                s0, w0 = states[j]
                for cont in (True, False):
                    # a floor of -1 keeps a repeated step going (cont),
                    # however far its residual estimate falls
                    # a loop-state step at j = m - 1 ends its cycle
                    row = {"n": n, "dtype": dname, "j": j, "cont": cont,
                           "done": int(not (cont and (
                               j + 1 < m or not loop_state)))}
                    ss, sw = clone(s0), w0.clone()

                    def three():
                        AR.arnoldi_cgs2(ss, sw, j)
                        AR.arnoldi_givens(ss, j, -1.0, cont)
                        torch.div(sw, ss.st[1], out=ss.V[j + 1])

                    row["three_ms"] = _queued_ms(three, reps)
                    row["three_host_ms"] = _host_ms(three)
                    if fused:
                        step, reset = one_step(ss, sw, j, -1.0, cont)
                        row["one_ms"] = _queued_ms(step, reps)
                        row["one_host_ms"] = _host_ms(step)
                        if reset is not None:
                            row["reset_ms"] = _queued_ms(reset, reps)
                            row["reset_host_ms"] = _host_ms(reset)
                            row["one_ms"] -= row["reset_ms"]
                            row["one_host_ms"] -= row["reset_host_ms"]
                    if int(ss.done[0]) != row["done"]:
                        raise RuntimeError(f"step j={j} cont={cont}: done flag "
                                           f"{int(ss.done[0])}")
                    report["rows"].append(row)
                    print(f"n={n} {dname} j={j} cont={int(cont)} done="
                          f"{row['done']}: L + M + division "
                          f"{row['three_ms']:.5f} ms device, "
                          f"{row['three_host_ms']:.5f} ms host"
                          + (f"; one launch {row['one_ms']:.5f} ms device, "
                             f"{row['one_host_ms']:.5f} ms host"
                             if fused else ""), flush=True)
            del s, states
    path = os.path.join(args.out, "arnoldi_kernels.json")
    with open(path, "w") as f:
        json.dump(report, f)
    print(json.dumps({"card": card, "path": "arnoldi-kernels",
                      "report": path}), flush=True)
    return 0


def _schur_kernels(args, card, dev) -> int:
    """``--schur-kernels``: device ms of kernel F at every launch shape of
    the n-plans' compressed factors (low-rank, structured kest=32,
    structured default caps), on the inputs the factor gives it: where the
    tree's F takes ``W`` (the earlier design), the bmm ``W = Abi RU`` and F;
    where it takes ``RU``, F alone in the launch its wrapper picks."""
    import importlib
    import inspect

    import torch

    import hsolve_torch as ht
    from hsolve_torch.ops import schur

    reps = max(args.reps, 20)
    floor = _queue_floor(dev, reps)
    print(f"a queued one-element launch: {floor:.5f} ms on the device",
          flush=True)
    takes_w = "W" in inspect.signature(schur.lowrank_schur_update).parameters
    fm = importlib.import_module("hsolve_torch.factor")
    comp = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3)
    configs = (("low-rank", dict(comp, kest=32, hss=False)),
               ("structured kest=32", dict(comp, kest=32)),
               ("structured default caps", comp))
    report = {"card": card, "path": "schur-kernels", "reps": reps,
              "queue_floor_ms": floor,
              "design": "bmm + F" if takes_w else "F", "rows": []}
    for n in args.sizes:
        A, _, shape = ht.helmholtz2d(n, k=40.0)
        tree = ht.nested_dissection(shape, leafmax=100)
        for label, kw in configs:
            opts = ht.SolverOptions(**kw)
            plan = ht.plan_factorization(A, tree, opts)
            calls = {}
            orig = fm._factor_front_compressed

            def rec(front, sperm, ni_pad, *rest):
                out = orig(front, sperm, ni_pad, *rest)
                key = (front.shape[0], front.shape[1], ni_pad,
                       out[4].shape[-1])
                if key not in calls:
                    calls[key] = (front.clone(), ni_pad, out[4], out[5], sperm)
                return out

            fm._factor_front_compressed = rec
            try:
                ht.factor_with_plan(plan, opts, device=dev)
            finally:
                fm._factor_front_compressed = orig
            torch.cuda.synchronize()
            for (B, m_pad, ni_pad, kc), (front, _, RU, RV, sperm) in sorted(
                    calls.items(), key=lambda kv: -kv[0][0]):
                nb = m_pad - ni_pad
                Abi = front[:, ni_pad:, :ni_pad]
                if takes_w:
                    fn = lambda: schur.lowrank_schur_update(
                        front, ni_pad, (Abi @ RU).contiguous(), RV, sperm)
                else:
                    fn = lambda: schur.lowrank_schur_update(front, ni_pad, RU,
                                                            RV, sperm)
                nbytes = 8 * B * (2 * nb * nb + nb * ni_pad + ni_pad * kc
                                  + nb * kc + nb)
                bms, by = _bound_ms(nbytes, 2 * B * kc * nb * (ni_pad + nb))
                row = {"plan": label, "n": n, "B": B, "nb": nb,
                       "ni_pad": ni_pad, "kc": kc, "ms": _queued_ms(fn, reps),
                       "bound_ms": bms, "bound_by": by}
                if not takes_w:
                    row["geometry"] = schur.schur_geometry(B, ni_pad, nb, kc)
                report["rows"].append(row)
                print(f"F {label} [{B},{nb},{nb}] ni={ni_pad} k={kc}: "
                      f"{report['design']} {row['ms']:.5f} ms device, "
                      f"bound {bms:.5f} {by}", flush=True)
            del calls
    path = os.path.join(args.out, "schur_kernels.json")
    with open(path, "w") as f:
        json.dump(report, f)
    print(json.dumps({"card": card, "path": "schur-kernels", "report": path}),
          flush=True)
    return 0


def _truncate_kernels(args, card, dev) -> int:
    """``--truncate-kernels``: device ms of kernel G at every launch of the
    n=512 low-rank plan and the 48^3 low-rank plan at the default caps."""
    import importlib
    import inspect

    import torch

    import hsolve_torch as ht
    from hsolve_torch.models.problems import helmholtz3d
    from hsolve_torch.ops import lowrank

    reps = max(args.reps, 20)
    floor = _queue_floor(dev, reps)
    print(f"a queued one-element launch: {floor:.5f} ms on the device",
          flush=True)
    fused = "Uw" in inspect.signature(lowrank.lowrank_truncate).parameters
    fm = importlib.import_module("hsolve_torch.factor")
    comp = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3, hss=False)
    plans = (("helmholtz2d(512) low-rank kest=32",
              ht.helmholtz2d(512, k=40.0), dict(comp, kest=32)),
             ("helmholtz3d(48) low-rank default caps",
              helmholtz3d(48, k=10.0),
              comp))
    report = {"card": card, "path": "truncate-kernels", "reps": reps,
              "queue_floor_ms": floor,
              "design": "G(Q, Uw)" if fused else "bmm + G(Q Uw)", "rows": []}
    for label, problem, kw in plans:
        A, _, shape = problem
        opts = ht.SolverOptions(**kw)
        plan = ht.plan_factorization(
            A, ht.nested_dissection(shape, leafmax=100), opts)
        calls = []
        orig = fm.rand_lowrank

        def rec(Ab, omega, atol, rtol, cap):
            calls.append((Ab.clone(), omega, atol, rtol, cap))
            return orig(Ab, omega, atol, rtol, cap)

        fm.rand_lowrank = rec
        try:
            ht.factor_with_plan(plan, opts, device=dev)
        finally:
            fm.rand_lowrank = orig
        torch.cuda.synchronize()
        for Ab, omega, atol, rtol, cap in calls:
            Q, _ = torch.linalg.qr(Ab @ omega)
            Uw, sv, Vh = torch.linalg.svd(Q.transpose(-1, -2) @ Ab,
                                          full_matrices=False)
            Q, Uw, sv, Vh = (t.contiguous() for t in (Q, Uw, sv, Vh))
            B, m, s = Q.shape
            r, n = Vh.shape[-2:]
            thr = torch.clamp(rtol * sv[:, :1], min=atol)
            rank = torch.clamp((sv > thr).sum(-1), max=cap)
            row = {"plan": label, "B": B, "m": m, "n": n, "s": s, "r": r,
                   "cap": cap, "max_rank": int(rank.max())}
            out = 8 * B * (m + n) * cap
            if fused:
                fn = lambda: lowrank.lowrank_truncate(Q, Uw, sv, Vh, atol,
                                                      rtol, cap)
                row["ms"] = _queued_ms(fn, reps)
            else:
                QU = (Q @ Uw).contiguous()
                g = lambda: lowrank.lowrank_truncate(QU, sv, Vh, atol, rtol,
                                                     cap)
                row["g_alone_ms"] = _queued_ms(g, reps)
                row["g_alone_bound_ms"] = _bound_ms(
                    8 * B * (m * r + r + r * n) + out, 0)[0]
                row["ms"] = _queued_ms(
                    lambda: lowrank.lowrank_truncate(
                        (Q @ Uw).contiguous(), sv, Vh, atol, rtol, cap), reps)
            # the product counts the columns that survive: the rank
            row["bound_ms"], row["bound_by"] = _bound_ms(
                8 * B * (m * s + s * r + r + r * n) + out,
                2 * m * s * float(rank.sum()))
            report["rows"].append(row)
            print(f"G {label} Q [{B},{m},{s}] r={r} n={n} cap={cap} rank "
                  f"<= {row['max_rank']}: {report['design']} "
                  f"{row['ms']:.5f} ms"
                  + (f" (G alone {row['g_alone_ms']:.5f}, bound "
                     f"{row['g_alone_bound_ms']:.5f})" if not fused else "")
                  + f", bound {row['bound_ms']:.5f} {row['bound_by']}",
                  flush=True)
        rows = [r_ for r_ in report["rows"] if r_["plan"] == label]
        print(f"{label}: {len(rows)} launches, {report['design']} "
              f"{sum(r_['ms'] for r_ in rows):.5f} ms, bound "
              f"{sum(r_['bound_ms'] for r_ in rows):.5f}"
              + (f"; G alone {sum(r_['g_alone_ms'] for r_ in rows):.5f}, "
                 f"bound {sum(r_['g_alone_bound_ms'] for r_ in rows):.5f}"
                 if not fused else ""), flush=True)
        del calls
    path = os.path.join(args.out, "truncate_kernels.json")
    with open(path, "w") as f:
        json.dump(report, f)
    print(json.dumps({"card": card, "path": "truncate-kernels",
                      "report": path}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[128, 512])
    ap.add_argument("--problem", choices=("helmholtz2d", "helmholtz3d"),
                    default="helmholtz2d",
                    help="the main-path modes' problem (3D: k=10, the "
                         "compressed modes at the default caps)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--compressed", action="store_true",
                      help="profile the low-rank compressed configuration")
    mode.add_argument("--hss", action="store_true",
                      help="profile the structured (HSS) compressed "
                           "configuration")
    mode.add_argument("--mixed", action="store_true",
                      help="profile the float32 exact factor with "
                           "mixed-precision GMRES")
    mode.add_argument("--spmv", action="store_true",
                      help="device time of kernel D and of the CSR matvec")
    mode.add_argument("--hss-kernels", action="store_true",
                      help="device time of kernels J and I and their plain "
                           "versions")
    mode.add_argument("--sweep-kernels", action="store_true",
                      help="device time of kernels E and B and their plain "
                           "versions at every launch shape")
    mode.add_argument("--arnoldi-kernels", action="store_true",
                      help="device time of the Arnoldi step: L + M + the "
                           "division, and the one launch")
    mode.add_argument("--schur-kernels", action="store_true",
                      help="device time of kernel F at every launch shape")
    mode.add_argument("--truncate-kernels", action="store_true",
                      help="device time of kernel G at every launch of the "
                           "n=512 and 48^3 low-rank plans")
    ap.add_argument("--plain-forward", action="store_true",
                    help="dense levels' forward step as its plain version")
    ap.add_argument("--damping", type=float, default=0.0,
                    help="main-path modes: the damped, complex helmholtz2d "
                         "(exact path; complex128, or with --mixed complex64 "
                         "factor and cycles)")
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profiling: no CUDA device", file=sys.stderr)
        return 2
    import importlib

    import hsolve_torch as ht
    from hsolve_torch import kernels
    from hsolve_torch.factor import solve_with_data
    from hsolve_torch.ops.sweep import level_forward_plain

    if args.plain_forward:      # hsolve_torch.factor is the function's name
        importlib.import_module("hsolve_torch.factor").level_forward = \
            level_forward_plain

    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    kernels.build()
    if args.spmv:
        return _spmv(args, card, dev)
    if args.hss_kernels:
        return _hss_kernels(args, card, dev)
    if args.sweep_kernels:
        return _sweep_kernels(args, card, dev)
    if args.arnoldi_kernels:
        return _arnoldi_kernels(args, card, dev)
    if args.schur_kernels:
        return _schur_kernels(args, card, dev)
    if args.truncate_kernels:
        return _truncate_kernels(args, card, dev)
    path = "hss" if args.hss else "compressed" if args.compressed else \
        "exact-f32-mixed" if args.mixed else "exact"
    cplx = args.damping > 0
    if cplx:
        if path in ("hss", "compressed") or args.problem != "helmholtz2d":
            print("profiling: --damping runs the exact helmholtz2d path only",
                  file=sys.stderr)
            return 2
        path = "exact-complex-mixed" if args.mixed else "exact-complex"
    narrow = torch.complex64 if cplx else torch.float32
    report = {"card": card, "path": path,
              "forward": "plain" if args.plain_forward else "kernel",
              "sizes": []}
    three = args.problem == "helmholtz3d"
    for n in args.sizes:
        A, b, shape = ht.helmholtz3d(n, k=10.0) if three else \
            ht.helmholtz2d(n, k=40.0, damping=args.damping)
        opts = ht.SolverOptions(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3,
                                kest=-1 if three else 32, hss=args.hss) \
            if path in ("compressed", "hss") else ht.SolverOptions(swlevel=0)
        plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                     opts)
        fdt = narrow if args.mixed else \
            (torch.complex128 if cplx else torch.float64)
        holder = {"F": ht.factor_with_plan(plan, opts, dtype=fdt, device=dev)}
        op, mv = ht.spmv_format(A, device=dev)
        bt = torch.as_tensor(np.asarray(b), device=dev)
        prec, inner = solve_with_data, {}
        if args.mixed:
            prec = lambda data, v: solve_with_data(
                data, v.to(narrow)).to(v.dtype)
            nname = str(narrow).replace("torch.", "")
            inner = dict(inner_dtype=nname, m_eps=1e-6, mv_data_inner=(
                ht.spmv_format(A, dtype=np.dtype(nname), device=dev)[0]))

        def factor():
            holder["F"] = None      # the last factor goes before the next
            holder["F"] = ht.factor_with_plan(plan, opts, dtype=fdt, device=dev)

        # where gmres_compiled takes fetch_info, the solve is one CUDA
        # graph on the card, captured at its first call on a factor (the
        # factor's reps make new ones) and read with fetch_info=False, as
        # the bench calls it
        deferred = "fetch_info" in inspect.signature(
            ht.gmres_compiled).parameters
        if deferred:
            inner["fetch_info"] = False

        def solve():
            holder["x"], holder["info"] = ht.gmres_compiled(
                mv, prec, bt, reltol=1e-9, restart=30, maxiter=60,
                mv_data=op, M_data=holder["F"].solve_data, **inner)

        entry = {"n": n, "problem": args.problem, "N": int(A.shape[0]),
                 "phases": {}}
        for name, fn in (("factor", factor), ("solve", solve)):
            if name == "solve":
                solve()                # the capture, outside the readings
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
            wall = _events_ms(fn, args.reps)
            rows = _profile(fn, args.reps,
                            os.path.join(args.out, f"{path}_n{n}_{name}.json"))
            busy = sum(r["ms"] for r in rows)
            entry["phases"][name] = {
                "wall_ms": wall, "device_busy_ms": busy,
                "idle_share": 1.0 - busy / wall if wall > 0 else None,
                "top": rows[:args.top]}
            print(f"{path} n={n} {name}: wall {wall:.3f} ms, device busy "
                  f"{busy:.3f} ms, "
                  f"idle share {1.0 - busy / wall:.3f}", flush=True)
            for r in rows[:args.top]:
                print(f"    {r['ms']:9.4f} ms  {r['calls']:7.1f} calls  "
                      f"{r['name'][:110]}", flush=True)
        info = ht.fetch_gmres_info(holder["info"]) if deferred \
            else holder["info"]
        entry["iters"] = info["iters"]
        # launches per solve: the graph's replays folded in (the readings
        # above ran 2 reps + 1 solves)
        counts = kernels.launch_counts()
        solves = 2 * args.reps + 1
        entry["launches_per_solve"] = {
            k: v / solves for k, v in counts.items() if v and ":" not in k}
        print(f"{path} n={n}: {entry['iters']} GMRES iterations "
              f"({report['forward']} forward step); launches per solve "
              f"{entry['launches_per_solve']}", flush=True)
        report["sizes"].append(entry)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
