"""Kernels E (``lowrank_sweep_update``) and B (``extend_add``): their launch
geometry at every launch shape of the n=128 and n=512 plans, on the CPU.

The kernels run only on the card; what decides their grids is plain Python
(``ops/sweep.py:lowrank_sweep_geometry``, ``ops/assembly.py:
extend_add_geometry`` and the plan's valid-row counts), and these tests hold
it: shared memory within one CTA's 227 KB, legal cluster sizes, every row of
U and V (E) and every valid front row (B) taken exactly once.  A numpy
walk-through of each kernel's partition (E: the CTAs' row slices and the
cluster sum; B: the compacted map and the row tiles) reproduces the plain
version."""

import numpy as np
import pytest
import torch

import hsolve_torch as ht
from hsolve_torch.interop import plan_to_torch
from hsolve_torch.ops.assembly import (extend_add_geometry, extend_add_plain,
                                       valid_rows)
from hsolve_torch.factor import DenseLevel
from hsolve_torch.ops import dense as dk
from hsolve_torch.ops.sweep import (E_MAX_CLUSTER, FORWARD_SIGNALS, PANEL,
                                    PANEL_WARPS, SMEM_MAX, WIDE_CLUSTER,
                                    WINDOW_ROWS, accumulator, forward_cluster,
                                    forward_smem, forward_wide_geometry,
                                    forward_wide_launch,
                                    forward_windows, level_forward_plain,
                                    lowrank_sweep_geometry,
                                    lowrank_sweep_update_plain,
                                    wide_max_warps, wide_window_panels)

torch.set_num_threads(1)

COMP = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3)
CONFIGS = {"low-rank": dict(COMP, kest=32, hss=False),
           "structured kest=32": dict(COMP, kest=32),
           "structured default caps": COMP,
           "exact": dict(swlevel=0)}
_PROBLEMS = {}


def _plan(n, config):
    if n not in _PROBLEMS:
        A, _, shape = ht.helmholtz2d(n, k=40.0)
        _PROBLEMS[n] = (A, ht.nested_dissection(shape, leafmax=100), {})
    A, tree, plans = _PROBLEMS[n]
    if config not in plans:
        plans[config] = ht.plan_factorization(
            A, tree, ht.SolverOptions(**CONFIGS[config]))
    return plans[config]


def _e_shapes(plan):
    """Kernel E's launch shapes ``(B, R, Cc, kc)`` on the plan's compressed
    and structured levels, both forms.  A low-rank level's pairs are
    ``rank_cap`` wide; a structured level's are the children's generator
    widths (their batches' caps) side by side with the two cross couplings'
    (``cbi*`` for L, ``cib*`` for R), as ``structured.py`` lays them out."""
    out = set()
    for bp in plan.batches:
        if not bp.compress:
            continue
        if bp.structured:
            caps = sum(plan.batches[g.src_batch].rank_cap
                       for g in (bp.groups_l[0], bp.groups_r[0]))
            kl = caps + bp.cross["cbi12"]["rcap"] + bp.cross["cbi21"]["rcap"]
            kr = caps + bp.cross["cib12"]["rcap"] + bp.cross["cib21"]["rcap"]
        else:
            kl = kr = bp.rank_cap
        out.add((bp.B, bp.nb_pad, bp.ni_pad, kl))      # forward: LU_, LV_
        out.add((bp.B, bp.ni_pad, bp.nb_pad, kr))      # backward: RU_, RV_
    return sorted(out)


def _check_e_geometry(B, R, Cc, kc, k):
    cs, threads, rstep, cstep, vec, kb, dd, smem = lowrank_sweep_geometry(
        B, R, Cc, kc, k)
    assert dd == int(B <= 16)
    assert cs in (1, 2, 4, 8, 16) and cs <= E_MAX_CLUSTER
    assert cs == 1 or B < 4 * 132, "clusters only where fronts leave SMs idle"
    assert cs == 1 or B * cs <= 8 * 132
    assert cs == 1 or max(R, Cc) * kc >= 1024 * cs
    assert threads in (256, 1024)
    assert threads == 256 or (cs == 1 and k == 1 and 66 <= B < 132)
    assert B * cs < 2 ** 31
    assert smem <= SMEM_MAX
    assert smem == 8 * (threads * (2 * vec + 1) * kb + 4 * kc * kb)
    assert vec == (2 if kc % 2 == 0 else 1)
    fits4 = 8 * (threads * (2 * vec + 1) * 4 + 16 * kc) <= SMEM_MAX
    assert kb == (4 if k > 1 and fits4 else 1)
    for n, step in ((R, rstep), (Cc, cstep)):
        taken = np.zeros(n, dtype=int)
        for j in range(cs):
            taken[min(j * step, n): min((j + 1) * step, n)] += 1
        assert (taken == 1).all(), (B, R, Cc, kc, cs)
    return cs


@pytest.mark.parametrize("n", [128, 512])
@pytest.mark.parametrize("config", ["low-rank", "structured kest=32",
                                    "structured default caps"])
def test_kernel_e_geometry_at_every_launch_shape(n, config):
    shapes = _e_shapes(_plan(n, config))
    assert shapes
    clusters = set()
    for B, R, Cc, kc in shapes:
        for k in (1, 3):
            clusters.add(_check_e_geometry(B, R, Cc, kc, k))
    # the top levels (one to a few fronts) spread over clusters
    assert max(clusters) > 1


def test_kernel_e_structured_widths_are_the_factors():
    """The structured widths ``_e_shapes`` reads off the plan are those of
    an n=48 structured factor's low-rank pairs (default caps)."""
    A, _, shape = ht.helmholtz2d(48, k=20.0)
    tree = ht.nested_dissection(shape, leafmax=40)
    opts = ht.SolverOptions(**COMP)
    plan = ht.plan_factorization(A, tree, opts)
    F = ht.factor_with_plan(plan, opts, device="cpu")
    got = set()
    for lev in F.levels:
        if getattr(lev, "LU_", None) is not None:
            got.add(tuple(lev.LU_.shape[:2]) + (lev.LV_.shape[1],
                                                 lev.LU_.shape[2]))
            got.add(tuple(lev.RU_.shape[:2]) + (lev.RV_.shape[1],
                                                 lev.RU_.shape[2]))
    assert any(bp.structured for bp in plan.batches)
    assert got == set(_e_shapes(plan))


@pytest.mark.parametrize("kc,k", [(1, 1), (47, 2), (400, 1), (400, 5),
                                  (3000, 1), (3000, 4), (6900, 1)])
def test_kernel_e_geometry_at_wide_ranks(kc, k):
    for B in (1, 3, 200):
        _check_e_geometry(B, 512, 300, kc, k)


@pytest.mark.parametrize("n", [128, 512])
def test_kernel_e_complex128_geometry_at_every_launch_shape(n):
    """Kernel E in complex128 at every launch shape of the low-rank plan (the
    damped system's is the same): the float64 launch's clusters, CTAs and
    slices, one 16-byte value a read (vec 1), its shared memory counted in
    16-byte values and within a CTA's."""
    for B, R, Cc, kc in _e_shapes(_plan(n, "low-rank")):
        for k in (1, 3):
            cs, threads, rstep, cstep, vec, kb, dd, smem = \
                lowrank_sweep_geometry(B, R, Cc, kc, k, itemsize=16)
            assert (cs, threads, rstep, cstep, dd) == lowrank_sweep_geometry(
                B, R, Cc, kc, k)[:4] + (int(B <= 16),)
            assert vec == 1 and kb == (4 if k > 1 else 1)
            assert smem == 16 * (threads * 3 * kb + 4 * kc * kb) <= SMEM_MAX


def test_kernel_e_geometry_refuses_what_no_cta_holds():
    with pytest.raises(ValueError, match="shared"):
        lowrank_sweep_geometry(1, 64, 64, 7000, 1)


def _e_walk(C, ids_out, U, V, N, X=None, ids_in=None):
    """Kernel E's partition in numpy: per front, the cs CTAs' partial
    t_j = V[c-slice]^T Y[c-slice] summed in rank order, then each CTA's
    slice of U's rows applied in chunks of kb right-hand sides."""
    C = C.copy()
    B, R, kc = U.shape
    Cc = V.shape[1]
    k = C.shape[1]
    cs, _, rstep, cstep, _, kb, _, _ = lowrank_sweep_geometry(B, R, Cc, kc,
                                                               k)
    for b in range(B):
        if X is not None:
            Y = X[b]
        else:
            Y = np.where((ids_in[b] < N)[:, None],
                         C[np.minimum(ids_in[b], N)], 0.0)
        for r0 in range(0, k, kb):
            cols = slice(r0, min(r0 + kb, k))
            t = sum(V[b, j * cstep:(j + 1) * cstep].T
                    @ Y[j * cstep:(j + 1) * cstep, cols] for j in range(cs))
            for j in range(cs):
                for row in range(j * rstep, min((j + 1) * rstep, R)):
                    if ids_out[b, row] < N:
                        C[ids_out[b, row], cols] -= U[b, row] @ t
    return C


@pytest.mark.parametrize("B,R,Cc,kc,k", [(1, 512, 512, 48, 1),
                                         (2, 512, 512, 192, 3),
                                         (8, 96, 40, 33, 2),
                                         (150, 20, 30, 32, 1)])
def test_kernel_e_partition_is_the_plain_update(B, R, Cc, kc, k):
    rng = np.random.default_rng(B + kc)
    N = B * (R + Cc) + 7
    perm = rng.permutation(N)
    ids_out = perm[:B * R].reshape(B, R).astype(np.int32)
    ids_in = perm[B * R:B * (R + Cc)].reshape(B, Cc).astype(np.int32)
    ids_out[:, -2:] = N
    ids_in[:, -3:] = N
    C = rng.standard_normal((N + 1, k))
    C[N] = 0.0
    U = rng.standard_normal((B, R, kc))
    V = rng.standard_normal((B, Cc, kc))
    X = rng.standard_normal((B, Cc, k))
    t = torch.as_tensor
    for kw, kwt in (({"X": X}, {"X": t(X)}),
                    ({"ids_in": ids_in}, {"ids_in": t(ids_in)})):
        got = _e_walk(C, ids_out, U, V, N, **kw)
        want = lowrank_sweep_update_plain(t(C), t(ids_out), t(U), t(V), N,
                                          **kwt).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
        assert got[N].max() == 0.0


def _b_rows(plan, bp, side):
    """The plan's groups on one side with their sources' Schur widths."""
    groups = bp.groups_l if side == "l" else bp.groups_r
    imap = bp.map_l if side == "l" else bp.map_r
    s_pad = bp.sl_pad if side == "l" else bp.sr_pad
    return groups, imap, s_pad


@pytest.mark.parametrize("n", [128, 512])
def test_kernel_b_row_counts_are_the_maps(n):
    """``plan_to_torch``'s per-group count, against ``imap`` entry for
    entry: the most valid entries of one front row, counted against the
    staging width s_pad and against the source's own width (the Schur
    stack's nb_pad: the same, so no CTA lacks a row on these plans)."""
    plan = _plan(n, "exact")
    tp = plan_to_torch(plan, "cpu")
    launches = 0
    for bp, tb in zip(plan.batches, tp.batches):
        for side in ("l", "r"):
            groups, imap, s_pad = _b_rows(plan, bp, side)
            counts = tb.rows_l if side == "l" else tb.rows_r
            tmap = tb.map_l if side == "l" else tb.map_r
            assert len(counts) == len(groups)
            for g, tg, cnt in zip(groups, tb.groups_l if side == "l"
                                  else tb.groups_r, counts):
                w = plan.batches[g.src_batch].nb_pad
                per_row = [sum(0 <= a < s_pad for a in imap[r])
                           for r in g.dst_rows]
                assert cnt == max(per_row)
                assert cnt == valid_rows(tmap, tg[2], w)
                assert cnt == valid_rows(tmap, tg[2], s_pad)
                tiles, trows = extend_add_geometry(len(g.dst_rows), cnt)
                assert (tiles - 1) * trows < cnt <= tiles * trows
                assert tiles * len(g.dst_rows) <= 65535 * 65535
                assert 8 * bp.m_pad <= SMEM_MAX
                launches += 1
    assert launches == {128: 21, 512: 33}[n]


@pytest.mark.parametrize("G,rows", [(1024, 21), (1024, 44), (1, 511), (3, 636),
                                    (7, 1), (40000, 3), (1, 1)])
def test_kernel_b_geometry_fills_the_card(G, rows):
    tiles, trows = extend_add_geometry(G, rows)
    assert trows * (tiles - 1) < rows <= trows * tiles
    assert trows - rows // tiles <= 1                    # balanced tiles
    assert tiles >= 1 and trows >= 1
    assert (tiles - 1) * trows < rows <= tiles * trows   # no tile without a row
    assert G * tiles >= min(4 * 132, G * rows)           # the launch's CTAs


def _b_walk(front, S, src_rows, dst_rows, imap, rows):
    """Kernel B's partition in numpy: per group the compacted valid map
    entries in order, then CTA t's row tiles (stride tiles * trows) times
    all compacted columns."""
    front = front.copy()
    w = S.shape[-1]
    tiles, trows = extend_add_geometry(len(dst_rows), max(rows, 1))
    for s, r in zip(src_rows, dst_rows):
        mp = imap[r]
        fj = np.nonzero((mp >= 0) & (mp < w))[0]
        sc = mp[fj]
        for t in range(tiles):
            for q0 in range(t * trows, len(fj), tiles * trows):
                for q in range(q0, min(q0 + trows, len(fj))):
                    front[r, fj[q], fj] += S[s, sc[q], sc]
    return front


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rows", ["exact", 1, 3])
def test_kernel_b_partition_is_the_plain_extend_add(dtype, rows):
    """A general map (negative entries, entries >= w, repeats, no runs),
    with the exact count and with counts below it (the CTAs stride over
    their tiles, so any count gives the same sums): bitwise the plain
    version."""
    rng = np.random.default_rng(7)
    B, m, w, G = 9, 70, 23, 5
    front = rng.standard_normal((B, m, m)).astype(dtype)
    S = rng.standard_normal((4, w, w)).astype(dtype)
    imap = rng.integers(-3, w + 4, size=(B, m)).astype(np.int32)
    imap[2, :10] = 5                     # a repeated source row
    src_rows = rng.integers(0, 4, size=G).astype(np.int32)
    dst_rows = rng.permutation(B)[:G].astype(np.int32)
    t = torch.as_tensor
    exact = valid_rows(t(imap), t(dst_rows), w)
    assert exact == max(int(((imap[r] >= 0) & (imap[r] < w)).sum())
                        for r in dst_rows)
    got = _b_walk(front, S, src_rows, dst_rows, imap,
                  exact if rows == "exact" else rows)
    want = extend_add_plain(t(front), t(S), t(src_rows), t(dst_rows),
                            t(imap)).numpy()
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# float32 (the JAX bench's device configuration on compressed levels):
# float32 values four a 16-byte read, float64 sums, no double-double
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [128, 512])
@pytest.mark.parametrize("config", ["low-rank", "structured kest=32",
                                    "structured default caps"])
def test_kernel_e_float32_geometry_at_every_launch_shape(n, config):
    """Kernel E in float32 at every launch shape of the plans: the float64
    launch's clusters, CTAs and slices; four float32 values a 16-byte read
    where kc is a multiple of 4 (else one); no double-double (the sums run
    in float64, far below float32's rounding); its shared memory counted in
    the 8-byte float64 sums, within a CTA's; four right-hand sides a chunk
    wherever that fits, as in float64."""
    for B, R, Cc, kc in _e_shapes(_plan(n, config)):
        for k in (1, 3):
            g64 = lowrank_sweep_geometry(B, R, Cc, kc, k)
            cs, threads, rstep, cstep, vec, kb, dd, smem = \
                lowrank_sweep_geometry(B, R, Cc, kc, k, itemsize=4)
            assert (cs, threads, rstep, cstep) == g64[:4]
            assert dd == 0
            assert vec == (4 if kc % 4 == 0 else 1)
            assert smem == 8 * (threads * (2 * vec + 1) * kb + 4 * kc * kb) \
                <= SMEM_MAX
            assert kb == (4 if k > 1 else 1), (B, R, Cc, kc, k)


@pytest.mark.parametrize("kc,k", [(1, 1), (47, 2), (400, 1), (400, 5),
                                  (3000, 1), (3000, 4)])
def test_kernel_e_float32_geometry_at_wide_ranks(kc, k):
    """Float32 at the 3D caps and beyond: a launch within a CTA's shared
    memory, unaligned operands one value a read."""
    for B in (1, 3, 200):
        for aligned in (True, False):
            _, threads, _, _, vec, kb, dd, smem = lowrank_sweep_geometry(
                B, 512, 300, kc, k, aligned=aligned, itemsize=4)
            assert dd == 0 and smem <= SMEM_MAX
            assert vec == (4 if aligned and kc % 4 == 0 else 1)
            assert smem == 8 * (threads * (2 * vec + 1) * kb + 4 * kc * kb)


@pytest.mark.parametrize("B,R,Cc,kc,k", [(1, 512, 512, 48, 1),
                                         (8, 96, 40, 33, 2),
                                         (150, 20, 30, 32, 1)])
def test_kernel_e_float32_partition_is_the_plain_update(B, R, Cc, kc, k):
    """The float32 launch's partition (its geometry's slices, t summed
    over the cluster's ranks in float64) reproduces the plain version's
    update summed in float64 and rounded once, to float32's rounding."""
    rng = np.random.default_rng(B + kc + 1)
    N = B * (R + Cc) + 7
    perm = rng.permutation(N)
    ids_out = perm[:B * R].reshape(B, R).astype(np.int32)
    ids_in = perm[B * R:B * (R + Cc)].reshape(B, Cc).astype(np.int32)
    ids_out[:, -2:] = N
    C = rng.standard_normal((N + 1, k)).astype(np.float32)
    C[N] = 0.0
    U = rng.standard_normal((B, R, kc)).astype(np.float32)
    V = rng.standard_normal((B, Cc, kc)).astype(np.float32)
    t = torch.as_tensor
    f64 = lambda a: a.astype(np.float64)
    got = _e_walk(f64(C), ids_out, f64(U), f64(V), N, ids_in=ids_in)
    want = lowrank_sweep_update_plain(torch.tensor(C), t(ids_out), t(U), t(V),
                                      N, ids_in=t(ids_in))
    assert want.dtype == torch.float32
    eps = float(np.finfo(np.float32).eps)
    assert np.abs(got - want.numpy()).max() <= 2 * eps * np.abs(got).max()


# ---------------------------------------------------------------------------
# complex64 (the bench's complex device configuration on compressed levels):
# two values a 16-byte read, complex128 sums, no double-double
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [128, 512])
@pytest.mark.parametrize("config", ["low-rank", "structured kest=32",
                                    "structured default caps"])
def test_kernel_e_complex64_geometry_at_every_launch_shape(n, config):
    """Kernel E in complex64 at every launch shape of the plans (the damped
    system's are the same): the float64 launch's clusters, CTAs and slices;
    two complex64 values a 16-byte read where kc is even (else one); no
    double-double (the sums run in complex128, far below complex64's
    rounding); its shared memory counted in the 16-byte complex128 sums,
    within a CTA's; four right-hand sides a chunk wherever that fits."""
    for B, R, Cc, kc in _e_shapes(_plan(n, config)):
        for k in (1, 3):
            g64 = lowrank_sweep_geometry(B, R, Cc, kc, k)
            cs, threads, rstep, cstep, vec, kb, dd, smem = \
                lowrank_sweep_geometry(B, R, Cc, kc, k, itemsize=8,
                                       is_complex=True)
            assert (cs, threads, rstep, cstep) == g64[:4]
            assert dd == 0
            assert vec == (2 if kc % 2 == 0 else 1)
            assert smem == 16 * (threads * (2 * vec + 1) * kb + 4 * kc * kb) \
                <= SMEM_MAX
            assert kb == (4 if k > 1 else 1), (B, R, Cc, kc, k)
            # complex128 at the same shape: one value a read, double-double
            # at the top levels, as before
            c128 = lowrank_sweep_geometry(B, R, Cc, kc, k, itemsize=16,
                                          is_complex=True)
            assert c128 == lowrank_sweep_geometry(B, R, Cc, kc, k,
                                                  itemsize=16)
            assert c128[4] == 1 and c128[6] == int(B <= 16)


@pytest.mark.parametrize("kc,k", [(1, 1), (47, 2), (400, 1), (400, 5),
                                  (2000, 1), (2000, 4)])
def test_kernel_e_complex64_geometry_at_wide_ranks(kc, k):
    """Complex64 at the 3D caps and beyond: a launch within a CTA's shared
    memory (four right-hand sides a chunk only where they fit), unaligned
    operands one value a read."""
    for B in (1, 3, 200):
        for aligned in (True, False):
            _, threads, _, _, vec, kb, dd, smem = lowrank_sweep_geometry(
                B, 512, 300, kc, k, aligned=aligned, itemsize=8,
                is_complex=True)
            assert dd == 0 and smem <= SMEM_MAX
            assert vec == (2 if aligned and kc % 2 == 0 else 1)
            assert smem == 16 * (threads * (2 * vec + 1) * kb + 4 * kc * kb)


@pytest.mark.parametrize("B,R,Cc,kc,k", [(1, 512, 512, 48, 1),
                                         (8, 96, 40, 33, 2),
                                         (150, 20, 30, 32, 1)])
def test_kernel_e_complex64_partition_is_the_plain_update(B, R, Cc, kc, k):
    """The complex64 launch's partition (its geometry's slices, t summed
    over the cluster's ranks in complex128) reproduces the plain version's
    update summed in complex128 and rounded once, to complex64's
    rounding."""
    rng = np.random.default_rng(B + kc + 2)
    N = B * (R + Cc) + 7
    perm = rng.permutation(N)
    ids_out = perm[:B * R].reshape(B, R).astype(np.int32)
    ids_in = perm[B * R:B * (R + Cc)].reshape(B, Cc).astype(np.int32)
    ids_out[:, -2:] = N
    c64 = lambda *s: (rng.standard_normal(s)
                      + 1j * rng.standard_normal(s)).astype(np.complex64)
    C = c64(N + 1, k)
    C[N] = 0.0
    U, V = c64(B, R, kc), c64(B, Cc, kc)
    t = torch.as_tensor
    c128 = lambda a: a.astype(np.complex128)
    got = _e_walk(c128(C), ids_out, c128(U), c128(V), N, ids_in=ids_in)
    want = lowrank_sweep_update_plain(torch.tensor(C), t(ids_out), t(U), t(V),
                                      N, ids_in=t(ids_in))
    assert want.dtype == torch.complex64
    eps = float(np.finfo(np.float32).eps)
    assert np.abs(got - want.numpy()).max() <= 2 * eps * np.abs(got).max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.complex128, torch.complex64])
def test_kernel_c_forward_shared_memory_at_every_level(dtype):
    """Kernel C's forward step at every level width of the n=512 exact plan
    (the damped system's complex plan has the same widths) and at the
    widest one-cluster front (2048 rows): its CTA's shared memory, the
    solved values in the accumulator type, x in the value type, the panel
    warps' staged diagonal blocks (in the value type, but as complex128 for
    a complex64 front on a cluster) and the substitution's ready signals (a
    complex128 front of 2048 rows: 200,960 bytes; complex64 184,576), stays
    within a CTA's 227 KB; so does the wide substitution of a wider front
    (its window's solved values and one inverse slot a warp) and its prep
    CTA (one staged block a warp)."""
    plan = _plan(512, "exact")
    item = torch.empty((), dtype=dtype).element_size()
    acc = torch.empty((), dtype=accumulator(dtype)).element_size()
    for ni in sorted({bp.ni_pad for bp in plan.batches}) + [WINDOW_ROWS]:
        warps = max(2, -(-(-(-ni // PANEL)) // forward_cluster(ni)))
        assert warps <= PANEL_WARPS
        dg = acc if forward_cluster(ni) > 1 and dtype == torch.complex64 \
            else item
        assert forward_smem(ni, dtype) == ni * (acc + item) \
            + warps * PANEL * 33 * dg + 4 * FORWARD_SIGNALS <= SMEM_MAX
    for ni in (WINDOW_ROWS + 1, 4424, 7944, 20608):
        geo = forward_wide_geometry(ni, 0, dtype)
        for (r0, r1, cs), warps, smem in zip(geo["windows"], geo["warps"],
                                             geo["smem"]):
            npw = -(-(r1 - r0) // PANEL)
            assert smem == (npw + -(-npw // cs)) * PANEL * acc \
                + warps * PANEL * PANEL * acc <= SMEM_MAX
    assert 8 * PANEL * 33 * acc <= SMEM_MAX  # a prep CTA: 8 warps' blocks
    if dtype.is_complex:
        assert forward_smem(WINDOW_ROWS, dtype) == \
            {torch.complex128: 200960, torch.complex64: 184576}[dtype]


# ---------------------------------------------------------------------------
# kernel C's forward step on fronts above 2048 rows (the wide form)
# ---------------------------------------------------------------------------

_WIDE = {}


def _wide_fronts():
    """``{(B, ni_pad, nb_pad)}`` of the dense levels wider than 2048 rows of
    the exact plans that reach the wide form: helmholtz3d(64) (two fronts
    of 3912 rows, the 7944-row root), helmholtz3d(48) (the 4424-row root,
    which the low-rank and structured 48^3 plans keep exact, and the 2072-
    and 2168-row fronts below it) and helmholtz2d(1026) (the 2056-row
    root)."""
    if not _WIDE:
        for A, _, shape in (ht.helmholtz3d(64, k=10.0),
                            ht.helmholtz3d(48, k=10.0),
                            ht.helmholtz2d(1026, k=40.0)):
            plan = ht.plan_factorization(
                A, ht.nested_dissection(shape, leafmax=100),
                ht.SolverOptions(swlevel=0))
            _WIDE.update({(bp.B, bp.ni_pad, bp.nb_pad): None
                          for bp in plan.batches if bp.ni_pad > WINDOW_ROWS})
    return sorted(_WIDE)


def test_kernel_c_wide_fronts_of_the_plans():
    """The wide form's shapes: the plans' dense levels above 2048 rows."""
    assert _wide_fronts() == [(1, 2056, 0), (1, 2168, 2216), (1, 4424, 0),
                              (1, 7944, 0), (2, 2072, 2216), (2, 3912, 3976)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.complex128, torch.complex64])
def test_kernel_c_wide_geometry_at_every_wide_front(dtype):
    """At every dense front above 2048 rows of the plans (and the 4424-row
    hand front of chip_smoke, nb 24), in each value type: one window (the
    whole front), so three launches (prep, ``C[bnd] -= L x`` where nb > 0,
    one substitution of both triangles); a cluster of 16 CTAs where the
    card holds one (the residency is asked of the card for the first
    window at 16, then at 8), else 8; as many warps as a CTA's panels
    within the type's limit and shared memory (the window's solved values,
    the CTA's running values, one inverse slot a warp) within 232,448
    bytes."""
    acc = torch.empty((), dtype=accumulator(dtype)).element_size()
    for B, ni, nb in _wide_fronts() + [(1, 4424, 24)]:
        asked = []

        def active(npw, cs, held=1):
            asked.append((npw, cs))
            return held

        npan = -(-ni // PANEL)
        geo = forward_wide_geometry(ni, nb, dtype, active)
        assert asked == [(npan, WIDE_CLUSTER)] and geo["resident"] == 1
        assert geo["cs_max"] == WIDE_CLUSTER
        assert geo["windows"] == [(0, ni, WIDE_CLUSTER)]
        assert geo["launches"] == (3 if nb else 2)
        warps, smem = geo["warps"][0], geo["smem"][0]
        per = -(-npan // WIDE_CLUSTER)
        fixed, slot = (npan + per) * PANEL * acc, PANEL * PANEL * acc
        assert warps == min(per, wide_max_warps(dtype),
                            (SMEM_MAX - fixed) // slot) >= 1
        assert smem == fixed + warps * slot <= SMEM_MAX
        # a card that holds no cluster of 16 takes 8; of neither, raises
        asked.clear()
        geo8 = forward_wide_geometry(
            ni, nb, dtype, lambda npw, cs: asked.append(cs) or int(cs <= 8))
        assert asked == [16, 8] and geo8["cs_max"] == 8
        assert geo8["windows"] == [(0, ni, 8)]
        with pytest.raises(RuntimeError):
            forward_wide_geometry(ni, nb, dtype, lambda npw, cs: 0)
        # the dinv form asks nothing: prep and two row products
        assert forward_wide_geometry(ni, nb, dtype, active, lu=False)[
            "launches"] == (3 if nb else 2)


@pytest.mark.parametrize("ni_pad", [20608, 49664, 100000])
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_kernel_c_wide_windows_beyond_one_window(ni_pad, dtype):
    """A front wider than one window (16384 rows in float64 and float32,
    8192 in the complex types) runs in windows that cover it in order, each
    within a CTA's shared memory: two substitution launches a window and
    the updates between."""
    geo = forward_wide_geometry(ni_pad, 24, dtype)
    wins = geo["windows"]
    step = wide_window_panels(dtype) * PANEL
    assert [w[:2] for w in wins] == [(r0, min(r0 + step, ni_pad))
                                    for r0 in range(0, ni_pad, step)]
    n = len(wins)
    assert geo["launches"] == 2 + 2 * n + 2 * (n - 1)
    assert all(s <= SMEM_MAX for s in geo["smem"])
    for (r0, r1, cs), warps in zip(wins, geo["warps"]):
        npw = -(-(r1 - r0) // PANEL)
        assert forward_wide_launch(npw, dtype)[:2] == (cs, warps)
    # at a cluster of 8 too (a card that holds none of 16)
    for r0, r1, cs in forward_windows(ni_pad, dtype, 8):
        assert cs == 8 and forward_wide_launch(-(-(r1 - r0) // PANEL), dtype,
                                               8)[2] <= SMEM_MAX


def _owners(npw, cs, warps):
    """The wide kernel's ownership, as ``wide_solve_kernel`` lays it out:
    panel t of a window to CTA t % cs as its m-th panel (m = t // cs, its
    running values at row m of the CTA's zs) and, there, to warp m % warps:
    ``{(cta, warp): [(t, m), ...]}`` in each warp's solve order."""
    out = {}
    for rank in range(cs):
        mine = -(-(npw - rank) // cs)
        for w in range(warps):
            out[(rank, w)] = [(rank + cs * m, m)
                              for m in range(w, mine, warps)]
    return out


@pytest.mark.parametrize("npw", [65, 123, 139, 249, 256, 512])
def test_kernel_c_wide_panels_owned_once(npw):
    """Every panel of a window is owned by exactly one warp of one CTA, and
    a CTA's panels' running values by distinct rows of its zs, in every
    value type and at clusters of 16 and 8."""
    for dtype in (torch.float64, torch.complex128):
        if npw > wide_window_panels(dtype):
            continue
        for cs_max in (WIDE_CLUSTER, 8):
            cs, warps, _ = forward_wide_launch(npw, dtype, cs_max)
            own = _owners(npw, cs, warps)
            flat = sorted(t for ts in own.values() for t, _ in ts)
            assert flat == list(range(npw))
            for rank in range(cs):
                rows = sorted(m for w in range(warps)
                              for _, m in own[(rank, w)])
                assert rows == list(range(len(rows)))
                assert len(rows) <= -(-npw // cs)


def _inv_lower(blk):
    """The prep kernel's inverse of a unit lower block: lane j substitutes
    the identity's column j, row by row."""
    n = blk.shape[0]
    X = np.zeros_like(blk)
    for j in range(n):
        for i in range(n):
            s = 1.0 if i == j else 0.0
            for c in range(i):
                s -= blk[i, c] * X[c, j]
            X[i, j] = s
    return X


def _inv_upper(blk):
    n = blk.shape[0]
    X = np.zeros_like(blk)
    for j in range(n):
        for i in range(n - 1, -1, -1):
            s = 1.0 if i == j else 0.0
            for c in range(i + 1, n):
                s -= blk[i, c] * X[c, j]
            X[i, j] = s * (1.0 / blk[i, i])
    return X


def _wide_model(lu, perm, x, panel, win):
    """The wide form's substitution order in numpy: z = x[perm]; per window
    of ``win`` panels and per panel P in it (in the direction's order), P's
    running values take the updates of the window's earlier panels in
    order, then y_P = inv(diagonal block) z_P with the block's inverse
    formed as the prep kernel forms it (identity past the last row); after
    a window, the rows after it (forward) or before it (backward) take the
    window's values, as window_update_kernel applies them."""
    ni = lu.shape[0]
    npan = -(-ni // panel)
    pad = npan * panel
    A = np.eye(pad)
    A[:ni, :ni] = lu
    Lo = np.tril(A, -1) + np.eye(pad)
    Up = np.triu(A)
    z = np.zeros(pad)
    z[:ni] = x[perm]
    blk = lambda M, p, q: M[p * panel:(p + 1) * panel, q * panel:(q + 1) * panel]
    inv = {(0, p): _inv_lower(blk(Lo, p, p)) for p in range(npan)}
    inv.update({(1, p): _inv_upper(blk(Up, p, p)) for p in range(npan)})
    wins = [(w0, min(w0 + win, npan)) for w0 in range(0, npan, win)]
    for d, M in ((0, Lo), (1, Up)):
        for w0, w1 in (wins if d == 0 else wins[::-1]):
            order = list(range(w0, w1)) if d == 0 else list(range(w1 - 1, w0 - 1, -1))
            for i, P in enumerate(order):
                zp = z[P * panel:(P + 1) * panel]
                for p in order[:i]:
                    zp -= blk(M, P, p) @ z[p * panel:(p + 1) * panel]
                z[P * panel:(P + 1) * panel] = inv[(d, P)] @ zp
            rows = slice(w1 * panel, pad) if d == 0 else slice(0, w0 * panel)
            z[rows] -= M[rows, w0 * panel:w1 * panel] @ z[w0 * panel:w1 * panel]
    return z[:ni]


@pytest.mark.parametrize("ni,panel,win", [(40, 8, 100), (77, 8, 3),
                                          (130, 16, 4), (96, 32, 1),
                                          (100, 32, 2)])
def test_kernel_c_wide_substitution_order_is_the_lu_solve(ni, panel, win):
    """The wide form's order (blocks by panels, each diagonal block's
    inverse, windows with the updates between them), at small panel and
    window sizes, gives the plain version's forward step and the JAX
    package's ``lu_solve`` (``hsolve/ops/dense.py``) to 1e-12 in float64,
    on a front with partial pivoting (growth as a random matrix gives)."""
    from hsolve.ops import dense as jdense

    rng = np.random.default_rng(ni + panel + win)
    D = rng.standard_normal((ni, ni)) + 2.0 * np.eye(ni)
    lu, perm = dk.lu_factor(torch.as_tensor(D)[None])
    lu_n, perm_n = lu[0].numpy(), perm[0].numpy()
    x = rng.standard_normal(ni)
    got = _wide_model(lu_n, perm_n, x, panel, win)
    want = np.asarray(jdense.lu_solve(lu_n[None], perm_n[None],
                                      x[None, :, None]))[0, :, 0]
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    # the plain version's step on the same front (no boundary)
    N = ni
    C = torch.zeros(N + 1, 1, dtype=torch.float64)
    ids = torch.as_tensor(rng.permutation(N)[:ni].astype(np.int32))
    C[ids.long(), 0] = torch.as_tensor(x)
    lev = DenseLevel(lu=lu, perm=perm,
                     L=torch.zeros(1, 0, ni, dtype=torch.float64),
                     R=torch.zeros(1, ni, 0, dtype=torch.float64),
                     int_ids=ids[None], bnd_ids=torch.zeros(1, 0,
                                                           dtype=torch.int32))
    plain = level_forward_plain(C, lev, N)[ids.long(), 0].numpy()
    assert np.abs(got - plain).max() <= 1e-12 * np.abs(plain).max()
