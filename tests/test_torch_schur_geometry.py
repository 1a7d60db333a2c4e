"""Kernel F (``lowrank_schur_update``): its launch geometry at every launch
shape of the n=128 and n=512 compressed plans, on the CPU.

The kernel runs only on the card; what decides its grid is plain Python
(``ops/schur.py:schur_geometry``), and these tests hold it: shared memory
within one CTA's 227 KB, legal cluster sizes (the column tiles a multiple
of the cluster), a tile the CTA's eight warps cover, every entry of S in
exactly one tile.  A numpy walk-through of the kernel's partition (row
bands, column tiles, the depth split over a cluster's ranks and its
reduce-scatter of W, whole rows with the permutation applied from the
staged rows) reproduces the plain version."""

import numpy as np
import pytest
import torch

import hsolve_torch as ht
from hsolve_torch.ops.schur import (F_MAX_CLUSTER, F_MAX_KD, F_W_KD,
                                    F_WHOLE_MAX, SMEM_MAX,
                                    lowrank_schur_update_plain,
                                    schur_geometry, schur_geometry_cc,
                                    schur_geometry_w, schur_smem,
                                    schur_smem_cc, schur_smem_w)

torch.set_num_threads(1)

COMP = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3)
CONFIGS = {"low-rank": dict(COMP, kest=32, hss=False),
           "structured kest=32": dict(COMP, kest=32),
           "structured default caps": COMP}
_PROBLEMS = {}


def _f_shapes(n, config):
    """Kernel F's launch shapes ``(B, ni_pad, nb_pad, kc)``: the plan's
    compressed batches that are not structured."""
    if n not in _PROBLEMS:
        A, _, shape = ht.helmholtz2d(n, k=40.0)
        _PROBLEMS[n] = (A, ht.nested_dissection(shape, leafmax=100))
    A, tree = _PROBLEMS[n]
    plan = ht.plan_factorization(A, tree, ht.SolverOptions(**CONFIGS[config]))
    return [(bp.B, bp.ni_pad, bp.nb_pad, bp.rank_cap) for bp in plan.batches
            if bp.compress and not bp.structured]


def _check_geometry(B, ni_pad, nb, kc, sms=132):
    g = schur_geometry(B, ni_pad, nb, kc, sms=sms)
    bm, bn, cs, nct, kd = g["bm"], g["bn"], g["cs"], g["nct"], g["kd"]
    if g["w"]:
        # the W form: W = Abi RU before the launch, square tiles of 64 or
        # 128 over depth chunks of 32
        assert bm in (64, 128) and bn == bm and kd == F_W_KD
        assert cs == 1 and not g["whole"] and nct == -(-nb // bn)
        assert g["smem"] == schur_smem_w(bm) <= SMEM_MAX
        assert g == schur_geometry_w(nb)
    else:
        assert g["smem"] == schur_smem(bm, bn, cs, kd, kc, g["whole"], nb) \
            <= SMEM_MAX
        # a rank's depth in chunks of kd (one where it is at most 64)
        assert 16 <= kd <= F_MAX_KD and kd % 16 == 0
        assert kd >= min(F_MAX_KD, -(-ni_pad // cs)) or kc > 64
        assert 16 <= bm <= 64 and bm % 16 == 0 and bn % 8 == 0
        assert bn <= 32 * (8 // (bm // 16))         # the warps' column blocks
        assert 1 <= cs <= F_MAX_CLUSTER and nct % cs == 0
        # each band's W once: one CTA a band (whole rows) or one cluster
        assert nct == cs
    if g["whole"]:
        assert cs == nct == 1 and bn >= nb
    else:
        assert nct * bn >= nb and (nct - cs) * bn < nb   # no spare tile
    # each entry of S in exactly one tile
    cover = np.zeros((nb, nb), dtype=int)
    for y in range(-(-nb // bm)):
        for x in range(nct):
            j0 = 0 if g["whole"] else x * bn
            cover[y * bm:(y + 1) * bm, j0:j0 + bn] += 1
    assert (cover == 1).all()
    return g


@pytest.mark.parametrize("n", [128, 512])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_kernel_f_geometry_at_every_launch_shape(n, config):
    shapes = _f_shapes(n, config)
    assert shapes
    for B, ni_pad, nb, kc in shapes:
        g = _check_geometry(B, ni_pad, nb, kc)
        # the many-front levels take whole rows, one CTA a front up to 64
        # rows; the top levels a cluster per row band
        assert g["whole"] == (nb <= F_WHOLE_MAX)
        if nb <= 64:
            assert g["bm"] >= nb and g["nct"] == 1
        if nb > F_WHOLE_MAX and B * -(-nb // 32) <= 2 * 132:
            # the top levels: a band's column tiles one cluster
            assert g["cs"] == g["nct"] == min(F_MAX_CLUSTER, -(-nb // 32))
        elif nb > F_WHOLE_MAX:
            # many fronts of wide rows: W once before the launch
            assert g["w"] and g["cs"] == 1 and g["bn"] <= 128


def test_kernel_f_geometry_on_the_n512_low_rank_plan():
    """The n=512 low-rank plan's eleven launches, as PERF.md reads them."""
    got = [(B, nb, kc) + tuple(schur_geometry(B, ni, nb, kc)[k] for k in
                               ("bm", "bn", "cs", "nct", "kd", "whole"))
           for B, ni, nb, kc in _f_shapes(512, "low-rank")]
    assert got == [
        (1023, 64, 32, 64, 64, 1, 1, 32, True),
        (512, 96, 32, 32, 96, 1, 1, 32, True),
        (256, 128, 48, 32, 128, 1, 1, 64, True),
        (128, 192, 48, 64, 64, 1, 3, 32, False),      # the W form
        (64, 256, 48, 128, 128, 1, 2, 32, False),
        (32, 384, 48, 128, 128, 1, 3, 32, False),
        (16, 512, 48, 32, 64, 8, 8, 32, False),
        (8, 640, 48, 32, 80, 8, 8, 32, False),
        (4, 512, 48, 16, 64, 8, 8, 64, False),
        (2, 512, 48, 16, 64, 8, 8, 64, False),
        (1, 512, 48, 16, 64, 8, 8, 64, False)]
    # on a card of 4 SMs the top levels take the W form without a cluster;
    # the whole-row levels do not depend on the card
    for B, ni, nb, kc in _f_shapes(512, "low-rank"):
        g = _check_geometry(B, ni, nb, kc, sms=4)
        if nb > F_WHOLE_MAX:
            assert g["w"] and g["cs"] == 1 and g["bn"] <= 128
        else:
            assert g == schur_geometry(B, ni, nb, kc)


@pytest.mark.parametrize("B,ni_pad,nb,kc", [(1, 512, 512, 192), (3, 64, 40, 256),
                                            (1, 100, 1500, 48), (2, 8, 8, 1),
                                            (7, 200, 130, 400)])
def test_kernel_f_geometry_at_wide_ranks_and_fronts(B, ni_pad, nb, kc):
    """Rank caps up to 400 (low-rank with the planner's default caps) and a
    front wider than 1024 rows still find a launch that fits."""
    _check_geometry(B, ni_pad, nb, kc)


@pytest.mark.parametrize("B,ni_pad,nb,kc", [(2, 2072, 2216, 560),
                                            (1, 2168, 2216, 560)])
def test_kernel_f_geometry_at_the_3d_top_shapes(B, ni_pad, nb, kc):
    """F6: the top two compressed batches of helmholtz3d(48, k=10) at the
    default caps are few fronts (a cluster per row band is preferred) at a
    rank cap whose W a cluster cannot keep twice; the chooser goes on to
    the W form (W = Abi RU once, before the launch) instead of raising."""
    g = _check_geometry(B, ni_pad, nb, kc)
    assert g["w"] and g["cs"] == 1 and g["smem"] <= SMEM_MAX


@pytest.mark.parametrize("hss", [False, True])
def test_kernel_f_geometry_at_every_3d_launch_shape(hss):
    """Every compressed batch of helmholtz3d(48, k=10), leafmax 100, at the
    default caps (56-576) that kernel F takes gets a launch."""
    A, _, shape = ht.helmholtz3d(48, k=10.0)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 ht.SolverOptions(**COMP, hss=hss))
    shapes = [(bp.B, bp.ni_pad, bp.nb_pad, bp.rank_cap) for bp in plan.batches
              if bp.compress and not bp.structured]
    assert len(shapes) == (2 if hss else 9)
    for B, ni_pad, nb, kc in shapes:
        _check_geometry(B, ni_pad, nb, kc)


def _f_walk(front, ni_pad, RU, RV, sperm, g):
    """The kernel's partition in numpy: per CTA tile, W's band from the
    depth split over the cluster's ranks (each rank's depth in chunks of kd;
    each segment of the band summed over the ranks in order), then the tile
    started from Abb's entries; in the W form W = Abi RU for the whole
    front first (the GEMM before the launch), then each bm x bm tile
    started from Abb's entries less W's gathered rows times RV's over depth
    chunks of 32."""
    B, m, _ = front.shape
    nb = m - ni_pad
    kc = RU.shape[-1]
    bm, bn, cs, nct, kd, whole = (g[k] for k in ("bm", "bn", "cs", "nct",
                                                  "kd", "whole"))
    kq = -(-(-(-ni_pad // cs)) // 4) * 4
    S = np.full((B, nb, nb), np.nan)
    for b in range(B):
        p = sperm[b]
        Abi, Abb = front[b, ni_pad:, :ni_pad], front[b, ni_pad:, ni_pad:]
        if g.get("w"):
            W = Abi @ RU[b]
            for y in range(-(-nb // bm)):
                rows = np.arange(y * bm, min(nb, (y + 1) * bm))
                for x in range(nct):
                    cols = np.arange(x * bn, min(nb, (x + 1) * bn))
                    acc = -Abb[np.ix_(p[rows], p[cols])]
                    for k0 in range(0, kc, kd):
                        acc = acc + W[p[rows], k0:k0 + kd] \
                            @ RV[b, p[cols], k0:k0 + kd].T
                    S[b][np.ix_(rows, cols)] = -acc
            continue
        for y in range(-(-nb // bm)):
            rows = np.arange(y * bm, min(nb, (y + 1) * bm))
            for x0 in range(0, nct, cs):
                parts = []
                for r in range(cs):
                    k0, k1 = r * kq, min(ni_pad, (r + 1) * kq)
                    part = np.zeros((len(rows), kc))
                    for c0 in range(k0, k1, kd):
                        c1 = min(k1, c0 + kd)
                        part += Abi[p[rows], c0:c1] @ RU[b, c0:c1]
                    parts.append(part)
                W = sum(parts[1:], parts[0]) if cs > 1 else parts[0]
                for x in range(x0, x0 + cs):
                    j0 = 0 if whole else x * bn
                    cols = np.arange(j0, min(nb, j0 + bn))
                    if not len(cols):
                        continue
                    if whole:                # natural rows, then permuted
                        tile = Abb[p[rows]][:, p[cols]]
                    else:
                        tile = Abb[np.ix_(p[rows], p[cols])]
                    S[b][np.ix_(rows, cols)] = tile - W @ RV[b, p[cols]].T
    return S


@pytest.mark.parametrize("B,ni_pad,nb,kc,sms", [
    (3, 32, 64, 32, 132), (3, 48, 120, 16, 132),
    (2, 24, 40, 8, 132), (2, 64, 96, 32, 132),
    (1, 512, 512, 48, 132), (1, 512, 512, 48, 4),
    (2, 256, 640, 48, 132), (3, 64, 192, 33, 132),
    (3, 64, 192, 33, 4), (1, 40, 200, 1, 132),
    # odd cluster tiles; the W form (many fronts, a cap no cluster keeps)
    (5, 24, 136, 72, 132), (2, 40, 150, 70, 132), (300, 8, 140, 9, 132),
    (1, 96, 300, 410, 132)])
def test_kernel_f_partition_is_the_plain_schur_update(B, ni_pad, nb, kc, sms):
    rng = np.random.default_rng(nb + kc)
    front = rng.standard_normal((B, ni_pad + nb, ni_pad + nb))
    RU = rng.standard_normal((B, ni_pad, kc))
    RV = rng.standard_normal((B, nb, kc))
    sperm = np.stack([rng.permutation(nb) for _ in range(B)])
    g = _check_geometry(B, ni_pad, nb, kc, sms)
    got = _f_walk(front, ni_pad, RU, RV, sperm, g)
    t = torch.as_tensor
    want = lowrank_schur_update_plain(t(front), ni_pad, t(RU), t(RV),
                                      t(sperm)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


# ---------------------------------------------------------------------------
# complex128 (the damped system's low-rank levels): one band's W a CTA, the
# band's column tiles walked by nct CTAs
# ---------------------------------------------------------------------------

def _check_geometry_c128(B, ni_pad, nb, kc, sms=132):
    g = schur_geometry(B, ni_pad, nb, kc, sms=sms, itemsize=16)
    bn, nct, walk = g["bn"], g["nct"], g["walk"]
    assert g["bm"] == 32 and g["cs"] == 1 and not g["whole"]
    assert g["smem"] == schur_smem_cc(bn, g["kd"], kc, 16) <= SMEM_MAX
    assert 8 <= bn <= 64 and bn % 8 == 0
    tiles = -(-nb // bn)
    assert 1 <= nct <= tiles and nct * walk >= tiles > nct * (walk - 1)
    return g


@pytest.mark.parametrize("n", [128, 512])
def test_kernel_f_complex128_geometry_at_every_launch_shape(n):
    """Every launch shape of the low-rank plan (the damped system's is the
    same: one mesh) finds a complex128 launch, two CTAs an SM."""
    shapes = _f_shapes(n, "low-rank")
    assert shapes
    for B, ni_pad, nb, kc in shapes:
        g = _check_geometry_c128(B, ni_pad, nb, kc)
        assert g["smem"] <= SMEM_MAX // 2, (B, ni_pad, nb, kc)


def _f_walk_c128(front, ni_pad, RU, RV, sperm, g):
    """Kernel F's complex128 partition in numpy: per front and band of 32
    rows, W = Abi[p_band] RU, then the column tiles x, x + nct, ... of each
    of the band's nct CTAs; every entry of S written once."""
    B, m, _ = front.shape
    nb = m - ni_pad
    bm, bn, nct, walk = g["bm"], g["bn"], g["nct"], g["walk"]
    tiles = -(-nb // bn)
    S = np.full((B, nb, nb), np.nan + 0j)
    for b in range(B):
        p = sperm[b]
        for y in range(-(-nb // bm)):
            rows = p[y * bm:(y + 1) * bm]
            W = front[b, ni_pad + rows, :ni_pad] @ RU[b]
            for x in range(nct):
                for w in range(walk):
                    t = x + w * nct
                    if t >= tiles:
                        break
                    cols = p[t * bn:(t + 1) * bn]
                    blk = S[b, y * bm:y * bm + len(rows),
                            t * bn:t * bn + len(cols)]
                    assert np.isnan(blk).all()
                    blk[...] = front[b][np.ix_(ni_pad + rows, ni_pad + cols)] \
                        - W @ RV[b, cols].T
    return S


@pytest.mark.parametrize("B,ni_pad,nb,kc,sms", [
    (3, 32, 64, 32, 132), (2, 24, 40, 8, 132), (1, 512, 512, 48, 132),
    (4, 512, 512, 48, 132), (2, 256, 640, 48, 132), (3, 64, 192, 33, 4),
    (1, 40, 200, 100, 132)])
def test_kernel_f_complex128_partition_is_the_plain_schur_update(
        B, ni_pad, nb, kc, sms):
    rng = np.random.default_rng(nb + kc + 1)
    c = lambda *s: rng.standard_normal(s) + 1j * rng.standard_normal(s)
    front = c(B, ni_pad + nb, ni_pad + nb)
    RU, RV = c(B, ni_pad, kc), c(B, nb, kc)
    sperm = np.stack([rng.permutation(nb) for _ in range(B)])
    g = _check_geometry_c128(B, ni_pad, nb, kc, sms)
    got = _f_walk_c128(front, ni_pad, RU, RV, sperm, g)
    t = torch.as_tensor
    want = lowrank_schur_update_plain(t(front), ni_pad, t(RU), t(RV),
                                      t(sperm)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


# ---------------------------------------------------------------------------
# float32 (the JAX bench's device configuration): the CUDA-core form of the
# complex128 levels, its shared memory in 4-byte values
# ---------------------------------------------------------------------------

def _check_geometry_f32(B, ni_pad, nb, kc, sms=132):
    g = schur_geometry(B, ni_pad, nb, kc, sms=sms, itemsize=4)
    bn, nct, walk = g["bn"], g["nct"], g["walk"]
    assert g["bm"] == 32 and g["cs"] == 1 and not g["whole"]
    assert g["kd"] == 16
    assert g["smem"] == schur_smem_cc(bn, g["kd"], kc, 4) <= SMEM_MAX
    assert g["smem"] == 4 * ((kc | 1) * (32 + bn) + 16 * (32 + kc)) \
        + 4 * (32 + bn)
    assert 8 <= bn <= 64 and bn % 8 == 0
    tiles = -(-nb // bn)
    assert 1 <= nct <= tiles and nct * walk >= tiles > nct * (walk - 1)
    return g


@pytest.mark.parametrize("n", [128, 512])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_kernel_f_float32_geometry_at_every_launch_shape(n, config):
    """Every launch shape of the n=128 and n=512 plans (low-rank and both
    structured: their transition batches) finds a float32 launch in the
    CUDA-core form, the widest tile (64 columns, or the front's width) with
    two CTAs an SM: 4-byte values take a quarter of complex128's bytes, so
    no shape takes a narrower tile than complex128 would."""
    shapes = _f_shapes(n, config)
    assert shapes
    for B, ni_pad, nb, kc in shapes:
        g = _check_geometry_f32(B, ni_pad, nb, kc)
        assert g["smem"] <= SMEM_MAX // 2, (B, ni_pad, nb, kc)
        assert g["bn"] == min(64, -(-nb // 8) * 8)
        assert g["bn"] >= schur_geometry(B, ni_pad, nb, kc,
                                         itemsize=16)["bn"]


@pytest.mark.parametrize("B,ni_pad,nb,kc", [(2, 2072, 2216, 560),
                                            (1, 2168, 2216, 560),
                                            (1, 512, 512, 192)])
def test_kernel_f_float32_geometry_at_wide_ranks(B, ni_pad, nb, kc):
    """The 3D top shapes' caps of 560 fit a float32 CTA (one an SM, 32-column
    tiles) where complex128 needs narrower tiles."""
    g = _check_geometry_f32(B, ni_pad, nb, kc)
    assert g["bn"] >= 32


@pytest.mark.parametrize("B,ni_pad,nb,kc,sms", [
    (3, 32, 64, 32, 132), (1, 512, 512, 48, 132), (2, 256, 640, 48, 132),
    (3, 64, 192, 33, 4), (1, 40, 200, 100, 132)])
def test_kernel_f_float32_partition_is_the_plain_schur_update(
        B, ni_pad, nb, kc, sms):
    """The float32 launch's partition (bands of 32, W a band, nct CTAs a
    band walking its column tiles) reproduces the plain version, every
    entry once, to float32's rounding of the two products."""
    rng = np.random.default_rng(nb + kc + 2)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    front = f(B, ni_pad + nb, ni_pad + nb)
    RU, RV = f(B, ni_pad, kc), f(B, nb, kc)
    sperm = np.stack([rng.permutation(nb) for _ in range(B)])
    g = _check_geometry_f32(B, ni_pad, nb, kc, sms)
    got = _f_walk_c128(front, ni_pad, RU, RV, sperm, g)
    assert np.isfinite(got).all() and not np.iscomplexobj(got.real)
    t = torch.as_tensor
    want = lowrank_schur_update_plain(t(front), ni_pad, t(RU), t(RV),
                                      t(sperm)).numpy()
    assert want.dtype == np.float32
    assert np.abs(got.real - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# complex64 (the bench's complex device configuration): the CUDA-core form,
# its shared memory in 8-byte values; never float64's tensor-core form,
# whose values are as wide
# ---------------------------------------------------------------------------

def _check_geometry_c64(B, ni_pad, nb, kc, sms=132):
    g = schur_geometry(B, ni_pad, nb, kc, sms=sms, itemsize=8,
                       is_complex=True)
    assert g == schur_geometry_cc(B, ni_pad, nb, kc, sms, 8)
    bn, nct, walk, kd = g["bn"], g["nct"], g["walk"], g["kd"]
    assert g["bm"] == 32 and g["cs"] == 1 and not g["whole"]
    assert kd in (16, 8)
    assert g["smem"] == schur_smem_cc(bn, kd, kc, 8) <= SMEM_MAX
    assert g["smem"] == 8 * ((kc | 1) * (32 + bn) + kd * (32 + kc)) \
        + 4 * (32 + bn)
    if kd == 8:     # the depth halves only where no tile fits at 16
        assert schur_smem_cc(8, 16, kc, 8) > SMEM_MAX
    assert 8 <= bn <= 64 and bn % 8 == 0
    tiles = -(-nb // bn)
    assert 1 <= nct <= tiles and nct * walk >= tiles > nct * (walk - 1)
    return g


@pytest.mark.parametrize("n", [128, 512])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_kernel_f_complex64_geometry_at_every_launch_shape(n, config):
    """Every launch shape of the n=128 and n=512 plans (low-rank and both
    structured: their transition batches; the damped system's are the
    same) finds a complex64 launch in the CUDA-core form with two CTAs an
    SM and the widest tile (64 columns, or the front's width), never a
    narrower one than complex128's; float64 at the same shape keeps its
    tensor-core form."""
    shapes = _f_shapes(n, config)
    assert shapes
    for B, ni_pad, nb, kc in shapes:
        g = _check_geometry_c64(B, ni_pad, nb, kc)
        assert g["kd"] == 16 and g["smem"] <= SMEM_MAX // 2, \
            (B, ni_pad, nb, kc)
        assert g["bn"] == min(64, -(-nb // 8) * 8)
        assert g["bn"] >= schur_geometry(B, ni_pad, nb, kc,
                                         itemsize=16)["bn"]
        assert "walk" not in schur_geometry(B, ni_pad, nb, kc)


@pytest.mark.parametrize("B,ni_pad,nb,kc,sms", [
    (3, 32, 64, 32, 132), (1, 512, 512, 48, 132), (2, 256, 640, 48, 132),
    (3, 64, 192, 33, 4), (1, 40, 200, 100, 132)])
def test_kernel_f_complex64_partition_is_the_plain_schur_update(
        B, ni_pad, nb, kc, sms):
    """The complex64 launch's partition (bands of 32, W a band, nct CTAs a
    band walking its column tiles) reproduces the plain version, every
    entry once, to complex64's rounding of the two products."""
    rng = np.random.default_rng(nb + kc + 3)
    f = lambda *s: (rng.standard_normal(s)
                    + 1j * rng.standard_normal(s)).astype(np.complex64)
    front = f(B, ni_pad + nb, ni_pad + nb)
    RU, RV = f(B, ni_pad, kc), f(B, nb, kc)
    sperm = np.stack([rng.permutation(nb) for _ in range(B)])
    g = _check_geometry_c64(B, ni_pad, nb, kc, sms)
    got = _f_walk_c128(front, ni_pad, RU, RV, sperm, g)
    assert np.isfinite(got).all()
    t = torch.as_tensor
    want = lowrank_schur_update_plain(t(front), ni_pad, t(RU), t(RV),
                                      t(sperm)).numpy()
    assert want.dtype == np.complex64
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("B,ni_pad,nb,kc", [(2, 2072, 2216, 560),
                                            (1, 2168, 2216, 560)])
def test_kernel_f_complex64_geometry_at_the_3d_caps(B, ni_pad, nb, kc):
    """At the 3D top shapes' caps of 560 no complex64 tile fits a depth
    chunk of 16 (W and RV's rows alone take 179,520 bytes at 8-column
    tiles): the chunk halves to 8 and 8-column tiles fit one CTA an SM,
    where complex128 finds no launch; float32 keeps its chunk of 16."""
    g = _check_geometry_c64(B, ni_pad, nb, kc)
    assert g["kd"] == 8 and g["bn"] == 8
    assert schur_geometry(B, ni_pad, nb, kc, itemsize=4)["kd"] == 16
    with pytest.raises(ValueError, match="no launch fits"):
        schur_geometry(B, ni_pad, nb, kc, itemsize=16)


def _3d_shapes(hss):
    A, _, shape = ht.helmholtz3d(48, k=10.0)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 ht.SolverOptions(**COMP, hss=hss))
    return [(bp.B, bp.ni_pad, bp.nb_pad, bp.rank_cap) for bp in plan.batches
            if bp.compress and not bp.structured]


@pytest.mark.parametrize("plan", ["128 low-rank", "128 structured kest=32",
                                  "128 structured default caps",
                                  "512 low-rank", "512 structured kest=32",
                                  "512 structured default caps",
                                  "48^3 low-rank", "48^3 structured"])
def test_kernel_f_float64_computes_each_band_w_once(plan):
    """At every compressed launch shape of the n=128 / 512 and 48^3 plans
    (low-rank and structured), the chosen float64 form computes each row
    band's W = Abi[p_band] RU once: whole rows (one CTA a band), one
    thread block cluster a band (its CTAs split the depth and sum W once),
    or the W form (one batched GEMM before the launch); none recomputes it
    per column tile.  At 48^3's nine low-rank launches (caps 56-560) every
    one takes the W form."""
    n, config = plan.split(" ", 1)
    if n == "48^3":
        shapes = _3d_shapes(config == "structured")
    else:
        shapes = _f_shapes(int(n), config)
    assert shapes
    forms = []
    for B, ni_pad, nb, kc in shapes:
        g = _check_geometry(B, ni_pad, nb, kc)
        assert g["w"] or g["nct"] == g["cs"]
        forms.append("w" if g["w"] else "whole" if g["whole"] else
                     "cluster")
    if plan == "48^3 low-rank":
        assert forms == ["w"] * 9
