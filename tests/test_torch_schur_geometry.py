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
from hsolve_torch.ops.schur import (F_MAX_CLUSTER, F_MAX_KD, F_WHOLE_MAX,
                                    SMEM_MAX, lowrank_schur_update_plain,
                                    schur_geometry, schur_smem)

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
    assert g["smem"] == schur_smem(bm, bn, cs, kd, kc, g["whole"], nb) \
        <= SMEM_MAX
    # a rank's depth in chunks of kd (one where it is at most 64)
    assert 16 <= kd <= F_MAX_KD and kd % 16 == 0
    assert kd >= min(F_MAX_KD, -(-ni_pad // cs)) or kc > 64
    assert 16 <= bm <= 64 and bm % 16 == 0 and bn % 8 == 0
    assert bn <= 32 * (8 // (bm // 16))         # the warps' column blocks
    assert 1 <= cs <= F_MAX_CLUSTER and nct % cs == 0
    if g["whole"]:
        assert cs == nct == 1 and bn >= nb
    else:
        assert nct * bn >= nb and (nct - cs) * bn < nb   # no spare cluster
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
            assert g["cs"] == 1 and g["bn"] <= 64


def test_kernel_f_geometry_on_the_n512_low_rank_plan():
    """The n=512 low-rank plan's eleven launches, as PERF.md reads them."""
    got = [(B, nb, kc) + tuple(schur_geometry(B, ni, nb, kc)[k] for k in
                               ("bm", "bn", "cs", "nct", "kd", "whole"))
           for B, ni, nb, kc in _f_shapes(512, "low-rank")]
    assert got == [
        (1023, 64, 32, 64, 64, 1, 1, 32, True),
        (512, 96, 32, 32, 96, 1, 1, 32, True),
        (256, 128, 48, 32, 128, 1, 1, 64, True),
        (128, 192, 48, 32, 64, 1, 3, 64, False),
        (64, 256, 48, 32, 64, 1, 4, 64, False),
        (32, 384, 48, 32, 64, 1, 6, 64, False),
        (16, 512, 48, 32, 64, 8, 8, 32, False),
        (8, 640, 48, 32, 80, 8, 8, 32, False),
        (4, 512, 48, 16, 64, 8, 8, 64, False),
        (2, 512, 48, 16, 64, 8, 8, 64, False),
        (1, 512, 48, 16, 64, 8, 8, 64, False)]
    # on a card of 4 SMs the top levels take tiles without a cluster; the
    # whole-row levels do not depend on the card
    for B, ni, nb, kc in _f_shapes(512, "low-rank"):
        g = _check_geometry(B, ni, nb, kc, sms=4)
        if nb > F_WHOLE_MAX:
            assert g["cs"] == 1 and g["bn"] <= 64
        else:
            assert g == schur_geometry(B, ni, nb, kc)


@pytest.mark.parametrize("B,ni_pad,nb,kc", [(1, 512, 512, 192), (3, 64, 40, 256),
                                            (1, 100, 1500, 48), (2, 8, 8, 1),
                                            (7, 200, 130, 400)])
def test_kernel_f_geometry_at_wide_ranks_and_fronts(B, ni_pad, nb, kc):
    """Rank caps up to 400 (low-rank with the planner's default caps) and a
    front wider than 1024 rows still find a launch that fits."""
    _check_geometry(B, ni_pad, nb, kc)


def _f_walk(front, ni_pad, RU, RV, sperm, g):
    """The kernel's partition in numpy: per CTA tile, W's band from the
    depth split over the cluster's ranks (each rank's depth in chunks of kd;
    each segment of the band summed over the ranks in order), then the tile
    started from Abb's entries."""
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
    (3, 64, 192, 33, 4), (1, 40, 200, 1, 132)])
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
