"""The port's CUDA kernels on the card, at edge cases the main path does not
reach (several right-hand sides, sentinel ids, narrow child stacks, ragged
tiles, cap padding, argmax ties, shared memory above 48 KB, boundary ids
repeated across fronts, a front spread over a thread block cluster, rows not
16-byte aligned, a cooperative grid the card cannot hold), kernels A-D in
float32, the Arnoldi kernels L and M in both types and the Arnoldi step as
one launch of both, kernel F's geometries, kernels C, E, F and G at the 3D
plans' shapes, and the exact,
compressed, structured (HSS) and mixed-precision slices end to end on
``cuda``.

Marked ``cuda``: each test skips without an NVIDIA GPU.  The machine with the
card has no JAX, which ``tests/conftest.py`` imports, so run these there with

    python -m pytest --noconftest -p no:cacheprovider \
        -W ignore::pytest.PytestUnknownMarkWarning tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import hsolve_torch as ht
from hsolve_torch import kernels
from hsolve_torch.ops import arnoldi as AR
from hsolve_torch.ops.assembly import (extend_add, extend_add_plain,
                                       front_assemble, front_assemble_plain)
from hsolve_torch.ops import hss as H
from hsolve_torch.ops.lowrank import (cpqr_pivots, cpqr_pivots_plain,
                                      lowrank_truncate, lowrank_truncate_plain)
from hsolve_torch.ops.schur import (lowrank_schur_update,
                                    lowrank_schur_update_plain,
                                    schur_geometry)
from hsolve_torch.ops.sparse import dia_spmv, dia_spmv_plain
from hsolve_torch.factor import DenseLevel
from hsolve_torch.ops import dense as dk
from hsolve_torch.ops.sweep import (level_forward, level_forward_plain,
                                    lowrank_sweep_update,
                                    lowrank_sweep_update_plain, sweep_update,
                                    sweep_update_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def test_front_assemble_kernel(dev):
    rng = np.random.default_rng(0)
    B, m = 3, 20
    pos = rng.permutation(B * m * m)[:500].astype(np.int32)
    src = rng.integers(-1, 300, size=500).astype(np.int32)
    adata = torch.as_tensor(rng.standard_normal(300), device=dev)
    args = (B, m, torch.as_tensor(pos, device=dev),
            torch.as_tensor(src, device=dev), adata)
    before = front_assemble.launches
    assert torch.equal(front_assemble(*args), front_assemble_plain(*args))
    assert front_assemble.launches == before + 1


def test_extend_add_kernel_narrow_and_wide_sources(dev):
    rng = np.random.default_rng(1)
    B, m, s_pad = 6, 24, 16
    front = torch.as_tensor(rng.standard_normal((B, m, m)), device=dev)
    imap = torch.as_tensor(rng.integers(-1, s_pad, size=(B, m)).astype(np.int32),
                           device=dev)
    for w, src_rows, dst_rows in ((10, [2, 0, 1], [5, 1, 3]), (20, [0], [2])):
        S = torch.as_tensor(rng.standard_normal((3, w, w)), device=dev)
        sr = torch.tensor(src_rows, dtype=torch.int32, device=dev)
        dr = torch.tensor(dst_rows, dtype=torch.int32, device=dev)
        got = extend_add(front.clone(), S, sr, dr, imap)
        want = extend_add_plain(front.clone(), S, sr, dr, imap)
        assert torch.equal(got, want)


def _hand_level(dev, dtype, B, ni, nb, N, seed, shared_bnd=False):
    """A dense level record made by hand: well-conditioned pivot blocks (LU
    with pivoting), random Gauss transforms, disjoint int ids, the last two
    int and three bnd ids of every front the sentinel N; ``shared_bnd``: every
    front has the same bnd ids (the forward step's atomics then collide)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N)
    int_ids = perm[: B * ni].reshape(B, ni).astype(np.int32)
    rest = perm[B * ni:]
    bnd = np.tile(rest[:nb], (B, 1)) if shared_bnd else \
        rest[: B * nb].reshape(B, nb)
    bnd = bnd.astype(np.int32)
    int_ids[:, -2:] = N
    bnd[:, -3:] = N
    D = torch.as_tensor(rng.standard_normal((B, ni, ni)) / np.sqrt(ni)
                        + 2.0 * np.eye(ni), dtype=dtype, device=dev)
    lu, piv = dk.lu_factor(D)
    t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=dev)
    return DenseLevel(lu=lu, perm=piv, L=t(rng.standard_normal((B, nb, ni))),
                      R=t(rng.standard_normal((B, ni, nb))),
                      int_ids=t(int_ids, torch.int32),
                      bnd_ids=t(bnd, torch.int32))


def _level_steps_agree(dev, lev, N, k, tol, seed=0):
    """Kernel C's forward step (lu and dinv records) and backward step
    against their plain versions on one level, one launch each; the forward
    step's interior rows (the solve) relative to max |x'| over them, its
    boundary rows (C[bnd] -= L x) relative to their own largest value."""
    rng = np.random.default_rng(seed)
    C = torch.as_tensor(rng.standard_normal((N + 1, k)), dtype=lev.L.dtype,
                        device=dev)
    C[N] = 0.0
    inv = dataclasses.replace(lev, lu=None, perm=None, dinv=dk.lu_inverse(
        lev.lu, lev.perm).contiguous())
    rows = lev.int_ids[lev.int_ids < N].long()
    bnd = lev.bnd_ids[lev.bnd_ids < N].long()
    for rec in (lev, inv):
        before = level_forward.launches
        got = level_forward(C.clone(), rec, N)
        assert level_forward.launches == before + 1
        want = level_forward_plain(C.clone(), rec, N)
        assert _rel(got[rows], want[rows]) < tol
        assert _rel(got[bnd], want[bnd]) < tol
        assert _rel(got, want) < tol
        assert float(got[N].abs().max()) == 0.0
    before = sweep_update.launches
    got = sweep_update(C.clone(), lev.int_ids, lev.R, N, ids_in=lev.bnd_ids)
    assert sweep_update.launches == before + 1
    want = sweep_update_plain(C.clone(), lev.int_ids, lev.R, N,
                              ids_in=lev.bnd_ids)
    assert _rel(got, want) < tol
    assert float(got[N].abs().max()) == 0.0


@pytest.mark.parametrize("k", [1, 3, 6])
def test_sweep_update_kernel_with_sentinels(dev, k):
    """Both steps of kernel C on a hand-made level with sentinel ids, rows
    that are not 16-byte aligned (ni = 9, nb = 13: scalar loads), several
    right-hand sides (k = 6: two chunks of four)."""
    lev = _hand_level(dev, torch.float64, B=7, ni=9, nb=13, N=500, seed=2 + k)
    _level_steps_agree(dev, lev, 500, k, 1e-12, seed=k)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("ni,nb", [(1024, 64), (1000, 40), (1800, 24),
                                   (256, 96)])
def test_level_steps_on_a_wide_front(dev, dtype, tol, ni, nb):
    """One front of ni_pad 1024 (a cluster of 4 CTAs), 1000 (4 CTAs, a
    partial last panel), 1800 (a cluster of 8, 57 panels) and 256 (one CTA
    of 8 panel warps) against the plain versions."""
    lev = _hand_level(dev, dtype, B=1, ni=ni, nb=nb, N=3000, seed=ni)
    _level_steps_agree(dev, lev, 3000, 1, tol)
    _level_steps_agree(dev, lev, 3000, 3, tol, seed=1)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("B,ni,nb", [(2, 2080, 40), (1, 4424, 24)])
def test_level_forward_in_windows_above_2048_rows(dev, dtype, tol, B, ni, nb):
    """Fronts wider than one cluster's 2048 rows: two fronts of 2080 (two
    windows) and the 4424-row top front of helmholtz3d(48) exact (three
    windows, the last of 328 rows) against the plain versions, one wrapper
    call each."""
    N = B * (ni + nb) + 50
    lev = _hand_level(dev, dtype, B=B, ni=ni, nb=nb, N=N, seed=ni)
    _level_steps_agree(dev, lev, N, 1, tol)
    _level_steps_agree(dev, lev, N, 2, tol, seed=1)


def test_level_forward_in_windows_above_20600_rows(dev):
    """A float64 front of 20,608 rows (11 windows), whose solved values no
    longer fit one CTA's shared memory: each window keeps only its own."""
    N = 20608 + 24 + 50
    lev = _hand_level(dev, torch.float64, B=1, ni=20608, nb=24, N=N, seed=5)
    _level_steps_agree(dev, lev, N, 1, 1e-12)


def test_level_forward_with_boundary_ids_shared_by_fronts(dev):
    """The atomics' case: every front adds into the same boundary rows."""
    lev = _hand_level(dev, torch.float64, B=40, ni=24, nb=16, N=2000, seed=9,
                      shared_bnd=True)
    _level_steps_agree(dev, lev, 2000, 2, 1e-12)


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_level_steps_on_a_small_plan(dev, dtype, tol, explicit):
    """Every level of a real factorization on the card: the forward step
    with its lu or dinv record and the backward step, one launch each."""
    A, b, shape = ht.helmholtz2d(48, k=20.0)
    tree = ht.nested_dissection(shape, leafmax=40)
    F = ht.factor(A, tree, swlevel=0, dtype=dtype, device=dev,
                  explicit_inverse=explicit)
    N = F.N
    rng = np.random.default_rng(5)
    for lev in F.levels:
        assert (lev.dinv is not None) == explicit
        C = torch.as_tensor(rng.standard_normal((N + 1, 2)), dtype=dtype,
                            device=dev)
        C[N] = 0.0
        assert _rel(level_forward(C.clone(), lev, N),
                    level_forward_plain(C.clone(), lev, N)) < tol
        assert _rel(sweep_update(C.clone(), lev.int_ids, lev.R, N,
                                 ids_in=lev.bnd_ids),
                    sweep_update_plain(C.clone(), lev.int_ids, lev.R, N,
                                       ids_in=lev.bnd_ids)) < tol


@pytest.mark.parametrize("k", [1, 3])
def test_dia_spmv_kernel(dev, k):
    A, _, _ = ht.helmholtz2d(33, k=10.0)
    op = ht.to_dia(A, device=dev)
    rng = np.random.default_rng(k)
    x = torch.as_tensor(rng.standard_normal((A.shape[0], k)), device=dev)
    b = torch.as_tensor(rng.standard_normal((A.shape[0], k)), device=dev)
    assert _rel(dia_spmv(op, x), dia_spmv_plain(op, x)) < 1e-13
    assert _rel(dia_spmv(op, x, b), dia_spmv_plain(op, x, b)) < 1e-13
    np.testing.assert_allclose(dia_spmv(op, x).cpu().numpy(),
                               A @ x.cpu().numpy(), rtol=1e-12, atol=1e-12)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    A, _, _ = ht.helmholtz2d(17, k=8.0)
    op = ht.to_dia(A, device=dev)
    op32 = ht.to_dia(A, dtype=np.float32, device=dev)
    with pytest.raises(TypeError, match="one type per call"):
        dia_spmv(op32, torch.zeros(A.shape[0], 1, dtype=torch.float64,
                                   device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv(op, torch.zeros(2, A.shape[0], dtype=torch.float64,
                                 device=dev).T[:, :1].expand(-1, 2))
    with pytest.raises(ValueError, match="several devices"):
        dia_spmv(op, torch.zeros(A.shape[0], 1, dtype=torch.float64))


@pytest.mark.parametrize("explicit", [False, True])
def test_slice_on_cuda(dev, explicit):
    A, b, shape = ht.helmholtz2d(48, k=20.0)
    tree = ht.nested_dissection(shape, leafmax=40)
    kernels.reset_launch_counts()
    F = ht.factor(A, tree, swlevel=0, device=dev, explicit_inverse=explicit)
    x_ref = spla.spsolve(A.tocsc(), b)
    x = F.solve(b).cpu().numpy()
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-10
    X = F.solve(np.column_stack([b, 2 * b])).cpu().numpy()
    assert np.abs(X[:, 1] - 2 * X[:, 0]).max() < 1e-10 * np.abs(X).max()
    from hsolve_torch.factor import solve_with_data

    op, mv = ht.spmv_format(A, device=dev)
    xg, info = ht.gmres_compiled(mv, solve_with_data,
                                 torch.as_tensor(b, device=dev), reltol=1e-9,
                                 restart=30, maxiter=60, mv_data=op,
                                 M_data=F.solve_data)
    assert info["converged"] and info["iters"] == 1
    xg = xg.cpu().numpy()
    assert np.linalg.norm(A @ xg - b) / np.linalg.norm(b) < 1e-9
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in kernels.EXACT_PATH), counts


@pytest.mark.parametrize("k,kc", [(1, 24), (3, 48), (2, 300)])
def test_lowrank_sweep_update_kernel_with_sentinels(dev, k, kc):
    """Kernel E at ranks below and above the block width, several
    right-hand sides, sentinel output and input ids."""
    rng = np.random.default_rng(30 + k)
    N, B, R, Cc = 2000, 5, 40, 56
    C = torch.as_tensor(rng.standard_normal((N + 1, k)), device=dev)
    C[N] = 0.0
    perm = rng.permutation(N)
    ids_out = perm[: B * R].reshape(B, R).astype(np.int32)
    ids_in = perm[B * R: B * R + B * Cc].reshape(B, Cc).astype(np.int32)
    ids_out[:, -3:] = N
    ids_in[:, -5:] = N
    ids_out = torch.as_tensor(ids_out, device=dev)
    ids_in = torch.as_tensor(ids_in, device=dev)
    U = torch.as_tensor(rng.standard_normal((B, R, kc)), device=dev)
    V = torch.as_tensor(rng.standard_normal((B, Cc, kc)), device=dev)
    X = torch.as_tensor(rng.standard_normal((B, Cc, k)), device=dev)
    for kw in ({"X": X}, {"ids_in": ids_in}):
        before = lowrank_sweep_update.launches
        got = lowrank_sweep_update(C.clone(), ids_out, U, V, N, **kw)
        want = lowrank_sweep_update_plain(C.clone(), ids_out, U, V, N, **kw)
        assert lowrank_sweep_update.launches == before + 1
        assert _rel(got, want) < 1e-13
        assert float(got[N].abs().max()) == 0.0


def _sweep_operands(dev, rng, B, R, Cc, kc, k, N, U_offset=0):
    """Kernel E's operands with sentinel output and input ids; ``U_offset``
    shifts U by that many doubles inside its buffer (not 16-byte aligned)."""
    C = torch.as_tensor(rng.standard_normal((N + 1, k)), device=dev)
    C[N] = 0.0
    perm = rng.permutation(N)
    ids_out = perm[: B * R].reshape(B, R).astype(np.int32)
    ids_in = perm[B * R: B * R + B * Cc].reshape(B, Cc).astype(np.int32)
    ids_out[:, -3:] = N
    ids_in[:, -5:] = N
    buf = torch.as_tensor(rng.standard_normal(B * R * kc + U_offset),
                          device=dev)
    U = buf[U_offset:].view(B, R, kc)
    V = torch.as_tensor(rng.standard_normal((B, Cc, kc)), device=dev)
    X = torch.as_tensor(rng.standard_normal((B, Cc, k)), device=dev)
    return (C, torch.as_tensor(ids_out, device=dev), U, V,
            {"X": X}, {"ids_in": torch.as_tensor(ids_in, device=dev)})


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("kc", [48, 192, 47])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_lowrank_sweep_update_kernel_at_the_top_shapes(dev, B, kc, k):
    """Kernel E at the top compressed levels' shapes (R = Cc = 512: a front
    spread over a thread block cluster, its partial products summed through
    distributed shared memory), both forms, with sentinels; an odd rank
    reads V and U 8 bytes at a time."""
    rng = np.random.default_rng(100 + B + kc + k)
    N = B * 1024 + 50
    C, ids_out, U, V, fwd, bwd = _sweep_operands(dev, rng, B, 512, 512, kc, k,
                                                 N)
    for kw in (fwd, bwd):
        before = lowrank_sweep_update.launches
        got = lowrank_sweep_update(C.clone(), ids_out, U, V, N, **kw)
        want = lowrank_sweep_update_plain(C.clone(), ids_out, U, V, N, **kw)
        assert lowrank_sweep_update.launches == before + 1
        assert _rel(got, want) < 1e-13
        assert float(got[N].abs().max()) == 0.0


@pytest.mark.parametrize("B,R,Cc,kc,k", [(3, 100, 70, 48, 1),
                                         (200, 40, 30, 32, 5),
                                         (1, 512, 512, 400, 1)])
def test_lowrank_sweep_update_kernel_unaligned_rows(dev, B, R, Cc, kc, k):
    """U not 16-byte aligned in its buffer: the kernel reads 8 bytes at a
    time (``lowrank_sweep_geometry``'s ``vec``)."""
    rng = np.random.default_rng(B + R)
    N = B * (R + Cc) + 10
    C, ids_out, U, V, fwd, bwd = _sweep_operands(dev, rng, B, R, Cc, kc, k, N,
                                                 U_offset=1)
    assert U.data_ptr() % 16 == 8
    for kw in (fwd, bwd):
        got = lowrank_sweep_update(C.clone(), ids_out, U, V, N, **kw)
        want = lowrank_sweep_update_plain(C.clone(), ids_out, U, V, N, **kw)
        assert _rel(got, want) < 1e-13


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_extend_add_kernel_bitwise_on_the_n128_plan(dev, dtype):
    """Kernel B at every launch of the n=128 exact factor, with the plan's
    valid-row counts and with the wrapper's own: bitwise its plain
    version."""
    from hsolve_torch.factor import _factor_levels
    from hsolve_torch.interop import plan_to_torch

    A, _, shape = ht.helmholtz2d(128, k=40.0)
    opts = ht.SolverOptions(swlevel=0)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=100),
                                 opts)
    tp = plan_to_torch(plan, dev)
    _, _, stacks = _factor_levels(plan, tp, opts, dtype)
    adata = tp.adata.to(dtype)
    launches = 0
    for bp, tb in zip(plan.batches, tp.batches):
        for groups, counts, imap in ((tb.groups_l, tb.rows_l, tb.map_l),
                                     (tb.groups_r, tb.rows_r, tb.map_r)):
            for (src, sr, dr), rows in zip(groups, counts):
                base = front_assemble_plain(bp.B, bp.m_pad, tb.pos, tb.src,
                                            adata)
                want = extend_add_plain(base.clone(), stacks[src], sr, dr, imap)
                for r in (rows, None):
                    got = extend_add(base.clone(), stacks[src], sr, dr, imap, r)
                    assert torch.equal(got, want)
                launches += 1
    assert launches == 21


@pytest.mark.parametrize("rows", [None, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_extend_add_kernel_on_a_general_map(dev, dtype, rows):
    """A map with negative entries, entries >= w, repeats and no runs, an odd
    front width (rows not 16-byte aligned), and valid-row counts below the
    true one (the CTAs stride over the tiles): bitwise the plain version."""
    rng = np.random.default_rng(11)
    B, m, w, G = 9, 301, 120, 5
    t = lambda a: torch.as_tensor(a, device=dev)
    front = t(rng.standard_normal((B, m, m))).to(dtype)
    S = t(rng.standard_normal((4, w, w))).to(dtype)
    imap = rng.integers(-3, w + 4, size=(B, m)).astype(np.int32)
    imap[2, :40] = 5
    imap[4, 100:220] = np.arange(120)            # one run, then the rest
    src_rows = t(rng.integers(0, 4, size=G).astype(np.int32))
    dst_rows = t(np.array([4, 2, 7, 0, 5], dtype=np.int32))
    imap = t(imap)
    got = extend_add(front.clone(), S, src_rows, dst_rows, imap, rows)
    want = extend_add_plain(front.clone(), S, src_rows, dst_rows, imap)
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,ni_pad,nb,kc", [
    (7, 16, 40, 24), (1, 64, 96, 70), (3, 24, 52, 33), (2, 32, 64, 1),
    (1, 512, 512, 48), (2, 256, 640, 48), (3, 64, 192, 8), (1, 100, 1500, 48),
    (2, 40, 130, 200)])
def test_lowrank_schur_update_kernel(dev, monkeypatch, B, ni_pad, nb, kc):
    """Kernel F, both products in one launch: whole rows (nb up to 128) and
    a row band's cluster with the depth split over its ranks (the top
    levels' 512 and 640, a front wider than 1024 rows), ragged tiles, odd
    widths (8-byte copies), a rank cap of 1, above one 64-column group of W
    (200) and above 32; then as on a card of 4 SMs, where the wide shapes
    take tiles without a cluster."""
    rng = np.random.default_rng(nb + kc)
    m = ni_pad + nb
    front = torch.as_tensor(rng.standard_normal((B, m, m)), device=dev)
    RU = torch.as_tensor(rng.standard_normal((B, ni_pad, kc)), device=dev)
    RV = torch.as_tensor(rng.standard_normal((B, nb, kc)), device=dev)
    sperm = torch.as_tensor(np.stack([rng.permutation(nb) for _ in range(B)]),
                            device=dev)
    before = lowrank_schur_update.launches
    got = lowrank_schur_update(front, ni_pad, RU, RV, sperm)
    torch.cuda.synchronize()
    assert lowrank_schur_update.launches == before + 1
    want = lowrank_schur_update_plain(front, ni_pad, RU, RV, sperm)
    assert _rel(got, want) < 1e-13
    g = schur_geometry(B, ni_pad, nb, kc, sms=4)
    assert g["cs"] == 1 or g["whole"]
    monkeypatch.setattr(kernels, "sm_count", lambda device: 4)
    got2 = lowrank_schur_update(front, ni_pad, RU, RV, sperm)
    torch.cuda.synchronize()
    assert _rel(got2, want) < 1e-13


@pytest.mark.parametrize("B,ni_pad,nb,kc", [(2, 2072, 2216, 560),
                                            (1, 2168, 2216, 560),
                                            (4, 1064, 2168, 544)])
def test_lowrank_schur_update_kernel_at_the_3d_top_shapes(dev, B, ni_pad, nb,
                                                           kc):
    """F6: kernel F at helmholtz3d(48, k=10)'s top compressed batches at the
    default caps, where no cluster form fits a CTA and the chooser takes one
    CTA a row band; within 1e-13 of its plain version."""
    rng = np.random.default_rng(nb + kc + B)
    m = ni_pad + nb
    front = torch.as_tensor(rng.standard_normal((B, m, m)), device=dev)
    RU = torch.as_tensor(rng.standard_normal((B, ni_pad, kc)), device=dev)
    RV = torch.as_tensor(rng.standard_normal((B, nb, kc)), device=dev)
    sperm = torch.as_tensor(np.stack([rng.permutation(nb) for _ in range(B)]),
                            device=dev)
    assert schur_geometry(B, ni_pad, nb, kc)["cs"] == 1
    before = lowrank_schur_update.launches
    got = lowrank_schur_update(front, ni_pad, RU, RV, sperm)
    torch.cuda.synchronize()
    assert lowrank_schur_update.launches == before + 1
    want = lowrank_schur_update_plain(front, ni_pad, RU, RV, sperm)
    assert _rel(got, want) < 1e-13


@pytest.mark.parametrize("B,R,Cc,kc", [(1, 2216, 2168, 560), (2, 2072, 2216, 560),
                                       (255, 56, 272, 56)])
@pytest.mark.parametrize("k", [1, 3])
def test_lowrank_sweep_update_kernel_at_the_3d_shapes(dev, B, R, Cc, kc, k):
    """Kernel E at helmholtz3d(48, k=10)'s low-rank shapes (the top fronts at
    cap 560, the 255 fronts at cap 56), both forms, with sentinels."""
    rng = np.random.default_rng(B + R + kc + k)
    N = B * (R + Cc) + 50
    C, ids_out, U, V, fwd, bwd = _sweep_operands(dev, rng, B, R, Cc, kc, k, N)
    for kw in (fwd, bwd):
        got = lowrank_sweep_update(C.clone(), ids_out, U, V, N, **kw)
        want = lowrank_sweep_update_plain(C.clone(), ids_out, U, V, N, **kw)
        assert _rel(got, want) < 1e-13
        assert float(got[N].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("B,ni,nb", [(2, 3912, 3976), (12, 1800, 2936)])
def test_sweep_update_kernel_at_the_3d_shapes(dev, dtype, tol, B, ni, nb):
    """Kernel C's backward step at helmholtz3d(64, k=10)'s exact shapes
    (nb_pad in the thousands with ni_pad in the thousands)."""
    rng = np.random.default_rng(ni + nb)
    N = B * (ni + nb) + 10
    perm = rng.permutation(N)
    int_ids = torch.as_tensor(perm[:B * ni].reshape(B, ni).astype(np.int32),
                              device=dev)
    bnd = torch.as_tensor(perm[B * ni:B * (ni + nb)].reshape(B, nb).astype(
        np.int32), device=dev)
    R = torch.as_tensor(rng.standard_normal((B, ni, nb)), dtype=dtype,
                        device=dev)
    C = torch.as_tensor(rng.standard_normal((N + 1, 1)), dtype=dtype,
                        device=dev)
    C[N] = 0.0
    got = sweep_update(C.clone(), int_ids, R, N, ids_in=bnd)
    want = sweep_update_plain(C.clone(), int_ids, R, N, ids_in=bnd)
    assert _rel(got, want) < tol
    assert float(got[N].abs().max()) == 0.0


@pytest.mark.parametrize("m,n,s,r,cap", [(40, 64, 40, 40, 32),
                                         (24, 20, 14, 12, 16),
                                         (130, 70, 72, 72, 64),
                                         (2216, 2072, 568, 568, 560)])
def test_lowrank_truncate_kernel(dev, m, n, s, r, cap):
    """Kernel G against its plain version, with and without cap padding
    (cap > r), with atol or rtol deciding the rank, up to the 48^3 plan's
    top shape: the rank and V bit for bit, U (the product Q @ Uw summed in
    another order) to 1e-13 of its largest entry."""
    rng = np.random.default_rng(m + n)
    B = 9 if m < 1000 else 2
    Q = torch.as_tensor(rng.standard_normal((B, m, s)), device=dev)
    Uw = torch.as_tensor(rng.standard_normal((B, s, r)), device=dev)
    Vh = torch.as_tensor(rng.standard_normal((B, r, n)), device=dev)
    sv = np.sort(np.abs(rng.standard_normal((B, r))) * 0.5 ** (
        np.arange(r) * 8.0 / r), axis=-1)[:, ::-1].copy()
    sv = torch.as_tensor(sv, device=dev)
    for atol, rtol in ((1e-3, 1e-2), (1e-1, 0.0), (0.0, 1e-9)):
        got = lowrank_truncate(Q, Uw, sv, Vh, atol, rtol, cap)
        want = lowrank_truncate_plain(Q, Uw, sv, Vh, atol, rtol, cap)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
        assert _rel(got[0], want[0]) <= 1e-13
        k = int(got[2].max())
        assert float(got[0][..., k:].abs().sum()) == 0.0


def test_compressed_slice_on_cuda(dev):
    """The low-rank compressed path on the card: it converges in a few GMRES
    iterations without saturating a cap, through all seven kernels."""
    from hsolve_torch.factor import solve_with_data

    A, b, shape = ht.helmholtz2d(64, k=20.0)
    tree = ht.nested_dissection(shape, leafmax=40)
    kernels.reset_launch_counts()
    F = ht.factor(A, tree, swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3,
                  kest=32, hss=False, device=dev)
    op, mv = ht.spmv_format(A, device=dev)
    xg, info = ht.gmres_compiled(mv, solve_with_data,
                                 torch.as_tensor(b, device=dev), reltol=1e-9,
                                 restart=30, maxiter=60, mv_data=op,
                                 M_data=F.solve_data)
    assert info["converged"] and info["iters"] <= 12
    xg = xg.cpu().numpy()
    assert np.linalg.norm(A @ xg - b) / np.linalg.norm(b) < 1e-9
    assert F.maxrank() > 0 and not F.rank_report()["saturated"]
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in kernels.COMPRESSED_PATH), counts


@pytest.mark.parametrize("m,n,k", [(58, 32, 32), (58, 96, 48), (92, 64, 48),
                                   (160, 96, 48), (7, 20, 7)])
def test_cpqr_kernel_selects_the_plain_pivots(dev, m, n, k):
    """Kernel H gives the plain pivots and ranks on decaying spectra, with an
    exact tie (a repeated column: the first one wins) and an all-zero matrix;
    (160, 96) needs more than 48 KB of shared memory."""
    rng = np.random.default_rng(m * n)
    B = 6
    A = rng.standard_normal((B, m, n)) * 0.7 ** np.arange(n)
    A[1, :, 5] = A[1, :, 2]
    A[2] = 0.0
    A = torch.as_tensor(A, device=dev)
    for atol, rtol in ((1e-6, 1e-6), (0.0, 1e-12), (1e-2, 0.0)):
        before = cpqr_pivots.launches
        piv, rank = cpqr_pivots(A, atol, rtol, k)
        assert cpqr_pivots.launches == before + 1
        ppiv, prank = cpqr_pivots_plain(A, atol, rtol, k)
        assert torch.equal(rank, prank) and torch.equal(piv, ppiv)
        if atol > 0:             # with atol = 0 the 1e-300 floor passes
            assert int(rank[2]) == 0


@pytest.mark.parametrize("m,n,k", [(202, 384, 192), (394, 768, 384)])
def test_cpqr_kernel_on_the_default_caps_panels(dev, m, n, k):
    """Kernel H on the largest panel of the default n=512 plan ([202, 384]:
    a cluster of 4 CTAs) and of its first adaptive replan ([394, 768]: a
    cluster of 8 with the columns in global memory): the plain pivots and
    ranks."""
    from hsolve_torch.ops.lowrank import cpqr_cluster

    assert cpqr_cluster(m, n)[0] > 1
    rng = np.random.default_rng(m)
    A = rng.standard_normal((5, m, n)) * 0.97 ** np.arange(n)
    A[1, :, 7] = A[1, :, 3]
    A = torch.as_tensor(A, device=dev)
    for tol in (1e-3, 1e-9):
        piv, rank = cpqr_pivots(A, tol, tol, k)
        ppiv, prank = cpqr_pivots_plain(A, tol, tol, k)
        assert torch.equal(rank, prank) and torch.equal(piv, ppiv)


def _hss_on(dev, depth=3, ls=16, cap=12, B=2, seed=0):
    """A batch of HSS matrices compressed from smooth dense ones on ``dev``."""
    rng = np.random.default_rng(seed)
    plan = H.ClusterPlan(ls=ls, depth=depth, n1=ls << (depth - 1),
                         n2=ls << (depth - 1))
    n = plan.n_pad
    pts = np.sort(rng.random((B, n)), axis=-1)
    A = 1.0 / (1.0 + 30.0 * np.abs(pts[:, :, None] - pts[:, None, :])) \
        + 4.0 * np.eye(n) + 1e-3 * rng.standard_normal((B, n, n))
    return H.hss_compress_dense(torch.as_tensor(A, device=dev), plan, 1e-6,
                                1e-6, cap)


@pytest.mark.parametrize("depth", [1, 3])
def test_hss_entries_kernel(dev, depth):
    h = _hss_on(dev, depth=depth)
    ef = H.hss_entry_factors(h)
    rng = np.random.default_rng(depth)
    n = h.plan.n_pad
    rows = torch.as_tensor(rng.integers(0, n, (h.B, 5, 7)), device=dev)
    cols = torch.as_tensor(rng.integers(0, n, (h.B, 5, 9)), device=dev)
    before = H.hss_entries_prepared.launches
    got = H.hss_entries_prepared(ef, rows, cols)
    assert H.hss_entries_prepared.launches == before + 1
    assert _rel(got, H.hss_entries_prepared_plain(ef, rows, cols)) < 1e-13
    dense = H.hss_todense(h)
    b = torch.arange(h.B, device=dev)[:, None, None, None]
    ref = dense[b, rows[..., :, None], cols[..., None, :]]
    assert _rel(got, ref) < 1e-12


@pytest.mark.parametrize("depth,k", [(1, 1), (3, 1), (3, 13), (2, 58)])
def test_hss_matvec_kernel_both_directions(dev, depth, k):
    """Kernel J against its plain version, k = 1 and ragged column tiles."""
    h = _hss_on(dev, depth=depth)
    rng = np.random.default_rng(k)
    x = torch.as_tensor(rng.standard_normal((h.B, h.plan.n_pad, k)), device=dev)
    dense = H.hss_todense(h)
    for adj in (False, True):
        before = H.hss_matvec.launches
        got = H.hss_matvec(h, x, adj)
        assert H.hss_matvec.launches == before + 1
        assert _rel(got, H.hss_matvec_plain(h, x, adj)) < 1e-13
        op = dense.transpose(-1, -2) if adj else dense
        assert _rel(got, op @ x) < 1e-12


def _random_hss(dev, B, depth, ls, r, seed):
    """Random generators of a batch of HSS matrices on the card."""
    rng = np.random.default_rng(seed)
    nl = 1 << depth
    g = lambda *s: torch.as_tensor(rng.standard_normal((B,) + s) / np.sqrt(s[-1]),
                                   device=dev)
    half = (nl // 2) * ls
    return H.Hss(D=g(nl, ls, ls), U=g(nl, ls, r), V=g(nl, ls, r),
                 Rs=[g(nl >> i, r, r) for i in range(depth)],
                 Ws=[g(nl >> i, r, r) for i in range(depth)],
                 B12s=[g(nl >> (i + 1), r, r) for i in range(depth)],
                 B21s=[g(nl >> (i + 1), r, r) for i in range(depth)],
                 plan=H.ClusterPlan(ls=ls, depth=depth, n1=half, n2=half))


# (B, depth, ls, r) of n=512 structured matrices: one CTA per matrix, and
# clusters of 2-8 CTAs at the default caps' ranks
J_SHAPES = [(511, 1, 23, 32), (127, 2, 24, 48), (15, 3, 32, 96),
            (3, 4, 24, 192), (1, 3, 32, 192)]


@pytest.mark.parametrize("B,depth,ls,r", J_SHAPES)
@pytest.mark.parametrize("k", [1, 58, 112])
def test_hss_matvec_kernel_at_n512_shapes(dev, B, depth, ls, r, k):
    """Kernel J against its plain version at the n=512 plans' shapes, both
    directions, on the geometry hss_matvec_geometry picks."""
    h = _random_hss(dev, B, depth, ls, r, seed=r + k)
    x = torch.as_tensor(np.random.default_rng(k).standard_normal(
        (B, h.plan.n_pad, k)), device=dev)
    for adj in (False, True):
        got = H.hss_matvec(h, x, adj)
        assert _rel(got, H.hss_matvec_plain(h, x, adj)) < 1e-13


@pytest.mark.parametrize("p,q", [(70, 45), (24, 24), (130, 192)])
def test_hss_entries_kernel_mixed_levels_and_nan(dev, p, q):
    """Kernel I on index blocks of several 64 x 64 tiles whose entries meet
    every LCA level, with out-of-range indices: its plain version's values,
    NaN in the same places."""
    h = _random_hss(dev, 2, 3, 24, 192, seed=p)
    ef = H.hss_entry_factors(h)
    n = h.plan.n_pad
    rng = np.random.default_rng(q)
    rows = rng.integers(0, n, (2, 3, p))
    cols = rng.integers(0, n, (2, 3, q))
    rows[0, 1, 3], rows[1, 2, -1], cols[0, 0, 0], cols[1, 1, -1] = -1, n, n + 7, -3
    rows, cols = torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)
    got = H.hss_entries_prepared(ef, rows, cols)
    ref = H.hss_entries_prepared_plain(ef, rows, cols)
    assert torch.equal(got.isnan(), ref.isnan())
    fin = ~ref.isnan()
    assert int(fin.sum()) > 0
    assert _rel(got[fin], ref[fin]) < 1e-13


@pytest.mark.parametrize("k", [1, 12])
def test_hss_level_correct_kernel_and_solve(dev, k):
    """Kernel K against its plain version at every level of both solves, and
    the solves against a dense solve."""
    h = _hss_on(dev, depth=3)
    sol = H.hss_factor(h)
    rng = np.random.default_rng(40 + k)
    x = torch.as_tensor(rng.standard_normal((h.B, h.plan.n_pad, k)), device=dev)
    for adj in (False, True):
        Y = H._leaf_solve(sol, x, adj)
        for lev in range(1, h.plan.depth + 1):
            xi = H._upsweep(h, Y, lev - 1, adj).contiguous()
            Bl, Br = h.B12s[lev - 1], h.B21s[lev - 1]
            lu, piv, Phi = sol.cores_lu[lev - 1], sol.cores_piv[lev - 1], \
                sol.Phis[lev - 1]
            if adj:
                Bl, Br = Br, Bl
                lu, piv, Phi = sol.coresT_lu[lev - 1], sol.coresT_piv[lev - 1], \
                    sol.PhisT[lev - 1]
            want = H.hss_level_correct_plain(Y.clone(), xi, Bl, Br, lu, piv,
                                             Phi, adj)
            before = H.hss_level_correct.launches
            Y = H.hss_level_correct(Y, xi, Bl, Br, lu, piv, Phi, adj)
            assert H.hss_level_correct.launches == before + 1
            assert _rel(Y, want) < 1e-13
        dense = H.hss_todense(h)
        op = dense.transpose(-1, -2) if adj else dense
        assert _rel(op @ Y, x) < 1e-10
        assert _rel(H.hss_solve(sol, x, adj), Y) < 1e-13


@pytest.mark.parametrize("r", [48, 96, 192])
@pytest.mark.parametrize("adjoint", [False, True])
def test_hss_level_correct_kernel_at_default_ranks(dev, r, adjoint):
    """Kernel K on random operands of rank r (cores 96, 192 and 384 wide),
    three nodes, k = 1 (the solve), k = 3 (one partial 8-column block on the
    tensor cores) and k = r (hss_factor: several column tiles where r > 32),
    against its plain version."""
    rng = np.random.default_rng(r + adjoint)
    B, m, blk = 3, 1, r + 5
    t = lambda a: torch.as_tensor(a, device=dev)
    M = np.eye(2 * r) + rng.standard_normal((B, m, 2 * r, 2 * r)) / (
        4 * np.sqrt(2 * r))
    lu, piv = dk.lu_factor(t(M))
    Bl, Br = (t(rng.standard_normal((B, m, r, r))) for _ in range(2))
    Phi = t(rng.standard_normal((B, 2 * m * blk, r)))
    for k in (1, 3, r):
        Y = t(rng.standard_normal((B, 2 * m * blk, k)))
        xi = t(rng.standard_normal((B, 2 * m, r, k)))
        args = (xi, Bl, Br, lu.contiguous(), piv.contiguous(), Phi, adjoint)
        want = H.hss_level_correct_plain(Y.clone(), *args)
        before = H.hss_level_correct.launches
        got = H.hss_level_correct(Y.clone(), *args)
        assert H.hss_level_correct.launches == before + 1
        assert _rel(got, want) < 1e-13


def test_structured_slice_at_the_default_caps_on_cuda(dev):
    """The structured path with every option at its default but the
    switching level and tolerances (no kest): helmholtz2d(128), where
    children of ranks 48 and 32 meet, converges through all eleven
    kernels."""
    from hsolve_torch.factor import solve_with_data

    A, b, shape = ht.helmholtz2d(128, k=40.0)
    tree = ht.nested_dissection(shape, leafmax=100)
    kernels.reset_launch_counts()
    F = ht.factor(A, tree, swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3,
                  device=dev)
    op, mv = ht.spmv_format(A, device=dev)
    xg, info = ht.gmres_compiled(mv, solve_with_data,
                                 torch.as_tensor(b, device=dev), reltol=1e-9,
                                 restart=30, maxiter=60, mv_data=op,
                                 M_data=F.solve_data)
    assert info["converged"] and info["iters"] <= 10
    xg = xg.cpu().numpy()
    assert np.linalg.norm(A @ xg - b) / np.linalg.norm(b) < 1e-9
    assert not F.rank_report()["saturated"]
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in kernels.HSS_PATH), counts


def test_structured_slice_on_cuda(dev):
    """The structured (HSS) path on the card: it converges in a few GMRES
    iterations without saturating a cap, through all eleven kernels."""
    from hsolve_torch.factor import StructuredLevel, solve_with_data

    A, b, shape = ht.helmholtz2d(64, k=20.0)
    tree = ht.nested_dissection(shape, leafmax=40)
    kernels.reset_launch_counts()
    F = ht.factor(A, tree, swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3,
                  kest=32, device=dev)
    assert any(isinstance(lv, StructuredLevel) for lv in F.levels)
    op, mv = ht.spmv_format(A, device=dev)
    xg, info = ht.gmres_compiled(mv, solve_with_data,
                                 torch.as_tensor(b, device=dev), reltol=1e-9,
                                 restart=30, maxiter=60, mv_data=op,
                                 M_data=F.solve_data)
    assert info["converged"] and info["iters"] <= 12
    xg = xg.cpu().numpy()
    assert np.linalg.norm(A @ xg - b) / np.linalg.norm(b) < 1e-9
    assert F.maxrank() > 0 and not F.rank_report()["saturated"]
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in kernels.HSS_PATH), counts


def test_sketches_are_the_same_on_every_device(dev):
    """The default sketches are drawn on the host and copied, so the card
    factors with the CPU's sketches: the same ranks and GMRES iterations on
    both devices for one seed."""
    from hsolve_torch.factor import solve_with_data

    A, b, shape = ht.helmholtz2d(64, k=20.0)
    opts = ht.SolverOptions(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3, kest=32)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=40), opts)
    out = []
    for d in (torch.device("cpu"), dev):
        F = ht.factor_with_plan(plan, opts, device=d)
        op, mv = ht.spmv_format(A, device=d)
        _, info = ht.gmres_compiled(mv, solve_with_data, torch.as_tensor(b, device=d),
                                    reltol=1e-9, restart=30, maxiter=60,
                                    mv_data=op, M_data=F.solve_data)
        out.append((F.rank_report(), info["iters"]))
    assert out[0] == out[1]


def test_typed_kernels_in_float32(dev):
    """A-D in float32 against their float32 plain versions: A and B bitwise,
    C and D to 1e-5 relative (only the summation order differs)."""
    rng = np.random.default_rng(50)
    f32 = torch.float32
    B, m = 3, 20
    pos = torch.as_tensor(rng.permutation(B * m * m)[:500].astype(np.int32),
                          device=dev)
    src = torch.as_tensor(rng.integers(-1, 300, 500).astype(np.int32), device=dev)
    adata = torch.as_tensor(rng.standard_normal(300), dtype=f32, device=dev)
    before = front_assemble.launches_by_type.get("float32", 0)
    got = front_assemble(B, m, pos, src, adata)
    assert got.dtype == f32 and front_assemble.launches_by_type["float32"] == before + 1
    assert torch.equal(got, front_assemble_plain(B, m, pos, src, adata))
    imap = torch.as_tensor(rng.integers(-1, 16, size=(B, m)).astype(np.int32),
                           device=dev)
    S = torch.as_tensor(rng.standard_normal((2, 10, 10)), dtype=f32, device=dev)
    sr = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    dr = torch.tensor([2, 0], dtype=torch.int32, device=dev)
    assert torch.equal(extend_add(got.clone(), S, sr, dr, imap),
                       extend_add_plain(got.clone(), S, sr, dr, imap))
    N, Bs, R, Cc = 500, 7, 9, 13
    C = torch.as_tensor(rng.standard_normal((N + 1, 2)), dtype=f32, device=dev)
    C[N] = 0.0
    perm = rng.permutation(N)
    ids_out = torch.as_tensor(perm[: Bs * R].reshape(Bs, R).astype(np.int32),
                              device=dev)
    ids_in = torch.as_tensor(
        perm[Bs * R: Bs * R + Bs * Cc].reshape(Bs, Cc).astype(np.int32), device=dev)
    M = torch.as_tensor(rng.standard_normal((Bs, R, Cc)), dtype=f32, device=dev)
    got = sweep_update(C.clone(), ids_out, M, N, ids_in=ids_in)
    assert _rel(got, sweep_update_plain(C.clone(), ids_out, M, N,
                                        ids_in=ids_in)) < 1e-5
    with pytest.raises(TypeError, match="one type per call"):
        sweep_update(C.clone(), ids_out, M.double(), N, ids_in=ids_in)
    A, b, _ = ht.helmholtz2d(33, k=10.0)
    op = ht.to_dia(A, dtype=np.float32, device=dev)
    x = torch.as_tensor(rng.standard_normal((A.shape[0], 1)), dtype=f32, device=dev)
    bt = torch.as_tensor(np.asarray(b)[:, None], dtype=f32, device=dev)
    for extra in ((), (bt,)):
        assert _rel(dia_spmv(op, x, *extra), dia_spmv_plain(op, x, *extra)) < 1e-5


def _arnoldi_inputs(dev, dtype, m, N, steps, seed):
    """A state after ``steps`` Arnoldi steps of the plain versions on
    I + noise, and the next step's vector."""
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(np.eye(N) + rng.standard_normal((N, N)) / (2 * N ** 0.5),
                        dtype=dtype, device=dev)
    s = AR.arnoldi_state(m, N, dtype, dev)
    r = torch.as_tensor(rng.standard_normal(N), device=dev)
    beta = float(torch.linalg.vector_norm(r))
    s.V[0] = (r / beta).to(dtype)
    s.g[0] = beta
    for j in range(steps):
        w = A @ s.V[j]
        AR.arnoldi_cgs2_plain(s, w, j)
        AR.arnoldi_givens_plain(s, j, 0.0, True)
        s.V[j + 1] = w / s.st[1]
    return s, A @ s.V[steps]


def _clone_state(s):
    import dataclasses

    return dataclasses.replace(s, **{f.name: getattr(s, f.name).clone()
                                     for f in dataclasses.fields(s)})


@pytest.mark.parametrize("j", [0, 29])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_arnoldi_kernels_against_plain(dev, dtype, j):
    """L and M at j = 0 and j = m - 1 (m = 30), N ragged against the chunks:
    the column and w within 1e-5 (float32) / 1e-13 (float64); M's rotations,
    done flag, divisor and coefficients equal bit for bit on equal columns."""
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    s, w = _arnoldi_inputs(dev, dtype, 30, 5003, j, seed=60 + j)
    sk, sp_ = _clone_state(s), _clone_state(s)
    wk, wp = w.clone(), w.clone()
    before = AR.arnoldi_cgs2.launches
    AR.arnoldi_cgs2(sk, wk, j)
    assert AR.arnoldi_cgs2.launches == before + 1
    AR.arnoldi_cgs2_plain(sp_, wp, j)
    assert _rel(sk.hc[: j + 2], sp_.hc[: j + 2]) < tol
    assert _rel(wk, wp) < tol
    assert int(sk.ticket[0]) == 0               # re-armed for the next step
    for cont, floor in ((True, 0.0), (True, 1e30), (False, 0.0)):
        mk, mp = _clone_state(sp_), _clone_state(sp_)
        AR.arnoldi_givens(mk, j, floor, cont)
        AR.arnoldi_givens_plain(mp, j, floor, cont)
        for a, b in ((mk.H, mp.H), (mk.cs, mp.cs), (mk.sn, mp.sn),
                     (mk.g, mp.g), (mk.st, mp.st), (mk.done, mp.done),
                     (mk.y, mp.y)):
            assert torch.equal(a, b)
        assert int(mk.done[0]) == int(not (cont and floor == 0.0))


@pytest.mark.parametrize("j", [0, 1, 29])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
def test_arnoldi_cgs2_on_ragged_slices(dev, dtype, tol, j):
    """Kernel L at N = 200,003: 132 CTAs, a last slice shorter than the
    others, rows of V that start off a 16-byte boundary (N odd), staged and
    unstaged rows at j = 29; one launch, h and w as the plain version, its
    barrier counter and ticket back at rest."""
    N, m = 200003, 30
    rng = np.random.default_rng(70 + j)
    s = AR.arnoldi_state(m, N, dtype, dev)
    V = rng.standard_normal((j + 1, N))
    s.V[: j + 1] = torch.as_tensor(V / np.linalg.norm(V, axis=1)[:, None],
                                   dtype=dtype, device=dev)
    w = torch.as_tensor(rng.standard_normal(N), dtype=dtype, device=dev)
    sk, sp_ = _clone_state(s), _clone_state(s)
    wk, wp = w.clone(), w.clone()
    before = AR.arnoldi_cgs2.launches
    AR.arnoldi_cgs2(sk, wk, j)
    assert AR.arnoldi_cgs2.launches == before + 1
    AR.arnoldi_cgs2_plain(sp_, wp, j)
    assert _rel(sk.hc[: j + 2], sp_.hc[: j + 2]) < tol
    assert _rel(wk, wp) < tol
    assert int(sk.ticket[0]) == 0
    AR.arnoldi_cgs2(sk, wk.clone(), j)          # the next step starts at rest
    assert int(sk.ticket[0]) == 0


def _step_outputs(s):
    return {k: getattr(s, k) for k in ("H", "cs", "sn", "g", "st", "done",
                                       "y")}


@pytest.mark.parametrize("N", [5003, 200003, 1050625])
@pytest.mark.parametrize("j", [0, 29])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_arnoldi_step_fused_against_plain(dev, dtype, j, N):
    """The step as one launch (L with M's step and V[j+1] as its tail), at
    j = 0 and j = m - 1, cont and done, on one CTA's worth of N, on 132 CTAs
    with a ragged last slice and at the n=1026 size (N = 1,050,625): hc bit
    for bit kernel L's alone (the same passes), within 1e-5 / 1e-13 of L's
    plain version; H, cs, sn, g, st, done, y and V[j+1] bitwise the plain M
    and division on L's hc and w; w left as given; one launch counted for
    the step and one each for L and M; the ticket back at rest after every
    launch."""
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    m = 30
    rng = np.random.default_rng(80 + j)
    s = AR.arnoldi_state(m, N, dtype, dev)
    V = rng.standard_normal((j + 1, N))
    s.V[: j + 1] = torch.as_tensor(V / np.linalg.norm(V, axis=1)[:, None],
                                   dtype=dtype, device=dev)
    s.g[0] = 3.0
    s.cs[:j] = torch.as_tensor(rng.uniform(0.2, 1.0, j), dtype=dtype)
    s.sn[:j] = torch.as_tensor(rng.uniform(-1.0, 1.0, j), dtype=dtype)
    s.g[: j + 1] = torch.as_tensor(rng.standard_normal(j + 1), dtype=dtype)
    s.H[:j, :j] = torch.triu(torch.as_tensor(
        rng.standard_normal((j, j)) + 4 * np.eye(j), dtype=dtype))
    w = torch.as_tensor(rng.standard_normal(N), dtype=dtype, device=dev)
    sl, wl = _clone_state(s), w.clone()    # kernel L alone
    AR.arnoldi_cgs2(sl, wl, j)
    sp_, wp = _clone_state(s), w.clone()
    AR.arnoldi_cgs2_plain(sp_, wp, j)
    torch.cuda.synchronize()
    assert _rel(sl.hc[: j + 2], sp_.hc[: j + 2]) < tol
    assert _rel(wl, wp) < tol
    for cont, floor in ((True, 0.0), (True, 1e30), (False, 0.0)):
        sk, wk = _clone_state(s), w.clone()
        AR.set_loop(sk, j, maxiter=None if cont else j + 1, floor=floor)
        cont = cont and j + 1 < m          # the loop state's test
        before = (AR.arnoldi_step.launches, AR.arnoldi_cgs2.launches,
                  AR.arnoldi_givens.launches)
        AR.arnoldi_step(sk, wk)
        torch.cuda.synchronize()
        assert (AR.arnoldi_step.launches, AR.arnoldi_cgs2.launches,
                AR.arnoldi_givens.launches) == tuple(b + 1 for b in before)
        assert int(sk.ticket[0]) == 0
        assert torch.equal(sk.hc, sl.hc)
        assert torch.equal(wk, w)
        mp = _clone_state(s)               # L's hc and w
        mp.hc.copy_(sl.hc)
        AR.arnoldi_givens_plain(mp, j, floor, cont)
        torch.div(wl, mp.st[1], out=mp.V[j + 1])
        for name, a in _step_outputs(sk).items():
            assert torch.equal(a, getattr(mp, name)), name
        assert torch.equal(sk.V[j + 1], mp.V[j + 1])
        assert int(sk.done[0]) == int(not (cont and floor == 0.0))
        # the loop advanced; the next step reads V[j+1] from vj
        assert int(sk.loop[AR.J]) == j + 1
        assert torch.equal(sk.vj, sk.V[j + 1])


def test_gmres_step_is_one_launch(dev):
    """A warm GMRES run on the card (its graph captured by a first call):
    one fused launch per Arnoldi step, which counts one launch of L and one
    of M, one graph launch, and per phase one init, a cycle start and end a
    cycle and a condition per step, cycle and phase."""
    A, b, shape = ht.helmholtz2d(64, k=10.0)
    op, mv = ht.spmv_format(A, device=dev)
    bt = torch.as_tensor(b, device=dev)
    run = lambda: ht.gmres_compiled(mv, None, bt, reltol=1e-6, restart=20,
                                    maxiter=40, mv_data=op)
    run()
    kernels.reset_launch_counts()
    x, info = run()
    counts = kernels.launch_counts()
    assert info["iters"] > 0
    assert counts["arnoldi_step"] == counts["arnoldi_cgs2"] == \
        counts["arnoldi_givens"] == info["iters"]
    cycles = counts["gmres_cycle_start"]
    assert counts["gmres_graph"] == counts["gmres_init"] == 1
    assert counts["gmres_cycle_end"] == cycles >= 1
    assert counts["gmres_set_cond"] == 1 + 2 * cycles + info["iters"]


def test_arnoldi_cgs2_refuses_a_grid_the_card_cannot_hold(dev, monkeypatch):
    """Kernel L's cooperative launch with more CTAs than can be resident at
    once is refused: the wrapper raises, nothing runs, nothing falls back."""
    monkeypatch.setattr(AR, "device_sms", lambda device: 10 ** 6)
    N = 10 ** 6
    s = AR.arnoldi_state(1, N, torch.float32, dev)
    assert AR.cgs2_blocks(N, AR.device_sms(dev)) == 977
    s.V[0] = 1.0 / N ** 0.5
    w = torch.ones(N, device=dev)
    before = AR.arnoldi_cgs2.launches
    with pytest.raises(RuntimeError, match="arnoldi_cgs2"):
        AR.arnoldi_cgs2(s, w, 0)
    torch.cuda.synchronize()
    assert AR.arnoldi_cgs2.launches == before
    assert bool((w == 1.0).all()) and int(s.ticket[0]) == 0


def test_mixed_slice_on_cuda(dev):
    """The float32 factor with mixed-precision GMRES on the card: it
    converges to relres 1e-9 through A-D in float32, D in float64 and L, M
    in float32, and agrees with the same run on the CPU in its count to 1."""
    from hsolve_torch.factor import solve_with_data

    A, b, shape = ht.helmholtz2d(48, k=20.0)
    tree = ht.nested_dissection(shape, leafmax=40)
    opts = ht.SolverOptions(swlevel=0)
    plan = ht.plan_factorization(A, tree, opts)

    def prec(data, v):
        return solve_with_data(data, v.to(torch.float32)).to(v.dtype)

    iters = []
    for d in (dev, torch.device("cpu")):
        kernels.reset_launch_counts()
        F = ht.factor_with_plan(plan, opts, dtype=torch.float32, device=d)
        op64, mv = ht.spmv_format(A, device=d)
        op32, _ = ht.spmv_format(A, dtype=np.float32, device=d)
        x, info = ht.gmres_compiled(
            mv, prec, torch.as_tensor(b, device=d), reltol=1e-9, restart=30,
            maxiter=60, mv_data=op64, M_data=F.solve_data,
            inner_dtype="float32", mv_data_inner=op32, m_eps=1e-6)
        assert info["converged"]
        x = x.cpu().numpy()
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-9
        iters.append(info["iters"])
        if d.type == "cuda":
            counts = kernels.launch_counts()
            assert all(counts.get(k, 0) > 0 for k in kernels.MIXED_PATH), counts
    assert abs(iters[0] - iters[1]) <= 1


def test_float32_refused_on_compressed_levels_on_cuda(dev):
    """Float32 on compressed levels is no longer refused on the card: the
    structured plan (hss at its default) factors in float32 through E-K's
    float32 instances, counted under ``float32``; complex64 there still
    raises, naming slice 16."""
    A, _, shape = ht.helmholtz2d(64, k=20.0)
    opts = ht.SolverOptions(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3, kest=32)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=40), opts)
    kernels.reset_launch_counts()
    F = ht.factor_with_plan(plan, opts, dtype=torch.float32, device=dev)
    F.solve(np.ones(A.shape[0]))
    assert F.dtype == torch.float32
    counts = kernels.launch_counts()
    assert all(counts.get(f"{k}:float32", 0) > 0 for k in (
        "lowrank_sweep_update", "lowrank_schur_update", "lowrank_truncate",
        "cpqr_pivots", "hss_entries_prepared", "hss_matvec",
        "hss_level_correct")), counts
    Ad, _, shape_d = ht.helmholtz2d(48, k=25.0, damping=0.1)
    with pytest.raises(NotImplementedError, match="slice 16"):
        ht.factor(Ad, ht.nested_dissection(shape_d, leafmax=40), swlevel=-2,
                  swsize=16, atol=1e-3, rtol=1e-3, dtype=torch.complex64,
                  device=dev)


def _gmres_setup(dev, path, n=128, k=40.0):
    """helmholtz2d(n, k) factored for ``path`` ("exact", "mixed": the float32
    factor inside mixed-precision GMRES, "structured": kest=32 HSS) with
    the solve's arguments."""
    from hsolve_torch.factor import solve_with_data

    A, b, shape = ht.helmholtz2d(n, k=k)
    tree = ht.nested_dissection(shape, leafmax=100)
    opts = dict(swlevel=0) if path != "structured" else dict(
        swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3, kest=32)
    F = ht.factor(A, tree, dtype=torch.float32 if path == "mixed" else None,
                  device=dev, **opts)
    op, mv = ht.spmv_format(A, device=dev)
    kw = dict(reltol=1e-9, restart=30, maxiter=60, mv_data=op,
              M_data=F.solve_data)
    prec = solve_with_data
    if path == "mixed":
        prec = lambda d, v: solve_with_data(d, v.to(torch.float32)).to(v.dtype)
        kw.update(inner_dtype="float32", m_eps=1e-6,
                  mv_data_inner=ht.spmv_format(A, dtype=np.float32,
                                               device=dev)[0])
    return A, b, F, mv, prec, kw


@pytest.mark.parametrize("path", ["exact", "mixed", "structured"])
def test_graph_solve_against_the_host_driven_loop(dev, path):
    """``gmres_compiled`` on the card is one CUDA graph: a warm solve with
    ``fetch_info=False`` under ``torch.cuda.set_sync_debug_mode("error")``
    reads nothing on the host, and gives the iterations of the same
    functions launched eagerly with the host reading the loop's flags, and x
    to 1e-10 relative (the same kernels on the same inputs)."""
    from hsolve_torch.krylov import gmres_host_driven

    A, b, F, mv, prec, kw = _gmres_setup(dev, path)
    bt = torch.as_tensor(b, device=dev)
    xh, ih = gmres_host_driven(mv, prec, bt, **kw)
    ht.gmres_compiled(mv, prec, bt, fetch_info=False, **kw)   # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        xg, dinfo = ht.gmres_compiled(mv, prec, bt, fetch_info=False, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ig = ht.fetch_gmres_info(dinfo)
    assert ih["converged"] and ig["converged"]
    assert ig["iters"] == ih["iters"]
    assert np.array_equal(ig["resnorm"], ih["resnorm"]) or \
        np.abs(ig["resnorm"] - ih["resnorm"]).max() <= 1e-10 * ih["resnorm"][0]
    assert _rel(xg, xh) < 1e-10
    xn = xg.cpu().numpy()
    assert np.linalg.norm(b - A @ xn) / np.linalg.norm(b) < 1e-9


def test_a_remade_factor_does_not_replay_the_old_graph(dev):
    """The graph lives on the factor's solve data: a factor of another
    system, made after the first was solved, captures its own graph (the
    old one is never replayed: x solves the new system), and the old graph
    is freed with its factor."""
    import gc as pygc

    import hsolve_torch.krylov as K
    from hsolve_torch.krylov import graph_stats
    from hsolve_torch.ops import gmres_control as GC

    A1, b1, F1, mv, prec, kw1 = _gmres_setup(dev, "exact", n=64, k=20.0)
    x1, _ = ht.gmres_compiled(mv, prec, torch.as_tensor(b1, device=dev), **kw1)
    assert len(graph_stats(F1.solve_data)) == 1
    old = [e.graph for e in vars(F1.solve_data)[K._CACHE].values()]
    assert all(g in GC._LIVE for g in old)
    A2, b2, F2, mv, prec, kw2 = _gmres_setup(dev, "exact", n=64, k=25.0)
    bt2 = torch.as_tensor(b2, device=dev)
    for _ in range(2):
        x2, info = ht.gmres_compiled(mv, prec, bt2, **kw2)
        xn = x2.cpu().numpy()
        assert info["converged"]
        assert np.linalg.norm(b2 - A2 @ xn) / np.linalg.norm(b2) < 1e-9
    assert len(graph_stats(F2.solve_data)) == 1
    refs = [__import__("weakref").ref(g) for g in old]
    del F1, kw1, old
    pygc.collect()
    assert all(r() is None for r in refs)


def test_a_preconditioner_that_reads_the_host_cannot_be_captured(dev):
    """A preconditioner with a host read cannot be part of the solve's
    graph: the capture raises, and nothing falls back to a host loop (as a
    JAX trace of a host read fails).  Kept last: a failed capture is the
    one error this file provokes on purpose."""
    A, b, shape = ht.helmholtz2d(32, k=10.0)
    op, mv = ht.spmv_format(A, device=dev)
    M = lambda v: v * float(torch.linalg.vector_norm(v))
    with pytest.raises(RuntimeError):
        ht.gmres_compiled(mv, M, torch.as_tensor(b, device=dev), reltol=1e-9,
                          restart=10, maxiter=10, mv_data=op)


# ---------------------------------------------------------------------------
# complex values (the damped Helmholtz system): A-D, the Arnoldi step and the
# cycle start in complex128 and complex64
# ---------------------------------------------------------------------------

CTOL = [(torch.complex128, 1e-12), (torch.complex64, 1e-5)]


def _crandn(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape)
                           + 1j * rng.standard_normal(shape), dtype=dtype,
                           device=dev)


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_complex_front_assemble_and_extend_add(dev, dtype):
    """Kernels A and B on complex values, bit for bit their plain versions
    (one complex value a load; the sentinel 1 + 0i; a complex add is the two
    real adds of torch's)."""
    rng = np.random.default_rng(90)
    B, m = 3, 20
    pos = torch.as_tensor(rng.permutation(B * m * m)[:500].astype(np.int32),
                          device=dev)
    src = torch.as_tensor(rng.integers(-1, 300, size=500).astype(np.int32),
                          device=dev)
    adata = _crandn(rng, 300, dtype, dev)
    got = front_assemble(B, m, pos, src, adata)
    assert got.dtype == dtype
    assert torch.equal(got, front_assemble_plain(B, m, pos, src, adata))
    B, m, s_pad = 6, 24, 16
    front = _crandn(rng, (B, m, m), dtype, dev)
    imap = torch.as_tensor(rng.integers(-1, s_pad, size=(B, m)).astype(np.int32),
                           device=dev)
    for w, src_rows, dst_rows in ((10, [2, 0, 1], [5, 1, 3]), (20, [0], [2])):
        S = _crandn(rng, (3, w, w), dtype, dev)
        sr = torch.tensor(src_rows, dtype=torch.int32, device=dev)
        dr = torch.tensor(dst_rows, dtype=torch.int32, device=dev)
        assert torch.equal(extend_add(front.clone(), S, sr, dr, imap),
                           extend_add_plain(front.clone(), S, sr, dr, imap))


def _complex_level(dev, dtype, B, ni, nb, N, seed, shared_bnd=False):
    """:func:`_hand_level` with complex pivot blocks and transforms."""
    lev = _hand_level(dev, torch.float64, B, ni, nb, N, seed, shared_bnd)
    rng = np.random.default_rng(seed + 1)
    D = torch.as_tensor((rng.standard_normal((B, ni, ni))
                         + 1j * rng.standard_normal((B, ni, ni))) / np.sqrt(ni)
                        + 2.0 * np.eye(ni), dtype=dtype, device=dev)
    lu, piv = dk.lu_factor(D)
    return dataclasses.replace(
        lev, lu=lu, perm=piv, L=_crandn(rng, (B, nb, ni), dtype, dev),
        R=_crandn(rng, (B, ni, nb), dtype, dev))


@pytest.mark.parametrize("dtype,tol", CTOL)
@pytest.mark.parametrize("B,ni,nb,k", [(7, 9, 13, 3), (3, 256, 40, 1),
                                       (1, 1000, 40, 1), (1, 1800, 24, 1),
                                       (2, 2080, 40, 1), (1, 4424, 24, 1)])
def test_complex_level_steps(dev, dtype, tol, B, ni, nb, k):
    """Kernel C's forward (lu and dinv records) and backward steps in
    complex: rows not 16-byte aligned and several right-hand sides (ni = 9,
    k = 3), one CTA (256), clusters of 4 and 8 CTAs (1000, 1800), windows
    (2080, 4424); complex128 to 1e-12 of the plain versions, complex64 to
    1e-5 (both accumulate in complex128)."""
    N = B * (ni + nb) + 500
    lev = _complex_level(dev, dtype, B, ni, nb, N, seed=ni + k)
    rng = np.random.default_rng(ni)
    C = _crandn(rng, (N + 1, k), dtype, dev)
    C[N] = 0.0
    inv = dataclasses.replace(lev, lu=None, perm=None, dinv=dk.lu_inverse(
        lev.lu, lev.perm).contiguous())
    for rec in (lev, inv):
        got = level_forward(C.clone(), rec, N)
        want = level_forward_plain(C.clone(), rec, N)
        assert _rel(got, want) < tol
        assert float(got[N].abs().max()) == 0.0
    got = sweep_update(C.clone(), lev.int_ids, lev.R, N, ids_in=lev.bnd_ids)
    want = sweep_update_plain(C.clone(), lev.int_ids, lev.R, N,
                              ids_in=lev.bnd_ids)
    assert _rel(got, want) < tol
    assert float(got[N].abs().max()) == 0.0


def test_complex_level_forward_with_shared_boundary_ids(dev):
    """The forward step's complex atomics (two real ones a value) where every
    front adds into the same boundary rows."""
    lev = _complex_level(dev, torch.complex128, B=40, ni=24, nb=16, N=2000,
                         seed=9, shared_bnd=True)
    rng = np.random.default_rng(3)
    C = _crandn(rng, (2001, 2), torch.complex128, dev)
    C[2000] = 0.0
    assert _rel(level_forward(C.clone(), lev, 2000),
                level_forward_plain(C.clone(), lev, 2000)) < 1e-12


@pytest.mark.parametrize("dtype,tol", [(torch.complex128, 1e-13),
                                       (torch.complex64, 1e-5)])
@pytest.mark.parametrize("k", [1, 3])
def test_complex_dia_spmv_kernel(dev, dtype, tol, k):
    A, _, _ = ht.helmholtz2d(33, k=10.0, damping=0.1)
    op = ht.to_dia(A, dtype=np.dtype(str(dtype)[6:]), device=dev)
    rng = np.random.default_rng(k)
    x = _crandn(rng, (A.shape[0], k), dtype, dev)
    b = _crandn(rng, (A.shape[0], k), dtype, dev)
    assert _rel(dia_spmv(op, x), dia_spmv_plain(op, x)) < tol
    assert _rel(dia_spmv(op, x, b), dia_spmv_plain(op, x, b)) < tol


@pytest.mark.parametrize("N", [5003, 200003])
@pytest.mark.parametrize("j", [0, 14, 29])
@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 1e-5),
                                       (torch.complex128, 1e-13)])
def test_complex_arnoldi_step_against_plain(dev, dtype, tol, j, N):
    """Kernel L alone, M alone and the step as one launch in complex: the
    column and w within the tolerance of L's plain version; M's rotations
    (cs real, sn complex), g, the estimate, done and y, and V[j+1] = w /
    ||w|| (each part divided), bit for bit M's plain version and the
    division on L's column and w; the ticket back at rest."""
    m = 30
    rng = np.random.default_rng(110 + j)
    s = AR.arnoldi_state(m, N, dtype, dev)
    V = rng.standard_normal((j + 1, N)) + 1j * rng.standard_normal((j + 1, N))
    s.V[: j + 1] = torch.as_tensor(V / np.linalg.norm(V, axis=1)[:, None],
                                   dtype=dtype, device=dev)
    s.cs[:j] = torch.as_tensor(rng.uniform(0.2, 1.0, j))
    s.sn[:j] = torch.as_tensor(rng.uniform(-0.6, 0.6, j)
                               + 1j * rng.uniform(-0.6, 0.6, j))
    s.g[: j + 1] = torch.as_tensor(rng.standard_normal(j + 1)
                                   + 1j * rng.standard_normal(j + 1))
    s.H[:j, :j] = torch.triu(torch.as_tensor(
        rng.standard_normal((j, j)) + 1j * rng.standard_normal((j, j))
        + 4 * np.eye(j), dtype=dtype))
    w = _crandn(rng, N, dtype, dev)
    sl, wl = _clone_state(s), w.clone()
    AR.arnoldi_cgs2(sl, wl, j)
    sp_, wp = _clone_state(s), w.clone()
    AR.arnoldi_cgs2_plain(sp_, wp, j)
    torch.cuda.synchronize()
    assert int(sl.ticket[0]) == 0
    assert _rel(sl.hc[: j + 2], sp_.hc[: j + 2]) < tol
    assert _rel(wl, wp) < tol
    for cont, floor in ((True, 0.0), (True, 1e30), (False, 0.0)):
        mk, mp = _clone_state(sl), _clone_state(sl)
        AR.arnoldi_givens(mk, j, floor, cont)
        AR.arnoldi_givens_plain(mp, j, floor, cont)
        for name, a in _step_outputs(mk).items():
            assert torch.equal(a, getattr(mp, name)), name
        sk, wk = _clone_state(s), w.clone()
        AR.set_loop(sk, j, maxiter=None if cont else j + 1, floor=floor)
        c = cont and j + 1 < m
        AR.arnoldi_step(sk, wk)
        torch.cuda.synchronize()
        assert int(sk.ticket[0]) == 0 and torch.equal(wk, w)
        assert torch.equal(sk.hc, sl.hc)
        mp = _clone_state(s)
        mp.hc.copy_(sl.hc)
        AR.arnoldi_givens_plain(mp, j, floor, c)
        AR.div_real(wl, mp.st[1], out=mp.V[j + 1])
        for name, a in _step_outputs(sk).items():
            assert torch.equal(a, getattr(mp, name)), name
        assert torch.equal(sk.V[j + 1], mp.V[j + 1])
        assert int(sk.loop[AR.J]) == j + 1 and torch.equal(sk.vj, sk.V[j + 1])


@pytest.mark.parametrize("to,ti", [(torch.complex128, torch.complex128),
                                   (torch.complex64, torch.complex64),
                                   (torch.complex128, torch.complex64)])
@pytest.mark.parametrize("beta", [3.0, 1e-12, 0.0])
def test_complex_cycle_start_bitwise(dev, to, ti, beta):
    """The cycle start in its complex type pairs: V[0] = r / beta with each
    part divided (JAX's complex division, bit for bit), cs and the floor
    real, the rest as its plain version."""
    from hsolve_torch.ops import gmres_control as GC

    rng = np.random.default_rng(7)
    N, m = 20011, 30
    r = _crandn(rng, N, to, dev)
    s0 = AR.arnoldi_state(m, N, ti, dev)
    s0.H.fill_(7.0), s0.sn.fill_(7.0), s0.y.fill_(7.0)
    sc = torch.tensor([2.0, 1e-9, beta, 1e-9], dtype=to.to_real(), device=dev)
    sk, sp_ = _clone_state(s0), _clone_state(s0)
    GC.gmres_cycle_start(r, sc, sk, 1e-6)
    GC.gmres_cycle_start_plain(r, sc, sp_, 1e-6)
    for name in ("V", "vj", "H", "cs", "sn", "g", "y", "floor", "loop"):
        assert torch.equal(getattr(sk, name), getattr(sp_, name)), name


@pytest.mark.parametrize("mixed", [False, True])
def test_complex_slice_on_cuda(dev, mixed):
    """The damped helmholtz2d(48) on the card, through the graph: complex128
    in one iteration, or the bench's configuration (complex64 factor and
    cycles in a complex128 solve, escalation) within one iteration of the
    same run on the CPU; relres <= 1e-9 and every kernel of the path
    launched in its complex type."""
    from hsolve_torch.factor import solve_with_data

    A, b, shape = ht.helmholtz2d(48, k=25.0, damping=0.1)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=60),
                                 ht.SolverOptions(swlevel=0))
    fdt = torch.complex64 if mixed else torch.complex128

    def prec(data, v):
        return solve_with_data(data, v.to(fdt)).to(v.dtype)

    iters = []
    for d in (dev, torch.device("cpu")):
        kernels.reset_launch_counts()
        F = ht.factor_with_plan(plan, ht.SolverOptions(swlevel=0), dtype=fdt,
                                device=d)
        op, mv = ht.spmv_format(A, device=d)
        inner = dict(inner_dtype="complex64", m_eps=1e-6,
                     mv_data_inner=ht.spmv_format(A, dtype=np.complex64,
                                                  device=d)[0]) if mixed else {}
        x, info = ht.gmres_compiled(mv, prec, torch.as_tensor(b, device=d),
                                    reltol=1e-9, restart=30, maxiter=60,
                                    mv_data=op, M_data=F.solve_data, **inner)
        assert info["converged"]
        xn = x.cpu().numpy()
        assert np.linalg.norm(A @ xn - b) / np.linalg.norm(b) <= 1e-9
        iters.append(info["iters"])
        if d.type == "cuda":
            counts = kernels.launch_counts()
            path = kernels.COMPLEX_MIXED_PATH if mixed else kernels.COMPLEX_PATH
            assert all(counts.get(k, 0) > 0 for k in path), counts
    assert abs(iters[0] - iters[1]) <= (1 if mixed else 0)
    if not mixed:
        assert iters == [1, 1]


def test_complex_compressed_refused_on_cuda(dev):
    """A complex64 factor on structured (HSS) levels, hss at its default,
    is still refused on the card (no complex64 kernels E-K); the message
    names complex64.  Complex128 factors there
    (``test_complex_structured_slice_on_cuda``)."""
    A, _, shape = ht.helmholtz2d(48, k=25.0, damping=0.1)
    with pytest.raises(NotImplementedError, match="complex64"):
        ht.factor(A, ht.nested_dissection(shape, leafmax=40), swlevel=-2,
                  swsize=16, atol=1e-3, rtol=1e-3, dtype=torch.complex64,
                  device=dev)


# ---------------------------------------------------------------------------
# complex values on the low-rank compressed levels: E, F and G in complex128
# ---------------------------------------------------------------------------

def test_complex64_compressed_refused_on_cuda(dev):
    """complex64 on compressed levels is refused on the card (float32 runs
    there since kernels E-K have float32 instances): the message names
    complex64."""
    A, _, shape = ht.helmholtz2d(48, k=25.0, damping=0.1)
    with pytest.raises(NotImplementedError, match="complex64"):
        ht.factor(A, ht.nested_dissection(shape, leafmax=40), swlevel=-2,
                  swsize=16, atol=1e-3, rtol=1e-3, hss=False,
                  dtype=torch.complex64, device=dev)


@pytest.mark.parametrize("B,R,Cc,kc,k", [(1, 512, 512, 48, 1),
                                         (1023, 64, 32, 32, 1),
                                         (8, 640, 256, 48, 3),
                                         (5, 40, 56, 33, 2)])
def test_complex_lowrank_sweep_update_kernel(dev, B, R, Cc, kc, k):
    """Kernel E in complex128 at the damped n=512 low-rank plan's shapes
    (the top front spread over a cluster, double-double sums where B <=
    16; the 1023 leaf-side fronts) and an odd rank, both forms, with
    sentinels: within 1e-13 of its plain version, the sentinel row zero."""
    rng = np.random.default_rng(B + R + kc + k)
    N = B * (R + Cc) + 50
    C, ids_out, U, V, fwd, bwd = _sweep_operands(dev, rng, B, R, Cc, kc, k, N)
    c128 = lambda t: t.to(torch.complex128) + 1j * torch.randn_like(t)
    C, U, V = c128(C), c128(U), c128(V)
    C[N] = 0.0
    fwd = {"X": c128(fwd["X"])}
    for kw in (fwd, bwd):
        before = lowrank_sweep_update.launches_by_type.get("complex128", 0)
        got = lowrank_sweep_update(C.clone(), ids_out, U, V, N, **kw)
        want = lowrank_sweep_update_plain(C.clone(), ids_out, U, V, N, **kw)
        assert lowrank_sweep_update.launches_by_type["complex128"] == before + 1
        assert got.dtype == torch.complex128
        assert _rel(got, want) < 1e-13
        assert float(got[N].abs().max()) == 0.0


@pytest.mark.parametrize("B,ni_pad,nb,kc", [(1, 512, 512, 48),
                                            (1023, 32, 64, 32),
                                            (8, 256, 640, 48),
                                            (3, 24, 52, 33), (2, 40, 130, 100)])
def test_complex_lowrank_schur_update_kernel(dev, B, ni_pad, nb, kc):
    """Kernel F in complex128 at the damped n=512 plan's shapes, odd widths
    and a rank above one 64-column group of W: within 1e-13 of its plain
    version (plain transposes)."""
    rng = np.random.default_rng(nb + kc + B)
    m = ni_pad + nb
    front = _crandn(rng, (B, m, m), torch.complex128, dev)
    RU = _crandn(rng, (B, ni_pad, kc), torch.complex128, dev)
    RV = _crandn(rng, (B, nb, kc), torch.complex128, dev)
    sperm = torch.as_tensor(np.stack([rng.permutation(nb) for _ in range(B)]),
                            device=dev)
    before = lowrank_schur_update.launches_by_type.get("complex128", 0)
    got = lowrank_schur_update(front, ni_pad, RU, RV, sperm)
    torch.cuda.synchronize()
    assert lowrank_schur_update.launches_by_type["complex128"] == before + 1
    want = lowrank_schur_update_plain(front, ni_pad, RU, RV, sperm)
    assert got.dtype == torch.complex128
    assert _rel(got, want) < 1e-13


@pytest.mark.parametrize("B,m,n,s,r,cap", [(1, 512, 512, 56, 56, 48),
                                           (1023, 64, 32, 32, 32, 32),
                                           (9, 24, 20, 14, 12, 16),
                                           (3, 130, 70, 72, 72, 64)])
def test_complex_lowrank_truncate_kernel(dev, B, m, n, s, r, cap):
    """Kernel G in complex128 (real singular values) at the damped n=512
    plan's shapes and with cap padding: the rank and V (the plain,
    unconjugated transpose of Vh) bit for bit, U to 1e-13."""
    rng = np.random.default_rng(m + n + B)
    Q = _crandn(rng, (B, m, s), torch.complex128, dev)
    Uw = _crandn(rng, (B, s, r), torch.complex128, dev)
    Vh = _crandn(rng, (B, r, n), torch.complex128, dev)
    sv = np.sort(np.abs(rng.standard_normal((B, r))) * 0.5 ** (
        np.arange(r) * 8.0 / r), axis=-1)[:, ::-1].copy()
    sv = torch.as_tensor(sv, device=dev)
    for atol, rtol in ((1e-3, 1e-2), (0.0, 1e-9)):
        got = lowrank_truncate(Q, Uw, sv, Vh, atol, rtol, cap)
        want = lowrank_truncate_plain(Q, Uw, sv, Vh, atol, rtol, cap)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
        assert _rel(got[0], want[0]) <= 1e-13


def test_complex_lowrank_slice_on_cuda(dev):
    """The damped system on low-rank compressed levels on the card: a
    complex128 factor and solve, relres <= 1e-9 within two iterations of
    the same run on the CPU (the same sketches), every kernel of
    ``kernels.COMPLEX_LOWRANK_PATH`` launched in its type."""
    from hsolve_torch.factor import solve_with_data

    A, b, shape = ht.helmholtz2d(64, k=20.0, damping=0.1)
    tree = ht.nested_dissection(shape, leafmax=40)
    iters = []
    for d in (dev, torch.device("cpu")):
        kernels.reset_launch_counts()
        F = ht.factor(A, tree, swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3,
                      kest=32, hss=False, device=d)
        assert F.dtype == torch.complex128
        op, mv = ht.spmv_format(A, device=d)
        x, info = ht.gmres_compiled(mv, solve_with_data,
                                    torch.as_tensor(b, device=d), reltol=1e-9,
                                    restart=30, maxiter=60, mv_data=op,
                                    M_data=F.solve_data)
        assert info["converged"]
        xn = x.cpu().numpy()
        assert np.linalg.norm(A @ xn - b) / np.linalg.norm(b) <= 1e-9
        assert F.maxrank() > 0 and not F.rank_report()["saturated"]
        iters.append(info["iters"])
        if d.type == "cuda":
            counts = kernels.launch_counts()
            assert all(counts.get(k, 0) > 0
                       for k in kernels.COMPLEX_LOWRANK_PATH), counts
    assert abs(iters[0] - iters[1]) <= 2


def test_complex_rand_lowrank_on_cuda_matches_cpu(dev):
    """``rand_lowrank`` on complex blocks on the card against the CPU's (the
    same sketch): equal ranks and ``U V^T`` to 1e-12.  The card's SVD returns
    ``Vh`` as a lazily conjugated view, which kernel G must read
    conjugated."""
    from hsolve_torch.ops.lowrank import rand_lowrank

    rng = np.random.default_rng(5)
    A = _crandn(rng, (3, 64, 32), torch.complex128, dev)
    om = torch.as_tensor(rng.standard_normal((32, 32)), device=dev).to(
        torch.complex128)
    g = rand_lowrank(A, om, 1e-6, 1e-6, 24)
    c = rand_lowrank(A.cpu(), om.cpu(), 1e-6, 1e-6, 24)
    assert torch.equal(g.rank.cpu(), c.rank)
    assert _rel((g.U @ g.V.mT).cpu(), c.U @ c.V.mT) < 1e-12


# ---------------------------------------------------------------------------
# complex values on the structured (HSS) levels: H-K in complex128
# ---------------------------------------------------------------------------

def _random_hss_c128(dev, B, depth, ls, r, seed):
    """Random complex128 generators of a batch of HSS matrices on the card."""
    rng = np.random.default_rng(seed)
    h = _random_hss(dev, B, depth, ls, r, seed)
    return h.map(lambda a: a.to(torch.complex128) + 1j * torch.as_tensor(
        rng.standard_normal(tuple(a.shape)) / np.sqrt(a.shape[-1]),
        device=dev))


@pytest.mark.parametrize("m,n,k", [(202, 384, 192), (58, 96, 48)])
def test_complex_cpqr_kernel_selects_the_plain_pivots(dev, m, n, k):
    """Kernel H in complex128 on the default n=512 plan's widest panel
    ([202, 384]: 16-byte values take a cluster of 8 CTAs) and a small one:
    the plain version's pivots and ranks on decaying spectra, one launch
    counted in complex128."""
    from hsolve_torch.ops.lowrank import cpqr_cluster

    assert cpqr_cluster(m, n, 16)[0] >= cpqr_cluster(m, n)[0]
    rng = np.random.default_rng(m + n)
    A = _crandn(rng, (5, m, n), torch.complex128, dev) * torch.as_tensor(
        0.97 ** np.arange(n), device=dev)
    for tol in (1e-3, 1e-9):
        before = cpqr_pivots.launches_by_type.get("complex128", 0)
        piv, rank = cpqr_pivots(A, tol, tol, k)
        assert cpqr_pivots.launches_by_type["complex128"] == before + 1
        ppiv, prank = cpqr_pivots_plain(A, tol, tol, k)
        assert torch.equal(rank, prank) and torch.equal(piv, ppiv)
        assert int(rank.min()) > 0


@pytest.mark.parametrize("p,q", [(70, 45), (130, 192)])
def test_complex_hss_entries_kernel(dev, p, q):
    """Kernel I in complex128 (T . V, no conjugate) at rank 192, every LCA
    level, out-of-range indices NaN where the plain version's are."""
    h = _random_hss_c128(dev, 2, 3, 24, 192, seed=p)
    ef = H.hss_entry_factors(h)
    n = h.plan.n_pad
    rng = np.random.default_rng(q)
    rows = rng.integers(0, n, (2, 3, p))
    cols = rng.integers(0, n, (2, 3, q))
    rows[0, 1, 3], cols[1, 1, -1] = -1, n + 7
    rows, cols = torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)
    before = H.hss_entries_prepared.launches_by_type.get("complex128", 0)
    got = H.hss_entries_prepared(ef, rows, cols)
    assert H.hss_entries_prepared.launches_by_type["complex128"] == before + 1
    ref = H.hss_entries_prepared_plain(ef, rows, cols)
    assert got.dtype == torch.complex128
    assert torch.equal(got.isnan(), ref.isnan())
    fin = ~ref.isnan()
    assert _rel(got[fin], ref[fin]) < 1e-13


@pytest.mark.parametrize("B,depth,ls,r", [(3, 4, 24, 192), (127, 2, 24, 48)])
@pytest.mark.parametrize("k", [1, 112])
def test_complex_hss_matvec_kernel(dev, B, depth, ls, r, k):
    """Kernel J in complex128 at n=512 default-caps shapes, both directions
    (``A^T``: the plain transpose), against its plain version."""
    h = _random_hss_c128(dev, B, depth, ls, r, seed=r + k)
    x = _crandn(np.random.default_rng(k), (B, h.plan.n_pad, k),
                torch.complex128, dev)
    for adj in (False, True):
        before = H.hss_matvec.launches_by_type.get("complex128", 0)
        got = H.hss_matvec(h, x, adj)
        assert H.hss_matvec.launches_by_type["complex128"] == before + 1
        assert _rel(got, H.hss_matvec_plain(h, x, adj)) < 1e-13


@pytest.mark.parametrize("r", [48, 192])
@pytest.mark.parametrize("adjoint", [False, True])
def test_complex_hss_level_correct_kernel(dev, r, adjoint):
    """Kernel K in complex128 (one CUDA-core kernel for every k) on random
    operands of rank r (cores up to 384 wide), k = 1 (the solve), 3 and r
    (hss_factor), against its plain version."""
    rng = np.random.default_rng(r + adjoint)
    B, m, blk = 3, 1, r + 5
    M = np.eye(2 * r) + (rng.standard_normal((B, m, 2 * r, 2 * r))
                         + 1j * rng.standard_normal((B, m, 2 * r, 2 * r))) / (
        6 * np.sqrt(2 * r))
    lu, piv = dk.lu_factor(torch.as_tensor(M, device=dev))
    c = lambda *s: _crandn(rng, s, torch.complex128, dev)
    Bl, Br, Phi = c(B, m, r, r), c(B, m, r, r), c(B, 2 * m * blk, r)
    for k in (1, 3, r):
        Y, xi = c(B, 2 * m * blk, k), c(B, 2 * m, r, k)
        args = (xi, Bl, Br, lu.contiguous(), piv.contiguous(), Phi, adjoint)
        want = H.hss_level_correct_plain(Y.clone(), *args)
        before = H.hss_level_correct.launches_by_type.get("complex128", 0)
        got = H.hss_level_correct(Y.clone(), *args)
        assert H.hss_level_correct.launches_by_type["complex128"] == before + 1
        assert _rel(got, want) < 1e-13


def test_complex_structured_slice_on_cuda(dev):
    """The damped system helmholtz2d(128, k=40, damping=0.1) on structured
    levels (kest=32, hss at its default) on the card: a complex128 factor
    and solve, relres <= 1e-9 within two iterations of the same run on the
    CPU (the same sketches), every kernel of ``kernels.COMPLEX_HSS_PATH``
    launched in its type."""
    from hsolve_torch.factor import solve_with_data

    A, b, shape = ht.helmholtz2d(128, k=40.0, damping=0.1)
    tree = ht.nested_dissection(shape, leafmax=100)
    iters = []
    for d in (dev, torch.device("cpu")):
        kernels.reset_launch_counts()
        F = ht.factor(A, tree, swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3,
                      kest=32, device=d)
        assert F.dtype == torch.complex128
        op, mv = ht.spmv_format(A, device=d)
        x, info = ht.gmres_compiled(mv, solve_with_data,
                                    torch.as_tensor(b, device=d), reltol=1e-9,
                                    restart=30, maxiter=60, mv_data=op,
                                    M_data=F.solve_data)
        assert info["converged"] and info["iters"] <= 8
        xn = x.cpu().numpy()
        assert np.linalg.norm(A @ xn - b) / np.linalg.norm(b) <= 1e-9
        assert F.maxrank() > 0 and not F.rank_report()["saturated"]
        iters.append(info["iters"])
        if d.type == "cuda":
            counts = kernels.launch_counts()
            assert all(counts.get(k, 0) > 0
                       for k in kernels.COMPLEX_HSS_PATH), counts
    assert abs(iters[0] - iters[1]) <= 2


# ---------------------------------------------------------------------------
# float32 on the compressed and structured levels (the JAX bench's device
# configuration): E-K in float32
# ---------------------------------------------------------------------------

F32 = torch.float32


@pytest.mark.parametrize("B,R,Cc,kc,k", [(1, 512, 512, 48, 1),
                                         (1023, 64, 32, 32, 1),
                                         (8, 640, 256, 48, 3),
                                         (5, 40, 56, 33, 2)])
def test_float32_lowrank_sweep_update_kernel(dev, B, R, Cc, kc, k):
    """Kernel E in float32 at the n=512 low-rank plan's shapes and an odd
    rank, both forms, with sentinels: float64 sums rounded once, as its
    plain version (within 1e-6 of it), the sentinel row zero."""
    rng = np.random.default_rng(B + R + kc + k + 7)
    N = B * (R + Cc) + 50
    C, ids_out, U, V, fwd, bwd = _sweep_operands(dev, rng, B, R, Cc, kc, k, N)
    C, U, V = C.to(F32), U.to(F32), V.to(F32)
    fwd = {"X": fwd["X"].to(F32)}
    for kw in (fwd, bwd):
        before = lowrank_sweep_update.launches_by_type.get("float32", 0)
        got = lowrank_sweep_update(C.clone(), ids_out, U, V, N, **kw)
        want = lowrank_sweep_update_plain(C.clone(), ids_out, U, V, N, **kw)
        assert lowrank_sweep_update.launches_by_type["float32"] == before + 1
        assert got.dtype == F32
        assert _rel(got, want) < 1e-6
        assert float(got[N].abs().max()) == 0.0


@pytest.mark.parametrize("B,ni_pad,nb,kc", [(1, 512, 512, 48),
                                            (1023, 32, 64, 32),
                                            (8, 256, 640, 48),
                                            (3, 24, 52, 33), (2, 40, 130, 100),
                                            (2, 2072, 2216, 560)])
def test_float32_lowrank_schur_update_kernel(dev, B, ni_pad, nb, kc):
    """Kernel F in float32 (the CUDA-core form) at n=512 and 48^3 shapes,
    odd widths and a rank above one 64-column group of W: within 1e-5 of
    its plain version."""
    rng = np.random.default_rng(nb + kc + B)
    m = ni_pad + nb
    g = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=F32,
                                   device=dev)
    front, RU, RV = g(B, m, m), g(B, ni_pad, kc), g(B, nb, kc)
    sperm = torch.as_tensor(np.stack([rng.permutation(nb) for _ in range(B)]),
                            device=dev)
    before = lowrank_schur_update.launches_by_type.get("float32", 0)
    got = lowrank_schur_update(front, ni_pad, RU, RV, sperm)
    torch.cuda.synchronize()
    assert lowrank_schur_update.launches_by_type["float32"] == before + 1
    want = lowrank_schur_update_plain(front, ni_pad, RU, RV, sperm)
    assert got.dtype == F32
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("B,m,n,s,r,cap", [(1, 512, 512, 56, 56, 48),
                                           (1023, 64, 32, 32, 32, 32),
                                           (9, 24, 20, 14, 12, 16),
                                           (3, 130, 70, 72, 72, 64)])
def test_float32_lowrank_truncate_kernel(dev, B, m, n, s, r, cap):
    """Kernel G in float32 (float32 singular values, the threshold rounded
    as the plain version's float32 ops round it): the rank and V bit for
    bit, U to 1e-5."""
    rng = np.random.default_rng(m + n + B)
    g = lambda *sh: torch.as_tensor(rng.standard_normal(sh), dtype=F32,
                                    device=dev)
    Q, Uw, Vh = g(B, m, s), g(B, s, r), g(B, r, n)
    sv = np.sort(np.abs(rng.standard_normal((B, r))) * 0.5 ** (
        np.arange(r) * 8.0 / r), axis=-1)[:, ::-1].copy()
    sv = torch.as_tensor(sv, dtype=F32, device=dev)
    for atol, rtol in ((1e-3, 1e-2), (0.0, 1e-5)):
        got = lowrank_truncate(Q, Uw, sv, Vh, atol, rtol, cap)
        want = lowrank_truncate_plain(Q, Uw, sv, Vh, atol, rtol, cap)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
        assert _rel(got[0], want[0]) <= 1e-5


@pytest.mark.parametrize("m,n,k", [(202, 384, 192), (58, 96, 48),
                                   (394, 768, 384)])
def test_float32_cpqr_kernel_selects_the_plain_pivots(dev, m, n, k):
    """Kernel H in float32 (float32 read, the pivot loop in float64) on the
    default n=512 plan's widest panel (a cluster of 4, as float64's), a
    small one and a 3D panel (in a global scratch copy on 8 CTAs): the
    plain version's pivots and ranks on decaying spectra, one launch
    counted in float32."""
    from hsolve_torch.ops.lowrank import cpqr_cluster, cpqr_itemsize

    assert cpqr_cluster(m, n, cpqr_itemsize(F32)) == cpqr_cluster(m, n)
    rng = np.random.default_rng(m + n)
    A = torch.as_tensor(rng.standard_normal((5, m, n)) * 0.97 ** np.arange(n),
                        dtype=F32, device=dev)
    for tol in (1e-2, 1e-3):
        before = cpqr_pivots.launches_by_type.get("float32", 0)
        piv, rank = cpqr_pivots(A, tol, tol, k)
        assert cpqr_pivots.launches_by_type["float32"] == before + 1
        ppiv, prank = cpqr_pivots_plain(A, tol, tol, k)
        assert torch.equal(rank, prank) and torch.equal(piv, ppiv)
        assert int(rank.min()) > 0


def _random_hss_f32(dev, B, depth, ls, r, seed):
    return _random_hss(dev, B, depth, ls, r, seed).map(lambda a: a.to(F32))


@pytest.mark.parametrize("p,q", [(70, 45), (130, 192)])
def test_float32_hss_entries_kernel(dev, p, q):
    """Kernel I in float32 at rank 192, every LCA level, out-of-range
    indices NaN where the plain version's are; within 1e-5."""
    h = _random_hss_f32(dev, 2, 3, 24, 192, seed=p)
    ef = H.hss_entry_factors(h)
    n = h.plan.n_pad
    rng = np.random.default_rng(q)
    rows = rng.integers(0, n, (2, 3, p))
    cols = rng.integers(0, n, (2, 3, q))
    rows[0, 1, 3], cols[1, 1, -1] = -1, n + 7
    rows, cols = torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)
    before = H.hss_entries_prepared.launches_by_type.get("float32", 0)
    got = H.hss_entries_prepared(ef, rows, cols)
    assert H.hss_entries_prepared.launches_by_type["float32"] == before + 1
    ref = H.hss_entries_prepared_plain(ef, rows, cols)
    assert got.dtype == F32
    assert torch.equal(got.isnan(), ref.isnan())
    fin = ~ref.isnan()
    assert _rel(got[fin], ref[fin]) < 1e-5


@pytest.mark.parametrize("B,depth,ls,r", J_SHAPES + [(1, 4, 32, 400)])
@pytest.mark.parametrize("k", [1, 112])
def test_float32_hss_matvec_kernel(dev, B, depth, ls, r, k):
    """Kernel J in float32 (the CUDA-core form) at the n=512 shapes and a
    3D cap, both directions, against its plain version (1e-5)."""
    h = _random_hss_f32(dev, B, depth, ls, r, seed=r + k)
    x = torch.as_tensor(np.random.default_rng(k).standard_normal(
        (B, h.plan.n_pad, k)), dtype=F32, device=dev)
    for adj in (False, True):
        before = H.hss_matvec.launches_by_type.get("float32", 0)
        got = H.hss_matvec(h, x, adj)
        assert H.hss_matvec.launches_by_type["float32"] == before + 1
        assert _rel(got, H.hss_matvec_plain(h, x, adj)) < 1e-5


@pytest.mark.parametrize("r", [48, 192, 400])
@pytest.mark.parametrize("adjoint", [False, True])
def test_float32_hss_level_correct_kernel(dev, r, adjoint):
    """Kernel K in float32 (one CUDA-core kernel for every k, computing in
    float64 on its float32 operands) on random well-conditioned cores of
    rank r (up to 800 wide), k = 1, 3 and r, against its float32 plain
    version (1e-5)."""
    rng = np.random.default_rng(r + adjoint)
    B, m, blk = 3, 1, r + 5
    M = np.eye(2 * r) + rng.standard_normal((B, m, 2 * r, 2 * r)) / (
        6 * np.sqrt(2 * r))
    lu, piv = dk.lu_factor(torch.as_tensor(M, dtype=F32, device=dev))
    g = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=F32,
                                   device=dev)
    Bl, Br, Phi = g(B, m, r, r), g(B, m, r, r), g(B, 2 * m * blk, r)
    for k in (1, 3, r):
        Y, xi = g(B, 2 * m * blk, k), g(B, 2 * m, r, k)
        args = (xi, Bl, Br, lu.contiguous(), piv.contiguous(), Phi, adjoint)
        want = H.hss_level_correct_plain(Y.clone(), *args)
        before = H.hss_level_correct.launches_by_type.get("float32", 0)
        got = H.hss_level_correct(Y.clone(), *args)
        assert H.hss_level_correct.launches_by_type["float32"] == before + 1
        assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("hss", [False, True])
def test_float32_compressed_slice_on_cuda(dev, hss):
    """The JAX bench's device configuration on compressed levels,
    helmholtz2d(128, k=40), low-rank (hss=False) and structured (kest=32):
    a float32 factor inside mixed-precision GMRES on the card, relres <=
    1e-9 within two iterations of the same run on the CPU (the same float32
    sketches), every kernel of ``kernels.LOWRANK_MIXED_PATH`` /
    ``HSS_MIXED_PATH`` launched in its type."""
    from hsolve_torch.factor import solve_with_data

    A, b, shape = ht.helmholtz2d(128, k=40.0)
    tree = ht.nested_dissection(shape, leafmax=100)
    prec = lambda d, v: solve_with_data(d, v.to(F32)).to(v.dtype)
    iters = []
    for d in (dev, torch.device("cpu")):
        kernels.reset_launch_counts()
        F = ht.factor(A, tree, swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3,
                      kest=32, hss=hss, dtype=F32, device=d)
        assert F.dtype == F32
        op64, mv = ht.spmv_format(A, device=d)
        op32, _ = ht.spmv_format(A, dtype=np.float32, device=d)
        x, info = ht.gmres_compiled(
            mv, prec, torch.as_tensor(b, device=d), reltol=1e-9, restart=30,
            maxiter=60, mv_data=op64, M_data=F.solve_data,
            inner_dtype="float32", mv_data_inner=op32, m_eps=1e-6)
        assert info["converged"]
        xn = x.cpu().numpy()
        assert np.linalg.norm(A @ xn - b) / np.linalg.norm(b) <= 1e-9
        assert F.maxrank() > 0 and not F.rank_report()["saturated"]
        iters.append(info["iters"])
        if d.type == "cuda":
            counts = kernels.launch_counts()
            path = kernels.HSS_MIXED_PATH if hss else \
                kernels.LOWRANK_MIXED_PATH
            assert all(counts.get(k, 0) > 0 for k in path), counts
    assert abs(iters[0] - iters[1]) <= 2
