"""Kernels K and H at the rank caps of the default options, on the CPU.

Under the default caps (boundary / 4) the helmholtz2d(512) structured plan
has ranks up to r = 192, and ``factor(adaptive=True)`` doubles a saturated
cap as ``rank_cap`` (r = 384, then 768).  Kernel K's core is then up to
2r x 2r and kernel H's largest panel [s, 2r] = [202, 384] (the sample width
s = r + 10 at the default stepsize).  Here:

- the plain versions of K (:func:`hss_level_correct_plain`) and of H (the
  pivot loop of :func:`cpqr`) against the JAX package's
  ``_apply_level_correction`` and ``cpqr`` at r = 96 and 192 and at that
  panel (1e-12 relative; pivots and ranks equal);
- the launch geometry the wrappers give at any rank: K's cluster per node,
  right-hand sides per CTA and shared memory (the operands stream, so it no
  longer grows with r^2), H's cluster size by bytes and its global-memory
  form beyond a cluster's shared memory."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsolve.ops import dense as JD
from hsolve.ops import hss as J
from hsolve.ops import lowrank as JL
from hsolve_torch.ops import hss as T
from hsolve_torch.ops import lowrank as TL

torch.set_num_threads(1)

# the largest ID panel of the default n=512 plan: [s, 2 r] at r = 192
LARGEST_PANEL = (202, 384, 192)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _solver_pair(r, seed):
    """One depth-2 HSS solver (two nodes at level 1) with random generators
    of width r and a well-conditioned random core per node, in both
    packages' types: the operands of one level correction."""
    rng = np.random.default_rng(seed)
    ls = r + 8
    plan = dict(ls=ls, depth=2, n1=2 * ls, n2=2 * ls)
    n = 4 * ls
    a = lambda *s: rng.standard_normal(s)
    D, U, V = a(4, ls, ls), a(4, ls, r) / ls, a(4, ls, r) / ls
    B12, B21 = [a(2, r, r), a(1, r, r)], [a(2, r, r), a(1, r, r)]
    Rs, Ws = [a(4, r, r), np.zeros((2, r, r))], [a(4, r, r), np.zeros((2, r, r))]
    M = np.eye(2 * r) + a(2, 2 * r, 2 * r) / (4 * np.sqrt(2 * r))
    N_ = np.eye(2 * r) + a(2, 2 * r, 2 * r) / (4 * np.sqrt(2 * r))
    Phi, PhiT = a(n, r), a(n, r)
    hj = J.Hss(D=jnp.asarray(D), U=jnp.asarray(U), V=jnp.asarray(V),
               Rs=[jnp.asarray(x) for x in Rs], Ws=[jnp.asarray(x) for x in Ws],
               B12s=[jnp.asarray(x) for x in B12], B21s=[jnp.asarray(x) for x in B21],
               plan=J.ClusterPlan(**plan))
    Mlu, Mpiv = JD.lu_factor(jnp.asarray(M))
    Nlu, Npiv = JD.lu_factor(jnp.asarray(N_))
    sj = J.HssSolver(h=hj, D_lu=None, D_piv=None, Phis=[jnp.asarray(Phi)],
                     cores_lu=[Mlu], cores_piv=[Mpiv], PhisT=[jnp.asarray(PhiT)],
                     coresT_lu=[Nlu], coresT_piv=[Npiv])
    t = lambda x: torch.as_tensor(np.array(x))[None].contiguous()
    ht = T.Hss(D=t(D), U=t(U), V=t(V), Rs=[t(x) for x in Rs], Ws=[t(x) for x in Ws],
               B12s=[t(x) for x in B12], B21s=[t(x) for x in B21],
               plan=T.ClusterPlan(**plan))
    cores = dict(fwd=(t(Mlu), t(Mpiv).long(), t(Phi)),
                 adj=(t(Nlu), t(Npiv).long(), t(PhiT)))
    return sj, ht, cores, n


@pytest.mark.parametrize("r", [96, 192])
@pytest.mark.parametrize("adjoint", [False, True])
def test_level_correction_plain_matches_jax_at_default_ranks(r, adjoint):
    """Kernel K's plain version on 2r x 2r cores (192 and 384 wide) against
    ``_apply_level_correction``, k = 1 (the solve) and k = 3."""
    sj, ht, cores, n = _solver_pair(r, seed=r + adjoint)
    rng = np.random.default_rng(7)
    for k in (1, 3):
        Y = rng.standard_normal((n, k))
        ref = J._apply_level_correction(sj, jnp.asarray(Y), 1, adjoint)
        Yt = torch.as_tensor(Y)[None].contiguous()
        xi = T._upsweep(ht, Yt, 0, adjoint).contiguous()
        lu, piv, Phi = cores["adj" if adjoint else "fwd"]
        Bl, Br = (ht.B21s[0], ht.B12s[0]) if adjoint else (ht.B12s[0], ht.B21s[0])
        got = T.hss_level_correct_plain(Yt.clone(), xi, Bl, Br, lu, piv, Phi,
                                        adjoint)
        assert _rel(got[0].numpy(), ref) < 1e-12


@pytest.mark.parametrize("m,n,cap", [(106, 192, 96), LARGEST_PANEL])
def test_cpqr_matches_jax_at_default_panels(m, n, cap):
    """Kernel H's plain pivot loop (inside the port's cpqr) on the ID panels
    [s, 2 r] of r = 96 and of the largest one, 192: JAX's pivots and ranks,
    R to 1e-10 relative."""
    rng = np.random.default_rng(m)
    M = rng.standard_normal((2, m, n)) * 0.93 ** np.arange(n)
    for tol in (1e-3, 1e-9):
        f = JL.cpqr(jnp.asarray(M), tol, tol, cap)
        g = TL.cpqr(torch.as_tensor(M), tol, tol, cap)
        assert np.array_equal(g.piv.numpy(), np.asarray(f.piv))
        assert np.array_equal(g.rank.numpy(), np.asarray(f.rank))
        assert _rel(g.R.numpy(), f.R) < 1e-10


@pytest.mark.parametrize("r", [16, 48, 96, 192, 384, 768])
def test_kernel_k_geometry_at_any_rank(r):
    """K takes every rank up to the adaptive replans' 768, each CTA's shared
    memory (the ring of streamed tiles and w [3r, nc + 4]) within 227 KB.
    With k > 1, a launch whose CTAs fit the card at once takes 16 columns a
    CTA and one cluster per node (clusters of 8, or none, where the card
    cannot hold that many at once); a larger one takes 32 columns a CTA and
    no cluster.  The tile count is the streamed sequence's."""
    for nodes, k in ((1, 2), (1, r), (124, r), (1, 400), (56, 272), (8, 400)):
        nc, cs, groups, stages = T.level_correct_geometry(r, k, nodes)
        assert nc in (4, 8, 16, 24, 32) and 1 <= cs <= 16 and stages >= 2
        assert T.level_correct_smem(r, nc, stages) <= T.HSS_CORRECT_MAX_SMEM
        assert cs * nc * groups >= k > cs * nc * (groups - 1)
        single = nodes * -(-k // 16) <= 132
        if r <= 192:
            assert nc == (8 if k <= 8 else 16 if single else 32)
        assert cs == (min(16, -(-k // nc)) if single else 1)
    # a card that holds 3 clusters of 16 and 15 of 8 at once: 4 nodes of 256
    # columns take clusters of 8, two per node
    few = lambda nc, cs, stages: 3 if cs > 8 else 15
    if r <= 192:
        assert T.level_correct_geometry(r, 256, 1, active=few)[1:3] == (16, 1)
        assert T.level_correct_geometry(r, 256, 4, active=few)[1:3] == (8, 2)
    assert T.level_correct_geometry(r, 256, 4, active=lambda *a: 0)[1] == 1
    r2 = 2 * r
    tiles = sum(-(-p0 // 64) + 1 for p0 in range(0, r2, 32)) + \
        sum(-(-max(r2 - p0 - 32, 0) // 64) + 1 for p0 in range(0, r2, 32))
    assert T.level_correct_tiles(r2) == tiles
    # k > 1, right-looking in 64-row tiles of 32-column chunks: eta, per
    # panel its diagonal block and the tiles below and above it, Phi
    lu = sum(2 + -(-max(r2 - p0 - 32, 0) // 64) + -(-p0 // 64)
             for p0 in range(0, r2, 32))
    assert T.level_correct_block_tiles(r, 24) == \
        2 * -(-r // 32) * (-(-r // 64) + 1) + lu


@pytest.mark.parametrize("m,n,cs,resident", [
    (58, 32, 1, True), (92, 64, 1, True), (202, 96, 1, True),
    (202, 384, 4, True), (106, 192, 1, True), (394, 768, 8, False),
    (778, 1536, 8, False)])
def test_kernel_h_cluster_by_bytes(m, n, cs, resident):
    """H spreads a matrix's columns over the fewest CTAs of a cluster whose
    shared memory holds them; beyond 8 CTAs (the adaptive replans' panels)
    the columns stay in a global scratch copy and only the norms and the
    pivot direction live in shared memory."""
    assert TL.cpqr_cluster(m, n) == (cs, resident)
    assert TL.cpqr_smem(m, n, cs, resident) <= TL.CPQR_MAX_SMEM
    if resident and cs > 1:
        assert TL.cpqr_smem(m, n, cs // 2) > TL.CPQR_MAX_SMEM


@pytest.mark.parametrize("m,n,cs,resident", [
    (58, 32, 1, True), (92, 64, 1, True), (202, 96, 2, True),
    (106, 192, 2, True), (138, 256, 4, True), (202, 384, 8, True),
    (394, 768, 8, False)])
def test_kernel_h_cluster_by_bytes_complex128(m, n, cs, resident):
    """In complex128 H's columns, coefficients and pivot direction take 16
    bytes a value and the norms 8: the default caps' widest panel [202,
    384] needs 315,808 bytes a CTA on 4 CTAs, so it takes a cluster of 8
    (159,520 bytes); every panel of the default n=512 plan keeps a launch."""
    assert TL.cpqr_smem(202, 384, 4, True, 16) == 315808
    assert TL.cpqr_smem(202, 384, 8, True, 16) == 159520
    assert TL.cpqr_cluster(m, n, 16) == (cs, resident)
    assert TL.cpqr_smem(m, n, cs, resident, 16) <= TL.CPQR_MAX_SMEM
    if resident and cs > 1:
        assert TL.cpqr_smem(m, n, cs // 2, True, 16) > TL.CPQR_MAX_SMEM
    # the float64 sizes are unchanged by the value-type argument
    assert TL.cpqr_smem(m, n, cs, resident) == \
        8 * ((m * -(-n // cs) if resident else 0) + 2 * -(-n // cs) + m)


@pytest.mark.parametrize("r", [16, 48, 96, 192, 384, 768])
def test_kernel_k_complex128_geometry_at_any_rank(r):
    """K's complex128 form (one CUDA-core kernel for every k): up to 32
    right-hand sides a CTA, halved while xi and w [2r, nc] do not fit 227
    KB; one column a CTA at k = 1, 16 at the default caps' 2r = 384."""
    for k in (1, 2, 3, r, 400):
        nc = T.level_correct_geometry_cc(r, k, 16)
        assert 1 <= nc <= min(k, T.HSS_CORRECT_MAX_COLS)
        assert T.level_correct_smem_cc(r, nc, 16) <= T.HSS_CORRECT_MAX_SMEM
        if nc < min(k, T.HSS_CORRECT_MAX_COLS):
            assert T.level_correct_smem_cc(r, 2 * nc, 16) > \
                T.HSS_CORRECT_MAX_SMEM
    assert T.level_correct_geometry_cc(r, 1, 16) == 1
    if r == 192:
        assert T.level_correct_geometry_cc(r, 400, 16) == 16


@pytest.mark.parametrize("m,n,cs,resident", [
    (58, 32, 1, True), (92, 64, 1, True), (202, 96, 1, True),
    (202, 384, 4, True), (106, 192, 1, True), (394, 768, 8, False),
    (400, 800, 8, False), (778, 1536, 8, False)])
def test_kernel_h_cluster_by_bytes_float32(m, n, cs, resident):
    """Float32 input runs H's pivot loop in float64 (``cpqr_loop_type``:
    widened as it is loaded), so its columns take float64's 8 bytes in
    shared memory and its launches are float64's at every default-caps and
    3D panel: the widest 2D panel [202, 384] on 4 CTAs, the 3D panels
    [394, 768] and [400, 800] in a global scratch copy (of float64
    values) on 8."""
    assert TL.cpqr_loop_type(torch.float32) == torch.float64
    assert TL.cpqr_itemsize(torch.float32) == TL.cpqr_itemsize(
        torch.float64) == 8
    assert TL.cpqr_itemsize(torch.complex128) == 16
    isz = TL.cpqr_itemsize(torch.float32)
    assert TL.cpqr_cluster(m, n, isz) == (cs, resident) == \
        TL.cpqr_cluster(m, n)
    assert TL.cpqr_smem(m, n, cs, resident, isz) <= TL.CPQR_MAX_SMEM


def test_kernel_h_float32_loop_is_float64s():
    """The float32 plain pivot loop is the float64 loop on the widened
    input: the same pivots and ranks, bit for bit.  Fault F8 (ROADMAP §3):
    on a rank-10 block whose tenth direction carries 3.2e-4 of its columns'
    norm (the transition compressions' truncation at 2.5e-4), a float32
    loop's downdate ``norms^2 - coef^2`` cancels to 0 at the tenth step
    and stops one rank short: the JAX package's float32 ``cpqr`` finds 9,
    float64 and the port 10."""
    rng = np.random.default_rng(1)
    m, n, r = 92, 64, 10
    G = np.linalg.qr(rng.standard_normal((m, r)))[0] * np.logspace(0, -3.5, r)
    A = (G @ rng.standard_normal((r, n)) / np.sqrt(r)).astype(np.float32)
    A = np.stack([A, A])
    piv32, rank32 = TL.cpqr_pivots_plain(torch.as_tensor(A), 2.5e-4, 2.5e-4,
                                         32)
    piv64, rank64 = TL.cpqr_pivots_plain(torch.as_tensor(A).double(), 2.5e-4,
                                         2.5e-4, 32)
    assert torch.equal(piv32, piv64) and torch.equal(rank32, rank64)
    assert rank64.tolist() == [10, 10]
    jrank = np.asarray(JL.cpqr(jnp.asarray(A), 2.5e-4, 2.5e-4, 32).rank)
    assert jrank.tolist() == [9, 9]


@pytest.mark.parametrize("r", [16, 48, 96, 192, 384, 400, 768])
def test_kernel_k_float32_geometry_at_any_rank(r):
    """K's float32 form (the complex128 CUDA-core kernel, computing in
    float64 on its float32 operands): xi and w in 8-byte values, up to 32
    right-hand sides a CTA, halved while they do not fit 227 KB: 32 through
    r = 217 (the 2D default caps' 192), 16 at the 3D caps' 400; one column a
    CTA at k = 1; never fewer than complex128's."""
    isz = T.level_correct_itemsize(torch.float32)
    assert isz == 8 and T.level_correct_itemsize(torch.complex128) == 16
    for k in (1, 2, 3, r, 400):
        nc = T.level_correct_geometry_cc(r, k, isz)
        assert 1 <= nc <= min(k, T.HSS_CORRECT_MAX_COLS)
        assert T.level_correct_smem_cc(r, nc, isz) <= T.HSS_CORRECT_MAX_SMEM
        assert T.level_correct_smem_cc(r, nc, isz) == \
            8 * (4 * r * nc + 32 * 33) + 8 * r
        if nc < min(k, T.HSS_CORRECT_MAX_COLS):
            assert T.level_correct_smem_cc(r, 2 * nc, isz) > \
                T.HSS_CORRECT_MAX_SMEM
        assert nc >= T.level_correct_geometry_cc(r, k, 16)
    assert T.level_correct_geometry_cc(r, 1, isz) == 1
    assert T.level_correct_geometry_cc(r, 400, isz) == \
        {16: 32, 48: 32, 96: 32, 192: 32, 384: 16, 400: 16, 768: 8}[r]
