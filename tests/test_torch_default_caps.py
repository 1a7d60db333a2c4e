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
