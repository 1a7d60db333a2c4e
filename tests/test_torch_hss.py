"""The port's HSS operations (``hsolve_torch.ops.hss`` and the interpolative
decompositions of ``hsolve_torch.ops.lowrank``) against the JAX package's, on
the CPU in float64, where every kernel wrapper runs its plain version.

The JAX functions take one matrix and are ``vmap``ped; the port's carry the
batch axis, so a JAX result is compared with the port's batch element 0 (or
the JAX ``vmap`` of it).  Operations on a given HSS matrix (matvec, entries,
sub-blocks, generators, solver) run on the SAME generators in both packages:
the JAX compression's output is carried over with ``interop``'s converter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsolve.ops import hss as J
from hsolve.ops import lowrank as JL
from hsolve_torch.interop import _hss_from_numpy
from hsolve_torch.ops import hss as T
from hsolve_torch.ops import lowrank as TL

torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _toeplitz(n, diag=4.0):
    """tests/test_hss.py's kernel matrix: smooth off-diagonal decay."""
    i = np.arange(n)
    return 1.0 / (1.0 + np.abs(i[:, None] - i[None, :]) ** 1.5) + diag * np.eye(n)


def _scattered(n, seed=3):
    """A kernel matrix on random points with a little noise: compressible like
    the Toeplitz one, but without its mirror symmetry, whose exactly equal
    column norms leave CPQR's argmax to rounding."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    pts = np.sort(rng.random(n))
    return (1.0 / (1.0 + 50.0 * np.abs(pts[:, None] - pts[None, :]))
            + 4.0 * np.eye(n) + 1e-3 * rng.standard_normal((n, n))
            * np.exp(-np.abs(i[:, None] - i[None, :]) / 3.0))


PLAN = dict(ls=32, depth=3, n1=128, n2=128)


@pytest.fixture(scope="module")
def pair():
    """(A, JAX Hss, port Hss of the same generators) on the tie-free matrix."""
    A = _scattered(256)
    hj = J.hss_compress_dense(jnp.asarray(A), J.ClusterPlan(**PLAN), 1e-5, 1e-5, 24)
    return A, hj, _hss_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a)[None], hj), lambda a, dt=None: torch.as_tensor(
            a, dtype=dt))


@pytest.mark.parametrize("n1,n2,leafsize,min_depth", [
    (100, 60, 32, 1), (31, 32, 16, 1), (64, 0, 16, 1), (7, 300, 24, 3),
    (1, 1, 16, 2)])
def test_plan_cluster_matches_jax(n1, n2, leafsize, min_depth):
    pj = J.plan_cluster(n1, n2, leafsize, min_depth)
    pt = T.plan_cluster(n1, n2, leafsize, min_depth)
    assert (pt.ls, pt.depth, pt.n1, pt.n2) == (pj.ls, pj.depth, pj.n1, pj.n2)
    assert (pt.nleaves, pt.half, pt.n_pad) == (pj.nleaves, pj.half, pj.n_pad)
    assert np.array_equal(pt.embed(), pj.embed())
    assert [pt.level_nodes(i) for i in range(1, pt.depth + 1)] == \
        [pj.level_nodes(i) for i in range(1, pj.depth + 1)]


@pytest.mark.parametrize("m,n,cap,tol", [(40, 30, 20, 1e-6), (58, 32, 32, 1e-3),
                                         (23, 92, 24, 1e-9), (12, 12, 16, 0.0)])
def test_cpqr_and_interp_decomp_match_jax(m, n, cap, tol):
    """Equal pivots and ranks (kernel H's plain version), R and the
    interpolation matrix to 1e-10 relative."""
    rng = np.random.default_rng(m + n)
    M = rng.standard_normal((4, m, n)) * 0.6 ** np.arange(n)
    f = JL.cpqr(jnp.asarray(M), tol, tol, cap)
    g = TL.cpqr(torch.as_tensor(M), tol, tol, cap)
    assert np.array_equal(g.piv.numpy(), np.asarray(f.piv))
    assert np.array_equal(g.rank.numpy(), np.asarray(f.rank))
    assert _rel(g.R.numpy(), f.R) < 1e-10
    Jj, Tj, rj = JL.interp_decomp(jnp.asarray(M), tol, tol, cap)
    Jt, Tt, rt = TL.interp_decomp(torch.as_tensor(M), tol, tol, cap)
    assert np.array_equal(Jt.numpy(), np.asarray(Jj))
    assert np.array_equal(rt.numpy(), np.asarray(rj))
    assert _rel(Tt.numpy(), Tj) < 1e-10


def test_compress_dense_matches_jax(pair):
    """Deterministic compression: the same selections, generators to 1e-10."""
    A, hj, _ = pair
    ht = T.hss_compress_dense(torch.as_tensor(A)[None], T.ClusterPlan(**PLAN),
                              1e-5, 1e-5, 24)
    ref = [hj.D, hj.U, hj.V, *hj.Rs, *hj.Ws, *hj.B12s, *hj.B21s]
    for a, b in zip(ht.arrays(), ref):
        assert _rel(a[0].numpy(), b) < 1e-10
    assert _rel(T.hss_todense(ht)[0].numpy(), J.hss_todense(hj)) < 1e-10
    assert T.hss_rank(ht) == J.hss_rank(hj)


def test_compress_dense_on_the_toeplitz_fixture():
    """tests/test_hss.py's fixture.  Its mirror symmetry gives exactly tied
    column norms, which the two packages' sums break differently, so one
    selection may differ: the reconstructions are compared, with A and with
    each other, at the compression tolerance."""
    A = _toeplitz(256)
    hj = J.hss_compress_dense(jnp.asarray(A), J.ClusterPlan(**PLAN), 1e-10,
                              1e-10, 24)
    ht = T.hss_compress_dense(torch.as_tensor(A)[None], T.ClusterPlan(**PLAN),
                              1e-10, 1e-10, 24)
    dj, dt = np.asarray(J.hss_todense(hj)), T.hss_todense(ht)[0].numpy()
    assert np.linalg.norm(dt - A) / np.linalg.norm(A) < 1e-7
    assert _rel(dt, dj) < 1e-8
    assert 0 < T.hss_rank(ht) <= 24


@pytest.mark.parametrize("k", [1, 3])
def test_matvec_both_directions_matches_jax(pair, k):
    A, hj, ht = pair
    x = np.random.default_rng(k).standard_normal((256, k))
    for adj in (False, True):
        yj = J.hss_matvec(hj, jnp.asarray(x), adjoint=adj)
        yt = T.hss_matvec(ht, torch.as_tensor(x)[None], adj)[0]
        assert _rel(yt.numpy(), yj) < 1e-12
    assert _rel(T.hss_todense(ht)[0].numpy(), J.hss_todense(hj)) < 1e-12


def test_entries_match_jax(pair):
    """Entries at random positions and the leaf and coupling blocks the
    randomized compressors extract (the LCA level as a bit length)."""
    A, hj, ht = pair
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 256, size=(3, 37))
    cols = rng.integers(0, 256, size=(3, 23))
    ej = jax.vmap(lambda r, c: J.hss_entries(hj, r, c))(jnp.asarray(rows),
                                                         jnp.asarray(cols))
    et = T.hss_entries(ht, torch.as_tensor(rows)[None], torch.as_tensor(cols)[None])
    assert _rel(et[0].numpy(), ej) < 1e-12
    leaf = np.arange(256).reshape(8, 32)
    blocks = T.hss_entries(ht, torch.as_tensor(leaf)[None], torch.as_tensor(leaf)[None])
    assert np.array_equal(blocks[0].numpy(), np.asarray(hj.D))


def test_sub_generators_and_rank_match_jax(pair):
    A, hj, ht = pair
    for side in (0, 1):
        sj, st = J.hss_sub(hj, side), T.hss_sub(ht, side)
        assert (st.plan.ls, st.plan.depth, st.plan.n1, st.plan.n2) == \
            (sj.plan.ls, sj.plan.depth, sj.plan.n1, sj.plan.n2)
        assert _rel(T.hss_todense(st)[0].numpy(), J.hss_todense(sj)) < 1e-12
    for a, b in zip(T.generators(ht), J.generators(hj)):
        assert _rel(a[0].numpy(), b) < 1e-12
    assert T.hss_rank(ht) == J.hss_rank(hj)


def _jax_batched_sketches(key, B, n, s):
    """hss_randcompress_batched's draws: split(key, B), then per element
    kO, kP = split(k) and normal(kO | kP, (n, s))."""
    om, ps = [], []
    for k in jax.random.split(key, B):
        kO, kP = jax.random.split(k)
        om.append(np.array(jax.random.normal(kO, (n, s), dtype=jnp.float64)))
        ps.append(np.array(jax.random.normal(kP, (n, s), dtype=jnp.float64)))
    return torch.as_tensor(np.stack(om)), torch.as_tensor(np.stack(ps))


def test_randcompress_batched_with_jax_sketches():
    """Two dense operators compressed matrix-free: with JAX's sketches the
    port reports the same largest interpolation ranks and rebuilds the same
    matrices (to 1e-9 relative)."""
    As = np.stack([_scattered(256, seed=s) for s in (3, 4)])
    plan_j, plan_t = J.ClusterPlan(**PLAN), T.ClusterPlan(**PLAN)
    cap, kest, step, tol = 24, 16, 16, 1e-6
    key = jax.random.PRNGKey(5)

    def sample_j(op, X, adj):
        return (op.T if adj else op) @ X

    def blocks_j(op, r, c):
        return op[r[:, None], c[None, :]]

    hj, mj = J.hss_randcompress_batched(sample_j, blocks_j, jnp.asarray(As),
                                        plan_j, key, tol, tol, cap, kest=kest,
                                        stepsize=step)
    At = torch.as_tensor(As)
    s = T.sample_width(plan_t, cap, kest, step)
    Om, Ps = _jax_batched_sketches(key, 2, plan_t.n_pad, s)

    def sample_t(X, adj):
        return (At.transpose(-1, -2) if adj else At) @ X

    def blocks_t(r, c):
        b = torch.arange(2)[:, None, None, None]
        return At[b, r[..., :, None], c[..., None, :]]

    ht, mt = T.hss_randcompress_batched(sample_t, blocks_t, plan_t, Om, Ps, tol,
                                        tol, cap)
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    dj = np.asarray(jax.vmap(J.hss_todense)(hj))
    assert _rel(T.hss_todense(ht).numpy(), dj) < 1e-9
    assert np.linalg.norm(dj - As) / np.linalg.norm(As) < 1e-5


def test_adaptive_randcompress_with_jax_sketches():
    """The standalone adaptive compressor (tests/test_hss.py's case) given
    the draws of each try, fold_in(key, t) then split."""
    A = _scattered(256, seed=6)
    key = jax.random.PRNGKey(42)
    ops = J.SampleOps(sample=lambda X, adj: (jnp.asarray(A).T if adj
                                             else jnp.asarray(A)) @ X,
                      blocks=lambda r, c: jnp.asarray(A)[r[..., :, None],
                                                         c[..., None, :]])
    hj = J.hss_randcompress(ops, J.ClusterPlan(**PLAN), key, atol=1e-6,
                            rtol=1e-6, cap=24, kest=20)
    At = torch.as_tensor(A)[None]

    def sketch(t, s):
        kO, kP = jax.random.split(jax.random.fold_in(key, t))
        return tuple(torch.as_tensor(np.array(jax.random.normal(
            k, (256, s), dtype=jnp.float64)))[None] for k in (kO, kP))

    ht = T.hss_randcompress(
        lambda X, adj: (At.transpose(-1, -2) if adj else At) @ X,
        lambda r, c: At[0][r[..., :, None], c[..., None, :]],
        T.ClusterPlan(**PLAN), sketch, 1e-6, 1e-6, 24, kest=20)
    dt = T.hss_todense(ht)[0].numpy()
    assert _rel(dt, J.hss_todense(hj)) < 1e-9
    assert np.linalg.norm(dt - A) / np.linalg.norm(A) < 1e-5


def test_factor_and_solve_both_directions_match_jax(pair):
    A, hj, ht = pair
    sj, st = J.hss_factor(hj), T.hss_factor(ht)
    b = np.random.default_rng(1).standard_normal((256, 2))
    for adj in (False, True):
        xj = J.hss_solve(sj, jnp.asarray(b), adjoint=adj)
        xt = T.hss_solve(st, torch.as_tensor(b)[None], adj)[0].numpy()
        assert _rel(xt, xj) < 1e-10
        op = np.asarray(J.hss_todense(hj))
        assert _rel((op.T if adj else op) @ xt, b) < 1e-10
    for a, b_ in zip(st.cores_lu + st.coresT_lu, sj.cores_lu + sj.coresT_lu):
        assert _rel(a[0].numpy(), b_) < 1e-10


def test_factor_solve_padded_identity():
    """tests/test_hss.py's padded case: identity padding rows stay zero."""
    n, pad = 96, 32
    Ap = np.eye(n + pad)
    Ap[:n, :n] = _toeplitz(n)
    ht = T.hss_compress_dense(torch.as_tensor(Ap)[None],
                              T.ClusterPlan(ls=16, depth=3, n1=64, n2=64),
                              1e-10, 1e-10, 20)
    b = np.zeros((1, n + pad, 1))
    b[0, :n, 0] = np.random.default_rng(3).standard_normal(n)
    x = T.hss_solve(T.hss_factor(ht), torch.as_tensor(b))[0].numpy()
    x_ref = np.linalg.solve(Ap[:n, :n], b[0, :n])
    assert np.linalg.norm(x[:n] - x_ref) / np.linalg.norm(x_ref) < 1e-6
    assert np.abs(x[n:]).max() < 1e-8
