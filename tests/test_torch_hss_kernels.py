"""Kernels J (``hss_matvec``) and I (``hss_entries_prepared``) on the CPU:
kernel J's launch geometry at the n=512 structured plans' shapes, the walk
over its tree that the CUDA kernel makes (written out in numpy: subtrees per
CTA of a cluster, the top levels across it, the state's slots), and the
plain versions against the JAX package at the default caps' rank 192 and on
index blocks that mix LCA levels and carry out-of-range indices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsolve.ops import hss as J
from hsolve_torch.ops import hss as T

torch.set_num_threads(1)


def _random_hss(B, depth, ls, r, seed):
    """Random generators of a batch of ``B`` HSS matrices: the JAX ``Hss`` of
    element 0 and the port's of the batch."""
    rng = np.random.default_rng(seed)
    nl = 1 << depth
    g = lambda *s: rng.standard_normal((B,) + s) / np.sqrt(s[-1])
    arrs = dict(D=g(nl, ls, ls), U=g(nl, ls, r), V=g(nl, ls, r),
                Rs=[g(nl >> i, r, r) for i in range(depth)],
                Ws=[g(nl >> i, r, r) for i in range(depth)],
                B12s=[g(nl >> (i + 1), r, r) for i in range(depth)],
                B21s=[g(nl >> (i + 1), r, r) for i in range(depth)])
    half = (nl // 2) * ls
    hj = J.Hss(**{k: (jnp.asarray(v[0]) if not isinstance(v, list) else
                      [jnp.asarray(a[0]) for a in v]) for k, v in arrs.items()},
               plan=J.ClusterPlan(ls=ls, depth=depth, n1=half, n2=half))
    ht = T.Hss(**{k: (torch.as_tensor(v) if not isinstance(v, list) else
                      [torch.as_tensor(a) for a in v]) for k, v in arrs.items()},
               plan=T.ClusterPlan(ls=ls, depth=depth, n1=half, n2=half))
    return hj, ht


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


# (B, nleaves) of the matrices kernel J meets at the n=512 structured plans:
# the children's root halves (depth 1-4) and the batch sizes of their levels
N512 = [(511, 2), (255, 2), (127, 4), (63, 4), (31, 8), (15, 8), (7, 16),
        (3, 16), (1, 2), (1, 4), (1, 8), (1, 16)]


@pytest.mark.parametrize("r", [48, 96, 192])
@pytest.mark.parametrize("k", [1, 58, 112])
def test_kernel_j_geometry_fits_a_cta(r, k):
    """At every n=512 shape the state's shared memory stays within a CTA's
    232,448 bytes, or the state goes to a scratch region (smem 0) where its
    slots would not fit; the cluster is a power of two of at most 8 CTAs and
    the leaves, the chunk 8-32 columns, and the column groups split no
    chunk."""
    for B, nl in N512:
        depth = nl.bit_length() - 1
        cs, kc, groups, smem, th, rb = T.hss_matvec_geometry(B, nl, 32, r,
                                                             depth, k)
        assert (th, rb) == ((512, 2) if k == 1 else (256, 4))
        assert smem <= 232448
        need = 2 * T.hss_matvec_slots(nl, depth, cs) * r * T.hss_matvec_ld(kc) * 8
        assert smem == (need if need <= 232448 else 0)
        if k == 1:      # the solve's launches keep their state on chip
            assert smem > 0
        assert cs in (1, 2, 4, 8) and cs <= nl and kc in T.J_CHUNKS
        assert T.hss_matvec_ld(kc) % 16 == 8
        assert 1 <= groups <= -(-k // kc)
        if k == 1:
            assert kc == 8 and groups == 1
    # rank 32: 256 threads, two 8-row blocks a warp's item
    assert T.hss_matvec_geometry(511, 2, 23, 32, 1, k)[4:] == (256, 2)


def _tree_walk(h, x, adjoint, cs, kc):
    """Kernel J's walk, one CTA after another within each phase: leaves,
    the subtree's upsweep, the top levels across the cluster (a sibling's xi
    and a parent's acc read from the owner's slots), both downsweeps, the
    leaves' output; the state of a CTA lives in its ``hss_matvec_slots``
    slots and nothing else."""
    p = h.plan
    nl, ls, r, depth = p.nleaves, p.ls, h.r, p.depth
    Rc, Wc, B12c, B21c = [a.numpy() for a in h.packed()]
    D = h.D.numpy()
    U, V = (a.numpy().reshape(h.B, -1, r) for a in (h.U, h.V))
    c = cs.bit_length() - 1
    nlc, Ls = nl >> c, depth - c
    sub = sum(nlc >> L for L in range(min(Ls, depth - 1) + 1))
    nown = T.hss_matvec_slots(nl, depth, cs)

    def owner(L, j):
        return j // (nlc >> L) if L <= Ls else j << (L - Ls)

    def slot(L, j):
        if L > Ls:
            return sub + L - Ls - 1
        return sum(nlc >> q for q in range(L)) + j - owner(L, j) * (nlc >> L)

    off = lambda L: 2 * nl - 2 * (nl >> L)
    boff = lambda L: nl - 2 * (nl >> (L + 1))
    xn = x.numpy()
    k = xn.shape[-1]
    y = np.full_like(xn, np.nan)
    for b in range(h.B):
        Vl, Ul = (U[b], V[b]) if adjoint else (V[b], U[b])
        Wu, Rd = (Rc[b], Wc[b]) if adjoint else (Wc[b], Rc[b])
        Cl, Cr = (B21c[b], B12c[b]) if adjoint else (B12c[b], B21c[b])

        def cpl(L, t, xs):
            cp = (Cr if t & 1 else Cl)[boff(L) + (t >> 1)]
            return (cp.T if adjoint else cp) @ xs

        for c0 in range(0, k, kc):
            XI = np.full((cs, nown, r, kc), np.nan)
            ETA = np.full((cs, nown, r, kc), np.nan)
            w = min(kc, k - c0)
            xc = np.zeros((nl * ls, kc))
            xc[:, :w] = xn[b, :, c0:c0 + w]
            leaf = lambda a, l: a[l * ls:(l + 1) * ls]
            for rho in range(cs):
                for l in range(rho * nlc, (rho + 1) * nlc):
                    XI[rho, slot(0, l)] = leaf(Vl, l).T @ leaf(xc, l)
                for L in range(1, Ls + 1):
                    nodes = nlc >> L if L <= depth - 1 else 0
                    kids = nlc >> (L - 1)
                    for j in range(rho * nodes, (rho + 1) * nodes):
                        XI[rho, slot(L, j)] = sum(
                            Wu[off(L - 1) + t].T @ XI[rho, slot(L - 1, t)]
                            for t in (2 * j, 2 * j + 1))
                    for t in range(rho * kids, (rho + 1) * kids):
                        ETA[rho, slot(L - 1, t)] = cpl(
                            L - 1, t, XI[rho, slot(L - 1, t ^ 1)])
            if cs > 1:
                for L in range(Ls, depth):
                    for rho in range(0, cs, 1 << (L - Ls)):
                        t = rho >> (L - Ls)
                        s = t ^ 1
                        xs = XI[owner(L, s), slot(L, s)]
                        ETA[rho, slot(L, t)] = cpl(L, t, xs)
                        if not t & 1 and L + 1 < depth:
                            assert owner(L + 1, t >> 1) == rho
                            XI[rho, slot(L + 1, t >> 1)] = \
                                Wu[off(L) + t].T @ XI[rho, slot(L, t)] \
                                + Wu[off(L) + s].T @ xs
                for L in range(depth - 2, Ls - 1, -1):
                    for rho in range(0, cs, 1 << (L - Ls)):
                        t = rho >> (L - Ls)
                        par = ETA[owner(L + 1, t >> 1), slot(L + 1, t >> 1)]
                        ETA[rho, slot(L, t)] += Rd[off(L) + t] @ par
            for rho in range(cs):
                for L in range(min(Ls, depth - 1) - 1, -1, -1):
                    for t in range(rho * (nlc >> L), (rho + 1) * (nlc >> L)):
                        ETA[rho, slot(L, t)] += \
                            Rd[off(L) + t] @ ETA[rho, slot(L + 1, t >> 1)]
                for l in range(rho * nlc, (rho + 1) * nlc):
                    Dl = D[b, l].T if adjoint else D[b, l]
                    yl = Dl @ leaf(xc, l) + leaf(Ul, l) @ ETA[rho, slot(0, l)]
                    y[b, l * ls:(l + 1) * ls, c0:c0 + w] = yl[:, :w]
    return y


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_kernel_j_tree_walk_is_the_plain_product(depth):
    """Every cluster size the geometry may pick, chunks of 8 and 16 columns
    (ragged at k = 9 and 17), both directions: the kernel's walk over the
    tree gives the plain version's product to 1e-12."""
    _, h = _random_hss(2, depth, 5, 3, seed=depth)
    rng = np.random.default_rng(depth)
    for k in (1, 9, 17):
        x = torch.as_tensor(rng.standard_normal((2, h.plan.n_pad, k)))
        for adj in (False, True):
            ref = T.hss_matvec_plain(h, x, adj).numpy()
            for cs in (1, 2, 4, 8):
                if cs > min(8, h.plan.nleaves):
                    continue
                for kc in (8, 16):
                    assert _rel(_tree_walk(h, x, adj, cs, kc), ref) < 1e-12


@pytest.mark.parametrize("k", [1, 58])
def test_plain_matvec_matches_jax_at_rank_192(k):
    """The default caps' largest rank: 8 leaves of 24 rows, r = 192."""
    hj, ht = _random_hss(2, 3, 24, 192, seed=11)
    x = np.random.default_rng(k).standard_normal((2, ht.plan.n_pad, k))
    for adj in (False, True):
        yj = J.hss_matvec(hj, jnp.asarray(x[0]), adjoint=adj)
        yt = T.hss_matvec_plain(ht, torch.as_tensor(x), adj)
        assert _rel(yt[0].numpy(), yj) < 1e-12


def test_plain_entries_match_jax_on_mixed_levels_at_rank_192():
    """An index block whose entries meet every LCA level (and the same leaf),
    with out-of-range rows and columns: the in-range entries equal JAX's
    (which clamps indices), the out-of-range ones are NaN."""
    hj, ht = _random_hss(1, 3, 24, 192, seed=5)
    n = ht.plan.n_pad
    rng = np.random.default_rng(2)
    rows = rng.integers(0, n, size=(3, 70))
    cols = rng.integers(0, n, size=(3, 45))
    rows[0, :24] = np.arange(24)               # the same leaf as cols[0, :24]
    cols[0, :24] = np.arange(24)
    rows[1, 3], rows[2, 69], cols[1, 0], cols[2, 44] = -1, n, n + 7, -3
    ej = np.asarray(jax.vmap(lambda r, c: J.hss_entries(hj, r, c))(
        jnp.asarray(rows), jnp.asarray(cols)))
    et = T.hss_entries_prepared_plain(T.hss_entry_factors(ht),
                                      torch.as_tensor(rows)[None],
                                      torch.as_tensor(cols)[None])[0].numpy()
    bad = ((rows < 0) | (rows >= n))[:, :, None] | \
        ((cols < 0) | (cols >= n))[:, None, :]
    assert np.array_equal(np.isnan(et), bad)
    xor = np.abs(rows // 24)[:, :, None] ^ np.abs(cols // 24)[:, None, :]
    lev = np.where(bad, -1, [[[int(v).bit_length() for v in r_] for r_ in m]
                             for m in xor])
    assert set(np.unique(lev)) == {-1, 0, 1, 2, 3}
    assert _rel(np.where(bad, 0.0, et), np.where(bad, 0.0, ej)) < 1e-12


@pytest.mark.parametrize("r", [48, 96, 192])
@pytest.mark.parametrize("k", [1, 58, 112])
def test_kernel_j_complex128_geometry_fits_a_cta(r, k):
    """J's complex128 form at every n=512 shape: the slots take 16-byte
    values (shared memory within a CTA's 232,448 bytes, or the state in a
    scratch region), the launch (512 threads, 2 row blocks) at one chunk of
    8 columns and (256, 2) above, the cluster and chunks chosen as in
    float64."""
    for B, nl in N512:
        depth = nl.bit_length() - 1
        cs, kc, groups, smem, th, rb = T.hss_matvec_geometry(
            B, nl, 32, r, depth, k, itemsize=16)
        assert (th, rb) == ((512, 2) if kc == 8 else (256, 2))
        need = T.hss_matvec_smem(nl, depth, r, cs, kc, itemsize=16)
        assert need == 2 * T.hss_matvec_smem(nl, depth, r, cs, kc)
        assert smem == (need if need <= 232448 else 0)
        assert (cs, kc, groups) == T.hss_matvec_geometry(B, nl, 32, r, depth,
                                                         k)[:3]


@pytest.mark.parametrize("r", [32, 48, 96, 192, 400])
@pytest.mark.parametrize("k", [1, 58, 112])
def test_kernel_j_float32_geometry_fits_a_cta(r, k):
    """J's float32 form (the complex128 CUDA-core kernel on 4-byte values)
    at every n=512 shape and the 3D caps' r = 400: the slots take half
    float64's bytes (shared memory within a CTA's 232,448 bytes, or the
    state in a scratch region), the launch (512 threads, 2 row blocks) at
    one chunk of 8 columns and (256, 2) above, even at rank 32 (the float64
    tensor-core form's (256, 2)), the cluster and chunks chosen as in
    float64."""
    for B, nl in N512:
        depth = nl.bit_length() - 1
        cs, kc, groups, smem, th, rb = T.hss_matvec_geometry(
            B, nl, 32, r, depth, k, itemsize=4)
        assert (th, rb) == ((512, 2) if kc == 8 else (256, 2))
        need = T.hss_matvec_smem(nl, depth, r, cs, kc, itemsize=4)
        assert 2 * need == T.hss_matvec_smem(nl, depth, r, cs, kc)
        assert smem == (need if need <= 232448 else 0)
        assert (cs, kc, groups) == T.hss_matvec_geometry(B, nl, 32, r, depth,
                                                         k)[:3]
