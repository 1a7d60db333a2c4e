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

from hsolve.ops import dense as JD
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
    """J's complex128 launches take float64's kernel templated on the value,
    the products on the FP64 tensor cores (four real m16n8k16 a complex
    one): at every n=512 shape the slots take 16-byte values (shared memory
    twice float64's, within a CTA's 232,448 bytes, or the state in a
    scratch region), the launch (256 threads, 2 row blocks) everywhere (the
    complex fragments take twice the registers: never float64's (256, 4),
    nor (512, 2), whose 128 registers a thread spill), the cluster and
    chunks chosen as in float64."""
    assert T.hss_matvec_state_itemsize(True) == 16
    for B, nl in N512:
        depth = nl.bit_length() - 1
        cs, kc, groups, smem, th, rb = T.hss_matvec_geometry(
            B, nl, 32, r, depth, k, itemsize=16, is_complex=True)
        assert (th, rb) == (256, 2)
        need = T.hss_matvec_smem(nl, depth, r, cs, kc, itemsize=16)
        assert need == 2 * T.hss_matvec_smem(nl, depth, r, cs, kc)
        assert smem == (need if need <= 232448 else 0)
        assert (cs, kc, groups) == T.hss_matvec_geometry(B, nl, 32, r, depth,
                                                         k)[:3]


@pytest.mark.parametrize("r", [32, 48, 96, 192, 400])
@pytest.mark.parametrize("k", [1, 58, 112])
def test_kernel_j_float32_geometry_fits_a_cta(r, k):
    """J's float32 launches are float64's at every n=512 shape and the 3D
    caps' r = 400: the kernel reads 4-byte values and widens them as its
    fragments load, so its state (the slots, and the scratch region where
    they pass 232,448 bytes) holds float64 values, float64's bytes, and its
    launch is float64's tensor-core form, but (512 threads, 2 row blocks)
    at one chunk of 8 columns at any rank (float64 at rank 32: (256, 2)),
    then (256, 2) at rank 32 and (256, 4) above."""
    assert T.hss_matvec_state_itemsize(False) == 8
    for B, nl in N512:
        depth = nl.bit_length() - 1
        geo = T.hss_matvec_geometry(B, nl, 32, r, depth, k, itemsize=4)
        cs, kc, groups, smem, th, rb = geo
        g64 = T.hss_matvec_geometry(B, nl, 32, r, depth, k)
        assert geo[:4] == g64[:4]
        assert (th, rb) == ((512, 2) if kc == 8 else
                            (256, 2) if r <= 32 else (256, 4))
        assert (th, rb) == g64[4:] or (kc == 8 and r <= 32)
        need = T.hss_matvec_smem(nl, depth, r, cs, kc)
        assert smem == (need if need <= 232448 else 0)


@pytest.mark.parametrize("r", [32, 48, 96, 192, 400])
@pytest.mark.parametrize("k", [1, 58, 112])
def test_kernel_j_complex64_geometry_fits_a_cta(r, k):
    """J's complex64 launches are complex128's at every n=512 shape and the
    3D caps' r = 400: the kernel reads 8-byte complex values and widens
    them to complex128 as its fragments load, so its state holds 16-byte
    values (twice float64's bytes, though a complex64 value has float64's
    8), and its launch is the complex form (256 threads, 2 row blocks),
    but (512, 2) at one chunk of 8 columns, where complex128 keeps (256, 2):
    its narrower A loads leave that form faster."""
    for B, nl in N512:
        depth = nl.bit_length() - 1
        geo = T.hss_matvec_geometry(B, nl, 32, r, depth, k, itemsize=8,
                                    is_complex=True)
        cs, kc, groups, smem, th, rb = geo
        assert geo[:4] == T.hss_matvec_geometry(B, nl, 32, r, depth, k,
                                                itemsize=16,
                                                is_complex=True)[:4]
        assert (th, rb) == ((512, 2) if kc == 8 else (256, 2))
        need = T.hss_matvec_smem(nl, depth, r, cs, kc, itemsize=16)
        assert need == 2 * T.hss_matvec_smem(nl, depth, r, cs, kc)
        assert smem == (need if need <= 232448 else 0)
        assert (cs, kc, groups) == T.hss_matvec_geometry(B, nl, 32, r, depth,
                                                         k)[:3]


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
@pytest.mark.parametrize("adjoint", [False, True])
def test_narrow_j_and_k_sum_wide_within_jax_tolerance(dtype, adjoint):
    """Kernels J and K compute float32 and complex64 values in float64 and
    complex128 and round once (their plain versions on the widened operands,
    rounded back, are what the card holds them to).  That result stays
    within 1e-5 relative of the JAX package's float32 / complex64
    ``hss_matvec`` and ``_apply_level_correction``, which sum in the narrow
    type: r = 48, 4 leaves of 56 rows, k = 1 and 3, both directions."""
    narrow = getattr(np, dtype)
    wide = torch.complex128 if dtype == "complex64" else torch.float64
    r, ls, rng = 48, 56, np.random.default_rng(17 + adjoint)

    def a(*s):
        v = rng.standard_normal(s)
        if dtype == "complex64":
            v = v + 1j * rng.standard_normal(s)
        return (v / np.sqrt(s[-1])).astype(narrow)

    plan = dict(ls=ls, depth=2, n1=2 * ls, n2=2 * ls)
    n = 4 * ls
    arrs = dict(D=a(4, ls, ls), U=a(4, ls, r), V=a(4, ls, r),
                Rs=[a(4, r, r), np.zeros((2, r, r), narrow)],
                Ws=[a(4, r, r), np.zeros((2, r, r), narrow)],
                B12s=[a(2, r, r), a(1, r, r)], B21s=[a(2, r, r), a(1, r, r)])
    hj = J.Hss(**{k: (jnp.asarray(v) if not isinstance(v, list) else
                      [jnp.asarray(x) for x in v]) for k, v in arrs.items()},
               plan=J.ClusterPlan(**plan))
    ht = T.Hss(**{k: (torch.as_tensor(v)[None] if not isinstance(v, list)
                      else [torch.as_tensor(x)[None] for x in v])
                  for k, v in arrs.items()}, plan=T.ClusterPlan(**plan))
    hw = ht.map(lambda t: t.to(wide))
    # one level-1 correction: a well-conditioned 2r x 2r core per node
    M = (np.eye(2 * r) + a(2, 2 * r, 2 * r) / 4).astype(narrow)
    Phi = a(n, r)
    lu, perm = JD.lu_factor(jnp.asarray(M))
    sj = J.HssSolver(h=hj, D_lu=None, D_piv=None, Phis=[jnp.asarray(Phi)],
                     cores_lu=[lu], cores_piv=[perm], PhisT=[jnp.asarray(Phi)],
                     coresT_lu=[lu], coresT_piv=[perm])
    tlu = torch.as_tensor(np.array(lu))[None].contiguous()
    tpiv = torch.as_tensor(np.array(perm))[None].long().contiguous()
    tPhi = torch.as_tensor(Phi)[None].contiguous()
    Bl, Br = (ht.B21s[0], ht.B12s[0]) if adjoint else (ht.B12s[0], ht.B21s[0])
    for k in (1, 3):
        x = a(n, k)
        yj = np.asarray(J.hss_matvec(hj, jnp.asarray(x), adjoint=adjoint))
        yt = T.hss_matvec_plain(hw, torch.as_tensor(x)[None].to(wide), adjoint)
        assert yj.dtype == narrow
        assert _rel(yt[0].to(getattr(torch, dtype)).numpy(), yj) < 1e-5
        cj = np.asarray(J._apply_level_correction(sj, jnp.asarray(x), 1,
                                                  adjoint))
        Yt = torch.as_tensor(x)[None].contiguous()
        xi = T._upsweep(ht, Yt, 0, adjoint).contiguous()
        wargs = [t.to(wide) for t in (Yt, xi, Bl, Br, tlu)]
        ct = T.hss_level_correct_plain(*wargs, tpiv, tPhi.to(wide), adjoint)
        assert cj.dtype == narrow
        assert _rel(ct[0].to(getattr(torch, dtype)).numpy(), cj) < 1e-5


# kernel H's launch shapes (B, m, n, k) at the helmholtz2d(512, k=40)
# structured factors, kest=32 and the default caps (113 in all; the damped
# system's complex plans have the same ones), as tools/h_breakdown.py
# recorded them on the card
H_N512 = [
    (2, 16, 8, 8), (2, 32, 16, 16), (2, 32, 64, 32), (2, 42, 64, 32),
    (2, 58, 32, 32), (2, 58, 96, 48), (2, 64, 32, 32), (2, 74, 128, 64),
    (2, 106, 192, 96), (2, 128, 256, 128), (2, 138, 256, 128),
    (2, 170, 320, 160), (4, 32, 8, 8), (4, 42, 16, 16), (4, 42, 32, 32),
    (4, 58, 16, 16), (4, 58, 32, 32), (4, 58, 96, 48), (4, 74, 128, 64),
    (4, 106, 32, 32), (4, 106, 192, 96), (4, 128, 32, 32), (4, 138, 256, 128),
    (4, 170, 320, 160), (6, 58, 96, 48), (6, 202, 384, 192), (8, 58, 32, 32),
    (8, 58, 96, 48), (8, 74, 32, 32), (8, 106, 32, 32), (8, 138, 32, 32),
    (8, 138, 256, 128), (8, 170, 32, 32), (8, 170, 320, 160),
    (12, 58, 96, 48), (12, 202, 384, 192), (14, 58, 96, 48),
    (14, 202, 384, 192), (16, 58, 32, 32), (16, 58, 96, 48),
    (16, 138, 32, 32), (16, 138, 256, 128), (16, 170, 32, 32),
    (24, 58, 96, 48), (24, 202, 384, 192), (28, 58, 96, 48),
    (28, 202, 384, 192), (30, 58, 96, 48), (30, 138, 256, 128),
    (32, 58, 32, 32), (32, 138, 32, 32), (48, 58, 24, 24), (48, 58, 32, 32),
    (48, 202, 24, 24), (48, 202, 32, 32), (56, 58, 96, 48),
    (56, 202, 384, 192), (60, 58, 96, 48), (60, 138, 256, 128),
    (62, 58, 96, 48), (62, 106, 192, 96), (112, 58, 24, 24),
    (112, 58, 96, 48), (112, 202, 24, 24), (112, 202, 384, 192),
    (120, 58, 32, 32), (120, 58, 96, 48), (120, 138, 32, 32),
    (120, 138, 256, 128), (124, 58, 96, 48), (124, 106, 192, 96),
    (126, 58, 96, 48), (126, 74, 128, 64), (224, 58, 24, 24),
    (224, 202, 24, 24), (240, 58, 96, 48), (240, 138, 256, 128),
    (248, 58, 24, 24), (248, 58, 96, 48), (248, 106, 24, 24),
    (248, 106, 192, 96), (252, 58, 32, 32), (252, 58, 96, 48),
    (252, 74, 32, 32), (252, 74, 128, 64), (254, 58, 96, 48),
    (480, 58, 24, 24), (480, 138, 24, 24), (496, 58, 32, 32),
    (496, 106, 32, 32), (504, 58, 96, 48), (504, 74, 128, 64),
    (508, 58, 24, 24), (508, 58, 96, 48), (510, 42, 31, 31),
    (510, 42, 64, 32), (510, 58, 31, 31), (510, 58, 96, 48),
    (1008, 58, 24, 24), (1008, 74, 24, 24), (1016, 58, 32, 32),
    (1020, 42, 64, 32), (1020, 58, 96, 48), (1022, 42, 23, 23),
    (1022, 42, 64, 32), (1022, 46, 23, 23), (1022, 58, 96, 48),
    (2040, 42, 24, 24), (2040, 58, 24, 24), (2044, 42, 31, 31),
    (2044, 58, 31, 31), (2046, 92, 64, 32), (4092, 92, 23, 23)]


def _h100_clusters(m, n, cs, resident, itemsize):
    """A model of ``cudaOccupancyMaxActiveClusters`` for kernel H on an
    H100 (132 SMs, 228 KB of shared memory and 2048 threads an SM, 1 KB of
    it reserved per CTA), blind to how the SMs group into GPCs."""
    from hsolve_torch.ops import lowrank as TL

    smem = TL.cpqr_smem(m, n, cs, resident, itemsize) + 1024
    per_sm = min(2048 // 256, 228 * 1024 // (smem + 1024))
    return 132 * per_sm // cs


@pytest.mark.parametrize("itemsize", [8, 16])
def test_kernel_h_geometry_at_every_n512_launch_shape(itemsize):
    """At every launch shape of both n=512 structured plans (8-byte loop
    values: float64 and float32; 16: complex128 and complex64) kernel H's
    launch holds each matrix's columns in its cluster's shared memory,
    within a CTA's 227 KB with the kernel's static arrays; given the card's
    resident clusters it takes the fewest waves, never more than the
    fewest-CTA cluster's, and without them that cluster."""
    from hsolve_torch.ops import lowrank as TL

    for B, m, n, k in H_N512:
        cs0, res0 = TL.cpqr_cluster(m, n, itemsize)
        assert res0 and k <= min(m, n)
        assert TL.cpqr_geometry(B, m, n, itemsize) == (cs0, res0)
        act = lambda cs, res: _h100_clusters(m, n, cs, res, itemsize)
        cs, res = TL.cpqr_geometry(B, m, n, itemsize, act)
        assert res and cs in TL.CPQR_CLUSTERS and cs >= cs0
        assert TL.cpqr_smem(m, n, cs, res, itemsize) + 1024 <= 232448
        assert -(-B // act(cs, res)) <= -(-B // act(cs0, res0))
        if cs > cs0:
            assert -(-B // act(cs, res)) < -(-B // act(cs0, res0))


def test_kernel_h_geometry_refuses_what_the_card_cannot_hold():
    """A geometry the card holds no cluster of is refused, not launched."""
    from hsolve_torch.ops import lowrank as TL

    with pytest.raises(ValueError):
        TL.cpqr_geometry(4, 202, 384, 16, lambda cs, res: 0)
