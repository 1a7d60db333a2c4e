"""The port's low-rank modules against the JAX package: the randomized
factorization (with the JAX sketch handed in) and the plain versions of
kernels E, F and G against the JAX expressions they replace (F's on small
fronts of several shapes; its geometry at the n=512 plans' shapes is in
``tests/test_torch_schur_geometry.py``).

Inputs are made with numpy from a seed and handed to both packages; low-rank
factors are compared as products (SVD signs make the factors themselves
non-unique), ranks exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsolve.ops import dense as jdense
from hsolve.ops import lowrank as jlowrank
from hsolve_torch.ops import lowrank as tlowrank
from hsolve_torch.ops.schur import (lowrank_schur_update,
                                    lowrank_schur_update_plain)
from hsolve_torch.ops.sweep import lowrank_sweep_update

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _decaying(B, m, n, seed, decay=0.6):
    """[B, m, n] matrices with geometrically decaying singular values."""
    rng = np.random.default_rng(seed)
    r = min(m, n)
    out = np.empty((B, m, n))
    for b in range(B):
        Qu, _ = np.linalg.qr(rng.standard_normal((m, r)))
        Qv, _ = np.linalg.qr(rng.standard_normal((n, r)))
        out[b] = (Qu * (3.0 * decay ** np.arange(r))) @ Qv.T
    return out


@pytest.mark.parametrize("B,m,n,cap,tol", [(4, 40, 24, 16, 1e-6),
                                           (3, 32, 56, 24, 1e-3),
                                           (2, 48, 48, 8, 1e-12)])
def test_rand_lowrank_matches_jax_with_the_jax_sketch(B, m, n, cap, tol):
    A = _decaying(B, m, n, seed=m + n)
    key = jax.random.PRNGKey(7)
    s = tlowrank.sketch_width(cap, n)
    omega = np.asarray(jax.random.normal(key, (n, s), dtype=jnp.float64))
    ref = jlowrank.rand_lowrank(jnp.asarray(A), key, tol, tol, cap)
    got = tlowrank.rand_lowrank(_t(A), _t(omega), tol, tol, cap)
    assert got.U.shape == (B, m, cap) and got.V.shape == (B, n, cap)
    assert got.rank.dtype == torch.int32
    assert np.array_equal(got.rank.numpy(), np.asarray(ref.rank))
    assert _rel(got.todense().numpy(), np.asarray(ref.todense())) < 1e-10
    # columns past the rank are zero, so the product is exact at the padding
    k = int(got.rank.max())
    assert float(got.U[..., k:].abs().sum()) == 0.0
    if cap == 8:
        assert int(got.rank.min()) == cap      # the cap binds


def test_lowrank_truncate_plain_matches_the_jax_epilogue():
    """Kernel G's plain version against the product ``Q @ Uw``, ``_rank_mask``
    and the scaling, transposition and cap padding of ``rand_lowrank``
    (U to 1e-13 of its largest entry, rank and V exactly), including a cap wider
    than the sketch (padding) and an ``atol`` that decides the rank."""
    rng = np.random.default_rng(5)
    B, m, n, r = 5, 12, 9, 7
    QU = rng.standard_normal((B, m, r))
    Vh = rng.standard_normal((B, r, n))
    sv = np.sort(np.abs(rng.standard_normal((B, r))) * 10.0 ** -np.arange(r),
                 axis=-1)[:, ::-1].copy()
    for atol, rtol, cap in ((1e-3, 1e-2, 4), (1e-1, 0.0, 10), (0.0, 1e-5, 7)):
        rank_j, mask_j = jlowrank._rank_mask(jnp.asarray(sv), atol, rtol, cap)
        k = min(cap, r)
        U_j = np.asarray(jnp.asarray(QU)[..., :k] *
                         (jnp.asarray(sv)[..., None, :k] * mask_j[..., None, :k]))
        V_j = np.asarray(jnp.swapaxes(jnp.asarray(Vh), -1, -2)[..., :k] *
                         mask_j[..., None, :k])
        U_j = np.pad(U_j, [(0, 0), (0, 0), (0, cap - k)])
        V_j = np.pad(V_j, [(0, 0), (0, 0), (0, cap - k)])
        # Q = QU and Uw = I: the product is QU, bit for bit
        U, V, rank = tlowrank.lowrank_truncate(
            _t(QU), _t(np.broadcast_to(np.eye(r), (B, r, r)).copy()), _t(sv),
            _t(Vh), atol, rtol, cap)
        assert np.array_equal(rank.numpy(), np.asarray(rank_j))
        assert np.array_equal(U.numpy(), U_j) and np.array_equal(V.numpy(), V_j)
        # and a product of its own: JAX's (Q @ Uw) to rounding
        Q, Uw = rng.standard_normal((B, m, r + 2)), rng.standard_normal(
            (B, r + 2, r))
        U, V, rank = tlowrank.lowrank_truncate(_t(Q), _t(Uw), _t(sv), _t(Vh),
                                               atol, rtol, cap)
        Uq = np.asarray(jnp.asarray(Q) @ jnp.asarray(Uw))[..., :k] * (
            sv[..., None, :k] * np.asarray(mask_j)[..., None, :k])
        Uq = np.pad(Uq, [(0, 0), (0, 0), (0, cap - k)])
        assert np.array_equal(rank.numpy(), np.asarray(rank_j))
        assert np.abs(U.numpy() - Uq).max() <= 1e-13 * np.abs(Uq).max()
        assert np.array_equal(V.numpy(), V_j)
    assert tlowrank.lowrank_truncate.launches == 0     # CPU: the plain version


def _jax_compressed_schur(front, ni_pad, RU, RV, sperm):
    """``S`` of ``hsolve/factor.py:_factor_front_compressed_impl`` (:378-379)
    on the given front and factors: ``permute_sym(Abb - (Abi @ RU) @ RV^T,
    sperm)``."""
    f = jnp.asarray(front)
    Abi, Abb = f[:, ni_pad:, :ni_pad], f[:, ni_pad:, ni_pad:]
    S = Abb - (Abi @ jnp.asarray(RU)) @ jnp.swapaxes(jnp.asarray(RV), -1, -2)
    return np.asarray(jdense.permute_sym(S, jnp.asarray(sperm)))


def _schur_inputs(B, ni_pad, nb, kc, seed, identity=False):
    rng = np.random.default_rng(seed)
    front = rng.standard_normal((B, ni_pad + nb, ni_pad + nb))
    RU = rng.standard_normal((B, ni_pad, kc))
    RV = rng.standard_normal((B, nb, kc))
    sperm = np.stack([np.arange(nb) if identity else rng.permutation(nb)
                      for _ in range(B)])
    return front, RU, RV, sperm


def test_lowrank_schur_update_plain_matches_jax():
    """Kernel F's plain version against ``permute_sym(Abb - (Abi @ RU) @
    RV^T, sperm)`` with ``Abi`` and ``Abb`` taken from a front buffer."""
    B, ni_pad, nb, k = 3, 16, 24, 8
    front, RU, RV, sperm = _schur_inputs(B, ni_pad, nb, k, 11)
    ref = _jax_compressed_schur(front, ni_pad, RU, RV, sperm)
    got = lowrank_schur_update(_t(front), ni_pad, _t(RU), _t(RV), _t(sperm))
    assert _rel(got.numpy(), ref) < 1e-13
    assert lowrank_schur_update.launches == 0


@pytest.mark.parametrize("kc", [1, 8, 33])
@pytest.mark.parametrize("B,ni_pad,nb", [(1, 24, 40), (5, 16, 52),
                                         (2, 40, 77)])
def test_lowrank_schur_update_plain_on_small_fronts(B, ni_pad, nb, kc):
    """The plain version of kernel F against JAX's compressed Schur
    complement: one front and several, nb not a multiple of 8 (the kernel's
    tile) or of 32, rank caps of 1, 8 and 33, non-identity sperm; relative
    1e-13 (both sum each product in their own order)."""
    front, RU, RV, sperm = _schur_inputs(B, ni_pad, nb, kc, 100 + nb + kc)
    ref = _jax_compressed_schur(front, ni_pad, RU, RV, sperm)
    got = lowrank_schur_update_plain(_t(front), ni_pad, _t(RU), _t(RV),
                                     _t(sperm))
    assert got.shape == (B, nb, nb)
    assert _rel(got.numpy(), ref) < 1e-13
    # the identity permutation leaves S in the front's order
    front, RU, RV, ident = _schur_inputs(B, ni_pad, nb, kc, 7, identity=True)
    got = lowrank_schur_update_plain(_t(front), ni_pad, _t(RU), _t(RV),
                                     _t(ident))
    want = front[:, ni_pad:, ni_pad:] - (front[:, ni_pad:, :ni_pad] @ RU) \
        @ np.swapaxes(RV, -1, -2)
    assert _rel(got.numpy(), want) < 1e-13


@pytest.mark.parametrize("k", [1, 3])
def test_lowrank_sweep_update_plain_matches_jax(k):
    """Kernel E's plain version against the compressed branches of
    ``_apply_impl``: forward with X, backward gathering ``C[ids_in]``; ids
    equal to N are the sentinel (output skipped, input read as zero)."""
    rng = np.random.default_rng(20 + k)
    N, B, R, Cc, kc = 200, 4, 6, 9, 5
    C = rng.standard_normal((N + 1, k))
    C[N] = 0.0
    perm = rng.permutation(N)
    ids_out = perm[:B * R].reshape(B, R).astype(np.int32)
    ids_in = perm[B * R:B * R + B * Cc].reshape(B, Cc).astype(np.int32)
    ids_out[:, -1] = N
    ids_in[:, -2:] = N
    U = rng.standard_normal((B, R, kc))
    V = rng.standard_normal((B, Cc, kc))
    X = rng.standard_normal((B, Cc, k))
    Cj, Uj, Vj = jnp.asarray(C), jnp.asarray(U), jnp.asarray(V)
    fwd = Cj.at[jnp.asarray(ids_out)].add(
        -(Uj @ (jnp.swapaxes(Vj, -1, -2) @ jnp.asarray(X))), mode="drop")
    Y = Cj[jnp.asarray(ids_in)]
    bwd = Cj.at[jnp.asarray(ids_out)].add(
        -(Uj @ (jnp.swapaxes(Vj, -1, -2) @ Y)), mode="drop")
    got_f = lowrank_sweep_update(_t(C), _t(ids_out), _t(U), _t(V), N, X=_t(X))
    got_b = lowrank_sweep_update(_t(C), _t(ids_out), _t(U), _t(V), N,
                                 ids_in=_t(ids_in))
    # JAX adds into its sentinel row N (dropped by the solve) and reads it
    # while it is zero; the port skips it and reads 0.0
    assert _rel(got_f.numpy()[:N], fwd[:N]) < 1e-13
    assert _rel(got_b.numpy()[:N], bwd[:N]) < 1e-13
    assert float(got_b[N].abs().max()) == 0.0
    with pytest.raises(ValueError, match="exactly one"):
        lowrank_sweep_update(_t(C), _t(ids_out), _t(U), _t(V), N)
