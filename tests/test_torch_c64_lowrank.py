"""The JAX bench's complex device configuration on low-rank compressed
levels (``hss=False``): the port's complex64 factor against the JAX
package's complex64 factor (``hsolve.factor_with_plan(...,
dtype=jnp.complex64)``: ``tests/conftest.py`` enables x64, so the type is
asked for), on the CPU, on ``tests/test_torch_complex_lowrank.py``'s damped
plan: helmholtz2d(48, k=25, damping=0.1), leafmax 60, ``swlevel=-2,
swsize=1, atol=rtol=1e-4``.

- ``rand_lowrank`` in complex64 given JAX's sketch (float32 draws cast, as
  JAX draws them for a complex64 block): equal ranks at 1e-3 and 1e-4, and
  ``U V^T`` to 1e-5 relative;
- the plain versions of kernels E, F and G in complex64 against the JAX
  expressions they replace (complex64 sums: 1e-5); E's also against the
  update summed in complex128 and rounded once (F4's rule), bit for bit;
- every level of the complex64 factor, given JAX's complex64 sketches:
  equal ranks, and ``LU_ LV_^T``, ``RU_ RV_^T`` and the Schur complements
  within 2e-4 of JAX's, relative to the level's largest entry (measured:
  at most 3.9e-5, the top level's transforms; the two packages' complex64
  QR, SVD and LU sum in other orders);
- mixed-precision GMRES (complex64 cycles over the complex64 operator
  inside a complex128 solve, ``m_eps=1e-6``, escalation on) on the port's
  complex64 factor with JAX's sketches takes JAX's count, or one more or
  less, and JAX's rank report; with the port's own sketches within two;
  relres < 1e-9 by scipy;
- a JAX complex64 low-rank factorization carried over with
  ``factorization_from_numpy`` solves as JAX's (1e-4: the port's sweep sums
  in complex128 and rounds once, JAX's in complex64).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht
from hsolve.ops import dense as jdense
from hsolve.ops import lowrank as jlowrank
from hsolve_torch.factor import (CompressedLevel, _factor_levels,
                                 solve_with_data, torch_sketch)
from hsolve_torch.interop import factorization_from_numpy, plan_to_torch
from hsolve_torch.ops.lowrank import (lowrank_truncate_plain, rand_lowrank,
                                      sketch_width)
from hsolve_torch.ops.schur import lowrank_schur_update_plain
from hsolve_torch.ops.sweep import lowrank_sweep_update_plain

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function
C64 = torch.complex64

# tests/test_torch_complex_lowrank.py's plan
COMP = dict(swlevel=-2, swsize=1, atol=1e-4, rtol=1e-4, hss=False)
LEVEL_RTOL = 2e-4   # the levels' products against JAX's (module docstring)


def jax_sketch32(seed):
    """The JAX package's sketches of a complex64 factor: ``split(fold_in(
    PRNGKey(seed), bidx))``, then ``normal(k, (n, s), float32)``, which
    the factor casts to complex64 (``hsolve/ops/lowrank.py:152`` draws in
    the block's real type)."""
    def draw(bidx, bi, ib):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                   bidx))
        return tuple(torch.as_tensor(np.array(
            jax.random.normal(k, shape, dtype=jnp.float32)))
            for k, shape in zip(keys, (bi, ib)))
    return draw


def _rel(got, ref):
    got = np.asarray(got, dtype=np.complex128)
    ref = np.asarray(ref, dtype=np.complex128)
    assert got.shape == ref.shape
    if not ref.size:
        return 0.0
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _lowrank(U, V):
    U = np.asarray(U, dtype=np.complex128)
    return U @ np.swapaxes(np.asarray(V, dtype=np.complex128), -1, -2)


def _cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _problem():
    A, b, shape = hsolve.helmholtz2d(48, k=25.0, damping=0.1)
    tree = hsolve.nested_dissection(shape, leafmax=60)
    plan = hsolve.plan_factorization(A, tree, hsolve.SolverOptions(**COMP))
    assert any(bp.compress for bp in plan.batches)
    assert not any(bp.structured for bp in plan.batches)
    return A, np.asarray(b), shape, plan


@functools.lru_cache(maxsize=None)
def _jax_levels():
    _, _, _, plan = _problem()
    levels, stacks = [], {}
    F = jfactor._factor_levels(plan, hsolve.SolverOptions(**COMP),
                               jnp.complex64, levels, stacks, None)
    return F, levels, stacks


def _jprec(data, v):
    return jfactor.solve_with_data(data, v.astype(jnp.complex64)).astype(
        v.dtype)


def _tprec(data, v):
    return solve_with_data(data, v.to(C64)).to(v.dtype)


@functools.lru_cache(maxsize=None)
def _jax_mixed():
    """JAX's mixed GMRES on its complex64 factor: (iterations, relres)."""
    A, b, _, _ = _problem()
    x, info = hsolve.gmres_compiled(
        lambda d, v: hsolve.dia_matvec(d, v), _jprec,
        jnp.asarray(b, jnp.complex128), reltol=1e-9, restart=30, maxiter=60,
        mv_data=hsolve.spmv_format(A, dtype=np.complex128)[0],
        M_data=_jax_levels()[0].solve_data, inner_dtype="complex64",
        mv_data_inner=hsolve.spmv_format(A, dtype=np.complex64)[0],
        m_eps=1e-6)
    assert info["converged"]
    return int(info["iters"]), \
        float(np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b))


def _port_mixed(A, b, F):
    op128, mv = ht.spmv_format(A, device="cpu")
    op64, _ = ht.spmv_format(A, dtype=np.complex64, device="cpu")
    x, info = ht.gmres_compiled(
        mv, _tprec, torch.as_tensor(b), reltol=1e-9, restart=30, maxiter=60,
        mv_data=op128, M_data=F.solve_data, inner_dtype="complex64",
        mv_data_inner=op64, m_eps=1e-6)
    assert x.dtype == torch.complex128
    return info, float(np.linalg.norm(A @ x.numpy() - b) / np.linalg.norm(b))


# --- rand_lowrank and the sketches ------------------------------------------------------

@pytest.mark.parametrize("tol", [1e-3, 1e-4])
@pytest.mark.parametrize("m,n,cap", [(40, 30, 20), (24, 64, 20)])
def test_c64_rand_lowrank_matches_jax(m, n, cap, tol):
    """Complex64 blocks with spectra decaying through the tolerance: given
    JAX's sketch (float32 draws cast), the port's ranks are JAX's and ``U
    V^T`` agrees to 1e-5 relative."""
    rng = np.random.default_rng(m + n)
    r = min(m, n)
    sv = np.logspace(0, -8, r)
    A = np.stack([(np.linalg.qr(_cplx(rng, m, r))[0] * sv)
                  @ np.linalg.qr(_cplx(rng, n, r))[0].T
                  for _ in range(3)]).astype(np.complex64)
    key = jax.random.PRNGKey(7)
    ref = jlowrank.rand_lowrank(jnp.asarray(A), key, tol, tol, cap)
    omega = jax.random.normal(key, (n, sketch_width(cap, n)),
                              dtype=jnp.float32)
    got = rand_lowrank(torch.as_tensor(A),
                       torch.as_tensor(np.array(omega)).to(C64), tol, tol,
                       cap)
    assert got.U.dtype == got.V.dtype == C64 and ref.U.dtype == jnp.complex64
    assert np.array_equal(got.rank.numpy(), np.asarray(ref.rank))
    assert 0 < int(got.rank.min()) and int(got.rank.max()) < cap
    assert _rel(_lowrank(got.U, got.V), _lowrank(ref.U, ref.V)) < 1e-5


@pytest.mark.parametrize("key", [3, (7005, 202)])
def test_torch_sketch_complex64_draws_float32(key):
    """The complex64 factor's default sketches are the float32 draws cast,
    bit for bit: JAX's rule, which draws in the block's real type."""
    shapes = ((40, 20), (24, 20))
    ref = torch_sketch(5, torch.device("cpu"), torch.float32)(key, *shapes)
    got = torch_sketch(5, torch.device("cpu"), C64)(key, *shapes)
    assert all(g.dtype == C64 and torch.equal(g, r.to(C64))
               for g, r in zip(got, ref))


# --- plain versions of E, F and G against JAX's complex64 expressions ------------------

def test_c64_truncate_plain_matches_jax():
    """G's plain version in complex64: ``(Q Uw)[:k] * (sv * mask)`` and
    the plain (unconjugated) ``Vh^T[:k] * mask``, padded to the cap, the
    rank and mask from float32 singular values, as
    ``hsolve/ops/lowrank.py:130-165`` in complex64: equal ranks, V bit for
    bit, U to 1e-5."""
    rng = np.random.default_rng(11)
    B, m, s, n, cap = 3, 30, 20, 25, 24
    Q = np.linalg.qr(_cplx(rng, B, m, s))[0].astype(np.complex64)
    W = (_cplx(rng, B, s, n) * np.logspace(0, -5, n)).astype(np.complex64)
    Uw, sv, Vh = np.linalg.svd(W, full_matrices=False)
    Uw, Vh, sv = Uw.astype(np.complex64), Vh.astype(np.complex64), \
        sv.astype(np.float32)
    rank, mask = jlowrank._rank_mask(jnp.asarray(sv), 1e-3, 1e-3, cap)
    k = min(cap, s)
    QUw = np.asarray(jnp.asarray(Q) @ jnp.asarray(Uw))
    pad = ((0, 0), (0, 0), (0, cap - k))
    U_ref = np.asarray(jnp.pad(QUw[..., :k] * (sv[:, None, :k]
                                               * mask[:, None, :k]), pad))
    V_ref = np.asarray(jnp.pad(np.swapaxes(Vh, -1, -2)[..., :k]
                               * mask[:, None, :k], pad))
    U, V, rk = lowrank_truncate_plain(*(torch.as_tensor(a) for a in
                                        (Q, Uw, sv, Vh)), 1e-3, 1e-3, cap)
    assert U.dtype == V.dtype == C64 and U_ref.dtype == np.complex64
    assert np.array_equal(rk.numpy(), np.asarray(rank))
    assert 0 < int(rk.min()) and int(rk.max()) < s
    assert np.array_equal(V.numpy(), V_ref)
    assert _rel(U.numpy(), U_ref) < 1e-5


def test_c64_schur_plain_matches_jax():
    """F's plain version in complex64: ``permute_sym(Abb - (Abi RU)
    RV^T, sperm)`` with plain transposes (``hsolve/factor.py:378-379``),
    summed in complex64 in both."""
    rng = np.random.default_rng(12)
    B, ni, nb, kc = 3, 20, 14, 6
    front, RU, RV = _cplx(rng, B, ni + nb, ni + nb), _cplx(rng, B, ni, kc), \
        _cplx(rng, B, nb, kc)
    sperm = np.stack([rng.permutation(nb) for _ in range(B)])
    fj = jnp.asarray(front)
    ref = jdense.permute_sym(
        fj[:, ni:, ni:] - (fj[:, ni:, :ni] @ jnp.asarray(RU))
        @ jnp.swapaxes(jnp.asarray(RV), -1, -2), jnp.asarray(sperm))
    got = lowrank_schur_update_plain(torch.as_tensor(front), ni,
                                     torch.as_tensor(RU), torch.as_tensor(RV),
                                     torch.as_tensor(sperm))
    assert got.dtype == C64 and ref.dtype == jnp.complex64
    assert _rel(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("form", ["forward", "backward"])
def test_c64_sweep_plain_matches_jax_and_sums_in_complex128(form):
    """E's plain version in complex64: ``C[out] -= U (V^T Y)`` with plain
    transposes, ``Y`` the gathered interior values (forward) or ``C[bnd]``
    (backward), padded ids at the sentinel row N dropped
    (``hsolve/factor.py:528-529``, ``:555-556``): within 1e-5 of JAX's
    complex64 update, and bit for bit the update summed in complex128 and
    rounded once, each part on its own (F4's rule), then subtracted."""
    rng = np.random.default_rng(13)
    N, B, R, Cc, kc, k = 400, 3, 60, 70, 40, 2
    perm = rng.permutation(N)
    ids_out = perm[:B * R].reshape(B, R).astype(np.int32)
    ids_in = perm[B * R:B * (R + Cc)].reshape(B, Cc).astype(np.int32)
    ids_out[0, -2:] = N
    ids_in[1, -1] = N
    C0 = np.concatenate([_cplx(rng, N, k), np.zeros((1, k), np.complex64)])
    U, V = _cplx(rng, B, R, kc), _cplx(rng, B, Cc, kc)
    Y = C0[ids_in]
    upd = jnp.asarray(U) @ (jnp.swapaxes(jnp.asarray(V), -1, -2)
                            @ jnp.asarray(Y))
    ref = jnp.asarray(C0).at[jnp.asarray(ids_out)].add(-upd, mode="drop")
    ref = np.asarray(ref.at[N].set(0.0))
    kw = {"X": torch.as_tensor(Y)} if form == "forward" else \
        {"ids_in": torch.as_tensor(ids_in)}
    got = lowrank_sweep_update_plain(torch.tensor(C0),
                                     torch.as_tensor(ids_out),
                                     torch.as_tensor(U), torch.as_tensor(V),
                                     N, **kw)
    assert got.dtype == C64 and float(got[N].abs().max()) == 0.0
    assert _rel(got.numpy(), ref) < 1e-5
    wide = lambda a: a.astype(np.complex128)
    exact = wide(U) @ (np.swapaxes(wide(V), -1, -2) @ wide(Y))
    want = C0.copy()
    keep = ids_out < N
    np.subtract.at(want, ids_out[keep], exact[keep].astype(np.complex64))
    assert np.array_equal(got.numpy(), want)


# --- the factor ---------------------------------------------------------------------------

def test_c64_lowrank_levels_match_jax():
    """Per level, with JAX's complex64 sketches: JAX's ranks, and ``LU_
    LV_^T``, ``RU_ RV_^T`` and the Schur complements within 2e-4 relative
    of JAX's complex64 factor (the module's docstring says why)."""
    _, _, _, plan = _problem()
    _, jlevels, jstacks = _jax_levels()
    opts = ht.SolverOptions(**COMP)
    tlevels, troot, tstacks = _factor_levels(
        plan, plan_to_torch(plan, "cpu"), opts, C64, jax_sketch32(opts.seed))
    assert troot is None and len(tlevels) == len(jlevels)
    ncomp = 0
    for j, (tl, jl) in enumerate(zip(tlevels, jlevels)):
        assert isinstance(tl, CompressedLevel) == plan.batches[j].compress
        assert isinstance(tl, CompressedLevel) == hasattr(jl, "LU_")
        if isinstance(tl, CompressedLevel):
            ncomp += 1
            assert tl.LU_.dtype == C64 and jl.LU_.dtype == jnp.complex64
            assert np.array_equal(tl.lrank.numpy(), np.asarray(jl.lrank)), j
            assert np.array_equal(tl.rrank.numpy(), np.asarray(jl.rrank)), j
            assert _rel(_lowrank(tl.LU_, tl.LV_), _lowrank(jl.LU_, jl.LV_)) \
                < LEVEL_RTOL, (j, "L")
            assert _rel(_lowrank(tl.RU_, tl.RV_), _lowrank(jl.RU_, jl.RV_)) \
                < LEVEL_RTOL, (j, "R")
        if tstacks[j].numel():
            assert tstacks[j].dtype == C64
            assert _rel(tstacks[j].numpy(), jstacks[j]) < LEVEL_RTOL, (j, "S")
    assert ncomp >= 3


def test_c64_lowrank_mixed_gmres_matches_jax():
    """Mixed-precision GMRES on the port's complex64 low-rank factor: with
    JAX's sketches JAX's count on its own complex64 factor, or one more or
    less, and JAX's rank report; with the port's own sketches within two;
    relres < 1e-9 by scipy in both."""
    A, b, shape, plan = _problem()
    iters_j, relres_j = _jax_mixed()
    assert relres_j < 1e-9
    Fj = _jax_levels()[0]
    opts = ht.SolverOptions(**COMP)
    F = ht.factor_with_plan(plan, opts, dtype=C64, device="cpu",
                            sketch=jax_sketch32(opts.seed))
    assert F.dtype == C64
    assert F.maxrank() == Fj.maxrank() > 0
    assert F.rank_report() == Fj.rank_report()
    info, relres = _port_mixed(A, b, F)
    assert info["converged"] and relres < 1e-9
    assert abs(info["iters"] - iters_j) <= 1
    F_own = ht.factor(A, ht.nested_dissection(shape, leafmax=60), dtype=C64,
                      device="cpu", **COMP)
    info, relres = _port_mixed(A, b, F_own)
    assert info["converged"] and relres < 1e-9
    assert info["iters"] <= iters_j + 2
    assert not F_own.rank_report()["saturated"]


def test_factorization_from_numpy_c64_lowrank():
    """A JAX complex64 low-rank factorization carried over record by record
    solves as JAX's: 1e-4 relative, one and two right-hand sides (the
    port's sweep sums in complex128 and rounds once, JAX's in complex64)."""
    A, b, _, plan = _problem()
    Fj = _jax_levels()[0]
    Fc = factorization_from_numpy(Fj.levels, Fj.root, plan.perm, "cpu")
    assert Fc.dtype == C64
    assert sum(isinstance(lv, CompressedLevel) for lv in Fc.levels) >= 3
    rng = np.random.default_rng(9)
    for rhs in (b, _cplx(rng, A.shape[0], 2)):
        rhs = rhs.astype(np.complex64)
        assert _rel(Fc.solve(rhs).numpy(), np.asarray(Fj.solve(rhs))) < 1e-4
