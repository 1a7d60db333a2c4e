"""The JAX bench's device configuration on low-rank compressed levels
(``hss=False``): the port's float32 factor against the JAX package's float32
factor (``hsolve.factor_with_plan(..., dtype=jnp.float32)``), on the CPU,
given JAX's own float32 sketches, on ``tests/test_torch_compressed.py``'s
plans and configuration (``swlevel=-2, swsize=16, atol=rtol=1e-3, kest=32``).

- ``rand_lowrank`` in float32 given JAX's float32 sketch: equal ranks at
  ``atol=rtol`` 1e-3 and 1e-4, far above float32's rounding, and ``U V^T``
  to 1e-5 relative; at 1e-6, where float32's rounding noise sets the ranks
  in both packages, the reconstruction errors ``||A - U V^T||`` within a
  factor 2 of each other;
- the plain versions of kernels E, F and G in float32 against the JAX
  expressions they replace (float32 sums: 1e-5); E's also against the
  update summed in float64 and rounded once (the F4 rule: within float32's
  rounding of the result);
- every level of the float32 factor, given JAX's float32 sketches: equal
  ranks, and ``LU_ LV_^T``, ``RU_ RV_^T`` and the Schur complements within
  2e-4 relative (the two libraries' float32 QR, SVD and LU sum in different
  orders, and the indefinite helmholtz2d(48, k=20)'s pivot blocks amplify
  that: its level 5's transforms part by 1.0e-4, the rest by at most 4e-5;
  ``tests/test_torch_mixed.py`` holds the float32 exact factor to 1e-4;
  ``tests/test_torch_compressed.py``'s float64 1e-10 is some 9e5 float64
  epsilons, 2e-4 some 3,400 float32 ones);
- mixed-precision GMRES (float32 cycles over the float32 operator inside a
  float64 solve, ``m_eps=1e-6``, escalation on) on the port's float32
  factor with JAX's sketches takes JAX's count on its own float32 factor,
  or one more or less; with the port's own sketches within two;
- a JAX float32 low-rank factorization carried over with
  ``factorization_from_numpy`` solves as JAX's (1e-4: the port's sweep sums
  in float64 and rounds once, JAX's sums in float32).
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
                                 solve_with_data)
from hsolve_torch.interop import factorization_from_numpy, plan_to_torch
from hsolve_torch.ops.lowrank import (lowrank_truncate_plain, rand_lowrank,
                                      sketch_width)
from hsolve_torch.ops.schur import lowrank_schur_update_plain
from hsolve_torch.ops.sweep import lowrank_sweep_update_plain

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function
F32 = torch.float32

# tests/test_torch_compressed.py's configuration and plans
COMP = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3, kest=32, hss=False)
CASES = [("poisson2d", 33, 40, {}), ("helmholtz2d", 48, 40, {"k": 20.0})]


def jax_sketch32(seed):
    """The JAX package's sketches of a float32 factor: ``split(fold_in(
    PRNGKey(seed), bidx))``, then ``normal(k, (n, s), float32)``
    (``hsolve/ops/lowrank.py:152`` draws in the factor's real type)."""
    def draw(bidx, bi, ib):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                   bidx))
        return tuple(torch.as_tensor(np.array(
            jax.random.normal(k, shape, dtype=jnp.float32)))
            for k, shape in zip(keys, (bi, ib)))
    return draw


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    if not ref.size:
        return 0.0
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _lowrank(U, V):
    U = np.asarray(U, dtype=np.float64)
    return U @ np.swapaxes(np.asarray(V, dtype=np.float64), -1, -2)


@functools.lru_cache(maxsize=None)
def _problem(i):
    name, n, leafmax, kw = CASES[i]
    A, b, shape = getattr(hsolve, name)(n, **kw)
    tree = hsolve.nested_dissection(shape, leafmax=leafmax)
    plan = hsolve.plan_factorization(A, tree, hsolve.SolverOptions(**COMP))
    assert any(bp.compress for bp in plan.batches)
    return A, np.asarray(b), shape, plan


@functools.lru_cache(maxsize=None)
def _jax_levels(i):
    _, _, _, plan = _problem(i)
    levels, stacks = [], {}
    jfactor._factor_levels(plan, hsolve.SolverOptions(**COMP), jnp.float32,
                           levels, stacks, None)
    return levels, stacks


@functools.lru_cache(maxsize=None)
def _jax_factor(i):
    _, _, _, plan = _problem(i)
    return hsolve.factor_with_plan(plan, hsolve.SolverOptions(**COMP),
                                   dtype=jnp.float32)


def _jprec(data, v):
    return jfactor.solve_with_data(data, v.astype(jnp.float32)).astype(v.dtype)


def _tprec(data, v):
    return solve_with_data(data, v.to(F32)).to(v.dtype)


@functools.lru_cache(maxsize=None)
def _jax_mixed(i):
    """JAX's mixed GMRES on its float32 factor: (iterations, relres)."""
    A, b, _, _ = _problem(i)
    x, info = hsolve.gmres_compiled(
        lambda d, v: hsolve.dia_matvec(d, v), _jprec,
        jnp.asarray(b, jnp.float64), reltol=1e-9, restart=30, maxiter=60,
        mv_data=hsolve.spmv_format(A, dtype=np.float64)[0],
        M_data=_jax_factor(i).solve_data, inner_dtype="float32",
        mv_data_inner=hsolve.spmv_format(A, dtype=np.float32)[0], m_eps=1e-6)
    assert info["converged"]
    return int(info["iters"]), \
        float(np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b))


def _port_mixed(A, b, F):
    op64, mv = ht.spmv_format(A, device="cpu")
    op32, _ = ht.spmv_format(A, dtype=np.float32, device="cpu")
    x, info = ht.gmres_compiled(
        mv, _tprec, torch.as_tensor(b), reltol=1e-9, restart=30, maxiter=60,
        mv_data=op64, M_data=F.solve_data, inner_dtype="float32",
        mv_data_inner=op32, m_eps=1e-6)
    return info, float(np.linalg.norm(A @ x.numpy() - b) / np.linalg.norm(b))


# --- rand_lowrank -------------------------------------------------------------------

def _decaying(rng, B, m, n, floor):
    r = min(m, n)
    sv = np.logspace(0, np.log10(floor), r)
    return np.stack([(np.linalg.qr(rng.standard_normal((m, r)))[0] * sv)
                     @ np.linalg.qr(rng.standard_normal((n, r)))[0].T
                     for _ in range(B)]).astype(np.float32)


@pytest.mark.parametrize("tol", [1e-3, 1e-4])
@pytest.mark.parametrize("m,n,cap", [(40, 30, 20), (24, 64, 20)])
def test_f32_rand_lowrank_matches_jax(m, n, cap, tol):
    """Float32 blocks with spectra decaying through the tolerance: given
    JAX's float32 sketch, the port's ranks are JAX's and ``U V^T`` agrees
    to 1e-5 relative."""
    rng = np.random.default_rng(m + n)
    A = _decaying(rng, 3, m, n, 1e-8)
    key = jax.random.PRNGKey(7)
    ref = jlowrank.rand_lowrank(jnp.asarray(A), key, tol, tol, cap)
    omega = jax.random.normal(key, (n, sketch_width(cap, n)),
                              dtype=jnp.float32)
    got = rand_lowrank(torch.as_tensor(A), torch.as_tensor(np.array(omega)),
                       tol, tol, cap)
    assert got.U.dtype == got.V.dtype == F32
    assert np.array_equal(got.rank.numpy(), np.asarray(ref.rank))
    assert 0 < int(got.rank.min()) and int(got.rank.max()) < cap
    assert _rel(_lowrank(got.U, got.V), _lowrank(ref.U, ref.V)) < 1e-5


def test_f32_rand_lowrank_at_float32_rounding():
    """At ``atol=rtol=1e-6`` the truncation sits at float32's rounding
    noise, which sets the ranks in both packages: the reconstruction errors
    are compared instead (each below 1e-5 of ||A||, within a factor 2 of
    each other)."""
    rng = np.random.default_rng(5)
    A = _decaying(rng, 3, 48, 40, 1e-9)
    key = jax.random.PRNGKey(3)
    ref = jlowrank.rand_lowrank(jnp.asarray(A), key, 1e-6, 1e-6, 32)
    omega = jax.random.normal(key, (40, sketch_width(32, 40)),
                              dtype=jnp.float32)
    got = rand_lowrank(torch.as_tensor(A), torch.as_tensor(np.array(omega)),
                       1e-6, 1e-6, 32)
    A64 = A.astype(np.float64)
    err = lambda U, V: np.linalg.norm(A64 - _lowrank(U, V), axis=(1, 2)) \
        / np.linalg.norm(A64, axis=(1, 2))
    et, ej = err(got.U, got.V), err(ref.U, ref.V)
    assert np.all(et < 1e-5) and np.all(ej < 1e-5)
    assert np.all(et <= 2 * ej) and np.all(ej <= 2 * et)


# --- plain versions of E, F and G against JAX's float32 expressions ------------------

def test_f32_truncate_plain_matches_jax():
    """G's plain version in float32: ``(Q Uw)[:k] * (sv * mask)`` and
    ``Vh^T[:k] * mask``, padded to the cap, the rank and mask from float32
    singular values as ``hsolve/ops/lowrank.py:130-165`` in float32: equal
    ranks, V bit for bit, U to 1e-5."""
    rng = np.random.default_rng(11)
    B, m, s, n, cap = 3, 30, 20, 25, 24
    Q = np.linalg.qr(rng.standard_normal((B, m, s)))[0].astype(np.float32)
    W = (rng.standard_normal((B, s, n)) * np.logspace(0, -5, n)).astype(
        np.float32)
    Uw, sv, Vh = (a.astype(np.float32) for a in
                  np.linalg.svd(W, full_matrices=False))
    rank, mask = jlowrank._rank_mask(jnp.asarray(sv), 1e-3, 1e-3, cap)
    k = min(cap, s)
    QUw = np.asarray(jnp.asarray(Q) @ jnp.asarray(Uw))
    U_ref = np.asarray(jnp.pad(QUw[..., :k] * (sv[:, None, :k]
                                               * mask[:, None, :k]),
                               ((0, 0), (0, 0), (0, cap - k))))
    V_ref = np.asarray(jnp.pad(np.swapaxes(Vh, -1, -2)[..., :k]
                               * mask[:, None, :k],
                               ((0, 0), (0, 0), (0, cap - k))))
    U, V, rk = lowrank_truncate_plain(*(torch.as_tensor(a) for a in
                                        (Q, Uw, sv, Vh)), 1e-3, 1e-3, cap)
    assert U.dtype == V.dtype == F32 and U_ref.dtype == np.float32
    assert np.array_equal(rk.numpy(), np.asarray(rank))
    assert 0 < int(rk.min()) and int(rk.max()) < s
    assert np.array_equal(V.numpy(), V_ref)
    assert _rel(U.numpy(), U_ref) < 1e-5


def test_f32_schur_plain_matches_jax():
    """F's plain version in float32: ``permute_sym(Abb - (Abi RU) RV^T,
    sperm)`` (``hsolve/factor.py:378-379``) summed in float32 in both."""
    rng = np.random.default_rng(12)
    B, ni, nb, kc = 3, 20, 14, 6
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    front, RU, RV = f(B, ni + nb, ni + nb), f(B, ni, kc), f(B, nb, kc)
    sperm = np.stack([rng.permutation(nb) for _ in range(B)])
    fj = jnp.asarray(front)
    ref = jdense.permute_sym(
        fj[:, ni:, ni:] - (fj[:, ni:, :ni] @ jnp.asarray(RU))
        @ jnp.swapaxes(jnp.asarray(RV), -1, -2), jnp.asarray(sperm))
    got = lowrank_schur_update_plain(torch.as_tensor(front), ni,
                                     torch.as_tensor(RU), torch.as_tensor(RV),
                                     torch.as_tensor(sperm))
    assert got.dtype == F32 and ref.dtype == jnp.float32
    assert _rel(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("form", ["forward", "backward"])
def test_f32_sweep_plain_matches_jax_and_sums_in_float64(form):
    """E's plain version in float32: ``C[out] -= U (V^T Y)`` with ``Y`` the
    gathered interior values (forward) or ``C[bnd]`` (backward), padded ids
    at the sentinel row N dropped (``hsolve/factor.py:528-529``,
    ``:555-556``): within 1e-5 of JAX's float32 update, and within
    float32's rounding (one rounding of the update, one of the difference)
    of the update summed in float64 and rounded once, where a float32
    summation of the same terms lands further off."""
    rng = np.random.default_rng(13)
    N, B, R, Cc, kc, k = 400, 3, 60, 70, 40, 2
    perm = rng.permutation(N)
    ids_out = perm[:B * R].reshape(B, R).astype(np.int32)
    ids_in = perm[B * R:B * (R + Cc)].reshape(B, Cc).astype(np.int32)
    ids_out[0, -2:] = N
    ids_in[1, -1] = N
    C0 = np.concatenate([rng.standard_normal((N, k)),
                         np.zeros((1, k))]).astype(np.float32)
    U = rng.standard_normal((B, R, kc)).astype(np.float32)
    V = rng.standard_normal((B, Cc, kc)).astype(np.float32)
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
    assert got.dtype == F32 and float(got[N].abs().max()) == 0.0
    assert _rel(got.numpy(), ref) < 1e-5
    # the F4 rule: the update in float64, rounded once, then subtracted
    U64, V64 = U.astype(np.float64), V.astype(np.float64)
    exact = U64 @ (np.swapaxes(V64, -1, -2) @ Y.astype(np.float64))
    want = C0.copy()
    keep = ids_out < N
    np.subtract.at(want, ids_out[keep], exact[keep].astype(np.float32))
    assert np.array_equal(got.numpy(), want)
    C64 = C0.astype(np.float64)
    np.subtract.at(C64, ids_out[keep], exact[keep])
    eps = np.finfo(np.float32).eps
    scale = np.abs(C64).max()
    assert np.abs(got.numpy() - C64).max() <= 2 * eps * scale
    assert np.abs(ref - C64).max() > np.abs(got.numpy() - C64).max()


# --- the factor -------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(CASES)))
def test_f32_lowrank_levels_match_jax(i):
    """Per level, with JAX's float32 sketches: JAX's ranks, and ``LU_
    LV_^T``, ``RU_ RV_^T`` and the Schur complements within 2e-4
    relative of JAX's float32 factor (the module's docstring says why)."""
    _, _, _, plan = _problem(i)
    jlevels, jstacks = _jax_levels(i)
    opts = ht.SolverOptions(**COMP)
    tlevels, troot, tstacks = _factor_levels(
        plan, plan_to_torch(plan, "cpu"), opts, F32, jax_sketch32(opts.seed))
    assert troot is None and len(tlevels) == len(jlevels)
    ncomp = 0
    for j, (tl, jl) in enumerate(zip(tlevels, jlevels)):
        assert isinstance(tl, CompressedLevel) == plan.batches[j].compress
        assert isinstance(tl, CompressedLevel) == hasattr(jl, "LU_")
        if isinstance(tl, CompressedLevel):
            ncomp += 1
            assert tl.LU_.dtype == F32 and jl.LU_.dtype == jnp.float32
            assert np.array_equal(tl.lrank.numpy(), np.asarray(jl.lrank)), j
            assert np.array_equal(tl.rrank.numpy(), np.asarray(jl.rrank)), j
            assert _rel(_lowrank(tl.LU_, tl.LV_), _lowrank(jl.LU_, jl.LV_)) \
                < 2e-4, (j, "L")
            assert _rel(_lowrank(tl.RU_, tl.RV_), _lowrank(jl.RU_, jl.RV_)) \
                < 2e-4, (j, "R")
        if tstacks[j].numel():
            assert _rel(tstacks[j].numpy(), jstacks[j]) < 2e-4, (j, "S")
    assert ncomp >= 3


@pytest.mark.parametrize("i", range(len(CASES)))
def test_f32_lowrank_mixed_gmres_matches_jax(i):
    """Mixed-precision GMRES on the port's float32 low-rank factor: with
    JAX's float32 sketches JAX's count on its own float32 factor, or one
    more or less (the two float32 factors part by up to 1e-4 a level), and
    JAX's ranks; with the port's own float32 sketches within two; relres <
    1e-9 by scipy in both."""
    A, b, shape, plan = _problem(i)
    iters_j, relres_j = _jax_mixed(i)
    assert relres_j < 1e-9
    opts = ht.SolverOptions(**COMP)
    F = ht.factor_with_plan(plan, opts, dtype=F32, device="cpu",
                            sketch=jax_sketch32(opts.seed))
    assert F.dtype == F32
    assert F.maxrank() == _jax_factor(i).maxrank() > 0
    assert F.rank_report() == _jax_factor(i).rank_report()
    info, relres = _port_mixed(A, b, F)
    assert info["converged"] and relres < 1e-9
    assert abs(info["iters"] - iters_j) <= 1
    name, n, leafmax, _ = CASES[i]
    F_own = ht.factor(A, ht.nested_dissection(shape, leafmax=leafmax),
                      dtype=F32, device="cpu", **COMP)
    info, relres = _port_mixed(A, b, F_own)
    assert info["converged"] and relres < 1e-9
    assert info["iters"] <= iters_j + 2
    assert not F_own.rank_report()["saturated"]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_factorization_from_numpy_f32_lowrank(i):
    """A JAX float32 low-rank factorization carried over record by record
    solves as JAX's: 1e-4 relative, one and two right-hand sides (the
    port's sweep sums in float64 and rounds once, JAX's in float32)."""
    A, b, _, plan = _problem(i)
    Fj = _jax_factor(i)
    Fc = factorization_from_numpy(Fj.levels, Fj.root, plan.perm, "cpu")
    assert Fc.dtype == F32
    assert sum(isinstance(lv, CompressedLevel) for lv in Fc.levels) >= 3
    rng = np.random.default_rng(9)
    for rhs in (b, rng.standard_normal((A.shape[0], 2))):
        rhs = rhs.astype(np.float32)
        assert _rel(Fc.solve(rhs).numpy(), np.asarray(Fj.solve(rhs))) < 1e-4
