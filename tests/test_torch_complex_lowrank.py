"""The damped, complex Helmholtz system on low-rank compressed levels
(``hss=False``) in the port against the JAX package, on the CPU, in
complex128, on ``tests/test_complex.py``'s fixture: helmholtz2d(48, k=25,
damping=0.1), leafmax 60, ``swlevel=-2, swsize=1, atol=rtol=1e-4``.

- ``rand_lowrank`` given JAX's sketch: JAX's ranks, and ``U V^T`` to 1e-12
  relative (the factors themselves differ by the complex SVD's and QR's
  unit-modulus column phases, so only products are compared);
- the plain versions of kernels E, F and G against the JAX expressions they
  replace, to 1e-13;
- every level of the factor, given JAX's sketches: equal ranks, and
  ``LU_ LV_^T``, ``RU_ RV_^T`` and the Schur complements to 1e-10;
- GMRES, given JAX's sketches: JAX's iteration count, relres < 1e-9 by
  scipy;
- ``torch_sketch``: the float64 and float32 draws bitwise as the real
  factor's always were, the complex128 draws the float64 ones cast;
  ``rand_lowrank`` on real input bitwise its plain-transpose form;
- a JAX complex low-rank factorization carried over with
  ``factorization_from_numpy`` solves as JAX's.
The JAX package runs with ``jax_enable_x64`` (``tests/conftest.py``): in
32-bit it factors this system in complex64 and its GMRES does not reach
1e-9."""

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
from hsolve_torch.ops.sweep import lowrank_sweep_update_plain, pivot_solve

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function

# tests/test_complex.py:39's compressed configuration, low-rank levels only
COMP = dict(swlevel=-2, swsize=1, atol=1e-4, rtol=1e-4, hss=False)


def jax_sketch(seed):
    """The JAX package's sketches (``hsolve/factor.py:354``): real normal
    draws, which the factor casts to its type as ``rand_lowrank`` does."""
    def draw(bidx, bi, ib):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                   bidx))
        return tuple(torch.as_tensor(np.array(
            jax.random.normal(k, shape, dtype=jnp.float64)))
            for k, shape in zip(keys, (bi, ib)))
    return draw


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    if not ref.size:
        return 0.0
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _lowrank(U, V):
    return np.asarray(U) @ np.swapaxes(np.asarray(V), -1, -2)


def _cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@functools.lru_cache(maxsize=None)
def _problem():
    A, b, shape = hsolve.helmholtz2d(48, k=25.0, damping=0.1)
    tree = hsolve.nested_dissection(shape, leafmax=60)
    plan = hsolve.plan_factorization(A, tree, hsolve.SolverOptions(**COMP))
    assert np.iscomplexobj(A.data)
    assert any(bp.compress for bp in plan.batches)
    assert not any(bp.structured for bp in plan.batches)
    return A, np.asarray(b), plan


@functools.lru_cache(maxsize=None)
def _jax_levels():
    _, _, plan = _problem()
    levels, stacks = [], {}
    jfactor._factor_levels(plan, hsolve.SolverOptions(**COMP), jnp.complex128,
                           levels, stacks, None)
    return levels, stacks


@functools.lru_cache(maxsize=None)
def _jax_factor():
    _, _, plan = _problem()
    return hsolve.factor_with_plan(plan, hsolve.SolverOptions(**COMP))


@functools.lru_cache(maxsize=None)
def _jax_iters():
    """``hsolve.gmres``'s and ``hsolve.gmres_compiled``'s iteration counts
    with the JAX factor."""
    A, b, _ = _problem()
    Fj = _jax_factor()
    ell = hsolve.to_ell(A)
    _, ij = hsolve.gmres(lambda v: hsolve.ell_matvec(ell, v), b, M=Fj.solve,
                         reltol=1e-9, restart=30, maxiter=60)
    _, ijc = hsolve.gmres_compiled(
        lambda d, v: hsolve.dia_matvec(d, v), jfactor.solve_with_data,
        jnp.asarray(b), reltol=1e-9, restart=30, maxiter=60,
        mv_data=hsolve.to_dia(A), M_data=Fj.solve_data)
    assert ij["converged"] and ijc["converged"]
    return int(ij["iters"]), int(ijc["iters"])


@functools.lru_cache(maxsize=None)
def _port_levels():
    _, _, plan = _problem()
    opts = ht.SolverOptions(**COMP)
    return _factor_levels(plan, plan_to_torch(plan, "cpu"), opts,
                          torch.complex128, jax_sketch(opts.seed))


# --- rand_lowrank ---------------------------------------------------------------

@pytest.mark.parametrize("m,n,cap", [(40, 30, 12), (24, 64, 20)])
def test_rand_lowrank_matches_jax(m, n, cap):
    """A batch of complex blocks with decaying spectra: given the sketch
    JAX draws from its key, the port's ranks are JAX's and ``U V^T``
    agrees to 1e-12 relative."""
    rng = np.random.default_rng(m + n)
    r = min(m, n)
    sv = np.logspace(0, -12, r)
    A = np.stack([(np.linalg.qr(_cplx(rng, m, r))[0] * sv)
                  @ np.linalg.qr(_cplx(rng, n, r))[0].T for _ in range(3)])
    key = jax.random.PRNGKey(7)
    ref = jlowrank.rand_lowrank(jnp.asarray(A), key, 1e-4, 1e-4, cap)
    omega = jax.random.normal(key, (n, sketch_width(cap, n)),
                              dtype=jnp.float64)
    got = rand_lowrank(torch.as_tensor(A),
                       torch.as_tensor(np.array(omega)).to(torch.complex128),
                       1e-4, 1e-4, cap)
    assert got.U.dtype == got.V.dtype == torch.complex128
    assert np.array_equal(got.rank.numpy(), np.asarray(ref.rank))
    assert 0 < int(got.rank.min()) and int(got.rank.max()) < cap
    assert _rel(_lowrank(got.U, got.V), _lowrank(ref.U, ref.V)) < 1e-12


def test_rand_lowrank_real_bitwise():
    """On real input ``Q^H A`` is ``Q^T A`` bit for bit: the float64
    factor's records do not move."""
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.standard_normal((4, 30, 50)))
    omega = torch.as_tensor(rng.standard_normal((50, 20)))
    got = rand_lowrank(A, omega, 1e-8, 1e-8, 12)
    Q, _ = torch.linalg.qr(A @ omega)
    Uw, sv, Vh = torch.linalg.svd(Q.transpose(-1, -2) @ A,
                                  full_matrices=False)
    U, V, rank = lowrank_truncate_plain(Q, Uw, sv, Vh, 1e-8, 1e-8, 12)
    for a, b in zip(got, (U, V, rank)):
        assert torch.equal(a, b)


# --- the sketches -----------------------------------------------------------------

@pytest.mark.parametrize("key", [3, (7005, 202)])
def test_torch_sketch_draws(key):
    """float64 and float32 draws bitwise the generator's in their own type
    (as the real factor drew them before complex levels); complex128 draws
    the float64 ones cast."""
    shapes = ((40, 20), (24, 20))
    k0, tag = (key, 0) if isinstance(key, int) else key
    for real, cplx in ((torch.float64, torch.complex128),
                       (torch.float32, None)):
        gen = torch.Generator()
        gen.manual_seed((5 << 24) + (tag << 14) + k0)
        ref = [torch.randn(s, generator=gen, dtype=real) for s in shapes]
        got = torch_sketch(5, torch.device("cpu"), real)(key, *shapes)
        assert all(g.dtype == real and torch.equal(g, r)
                   for g, r in zip(got, ref))
        if cplx is not None:
            got = torch_sketch(5, torch.device("cpu"), cplx)(key, *shapes)
            assert all(g.dtype == cplx and torch.equal(g, r.to(cplx))
                       for g, r in zip(got, ref))


# --- plain versions of E, F and G against JAX's expressions -------------------------

def test_truncate_plain_matches_jax():
    """G's plain version: ``(Q Uw)[:k] * (sv * mask)`` and the plain
    (unconjugated) ``Vh^T[:k] * mask``, padded to the cap, as
    ``hsolve/ops/lowrank.py:157-165``; the rank equal, real ``sv``."""
    rng = np.random.default_rng(11)
    B, m, s, n, cap = 3, 30, 20, 25, 24
    Q = np.linalg.qr(_cplx(rng, B, m, s))[0]
    W = _cplx(rng, B, s, n) * np.logspace(0, -8, n)
    Uw, sv, Vh = np.linalg.svd(W, full_matrices=False)
    rank, mask = jlowrank._rank_mask(jnp.asarray(sv), 1e-5, 1e-5, cap)
    k = min(cap, s)
    pad = ((0, 0), (0, 0), (0, cap - k))
    U_ref = np.pad((Q @ Uw)[..., :k] * (sv[:, None, :k] * mask[:, None, :k]),
                   pad)
    V_ref = np.pad(np.swapaxes(Vh, -1, -2)[..., :k] * mask[:, None, :k], pad)
    U, V, rk = lowrank_truncate_plain(*(torch.as_tensor(a) for a in
                                        (Q, Uw, sv, Vh)), 1e-5, 1e-5, cap)
    assert U.dtype == V.dtype == torch.complex128
    assert np.array_equal(rk.numpy(), np.asarray(rank))
    assert _rel(U.numpy(), U_ref) < 1e-13
    assert _rel(V.numpy(), V_ref) < 1e-13


def test_schur_plain_matches_jax():
    """F's plain version: ``permute_sym(Abb - (Abi RU) RV^T, sperm)``
    with plain transposes (``hsolve/factor.py:378-379``)."""
    rng = np.random.default_rng(12)
    B, ni, nb, kc = 3, 20, 14, 6
    front = _cplx(rng, B, ni + nb, ni + nb)
    RU, RV = _cplx(rng, B, ni, kc), _cplx(rng, B, nb, kc)
    sperm = np.stack([rng.permutation(nb) for _ in range(B)])
    ref = jdense.permute_sym(
        jnp.asarray(front[:, ni:, ni:] - (front[:, ni:, :ni] @ RU)
                    @ np.swapaxes(RV, -1, -2)), jnp.asarray(sperm))
    got = lowrank_schur_update_plain(*(torch.as_tensor(a) for a in
                                       (front, )), ni, torch.as_tensor(RU),
                                     torch.as_tensor(RV), torch.as_tensor(sperm))
    assert got.dtype == torch.complex128
    assert _rel(got.numpy(), ref) < 1e-13


@pytest.mark.parametrize("form", ["forward", "backward"])
def test_sweep_plain_matches_jax(form):
    """E's plain version: ``C[out] -= U (V^T Y)`` with ``Y`` the gathered
    interior values (forward) or ``C[bnd]`` (backward), plain transposes,
    padded ids at the sentinel row N dropped, as ``_apply_impl``
    (``hsolve/factor.py:528-529``, ``:555-556``)."""
    rng = np.random.default_rng(13)
    N, B, R, Cc, kc, k = 60, 3, 9, 7, 4, 2
    perm = rng.permutation(N)
    ids_out = perm[:B * R].reshape(B, R).astype(np.int32)
    ids_in = perm[B * R:B * (R + Cc)].reshape(B, Cc).astype(np.int32)
    ids_out[0, -2:] = N
    ids_in[1, -1] = N
    C0 = np.concatenate([_cplx(rng, N, k), np.zeros((1, k))])
    U, V = _cplx(rng, B, R, kc), _cplx(rng, B, Cc, kc)
    Y = C0[ids_in]
    upd = U @ (np.swapaxes(V, -1, -2) @ Y)
    ref = jnp.asarray(C0).at[jnp.asarray(ids_out)].add(
        -jnp.asarray(upd), mode="drop")
    ref = np.asarray(ref.at[N].set(0.0))
    kw = {"X": torch.as_tensor(Y)} if form == "forward" else \
        {"ids_in": torch.as_tensor(ids_in)}
    got = lowrank_sweep_update_plain(torch.as_tensor(C0),
                                     torch.as_tensor(ids_out),
                                     torch.as_tensor(U), torch.as_tensor(V),
                                     N, **kw)
    assert float(got[N].abs().max()) == 0.0
    assert _rel(got.numpy(), ref) < 1e-13


# --- the factor ---------------------------------------------------------------------

def test_complex_lowrank_levels_match_jax():
    """Per level, with JAX's sketches: JAX's ranks, and ``LU_ LV_^T``,
    ``RU_ RV_^T`` and the Schur complements within 1e-10 relative."""
    _, _, plan = _problem()
    jlevels, jstacks = _jax_levels()
    tlevels, troot, tstacks = _port_levels()
    assert len(tlevels) == len(jlevels)
    ncomp = 0
    for i, (tl, jl) in enumerate(zip(tlevels, jlevels)):
        assert isinstance(tl, CompressedLevel) == plan.batches[i].compress
        assert isinstance(tl, CompressedLevel) == hasattr(jl, "LU_")
        if isinstance(tl, CompressedLevel):
            ncomp += 1
            assert tl.LU_.dtype == torch.complex128
            assert np.array_equal(tl.lrank.numpy(), np.asarray(jl.lrank)), i
            assert np.array_equal(tl.rrank.numpy(), np.asarray(jl.rrank)), i
            assert _rel(_lowrank(tl.LU_, tl.LV_), _lowrank(jl.LU_, jl.LV_)) \
                < 1e-10, (i, "L")
            assert _rel(_lowrank(tl.RU_, tl.RV_), _lowrank(jl.RU_, jl.RV_)) \
                < 1e-10, (i, "R")
        if tstacks[i].numel():
            assert _rel(tstacks[i].numpy(), jstacks[i]) < 1e-10, (i, "S")
    assert ncomp >= 3


def test_complex_lowrank_rank_report():
    """``rank_report`` and ``maxrank`` read the complex levels' ranks: the
    JAX factor's maximum, no cap saturated."""
    A, _, plan = _problem()
    opts = ht.SolverOptions(**COMP)
    F = ht.factor_with_plan(plan, opts, device="cpu",
                            sketch=jax_sketch(opts.seed))
    assert F.dtype == torch.complex128
    assert F.maxrank() == _jax_factor().maxrank() > 0
    assert not F.rank_report()["saturated"]


def test_complex_lowrank_gmres_matches_jax():
    """GMRES with the port's complex low-rank factor (JAX's sketches) takes
    ``hsolve.gmres``'s and ``hsolve.gmres_compiled``'s iteration count,
    relres < 1e-9 by scipy."""
    A, b, plan = _problem()
    opts = ht.SolverOptions(**COMP)
    F = ht.factor_with_plan(plan, opts, device="cpu",
                            sketch=jax_sketch(opts.seed))
    op, mv = ht.spmv_format(A, device="cpu")
    x, info = ht.gmres_compiled(mv, solve_with_data, torch.as_tensor(b),
                                reltol=1e-9, restart=30, maxiter=60,
                                mv_data=op, M_data=F.solve_data)
    assert x.dtype == torch.complex128 and info["converged"]
    assert (info["iters"],) * 2 == _jax_iters() and info["iters"] > 1
    assert np.linalg.norm(b - A @ x.numpy()) / np.linalg.norm(b) < 1e-9


def test_complex_lowrank_own_sketches_converge():
    """``ht.factor`` with the port's own sketches (complex128 from the
    float64 draws): GMRES converges to relres < 1e-9 within two iterations
    of the JAX package's count."""
    A, b, _ = _problem()
    _, _, shape = hsolve.helmholtz2d(48, k=25.0, damping=0.1)
    F = ht.factor(A, ht.nested_dissection(shape, leafmax=60), device="cpu",
                  **COMP)
    op, mv = ht.spmv_format(A, device="cpu")
    x, info = ht.gmres_compiled(mv, solve_with_data, torch.as_tensor(b),
                                reltol=1e-9, restart=30, maxiter=60,
                                mv_data=op, M_data=F.solve_data)
    assert info["converged"] and info["iters"] <= _jax_iters()[1] + 2
    assert np.linalg.norm(b - A @ x.numpy()) / np.linalg.norm(b) < 1e-9


def test_factorization_from_numpy_complex_lowrank():
    """A JAX complex low-rank factorization carried over record by record
    solves as JAX's (1e-12 relative, one and three right-hand sides); the
    pivot solves keep C's sentinel row zero."""
    A, b, plan = _problem()
    Fj = _jax_factor()
    Fc = factorization_from_numpy(Fj.levels, Fj.root, plan.perm, "cpu")
    assert Fc.dtype == torch.complex128
    assert any(isinstance(lv, CompressedLevel) for lv in Fc.levels)
    rng = np.random.default_rng(9)
    for rhs in (b, _cplx(rng, A.shape[0], 3)):
        assert _rel(Fc.solve(rhs).numpy(), np.asarray(Fj.solve(rhs))) < 1e-12
    N, padded = A.shape[0], 0
    for lev in Fc.levels:
        if isinstance(lev, CompressedLevel):
            pad = lev.int_ids == N
            x = torch.as_tensor(_cplx(rng, *lev.int_ids.shape, 2))
            x[pad] = 0.0
            assert torch.count_nonzero(pivot_solve(lev, x)[pad]) == 0
            padded += int(pad.sum())
    assert padded > 0


def test_kernel_operands_are_materialized():
    """A lazily conjugated view keeps its values unconjugated in memory
    (``torch.linalg.svd`` on the card returns ``Vh`` so, and
    ``.contiguous()`` keeps the view's conjugate bit): ``kernels.require``
    refuses one, and ``kernels.materialized`` writes the conjugate out."""
    from hsolve_torch import kernels

    rng = np.random.default_rng(21)
    t = torch.as_tensor(_cplx(rng, 3, 4)).conj()
    assert t.is_conj() and t.contiguous().is_conj()
    with pytest.raises(ValueError, match="conjugated"):
        kernels.require(t.contiguous(), "Vh", torch.complex128)
    m = kernels.materialized(t)
    assert not m.is_conj() and m.is_contiguous()
    assert torch.equal(m, t) and torch.equal(
        torch.view_as_real(m), torch.view_as_real(t.resolve_conj()))
    kernels.require(m, "Vh", torch.complex128)
    r = torch.as_tensor(rng.standard_normal((3, 4)))
    assert kernels.materialized(r) is r
