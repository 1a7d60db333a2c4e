"""Each kernel module of the port against the JAX function it replaces.

On the CPU every kernel wrapper runs its plain torch version, so these tests
pin the arithmetic the CUDA kernels must reproduce (``chip_smoke.py`` holds the
kernels to the plain versions on the card).  Inputs are made with numpy from a
seed and handed to both packages."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht
from hsolve.ops import dense as jdense
from hsolve.planner import ChildGroup
from hsolve_torch.interop import factorization_from_numpy, plan_to_torch
from hsolve_torch.ops import dense as tdense
from hsolve_torch.ops.assembly import extend_add, front_assemble
from hsolve_torch.ops.sparse import dia_residual

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # the name hsolve.factor is the function


def _t(a):
    return torch.as_tensor(np.array(a))


def _plan(n=48, leafmax=40, k=20.0):
    A, b, shape = hsolve.helmholtz2d(n, k=k)
    tree = hsolve.nested_dissection(shape, leafmax=leafmax)
    return A, np.asarray(b), hsolve.plan_factorization(
        A, tree, hsolve.SolverOptions(swlevel=0))


# --- kernel A: front assembly -------------------------------------------------

def test_front_assemble_matches_build_front_vals():
    _, _, plan = _plan()
    tp = plan_to_torch(plan, "cpu")
    ad = jnp.asarray(plan.A_raw[2])
    for bp, tb in zip(plan.batches, tp.batches):
        sf = jnp.asarray(bp.front_src)
        vals = jnp.where(sf >= 0, ad[jnp.clip(sf, 0)], jnp.ones((), ad.dtype))
        ref = np.asarray(jfactor.build_front_vals(bp, vals,
                                                  jnp.asarray(bp.front_pos)))
        got = front_assemble(bp.B, bp.m_pad, tb.pos, tb.src, tp.adata).numpy()
        assert np.array_equal(got, ref)
        # the host-value path of the JAX package builds the same fronts
        assert np.array_equal(got, np.asarray(jfactor.build_front(bp, jnp.float64)))


# --- kernel B: extend-add -------------------------------------------------------

def _jax_extend_add(front, groups, stacks, s_pad, imap):
    stage = jfactor._stage_children(groups, stacks, front.shape[0], s_pad,
                                    jnp.float64)
    return np.asarray(jfactor._extend_add_impl(jnp.asarray(front), stage,
                                               jnp.asarray(imap)))


def test_extend_add_reads_narrow_and_wide_sources():
    """A source stack narrower than s_pad must add zeros past its width (the
    JAX staging buffer's padding); a wider one is read inside s_pad only."""
    rng = np.random.default_rng(7)
    B, m, s_pad = 5, 12, 8
    front = rng.standard_normal((B, m, m))
    imap = rng.integers(-1, s_pad, size=(B, m)).astype(np.int32)
    stacks = {0: rng.standard_normal((3, 6, 6)),       # width 6 < s_pad
              1: rng.standard_normal((2, 10, 10))}     # width 10 > s_pad
    groups = (ChildGroup(0, np.array([2, 0]), np.array([1, 3])),
              ChildGroup(1, np.array([1]), np.array([4])))
    ref = _jax_extend_add(front, groups, {k: jnp.asarray(v)
                                          for k, v in stacks.items()},
                          s_pad, imap)
    got = _t(front).clone()
    for g in groups:
        extend_add(got, _t(stacks[g.src_batch]),
                   _t(g.src_rows.astype(np.int32)), _t(g.dst_rows.astype(np.int32)),
                   _t(imap))
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got.numpy()[[0, 2]], front[[0, 2]])  # rows of no group


def test_extend_add_matches_jax_on_a_real_plan():
    """Left then right groups, several source batches per side (n=48 is
    unbalanced), real Schur stacks from the JAX factorization."""
    _, _, plan = _plan()
    opts = hsolve.SolverOptions(swlevel=0, explicit_inverse=False)
    stacks = {}
    jfactor._factor_levels(plan, opts, jnp.float64, [], stacks, None)
    tp = plan_to_torch(plan, "cpu")
    tstacks = {k: _t(v) for k, v in stacks.items()}
    multi = 0
    for bp, tb in zip(plan.batches[1:], tp.batches[1:]):
        front = np.asarray(jfactor.build_front(bp, jnp.float64))
        ref = _jax_extend_add(front, bp.groups_l, stacks, bp.sl_pad, bp.map_l)
        ref = _jax_extend_add(ref, bp.groups_r, stacks, bp.sr_pad, bp.map_r)
        got = _t(front).clone()
        for groups, imap in ((tb.groups_l, tb.map_l), (tb.groups_r, tb.map_r)):
            for s, sr, dr in groups:
                extend_add(got, tstacks[s], sr, dr, imap)
        assert np.array_equal(got.numpy(), ref)
        multi += len(bp.groups_l) + len(bp.groups_r) > 2
    assert multi > 0


# --- kernel C: solve sweeps -----------------------------------------------------

@pytest.mark.parametrize("explicit", [False, True])
def test_sweeps_on_jax_factors(explicit):
    """The port's level sweeps (kernel C around the pivot solves) on the JAX
    factors carried over with factorization_from_numpy."""
    A, b, plan = _plan()
    Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(
        swlevel=0, explicit_inverse=explicit), dtype=jnp.float64)
    Ft = factorization_from_numpy(Fj.levels, Fj.root, plan.perm, "cpu")
    assert (Ft.levels[0].dinv is not None) == explicit
    rng = np.random.default_rng(3)
    for rhs in (b, rng.standard_normal((A.shape[0], 3))):
        ref = np.asarray(Fj.solve(rhs))
        got = Ft.solve(rhs).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())
        ref_p = np.asarray(Fj.apply_permuted(rhs))
        np.testing.assert_allclose(Ft.apply_permuted(rhs).numpy(), ref_p,
                                   rtol=1e-12, atol=1e-12 * np.abs(ref_p).max())


def test_sweep_update_skips_sentinel_rows():
    from hsolve_torch.ops.sweep import sweep_update

    N = 6
    C = torch.arange(2 * (N + 1), dtype=torch.float64).reshape(N + 1, 2)
    C[N] = 0.0
    ids_out = torch.tensor([[1, N]], dtype=torch.int32)
    ids_in = torch.tensor([[0, N, 3]], dtype=torch.int32)
    M = torch.ones(1, 2, 3, dtype=torch.float64)
    out = sweep_update(C.clone(), ids_out, M, N, ids_in=ids_in)
    want = C.clone()
    want[1] -= C[0] + C[3]
    assert torch.equal(out, want)
    with pytest.raises(ValueError, match="exactly one"):
        sweep_update(C.clone(), ids_out, M, N)


# --- kernel D: DIA matvec -------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
def test_dia_matvec_matches_jax(k):
    A, b, _ = hsolve.helmholtz2d(33, k=10.0)
    rng = np.random.default_rng(k)
    x = rng.standard_normal((A.shape[0], k))
    rhs = rng.standard_normal((A.shape[0], k))
    if k == 1:
        x, rhs = x[:, 0], rhs[:, 0]
    jd = hsolve.to_dia(A)
    ref = np.asarray(hsolve.dia_matvec(jd, jnp.asarray(x)))
    td = ht.to_dia(A, device="cpu")
    assert td.offsets == jd.offsets
    got = ht.dia_matvec(td, _t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13 * np.abs(ref).max())
    res = dia_residual(td, _t(x), _t(rhs)).numpy()
    np.testing.assert_allclose(res, rhs - ref, rtol=1e-13,
                               atol=1e-13 * np.abs(rhs - ref).max())


def test_ell_and_spmv_format_match_scipy():
    A, _, _ = hsolve.helmholtz2d(17, k=8.0)
    x = np.random.default_rng(0).standard_normal((A.shape[0], 2))
    ell = ht.to_ell(A, device="cpu")
    np.testing.assert_allclose(ht.ell_matvec(ell, _t(x)).numpy(), A @ x,
                               rtol=1e-13, atol=1e-13)
    op, mv = ht.spmv_format(A, device="cpu")
    assert mv is ht.dia_matvec
    np.testing.assert_allclose(mv(op, _t(x[:, 0])).numpy(), A @ x[:, 0],
                               rtol=1e-13, atol=1e-13)


# --- ops/dense.py (library calls) -----------------------------------------------

def _blocks(n, batch=3, seed=0):
    rng = np.random.default_rng(seed + n)
    D = rng.standard_normal((batch, n, n)) + 0.5 * np.eye(n)
    return D, rng.standard_normal((batch, n, 5)), rng.standard_normal((batch, 4, n))


@pytest.mark.parametrize("n", [32, 104, 128])
def test_dense_ops_match_jax(n):
    D, Bm, Bl = _blocks(n)
    lu_j, perm_j = jdense.lu_factor(jnp.asarray(D))
    lu_t, perm_t = tdense.lu_factor(_t(D))
    assert np.array_equal(perm_t.numpy(), np.asarray(perm_j))
    np.testing.assert_allclose(lu_t.numpy(), np.asarray(lu_j), rtol=1e-12,
                               atol=1e-12)
    pairs = [
        (tdense.lu_solve(lu_t, perm_t, _t(Bm)),
         jdense.lu_solve(lu_j, perm_j, jnp.asarray(Bm))),
        (tdense.lu_solve_right(lu_t, perm_t, _t(Bl)),
         jdense.lu_solve_right(lu_j, perm_j, jnp.asarray(Bl))),
        (tdense.lu_inverse(lu_t, perm_t), jdense.lu_inverse(lu_j, perm_j)),
    ]
    inv_t, ratio_t = tdense.block_inverse(_t(D))
    inv_j, ratio_j = jdense.block_inverse(jnp.asarray(D))
    pairs.append((inv_t, inv_j))
    for got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max())
    np.testing.assert_allclose(ratio_t.numpy(), np.asarray(ratio_j), rtol=1e-10)
    perm = np.stack([np.random.default_rng(i).permutation(n) for i in range(3)])
    assert np.array_equal(
        tdense.permute_sym(_t(D), _t(perm)).numpy(),
        np.asarray(jdense.permute_sym(jnp.asarray(D), jnp.asarray(perm))))
    ref = np.asarray(jdense.schur_complement(jnp.asarray(D), jnp.asarray(D),
                                             jnp.asarray(D)))
    np.testing.assert_allclose(
        tdense.schur_complement(_t(D), _t(D), _t(D)).numpy(), ref,
        rtol=1e-12, atol=1e-12 * np.abs(ref).max())
