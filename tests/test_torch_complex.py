"""The complex (damped Helmholtz) system in the port against the JAX package,
on the CPU: each module of the exact path in complex128 and complex64, and
the whole slice on ``tests/test_complex.py``'s fixture,
helmholtz2d(48, k=25, damping=0.1) at leafmax 60.

- kernels A and B (front assembly, extend-add) bit for bit JAX's
  ``build_front_vals`` and ``_extend_add_impl`` on complex values;
- kernel D (``dia_matvec`` and the fused residual) to 1e-13 (complex128) and
  1e-6 (complex64) relative: only the summation order differs;
- the factor: the port's levels solve as JAX's to 1e-12 relative, and the
  JAX records carried over with ``factorization_from_numpy`` give the same
  solve to 1e-12;
- GMRES: the exact complex128 solve in one iteration at relres <= 1e-9, and
  the bench's complex configuration (a complex64 factor, complex64 cycles in
  a complex128 solve, ``m_eps=1e-6``, escalation) within one iteration of
  JAX's count on the same inputs;
- a complex compressed plan factors in complex128, on low-rank
  (``hss=False``) and on structured levels (``hss=True``, the default;
  ``test_torch_complex_lowrank.py`` and
  ``test_torch_complex_structured.py`` hold those levels to JAX's).
Kernel C's level steps in complex are in ``test_torch_sweep.py``, the
Arnoldi step in ``test_torch_arnoldi.py`` and the cycle start in
``test_torch_krylov_deferred.py``, beside their real cases."""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht
from hsolve.planner import ChildGroup
from hsolve_torch.factor import solve_with_data
from hsolve_torch.interop import factorization_from_numpy, plan_to_torch
from hsolve_torch.ops.assembly import extend_add, front_assemble
from hsolve_torch.ops.sparse import dia_residual

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function

CTYPES = ["complex128", "complex64"]


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    if not got.size:                # an empty record (no boundary)
        return 0.0
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@functools.lru_cache(maxsize=None)
def _problem():
    A, b, shape = hsolve.helmholtz2d(48, k=25.0, damping=0.1)
    tree = hsolve.nested_dissection(shape, leafmax=60)
    plan = hsolve.plan_factorization(A, tree, hsolve.SolverOptions(swlevel=0))
    return A, np.asarray(b), plan


# --- kernels A and B ----------------------------------------------------------

@pytest.mark.parametrize("dtype", CTYPES)
def test_front_assemble_matches_build_front_vals(dtype):
    """Complex values gathered bit for bit, the padding's sentinel 1 + 0j."""
    _, _, plan = _problem()
    tp = plan_to_torch(plan, "cpu")
    ad = jnp.asarray(plan.A_raw[2]).astype(dtype)
    assert np.iscomplexobj(plan.A_raw[2])
    for bp, tb in zip(plan.batches, tp.batches):
        sf = jnp.asarray(bp.front_src)
        vals = jnp.where(sf >= 0, ad[jnp.clip(sf, 0)], jnp.ones((), dtype))
        ref = np.asarray(jfactor.build_front_vals(bp, vals,
                                                  jnp.asarray(bp.front_pos)))
        got = front_assemble(bp.B, bp.m_pad, tb.pos, tb.src,
                             tp.adata.to(getattr(torch, dtype))).numpy()
        assert got.dtype == np.dtype(dtype)
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("dtype", CTYPES)
def test_extend_add_matches_jax(dtype):
    """Random complex fronts and Schur stacks (one narrower, one wider than
    s_pad) through JAX's staging and ``_extend_add_impl``: bit for bit."""
    rng = np.random.default_rng(17)
    cplx = lambda *sh: (rng.standard_normal(sh)
                        + 1j * rng.standard_normal(sh)).astype(dtype)
    B, m, s_pad = 5, 12, 8
    front = cplx(B, m, m)
    imap = rng.integers(-1, s_pad, size=(B, m)).astype(np.int32)
    stacks = {0: cplx(3, 6, 6), 1: cplx(2, 10, 10)}
    groups = (ChildGroup(0, np.array([2, 0]), np.array([1, 3])),
              ChildGroup(1, np.array([1]), np.array([4])))
    stage = jfactor._stage_children(groups, {k: jnp.asarray(v)
                                             for k, v in stacks.items()},
                                    B, s_pad, getattr(jnp, dtype))
    ref = np.asarray(jfactor._extend_add_impl(jnp.asarray(front), stage,
                                              jnp.asarray(imap)))
    got = _t(front).clone()
    for g in groups:
        extend_add(got, _t(stacks[g.src_batch]), _t(g.src_rows.astype(np.int32)),
                   _t(g.dst_rows.astype(np.int32)), _t(imap))
    assert np.array_equal(got.numpy(), ref)


# --- kernel D -------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("complex128", 1e-13),
                                       ("complex64", 1e-6)])
@pytest.mark.parametrize("k", [1, 3])
def test_dia_matvec_and_residual_match_jax(dtype, tol, k):
    A, _, _ = _problem()
    rng = np.random.default_rng(k)
    sh = (A.shape[0], k) if k > 1 else (A.shape[0],)
    x = (rng.standard_normal(sh) + 1j * rng.standard_normal(sh)).astype(dtype)
    rhs = (rng.standard_normal(sh) + 1j * rng.standard_normal(sh)).astype(dtype)
    jd = hsolve.to_dia(A, np.dtype(dtype))
    ref = np.asarray(hsolve.dia_matvec(jd, jnp.asarray(x)))
    td = ht.to_dia(A, dtype=np.dtype(dtype), device="cpu")
    assert td.offsets == jd.offsets and td.values.dtype == getattr(torch, dtype)
    assert _rel(ht.dia_matvec(td, _t(x)).numpy(), ref) < tol
    assert _rel(dia_residual(td, _t(x), _t(rhs)).numpy(), rhs - ref) < tol


# --- the factor -----------------------------------------------------------------

def test_port_factor_solves_as_jax_s():
    """complex128 exact factor: the port's solve and the JAX records carried
    over both agree with JAX's solve to 1e-12 relative, on one and three
    right-hand sides."""
    A, b, plan = _problem()
    Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(swlevel=0))
    Ft = ht.factor_with_plan(plan, ht.SolverOptions(swlevel=0), device="cpu")
    Fc = factorization_from_numpy(Fj.levels, Fj.root, plan.perm, "cpu")
    assert Ft.dtype == Fc.dtype == torch.complex128
    rng = np.random.default_rng(5)
    for rhs in (b, rng.standard_normal((A.shape[0], 3))
                + 1j * rng.standard_normal((A.shape[0], 3))):
        ref = np.asarray(Fj.solve(rhs))
        assert _rel(Ft.solve(rhs).numpy(), ref) < 1e-12
        assert _rel(Fc.solve(rhs).numpy(), ref) < 1e-12
    x = Ft.solve(b).numpy()
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-11


def test_complex64_levels_match_jax():
    """complex64 exact factor: each level's records (L, R) within 1e-4 of
    JAX's complex64 ones relative to the level's largest entry (both run
    LAPACK's c routines on the same fronts, in other orders), and the solve
    within 1e-4."""
    A, b, plan = _problem()
    Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(swlevel=0),
                                 dtype=jnp.complex64)
    Ft = ht.factor_with_plan(plan, ht.SolverOptions(swlevel=0),
                             dtype=torch.complex64, device="cpu")
    assert Ft.dtype == torch.complex64
    for jl, tl in zip(Fj.levels, Ft.levels):
        for f in ("L", "R"):
            assert _rel(getattr(tl, f).numpy(), getattr(jl, f)) < 1e-4, f
    assert _rel(Ft.solve(b.astype(np.complex64)).numpy(),
                Fj.solve(b.astype(np.complex64))) < 1e-4


@pytest.mark.parametrize("hss", [True, False])
def test_complex_compressed_plan_is_refused(hss):
    """A complex compressed plan is no longer refused: it factors in
    complex128 on low-rank compressed levels (``hss=False``) and on
    structured (HSS) levels (``hss=True``, the default), with computed
    ranks (``tests/test_torch_complex_structured.py`` holds the structured
    levels to the JAX package's)."""
    from hsolve_torch.structured import StructuredLevel

    A, _, shape = hsolve.helmholtz2d(48, k=25.0, damping=0.1)
    tree = ht.nested_dissection(shape, leafmax=60)
    kw = dict(swlevel=-2, swsize=1, atol=1e-4, rtol=1e-4, hss=hss,
              device="cpu")
    F = ht.factor(A, tree, **kw)
    assert F.dtype == torch.complex128 and F.maxrank() > 0
    assert any(isinstance(lv, StructuredLevel) for lv in F.levels) == hss


# --- GMRES ------------------------------------------------------------------------

def test_exact_gmres_takes_one_iteration():
    A, b, plan = _problem()
    F = ht.factor_with_plan(plan, ht.SolverOptions(swlevel=0), device="cpu")
    op, mv = ht.spmv_format(A, device="cpu")
    x, info = ht.gmres_compiled(mv, solve_with_data, torch.as_tensor(b),
                                reltol=1e-9, restart=30, maxiter=60,
                                mv_data=op, M_data=F.solve_data)
    assert x.dtype == torch.complex128
    assert info["iters"] == 1 and info["converged"]
    assert np.linalg.norm(A @ x.numpy() - b) / np.linalg.norm(b) <= 1e-9


def test_mixed_complex64_gmres_matches_jax():
    """The bench's complex configuration: complex64 factor and cycles over a
    complex64 operator inside a complex128 solve (m_eps=1e-6, escalation),
    within one iteration of the JAX package's count on the same system."""
    A, b, plan = _problem()
    common = dict(reltol=1e-9, restart=30, maxiter=60, m_eps=1e-6,
                  inner_dtype="complex64")
    Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(swlevel=0),
                                 dtype=jnp.complex64)
    xj, ij = hsolve.gmres_compiled(
        lambda d, v: hsolve.dia_matvec(d, v),
        lambda d, v: jfactor.solve_with_data(
            d, v.astype(jnp.complex64)).astype(v.dtype),
        jnp.asarray(b), mv_data=hsolve.to_dia(A, np.complex128),
        M_data=Fj.solve_data,
        mv_data_inner=hsolve.to_dia(A, np.complex64), **common)
    Ft = ht.factor_with_plan(plan, ht.SolverOptions(swlevel=0),
                             dtype=torch.complex64, device="cpu")
    xt, it = ht.gmres_compiled(
        ht.dia_matvec,
        lambda d, v: solve_with_data(d, v.to(torch.complex64)).to(v.dtype),
        torch.as_tensor(b), mv_data=ht.to_dia(A, device="cpu"),
        M_data=Ft.solve_data,
        mv_data_inner=ht.to_dia(A, dtype=np.complex64, device="cpu"), **common)
    assert ij["converged"] and it["converged"]
    assert abs(it["iters"] - ij["iters"]) <= 1
    for x in (np.asarray(xj), xt.numpy()):
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) <= 1e-9
