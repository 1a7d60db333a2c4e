"""The damped, complex Helmholtz system on structured (HSS) levels (``hss``
at its default, True) in the port against the JAX package, on the CPU, in
complex128, on ``tests/test_complex.py``'s compressed fixture
(``test_complex_compressed_gmres``): helmholtz2d(48, k=25, damping=0.1),
leafmax 60, ``swlevel=-2, swsize=1, atol=rtol=1e-4``.

Given the JAX package's sketches (real normal draws, which both packages
cast to complex128):

- every structured level's largest interpolation ranks exactly, and its
  low-rank Gauss transforms ``LU_ LV_^T`` and ``RU_ RV_^T`` to 1e-9
  relative; the transition batch's HSS Schur complements to 1e-9;
- GMRES: JAX's iteration count and rank report, relres < 1e-9 by scipy;
- the port's own sketches: converged within two iterations of JAX's count;
- a JAX complex structured factorization carried over with
  ``factorization_from_numpy`` solves as JAX's.

Only the column-pivoted QR conjugates (``R = Q^H A``, the ID of ``A^H``);
every other product of these levels, ``d_apply``'s ``D^{-T}`` and the
samplers' adjoints included, takes plain transposes in both packages, so a
conjugate there shows up in the products compared here.  The JAX
factorization is shared through a module-scoped fixture (its structured
factor compiles slowly on the CPU)."""

import importlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht
from hsolve.structured import densify_schur as jdensify_schur
from hsolve_torch.factor import _factor_levels, solve_with_data
from hsolve_torch.interop import factorization_from_numpy, plan_to_torch
from hsolve_torch.structured import SchurHss, StructuredLevel, densify_schur
from test_torch_structured import _lowrank, _rel, jax_sketch

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function

# tests/test_complex.py:39's compressed configuration, hss at its default
KW = dict(swlevel=-2, swsize=1, atol=1e-4, rtol=1e-4)


def _cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _port_gmres(A, b, F):
    op, mv = ht.spmv_format(A, device="cpu")
    x, info = ht.gmres_compiled(mv, solve_with_data, torch.as_tensor(b),
                                reltol=1e-9, restart=30, maxiter=60, mv_data=op,
                                M_data=F.solve_data)
    assert x.dtype == torch.complex128
    return info, np.linalg.norm(b - A @ x.numpy()) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def case():
    """The JAX factorization (per-batch path, its levels and Schur stacks)
    and its GMRES run, and the port's levels and stacks given the JAX
    sketches, on one plan."""
    A, b, shape = hsolve.helmholtz2d(48, k=25.0, damping=0.1)
    b = np.asarray(b)
    assert np.iscomplexobj(A.data)
    tree = hsolve.nested_dissection(shape, leafmax=60)
    plan = hsolve.plan_factorization(A, tree, hsolve.SolverOptions(**KW))
    jlevels, jstacks = [], {}
    Fj = jfactor._factor_levels(plan, hsolve.SolverOptions(**KW),
                                jnp.complex128, jlevels, jstacks, None)
    _, jinfo = hsolve.gmres_compiled(
        lambda d, v: hsolve.dia_matvec(d, v), jfactor.solve_with_data,
        jnp.asarray(b), reltol=1e-9, restart=30, maxiter=60,
        mv_data=hsolve.to_dia(A), M_data=Fj.solve_data)
    assert jinfo["converged"]
    opts = ht.SolverOptions(**KW)
    sketch = jax_sketch(opts.seed)
    tlevels, troot, tstacks = _factor_levels(plan, plan_to_torch(plan, "cpu"),
                                             opts, torch.complex128, sketch)
    return SimpleNamespace(A=A, b=b, shape=shape, plan=plan, Fj=Fj,
                           jstacks=jstacks, jiters=int(jinfo["iters"]),
                           tlevels=tlevels, troot=troot, tstacks=tstacks,
                           sketch=sketch)


def test_complex_structured_levels_match_jax(case):
    """Per structured level: JAX's largest interpolation ranks and rank cap,
    ``LU_ LV_^T`` and ``RU_ RV_^T`` to 1e-9, complex128; the transition
    batch's HSS Schur complements, densified and masked to their content,
    to 1e-9."""
    nstruct = ntrans = 0
    assert len(case.tlevels) == len(case.Fj.levels)
    for i, (tl, jl) in enumerate(zip(case.tlevels, case.Fj.levels)):
        bp = case.plan.batches[i]
        assert isinstance(tl, StructuredLevel) == bp.structured, i
        if bp.structured:
            nstruct += 1
            assert tl.LU_.dtype == tl.RU_.dtype == torch.complex128
            assert tl.solver1.h.D.dtype == torch.complex128
            assert tl.rank_cap == jl.rank_cap == bp.rank_cap
            assert np.array_equal(tl.rank_maxed.numpy(),
                                  np.asarray(jl.rank_maxed)), i
            assert int(tl.rank_maxed.min()) > 0
            assert _rel(_lowrank(tl.LU_, tl.LV_), _lowrank(jl.LU_, jl.LV_)) \
                < 1e-9, (i, "L")
            assert _rel(_lowrank(tl.RU_, tl.RV_), _lowrank(jl.RU_, jl.RV_)) \
                < 1e-9, (i, "R")
        if isinstance(case.tstacks[i], SchurHss):
            ntrans += not bp.structured
            ts, js = case.tstacks[i], case.jstacks[i]
            assert ts.h.D.dtype == torch.complex128
            assert np.array_equal(ts.n1.numpy(), np.asarray(js.n1))
            assert np.array_equal(ts.n2.numpy(), np.asarray(js.n2))
            w = bp.cplan.n_pad
            live = (np.arange(w)[None, :] < (ts.n1 + ts.n2).numpy()[:, None])
            live = live[:, :, None] & live[:, None, :]
            dj = np.asarray(jdensify_schur(js, w)) * live
            assert _rel(densify_schur(ts, w).numpy() * live, dj) < 1e-9, i
    assert nstruct >= 2 and ntrans >= 1


def test_complex_structured_gmres_matches_jax(case):
    """With the JAX sketches: JAX's GMRES iteration count, rank report and
    largest rank, relres < 1e-9 by scipy."""
    F = ht.factor_with_plan(case.plan, ht.SolverOptions(**KW), device="cpu",
                            sketch=case.sketch)
    assert F.dtype == torch.complex128
    info, relres = _port_gmres(case.A, case.b, F)
    assert info["converged"] and relres < 1e-9
    assert info["iters"] == case.jiters > 1
    assert F.rank_report() == case.Fj.rank_report()
    assert F.maxrank() == case.Fj.maxrank() > 0


def test_complex_structured_own_sketches_converge(case):
    """``ht.factor`` with hss at its default and the port's own sketches
    (the float64 draws cast): complex128 structured levels, no cap
    saturated, converged within two iterations of JAX's count."""
    F = ht.factor(case.A, ht.nested_dissection(case.shape, leafmax=60),
                  device="cpu", **KW)
    assert F.dtype == torch.complex128
    assert any(isinstance(lv, StructuredLevel) for lv in F.levels)
    assert not F.rank_report()["saturated"]
    info, relres = _port_gmres(case.A, case.b, F)
    assert info["converged"] and relres < 1e-9
    assert info["iters"] <= case.jiters + 2


def test_factorization_from_numpy_complex_structured(case):
    """A JAX complex structured factorization carried over record by record
    (HSS, HSS solvers and structured levels in complex128) solves as JAX's
    to 1e-10, one and two right-hand sides."""
    Fc = factorization_from_numpy(case.Fj.levels, case.Fj.root,
                                  case.plan.perm, "cpu")
    lv = [lv for lv in Fc.levels if isinstance(lv, StructuredLevel)]
    assert len(lv) >= 2 and lv[0].solver22.cores_lu[0].dtype == torch.complex128
    assert Fc.dtype == torch.complex128
    rng = np.random.default_rng(9)
    for rhs in (case.b, _cplx(rng, case.A.shape[0], 2)):
        assert _rel(Fc.solve(rhs).numpy(), np.asarray(case.Fj.solve(rhs))) \
            < 1e-10
