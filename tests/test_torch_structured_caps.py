"""The structured (HSS) slice where a batch's two children carry different
ranks, against the JAX package, float64, CPU.

The rank of a child's HSS generators is its source batch's cap, so the two
children of a structured batch differ where their batches' caps differ: under
the default caps (boundary / 4) of ``helmholtz2d(128)`` and, on the smaller
input here, under an explicit ``rank_cap``.  The port lays the children's
generator groups side by side (``r1 + r2`` columns); the JAX package puts
child 2's group at column ``r1`` in ``2 r1`` columns.  Both give one product
where ``r2 <= r1``, the only case the JAX package handles, so handed the JAX
sketches the port must give JAX's ranks, Gauss-transform products (1e-9
relative), preconditioner action (1e-9 relative) and GMRES count."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht
from hsolve_torch.factor import _factor_levels
from hsolve_torch.interop import plan_to_torch
from hsolve_torch.structured import StructuredLevel
from test_torch_structured import _jax_gmres, _lowrank, _port_gmres, _rel, jax_sketch

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")

# helmholtz2d(64), leafmax 100: batch 8's children have ranks 64 and 62
PROBLEM = ("helmholtz2d", 64, {"k": 40.0}, 100)
OPTS = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3, rank_cap=64)


def _child_ranks(plan, tp):
    """Per structured batch, the caps of its left and right source batches."""
    caps = [bp.rank_cap for bp in plan.batches]
    return {i: ({caps[g[0]] for g in tb.groups_l}, {caps[g[0]] for g in tb.groups_r})
            for i, (bp, tb) in enumerate(zip(plan.batches, tp.batches))
            if bp.structured}


@pytest.fixture(scope="module")
def unequal():
    name, n, pkw, leafmax = PROBLEM
    A, b, shape = getattr(hsolve, name)(n, **pkw)
    b = np.asarray(b)
    opts_j = hsolve.SolverOptions(**OPTS)
    plan = hsolve.plan_factorization(
        A, hsolve.nested_dissection(shape, leafmax=leafmax), opts_j)
    jlevels, jstacks = [], {}
    Fj = jfactor._factor_levels(plan, opts_j, jnp.float64, jlevels, jstacks, None)
    sketch = jax_sketch(ht.SolverOptions(**OPTS).seed)
    return dict(A=A, b=b, plan=plan, Fj=Fj, sketch=sketch,
                jinfo=_jax_gmres(A, b, Fj))


def test_the_input_has_children_of_unequal_rank(unequal):
    ranks = _child_ranks(unequal["plan"], plan_to_torch(unequal["plan"], "cpu"))
    pairs = [(max(l), max(r)) for l, r in ranks.values()]
    assert any(r1 > r2 for r1, r2 in pairs)
    assert all(len(l) == len(r) == 1 for l, r in ranks.values())


def test_unequal_child_ranks_match_jax(unequal):
    """Equal largest interpolation ranks per level, the Gauss transforms'
    products to 1e-9 relative, the preconditioner's action on the right-hand
    side and on a random block to 1e-9 relative, and JAX's GMRES count."""
    plan, Fj = unequal["plan"], unequal["Fj"]
    opts = ht.SolverOptions(**OPTS)
    tlevels, _, _ = _factor_levels(plan, plan_to_torch(plan, "cpu"), opts,
                                   torch.float64, unequal["sketch"])
    nstruct = 0
    for tl, jl, bp in zip(tlevels, Fj.levels, plan.batches):
        if not bp.structured:
            continue
        nstruct += 1
        assert isinstance(tl, StructuredLevel)
        assert np.array_equal(tl.rank_maxed.numpy(), np.asarray(jl.rank_maxed))
        assert _rel(_lowrank(tl.LU_, tl.LV_), _lowrank(jl.LU_, jl.LV_)) < 1e-9
        assert _rel(_lowrank(tl.RU_, tl.RV_), _lowrank(jl.RU_, jl.RV_)) < 1e-9
    assert nstruct >= 1
    F = ht.factor_with_plan(plan, opts, device="cpu", sketch=unequal["sketch"])
    rng = np.random.default_rng(3)
    for rhs in (unequal["b"], rng.standard_normal((plan.N, 2))):
        assert _rel(F.solve(rhs).numpy(), np.asarray(Fj.solve(rhs))) < 1e-9
    info, relres = _port_gmres(unequal["A"], unequal["b"], F)
    assert unequal["jinfo"]["converged"] and info["converged"] and relres <= 1e-9
    assert info["iters"] == unequal["jinfo"]["iters"]
    assert F.rank_report() == Fj.rank_report()


def test_default_caps_factor_at_n128_converges():
    """The default-caps input (helmholtz2d(128, k=40), leafmax 100,
    ``swlevel=-2, swsize=16, atol=rtol=1e-3``): children of ranks 48 and 32
    meet in two batches; the factor completes and GMRES converges, in 5
    iterations here (at most 10 asked)."""
    A, b, shape = ht.helmholtz2d(128, k=40.0)
    tree = ht.nested_dissection(shape, leafmax=100)
    F = ht.factor(A, tree, swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3,
                  device="cpu")
    pairs = _child_ranks(F.plan, plan_to_torch(F.plan, "cpu")).values()
    assert any(max(l) != max(r) for l, r in pairs)
    assert not F.rank_report()["saturated"]
    info, relres = _port_gmres(A, b, F)
    assert info["converged"] and relres <= 1e-9 and info["iters"] <= 10


def _dense(U, V):
    return U @ V.transpose(-1, -2)


def test_second_child_of_larger_rank_holds_the_dense_gauss_transforms(
        monkeypatch):
    """Where the second child's rank exceeds the first's (helmholtz2d(64,
    k=40), leafmax 40, ``rank_cap=384``: a batch of ranks 76 and 80), which
    the JAX package's layout gets wrong (ROADMAP §3), every structured
    batch's Gauss transforms hold the dense ones built from the batch's own
    operands: ``RU_ RV_^T`` against ``D^-1 Aib`` and ``LU_ LV_^T`` against
    ``Abi D^-1``, with D, Aib and Abi assembled from the children's HSS
    Schur complements and the cross couplings, to 1e-3 relative (the
    compression tolerance of S22', whose solver d_apply uses); GMRES
    converges."""
    from hsolve_torch.factor import solve_with_data
    from hsolve_torch.ops.hss import hss_todense
    from hsolve_torch.structured import structured_factor_batch

    fm = importlib.import_module("hsolve_torch.factor")  # ht.factor: the function
    seen = []

    def rec(sh1, sh2, cross, *args, **kw):
        lev, out = structured_factor_batch(sh1, sh2, cross, *args, **kw)
        seen.append((sh1, sh2, cross, lev))
        return lev, out

    monkeypatch.setattr(fm, "structured_factor_batch", rec)
    A, b, shape = ht.helmholtz2d(64, k=40.0)
    F = ht.factor(A, ht.nested_dissection(shape, leafmax=40), swlevel=-2,
                  swsize=16, atol=1e-3, rtol=1e-3, rank_cap=384, device="cpu")
    larger_second = 0
    for sh1, sh2, cr, lev in seen:
        r1, r2 = sh1.h.r, sh2.h.r
        S1, S2 = hss_todense(sh1.h), hss_todense(sh2.h)
        h1, h2 = sh1.cplan.half, sh2.cplan.half
        D = torch.cat([torch.cat([S1[:, :h1, :h1], _dense(*cr["ci12"])], 2),
                       torch.cat([_dense(*cr["ci21"]), S2[:, :h2, :h2]], 2)], 1)
        Aib = torch.cat([torch.cat([S1[:, :h1, h1:], _dense(*cr["cib12"])], 2),
                         torch.cat([_dense(*cr["cib21"]), S2[:, :h2, h2:]], 2)],
                        1)
        Abi = torch.cat([torch.cat([S1[:, h1:, :h1], _dense(*cr["cbi12"])], 2),
                         torch.cat([_dense(*cr["cbi21"]), S2[:, h2:, :h2]], 2)],
                        1)
        R = torch.linalg.solve(D, Aib)
        L = torch.linalg.solve(D.mT, Abi.mT).mT
        assert _rel(_dense(lev.RU_, lev.RV_), R) < 1e-3
        assert _rel(_dense(lev.LU_, lev.LV_), L) < 1e-3
        if r2 > r1:
            larger_second += 1
    assert larger_second >= 1
    op, mv = ht.spmv_format(A, device="cpu")
    x, info = ht.gmres_compiled(mv, solve_with_data, torch.as_tensor(b),
                                reltol=1e-9, restart=30, maxiter=60,
                                mv_data=op, M_data=F.solve_data)
    relres = np.linalg.norm(b - A @ x.numpy()) / np.linalg.norm(b)
    assert info["converged"] and relres <= 1e-9 and info["iters"] <= 10
