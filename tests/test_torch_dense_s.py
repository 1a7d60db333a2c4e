"""The ``HS_DEBUG_DENSE_S`` bisection hook (``hsolve/structured.py:294-301``,
``:415-421``): with the variable set both packages build the structured
levels' HSS compressions from the dense matrices instead of sampling
them."""

import numpy as np
import torch

import hsolve
import hsolve_torch as ht
from hsolve_torch.factor import StructuredLevel

import torch_parallel_jobs as jobs
from test_torch_parallel_compressed import jax_records

torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def test_dense_s_hook_matches_jax(monkeypatch):
    """With ``HS_DEBUG_DENSE_S`` set both packages give the same structured
    levels: ranks (none sampled: all 0), Gauss transforms to 1e-9, and the
    same solve (an unusual size, so no JAX program traced without the
    variable is reused)."""
    from test_torch_structured import jax_sketch

    monkeypatch.setenv("HS_DEBUG_DENSE_S", "1")
    A, b, shape = hsolve.poisson2d(29)
    kw = dict(swlevel=-2, swsize=1, atol=1e-4, rtol=1e-4, leafsize=8)
    plan = hsolve.plan_factorization(A, hsolve.nested_dissection(shape, leafmax=12),
                                     hsolve.SolverOptions(**kw))
    Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(**kw))
    opts = ht.SolverOptions(**kw)
    F = ht.factor_with_plan(plan, opts, device="cpu", sketch=jax_sketch(opts.seed))
    nstruct = 0
    for i, (t, j) in enumerate(zip(jobs.records(F.levels), jax_records(Fj.levels))):
        assert t["kind"] == j["kind"], i
        if t["kind"] != "structured":
            continue
        nstruct += 1
        assert isinstance(F.levels[i], StructuredLevel)
        assert np.array_equal(t["ranks"], j["ranks"]) and not t["ranks"].any()
        for f in ("L", "R"):
            assert _rel(t[f], j[f]) < 1e-9, (i, f)
    assert nstruct >= 1
    x, xj = F.solve(b).numpy(), np.asarray(Fj.solve(b))
    assert _rel(x, xj) < 1e-9
