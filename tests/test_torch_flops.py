"""The port's FLOP model (``hsolve_torch/utils/profiling.py``) against the
JAX package's (``hsolve/utils/profiling.py``): level by level the same
``flops``, ``bytes_moved``, ``solve_flops`` and ``lapack_flops`` (1e-12
relative) on 2D and 3D plans, exact, low-rank and structured; and the
roofline's physics guard against the H100's peaks."""

import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht
from hsolve.utils import profiling as jprof
from hsolve_torch.utils import profiling as tprof

torch.set_num_threads(1)

COMP = dict(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3)
PLANS = [
    (("helmholtz2d", 64, {"k": 40.0}), 40, dict(swlevel=0)),
    (("helmholtz2d", 64, {"k": 40.0}), 40, dict(COMP, kest=32, hss=False)),
    (("helmholtz2d", 64, {"k": 40.0}), 40, dict(COMP, kest=32)),
    (("helmholtz2d", 128, {"k": 40.0}), 100, COMP),
    (("poisson3d", 12, {}), 40, dict(swlevel=0)),
    (("helmholtz3d", 14, {"k": 8.0}), 60,
     dict(swlevel=-3, swsize=8, atol=1e-4, rtol=1e-4, hss=False)),
    (("helmholtz3d", 14, {"k": 8.0}), 60,
     dict(swlevel=-3, swsize=8, atol=1e-4, rtol=1e-4)),
]
FIELDS = ("flops", "bytes_moved", "solve_flops", "lapack_flops")


def _plans(problem, leafmax, opts):
    name, n, kw = problem
    A, _, shape = getattr(ht, name)(n, **kw)
    pt = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=leafmax),
                               ht.SolverOptions(**opts))
    pj = hsolve.plan_factorization(
        A, hsolve.nested_dissection(shape, leafmax=leafmax),
        hsolve.SolverOptions(**opts))
    return pt, pj


@pytest.mark.parametrize("dtype_bytes", [4, 8])
@pytest.mark.parametrize("problem,leafmax,opts", PLANS)
def test_analyze_plan_matches_jax(problem, leafmax, opts, dtype_bytes):
    pt, pj = _plans(problem, leafmax, opts)
    st = tprof.analyze_plan(pt, dtype_bytes)
    sj = jprof.analyze_plan(pj, dtype_bytes)
    assert len(st) == len(sj) == len(pt.batches)
    kinds = set()
    for a, b in zip(st, sj):
        assert (a.kind, a.B, a.ni_pad, a.nb_pad) == (b.kind, b.B, b.ni_pad,
                                                      b.nb_pad)
        kinds.add(a.kind)
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert abs(x - y) <= 1e-12 * max(abs(y), 1.0), (a.kind, f, x, y)
    if opts["swlevel"] < 0:
        assert ("structured" if opts.get("hss", True) else "compressed") in kinds
    assert tprof.factor_flops(pt, dtype_bytes) == pytest.approx(
        jprof.factor_flops(pj, dtype_bytes), rel=1e-12)
    assert tprof.solve_flops(pt, dtype_bytes) == pytest.approx(
        jprof.solve_flops(pj, dtype_bytes), rel=1e-12)


@pytest.mark.parametrize("dtype_bytes,peak", [(8, 67e12), (4, 67e12)])
def test_roofline_flags_a_time_under_the_speed_of_light(dtype_bytes, peak):
    pt, _ = _plans(*PLANS[4])
    stats = tprof.analyze_plan(pt, dtype_bytes)
    sol = sum(max(s.flops / peak, s.bytes_moved / 3.35e12) for s in stats)
    rep = tprof.roofline_report(pt, 10 * sol, dtype_bytes=dtype_bytes)
    assert not rep["sol_violation"]
    # the report rounds seconds to 6 decimals and the fraction to 4
    assert rep["speed_of_light_s"] == pytest.approx(sol, abs=5e-7)
    assert rep["sol_fraction"] == pytest.approx(0.1, abs=5e-5)
    assert len(rep["per_level"]) == len(pt.batches)
    assert tprof.roofline_report(pt, 0.5 * sol,
                                 dtype_bytes=dtype_bytes)["sol_violation"]
    # faster than the card's peak rate, whatever the bound's sum says
    total = sum(s.flops for s in stats)
    assert tprof.roofline_report(pt, 0.9 * total / peak,
                                 dtype_bytes=dtype_bytes)["sol_violation"]
    assert np.isfinite(rep["nnz_per_s"]) and rep["nnz_per_s"] > 0
