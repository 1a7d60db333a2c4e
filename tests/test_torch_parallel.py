"""The port's multi-device path on gloo ranks (the port of
``tests/test_parallel.py``'s exact cases and ``tests/test_distributed.py``).

The ranks are child processes (:func:`hsolve_torch.parallel.dist.run_ranks`:
gloo, a file store under ``tmp_path``, one host thread each, 120 s each
run); their functions live in ``tests/torch_parallel_jobs.py``.  The test
process runs the JAX side on the conftest's 8 virtual CPU devices:
``factor(A, tree, swlevel=0, mesh=make_mesh(4, front=2))`` plans with
``batch_multiple=2``, the plan a 2-rank and a 2 x 2 port mesh factor too.
"""

import numpy as np
import pytest
import torch

import hsolve
from hsolve.parallel.dist import make_mesh as jax_make_mesh
from hsolve_torch.parallel.dist import run_ranks

import torch_parallel_jobs as jobs

torch.set_num_threads(1)
TIMEOUT = 120


def _run(tmp_path_factory, fn, world, *args):
    return run_ranks(fn, world, *args, device="cpu", timeout=TIMEOUT,
                     store_dir=str(tmp_path_factory.mktemp("store")))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.fixture(scope="module")
def jax_exact():
    """JAX's mesh factor of poisson2d(33), leafmax 40: its levels' L and R."""
    A, b, shape = hsolve.poisson2d(33)
    F = hsolve.factor(A, hsolve.nested_dissection(shape, leafmax=40), swlevel=0,
                      mesh=jax_make_mesh(4, front=2))
    return [(np.asarray(lv.L), np.asarray(lv.R)) for lv in F.levels]


@pytest.fixture(scope="module", params=[(2, 1), (4, 2)], ids=["2ranks", "2x2ranks"])
def exact(request, tmp_path_factory):
    world, front = request.param
    return world, _run(tmp_path_factory, jobs.exact_job, world, front)


def test_exact_levels_match_jax_mesh_factor(exact, jax_exact):
    """The gathered levels are JAX's mesh factor's, within 1e-12."""
    _, res = exact
    levels = res[0]["levels"]
    assert len(levels) == len(jax_exact)
    for i, (lev, (L, R)) in enumerate(zip(levels, jax_exact)):
        assert lev["kind"] == "dense"
        if L.size:
            assert _rel(lev["L"], L) < 1e-12, i
            assert _rel(lev["R"], R) < 1e-12, i


def test_exact_levels_match_single_process(exact):
    """The same padded plan factored in one process gives the same records
    bit for bit (each front is factored by the same calls) and the same x
    to rounding (the solve sums its boundary updates in another order)."""
    _, res = exact
    for lev, one in zip(res[0]["levels"], res[0]["single"]):
        for f in ("L", "R"):
            assert np.array_equal(lev[f], one[f])
    assert _rel(res[0]["x"], res[0]["x_single"]) < 1e-14


def test_exact_solve_matches_spsolve_on_every_rank(exact):
    world, res = exact
    assert len(res) == world
    assert set(res[0]["specs"]) == {"tree"}
    for r in res:
        assert np.array_equal(r["x"], res[0]["x"])     # replicated, bit for bit
    x_ref = res[0]["x_ref"]
    assert np.linalg.norm(res[0]["x"] - x_ref) / np.linalg.norm(x_ref) < 1e-10


def test_exact_gmres_with_the_mesh_factor(exact):
    _, res = exact
    for r in res:
        assert r["info"]["converged"] and r["info"]["iters"] <= 2
        assert np.array_equal(r["xh"], res[0]["xh"])
    xr = res[0]["xh_ref"]
    assert np.linalg.norm(res[0]["xh"] - xr) / np.linalg.norm(xr) < 1e-9


def test_exact_bytes_equal_collective_estimate(exact):
    """Per level, the bytes the exchange sent equal the model's count on the
    tree axis (each front coordinate sends its own copy)."""
    world, res = exact
    front = world // 2
    got = [b // front for b in res[0]["bytes"]]
    assert got == [int(e) for e in res[0]["estimate"]]
    assert sum(got) > 0
    assert all(b >= 0 for b in res[0]["solve_bytes"])


@pytest.mark.parametrize("tree,front", [(2, 2), (1, 2)])
def test_front_axis_splits_the_undivided_levels(tree, front, tmp_path_factory):
    """On the unpadded plan the levels the tree axis cannot divide are held
    whole and their Schur rows split over the front group; the records and
    x are the single-process factor's."""
    res = _run(tmp_path_factory, jobs.front_job, tree * front, tree, front)
    assert "front" in res[0]["specs"]
    assert (tree > 1) == ("tree" in res[0]["specs"])
    for lev, one in zip(res[0]["levels"], res[0]["single"]):
        for f in ("L", "R"):
            assert np.array_equal(lev[f], one[f])
    for r in res:
        assert np.array_equal(r["x"], res[0]["x"])
    assert _rel(res[0]["x"], res[0]["x_single"]) < 1e-14
    assert sum(res[0]["bytes"]) > 0


def test_lowrank_mesh_factor_is_the_single_process_one(tmp_path_factory):
    """The low-rank path (``hss=False``) on 2 ranks: records bit for bit the
    single-process factor's of the same padded plan, GMRES to spsolve."""
    res = _run(tmp_path_factory, jobs.lowrank_job, 2)
    kinds = {lev["kind"] for lev in res[0]["levels"]}
    assert "compressed" in kinds and "structured" not in kinds
    for lev, one in zip(res[0]["levels"], res[0]["single"]):
        for f in ("L", "R") + (("ranks",) if "ranks" in one else ()):
            assert np.array_equal(lev[f], one[f])
    assert _rel(res[0]["x"], res[0]["x_single"]) < 1e-14
    for r in res:
        assert r["info"]["converged"] and np.array_equal(r["xg"], res[0]["xg"])
    xr = res[0]["x_ref"]
    assert np.linalg.norm(res[0]["xg"] - xr) / np.linalg.norm(xr) < 1e-8


def test_two_rank_allreduce_and_sharded_lu(tmp_path_factory):
    res = _run(tmp_path_factory, jobs.smoke_job, 2)
    for r in res:
        assert r["held"] == 1 and r["ranks"] == 2.0
        assert abs(r["sum"] - r["ref"]) / abs(r["ref"]) < 1e-12
        # the graph solve and checkpoints refuse a mesh factor
        assert all(m and "mesh" in m for m in r["refused"]), r["refused"]


def test_run_ranks_reports_a_failing_rank(tmp_path_factory):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        _run(tmp_path_factory, jobs.failing_job, 2)
