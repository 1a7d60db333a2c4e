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
from hsolve_torch.parallel.dist import default_backend, run_ranks

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
    """JAX's mesh factors (``make_mesh(4, front=2)``), leafmax 40: of
    poisson2d(33) its levels' L and R and its solve, of helmholtz2d(33,
    k=10) its ``gmres_compiled`` solve (DIA)."""
    import jax.numpy as jnp
    from hsolve.factor import solve_with_data

    mesh = jax_make_mesh(4, front=2)
    A, b, shape = hsolve.poisson2d(33)
    F = hsolve.factor(A, hsolve.nested_dissection(shape, leafmax=40), swlevel=0,
                      mesh=mesh)
    Ah, bh, sh = hsolve.helmholtz2d(33, k=10.0)
    Fh = hsolve.factor(Ah, hsolve.nested_dissection(sh, leafmax=40), swlevel=0,
                       mesh=mesh)
    xc, info = hsolve.gmres_compiled(
        lambda d, v: hsolve.dia_matvec(d, v), solve_with_data, jnp.asarray(bh),
        reltol=1e-9, restart=30, maxiter=30, mv_data=hsolve.to_dia(Ah),
        M_data=Fh.solve_data)
    return {"levels": [(np.asarray(lv.L), np.asarray(lv.R)) for lv in F.levels],
            "x": np.asarray(F.solve(b)), "xc": np.asarray(xc),
            "iters_c": int(info["iters"])}


@pytest.fixture(scope="module", params=[(2, 1), (4, 2)], ids=["2ranks", "2x2ranks"])
def exact(request, tmp_path_factory):
    world, front = request.param
    ckpt = tmp_path_factory.mktemp("ckpt")
    return world, _run(tmp_path_factory, jobs.exact_job, world, front,
                       str(ckpt / "mesh.pt")), ckpt


def test_exact_levels_match_jax_mesh_factor(exact, jax_exact):
    """The gathered levels are JAX's mesh factor's, within 1e-12."""
    _, res, _ = exact
    levels = res[0]["levels"]
    assert len(levels) == len(jax_exact["levels"])
    for i, (lev, (L, R)) in enumerate(zip(levels, jax_exact["levels"])):
        assert lev["kind"] == "dense"
        if L.size:
            assert _rel(lev["L"], L) < 1e-12, i
            assert _rel(lev["R"], R) < 1e-12, i


def test_exact_levels_match_single_process(exact):
    """The same padded plan factored in one process gives the same records
    bit for bit (each front is factored by the same calls) and the same x
    to rounding (the solve sums its boundary updates in another order)."""
    _, res, _ = exact
    for lev, one in zip(res[0]["levels"], res[0]["single"]):
        for f in ("L", "R"):
            assert np.array_equal(lev[f], one[f])
    assert _rel(res[0]["x"], res[0]["x_single"]) < 1e-14


def test_exact_solve_matches_spsolve_on_every_rank(exact):
    world, res, _ = exact
    assert len(res) == world
    assert set(res[0]["specs"]) == {"tree"}
    for r in res:
        assert np.array_equal(r["x"], res[0]["x"])     # replicated, bit for bit
    x_ref = res[0]["x_ref"]
    assert np.linalg.norm(res[0]["x"] - x_ref) / np.linalg.norm(x_ref) < 1e-10


def test_exact_gmres_with_the_mesh_factor(exact):
    _, res, _ = exact
    for r in res:
        assert r["info"]["converged"] and r["info"]["iters"] <= 2
        assert np.array_equal(r["xh"], res[0]["xh"])
    xr = res[0]["xh_ref"]
    assert np.linalg.norm(res[0]["xh"] - xr) / np.linalg.norm(xr) < 1e-9


def test_exact_gmres_with_the_bound_solve_of_the_mesh_factor(exact):
    """``krylov.gmres(..., M=F.solve)`` of a mesh factor is collective as
    with ``M_data``: rank 0's scalars and the replication check, the same
    iterations and x bit for bit."""
    _, res, _ = exact
    for r in res:
        assert r["info_b"]["iters"] == r["info"]["iters"]
        assert np.array_equal(r["xb"], r["xh"])
        assert r["hook_calls"]["consensus"] > 0
        assert r["hook_calls"]["check_replicated"] == 1


def test_exact_gmres_compiled_with_the_mesh_factor(exact, jax_exact):
    """``gmres_compiled`` (the host program on the CPU) takes the mesh
    factor's solve data: ``krylov.gmres``'s count on the same factor and
    JAX's ``gmres_compiled`` count on JAX's mesh factor, x within 1e-12 of
    JAX's and bit for bit on every rank."""
    _, res, _ = exact
    for r in res:
        assert r["info_c"]["converged"]
        assert r["info_c"]["iters"] == r["info"]["iters"] == jax_exact["iters_c"]
        assert np.array_equal(r["xc"], res[0]["xc"])
    assert _rel(res[0]["xc"], jax_exact["xc"]) < 1e-12


def test_exact_checkpoint_of_the_mesh_factor(exact, jax_exact):
    """``save_solver`` of a mesh factor: rank 0 writes the one file, the
    loaded one-device solve is the gathered factor's bit for bit and JAX's
    mesh factor's within 1e-12."""
    _, res, ckpt = exact
    assert [p.name for p in ckpt.iterdir()] == ["mesh.pt"]
    assert np.array_equal(res[0]["x_loaded"], res[0]["x_gathered"])
    assert _rel(res[0]["x_loaded"], jax_exact["x"]) < 1e-12
    assert all("x_loaded" not in r for r in res[1:])


def test_exact_bytes_equal_collective_estimate(exact):
    """Per level, the bytes the exchange sent equal the model's count on the
    tree axis (each front coordinate sends its own copy)."""
    world, res, _ = exact
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
        # a mesh factor's solve data; a CUDA graph of its solves over gloo
        # is refused, naming the backend
        g = r["graph"]
        assert g["mesh_data"] and g["backend"] == "gloo"
        assert g["refusal"] and "gloo" in g["refusal"], g


@pytest.mark.parametrize("cards, world, backend", [
    (0, 2, "gloo"), (1, 1, "nccl"), (1, 2, "gloo"), (4, 4, "nccl")])
def test_default_backend_takes_nccl_only_one_rank_a_card(
        monkeypatch, cards, world, backend):
    """NCCL where each rank has a card of its own; gloo where ranks share
    one (as a one-card machine's ranks do) and on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert default_backend("cuda", world) == backend
    assert default_backend("cpu", world) == "gloo"


def test_run_ranks_reports_a_failing_rank(tmp_path_factory):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        _run(tmp_path_factory, jobs.failing_job, 2)
