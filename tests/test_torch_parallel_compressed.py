"""The port's compressed and structured levels on gloo ranks (the port of
``tests/test_parallel.py::test_sharded_compressed_factor``).

poisson2d(49), ``swlevel=-2, swsize=1, atol=rtol=1e-4, leafsize=16``,
leafmax 24, on 2 ranks, handed the JAX package's sketches (recorded in the
test process and sent to the ranks): the gathered records are the
single-process port's of the same padded plan bit for bit, and on the real
fronts their ranks are JAX's mesh factor's.  Their Gauss transforms (as
products U V^T) agree with JAX's to the compression tolerance, 1e-4: at this
size the two packages' interpolative decompositions pick other skeletons of
equal rank at the structured levels (one device shows the same, 2.6e-5
relative at worst), so the 1e-9 of ``tests/test_torch_structured.py``'s
case does not hold here.  The dummy fronts are not compared: JAX draws
their sketches from its split of the batch key, the port repeats front 0's
draws."""

import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht
from hsolve.parallel.dist import make_mesh as jax_make_mesh
from hsolve_torch.parallel.dist import run_ranks

import torch_parallel_jobs as jobs

torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def jax_records(levels):
    out = []
    for lv in levels:
        if getattr(lv, "LU_", None) is None:
            out.append({"kind": "dense", "L": np.asarray(lv.L),
                        "R": np.asarray(lv.R)})
            continue
        LU, LV, RU, RV = (np.asarray(getattr(lv, f))
                          for f in ("LU_", "LV_", "RU_", "RV_"))
        rec = {"L": LU @ np.swapaxes(LV, -1, -2), "R": RU @ np.swapaxes(RV, -1, -2)}
        if getattr(lv, "WU", None) is not None:
            rec.update(kind="structured", ranks=np.asarray(lv.rank_maxed))
        else:
            rec.update(kind="compressed", ranks=np.stack(
                [np.asarray(lv.lrank), np.asarray(lv.rrank)]))
        out.append(rec)
    return out


class JaxPadded:
    """JAX's draws for a padded plan: JAX splits a structured batch's key over
    all ``B`` fronts, dummies included; the port asks for its real fronts'."""

    def __init__(self, plan, draw):
        self.plan, self.draw = plan, draw

    def __call__(self, key, shape_a, shape_b):
        if isinstance(key, int):
            return self.draw(key, shape_a, shape_b)
        B = self.plan.batches[key[0] - 7000].B
        full = self.draw(key, (B,) + tuple(shape_a[1:]),
                         (B,) + tuple(shape_b[1:]))
        return tuple(o[: shape_a[0]] for o in full)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    import jax.numpy as jnp
    from hsolve.factor import solve_with_data
    from test_torch_structured import jax_sketch

    A, b, shape = hsolve.poisson2d(49)
    Fj = hsolve.factor(A, hsolve.nested_dissection(shape, leafmax=24),
                       mesh=jax_make_mesh(2), **jobs.COMPRESSED)
    _, jinfo = hsolve.gmres_compiled(
        lambda d, v: hsolve.dia_matvec(d, v), solve_with_data, jnp.asarray(b),
        reltol=1e-9, restart=30, maxiter=30, mv_data=hsolve.to_dia(A),
        M_data=Fj.solve_data)
    opts = ht.SolverOptions(**jobs.COMPRESSED)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=24),
                                 opts, batch_multiple=2)
    rec = jobs.RecordingSketch(JaxPadded(plan, jax_sketch(opts.seed)))
    F1 = ht.factor_with_plan(plan, opts, device="cpu", sketch=rec)
    res = run_ranks(jobs.compressed_job, 2, rec.table, device="cpu",
                    timeout=120, store_dir=str(tmp_path_factory.mktemp("s")))
    real = [len(bp.node_ids) for bp in plan.batches]
    return (F1, jax_records(Fj.levels), jobs.records(F1.levels), res, real,
            int(jinfo["iters"]))


def test_compressed_mesh_ranks_and_products_match_jax(case):
    F1, jrec, single, res, real, _ = case
    got = res[0]["levels"]
    assert [r["kind"] for r in got] == [r["kind"] for r in jrec]
    assert {"compressed", "structured"} <= {r["kind"] for r in got}
    for i, (t, j, one, B0) in enumerate(zip(got, jrec, single, real)):
        if "ranks" in j:
            assert np.array_equal(t["ranks"], one["ranks"]), i
            assert np.array_equal(t["ranks"][..., :B0], j["ranks"][..., :B0]), i
        for f in ("L", "R"):
            assert np.array_equal(t[f], one[f]), (i, f)
            if j[f].size:
                tol = 1e-12 if t["kind"] == "dense" else 1e-4
                assert _rel(t[f][:B0], j[f][:B0]) < tol, (i, f)
    for r in res:
        assert r["rank_report"] == F1.rank_report()
        assert r["maxrank"] == F1.maxrank() > 0
    assert set(res[0]["specs"]) == {"tree"}


def test_compressed_mesh_gmres(case):
    res = case[3]
    for r in res:
        assert r["info"]["converged"]
        assert np.array_equal(r["x"], res[0]["x"])
    x, xr = res[0]["x"], res[0]["x_ref"]
    assert np.linalg.norm(x - xr) / np.linalg.norm(xr) < 1e-8


def test_compressed_mesh_gmres_compiled(case):
    """``gmres_compiled`` on the compressed mesh factor's solve data (the
    host program): ``krylov.gmres``'s count on the same factor and JAX's
    ``gmres_compiled`` count on JAX's mesh factor, x bit for bit on every
    rank."""
    res, jax_iters = case[3], case[5]
    for r in res:
        assert r["info_c"]["converged"]
        assert r["info_c"]["iters"] == r["info"]["iters"] == jax_iters
        assert np.array_equal(r["xc"], res[0]["xc"])
    x, xr = res[0]["xc"], res[0]["x_ref"]
    assert np.linalg.norm(x - xr) / np.linalg.norm(xr) < 1e-8


def test_padded_plan_draws_the_unpadded_plans_sketches():
    """F10: at the default draw (``torch_sketch``), a plan padded for a
    2-rank tree (``batch_multiple=2``) gives its real fronts the unpadded
    plan's structured records bit for bit: every array of every structured
    level, real rows only, both plans factored on one CPU device.
    poisson2d(37), leafmax 16, structured at kest=32: five structured
    batches padded (7 -> 8, 1 -> 2, 3 -> 4, 1 -> 2, 1 -> 2 fronts)."""
    from hsolve_torch.factor import StructuredLevel
    from hsolve_torch.utils.checkpoint import _record

    def leaves(rec, path=""):
        if isinstance(rec, dict):
            for k, v in rec.items():
                yield from leaves(v, f"{path}.{k}")
        elif isinstance(rec, list):
            for i, v in enumerate(rec):
                yield from leaves(v, f"{path}[{i}]")
        elif isinstance(rec, torch.Tensor):
            yield path, rec

    A, b, shape = ht.poisson2d(37)
    opts = ht.SolverOptions(swlevel=-2, swsize=16, atol=1e-3, rtol=1e-3,
                            kest=32)
    plans = [ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=16),
                                   opts, batch_multiple=m) for m in (1, 2)]
    padded = [i for i, (b1, b2) in enumerate(zip(*(p.batches for p in plans)))
              if b2.structured and b2.B > b1.B]
    assert len(padded) == 5
    one, two = (ht.factor_with_plan(p, opts, device="cpu").levels
                for p in plans)
    compared = 0
    for i in padded:
        assert isinstance(one[i], StructuredLevel)
        B0, B = plans[0].batches[i].B, plans[1].batches[i].B
        for (path, a), (path2, c) in zip(leaves(_record(one[i])),
                                         leaves(_record(two[i])), strict=True):
            assert path == path2 and c.shape == (B,) + a.shape[1:], path
            assert a.shape[0] == B0
            assert torch.equal(a, c[:B0]), (i, path)
            compared += 1
    assert compared >= 5 * 40
