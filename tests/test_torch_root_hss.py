"""The port's HSS root solve (``RootHss``) against the JAX package, on one
shared plan, float64, CPU.

A tree whose root keeps a boundary (``plan.nb_root > 0``) under a compressed
top batch hands the root an HSS Schur complement; both packages then factor
it with ``hss_factor`` and solve it with ``hss_solve`` (``hsolve/factor.py:
907-943``).  The reference's elimination-tree files give such trees;
here nested dissection's tree with the root's separator moved into its
``bnd`` does.  The case: helmholtz2d(33, k=10), leafmax 24, ``swlevel=-2,
swsize=1, atol=rtol=1e-6, leafsize=16`` (JAX: ``nb_root`` 64, a structured
top batch, 2 GMRES iterations).  Handed the JAX sketches, the port must give
JAX's root ids, its root HSS to 1e-9, its GMRES count and history; on JAX's
factors its solve must give JAX's to 1e-10.  The JAX factorization is shared
through one module-scoped fixture (its compile takes most of the file's
time)."""

import importlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht
from hsolve.ops.hss import hss_todense as jhss_todense
from hsolve.utils.checkpoint import load_solver as jload_solver
from hsolve.utils.checkpoint import save_solver as jsave_solver
from hsolve_torch.factor import RootHss
from hsolve_torch.interop import factorization_from_numpy
from hsolve_torch.ops.hss import hss_todense
from hsolve_torch.utils.checkpoint import load_solver, save_solver
from test_torch_structured import _jax_gmres, _port_gmres, _rel, jax_sketch

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function

KW = dict(swlevel=-2, swsize=1, atol=1e-6, rtol=1e-6, leafsize=16)


def boundary_root(tree, keep_int=False):
    """``tree`` with its root separator moved into the root's ``bnd``
    (``keep_int``: the first half stays interior)."""
    r = tree.root
    sep = np.asarray(tree.int_idx[r])
    cut = len(sep) // 2 if keep_int else 0
    tree.bnd_idx[r] = np.sort(sep[cut:])
    tree.int_idx[r] = np.sort(sep[:cut])
    return tree


def _both(A, tree, kw):
    """The JAX plan, JAX's factorization on it and the port's with the JAX
    sketches."""
    plan = hsolve.plan_factorization(A, tree, hsolve.SolverOptions(**kw))
    Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(**kw))
    opts_t = ht.SolverOptions(**kw)
    sketch = jax_sketch(opts_t.seed)
    Ft = ht.factor_with_plan(plan, opts_t, device="cpu", sketch=sketch)
    return plan, Fj, Ft, sketch


@pytest.fixture(scope="module")
def case():
    A, b, shape = hsolve.helmholtz2d(33, k=10.0)
    tree = boundary_root(hsolve.nested_dissection(shape, leafmax=24))
    plan, Fj, Ft, sketch = _both(A, tree, KW)
    return SimpleNamespace(A=A, b=np.asarray(b), shape=shape, tree=tree,
                           plan=plan, Fj=Fj, Ft=Ft, sketch=sketch,
                           jinfo=_jax_gmres(A, np.asarray(b), Fj))


def test_root_is_root_hss_with_jax_ids(case):
    """A structured top batch: the port's root is a RootHss whose ids
    (child-aligned boundary, sentinel N) are JAX's."""
    assert case.plan.nb_root == 64 and case.plan.batches[-1].structured
    assert isinstance(case.Fj.root, jfactor.RootHss)
    root = case.Ft.root
    assert isinstance(root, RootHss) and root.ids_pad.dtype == torch.int32
    assert np.array_equal(root.ids_pad.numpy(), np.asarray(case.Fj.root.ids_pad))
    assert root.solver.h.B == 1
    assert int((root.ids_pad < case.plan.N).sum()) == case.plan.nb_root


def test_root_hss_densified_matches_jax(case):
    """The root's HSS Schur complement, densified, within 1e-9 of JAX's."""
    dj = np.asarray(jhss_todense(case.Fj.root.solver.h))
    dt = hss_todense(case.Ft.root.solver.h).numpy()
    assert dt.shape == (1,) + dj.shape
    assert _rel(dt[0], dj) < 1e-9


def test_port_solve_on_jax_root_hss_factors(case):
    """factorization_from_numpy carries JAX's levels and its unbatched root
    solver over (a batch axis of 1 added); the port's solve gives JAX's to
    1e-10."""
    Ft = factorization_from_numpy(case.Fj.levels, case.Fj.root, case.plan.perm,
                                  "cpu")
    assert isinstance(Ft.root, RootHss) and Ft.root.solver.D_lu.shape[0] == 1
    rng = np.random.default_rng(7)
    for rhs in (case.b, rng.standard_normal((case.A.shape[0], 2))):
        ref = np.asarray(case.Fj.solve(rhs))
        assert _rel(Ft.solve(rhs).numpy(), ref) < 1e-10


def test_root_hss_gmres_matches_jax(case):
    """With the JAX sketches: JAX's iteration count (2), its residual history
    within 1e-8, and its rank report; rank_report and maxrank read the levels
    only, as JAX's do, and run with a RootHss root; cond_report skips it."""
    assert case.jinfo["converged"] and case.jinfo["iters"] == 2
    info, relres = _port_gmres(case.A, case.b, case.Ft)
    assert info["converged"] and relres <= 1e-9
    assert info["iters"] == case.jinfo["iters"]
    assert _rel(info["resnorm"], case.jinfo["resnorm"]) < 1e-8
    assert case.Ft.rank_report() == case.Fj.rank_report()
    assert case.Ft.maxrank() == case.Fj.maxrank()
    assert [lv["level"] for lv in case.Ft.cond_report()["levels"]] == \
        [lv["level"] for lv in case.Fj.cond_report()["levels"]]


def test_root_hss_of_a_compressed_top_batch():
    """The other branch: a top batch that is compressed, not structured
    (its children dense: ``swlevel=1`` on a root that keeps half its
    separator interior), emits HSS through its transition for the root
    alone; the root's ids are its boundary's first ``nb_root`` entries."""
    A, b, shape = hsolve.helmholtz2d(33, k=10.0)
    tree = boundary_root(hsolve.nested_dissection(shape, leafmax=24),
                         keep_int=True)
    kw = dict(swlevel=1, swsize=1, atol=1e-6, rtol=1e-6, leafsize=16)
    plan, Fj, Ft, _ = _both(A, tree, kw)
    last = plan.batches[-1]
    assert last.compress and not last.structured and last.cplan is not None
    assert isinstance(Fj.root, jfactor.RootHss) and isinstance(Ft.root, RootHss)
    assert np.array_equal(Ft.root.ids_pad.numpy(), np.asarray(Fj.root.ids_pad))
    assert np.array_equal(Ft.root.ids_pad[:plan.nb_root].numpy(),
                          np.asarray(last.bnd_ids[0][:plan.nb_root]))
    ref = np.asarray(Fj.solve(b))
    assert _rel(Ft.solve(b).numpy(), ref) < 1e-9
    Fx = factorization_from_numpy(Fj.levels, Fj.root, plan.perm, "cpu")
    assert _rel(Fx.solve(b).numpy(), ref) < 1e-10


@pytest.mark.parametrize("route", ["elimtree", "mat"])
def test_tree_read_back_gives_the_same_solve(case, route, tmp_path):
    """The boundary-root tree serialized in the reference's format and read
    back (``serialize_elimtree`` -> ``parse_elimtree``, or a ``.mat`` file
    through ``write_problem`` -> ``read_problem``) plans and solves bit for
    bit as the tree itself."""
    A, b = case.A, case.b
    if route == "elimtree":
        tree = ht.parse_elimtree(*ht.serialize_elimtree(case.tree), one_based=True)
    else:
        path = str(tmp_path / "broot.mat")
        ht.write_problem(path, A, b, case.tree)
        A, b, tree = ht.read_problem(path)
        assert np.array_equal(b, case.b)
    opts = ht.SolverOptions(**KW)
    plan = ht.plan_factorization(A, tree, opts)
    assert plan.nb_root == case.plan.nb_root
    F = ht.factor_with_plan(plan, opts, device="cpu", sketch=case.sketch)
    assert isinstance(F.root, RootHss)
    assert torch.equal(F.solve(b), case.Ft.solve(case.b))


def test_checkpoint_of_jax_root_hss_factors(case, tmp_path):
    """JAX's RootHss factors carried across, saved and loaded by the port,
    solve within 1e-10 of the JAX package's own save/load round trip (its
    loaded data solved by its jitted solve, whose program the live solve
    compiled: the loaded solver's eager solve takes 20 s here)."""
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jsave_solver(jpath, case.Fj)
    ref = np.asarray(jfactor._solve_jit(*jload_solver(jpath).solve_data,
                                        jnp.asarray(case.b)))
    save_solver(tpath, factorization_from_numpy(case.Fj.levels, case.Fj.root,
                                                case.plan.perm, "cpu"))
    L = load_solver(tpath, device="cpu")
    assert isinstance(L.solve_data[1], RootHss)
    assert _rel(L.solve(case.b).numpy(), ref) < 1e-10
