"""The port's checkpoints (``hsolve_torch.utils.checkpoint``) on the CPU,
after tests/test_aux.py:12-33: a factorization saved and loaded solves bit
for bit as the live one, in every value type and on every level kind (exact,
low-rank, structured) and root (``RootSolve``, ``RootHss``); the file is a
``torch.load(weights_only=True)`` file; ``gmres_compiled`` on a loaded
solver repeats the live run; JAX's factors carried across and saved by the
port solve as the JAX package's own save/load round trip does."""

import importlib
import pickle
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht
from hsolve.utils.checkpoint import load_solver as jload_solver
from hsolve.utils.checkpoint import save_solver as jsave_solver
from hsolve_torch.factor import RootHss, RootSolve, solve_with_data
from hsolve_torch.interop import factorization_from_numpy
from hsolve_torch.structured import StructuredLevel
from hsolve_torch.utils.checkpoint import (FORMAT, LoadedSolver, load_solver,
                                           save_solver)
from test_torch_root_hss import KW as BROOT_KW
from test_torch_root_hss import boundary_root

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function

STRUCT = dict(swlevel=-2, swsize=1, atol=1e-4, rtol=1e-4, leafsize=16)
# name: (problem, n, problem kwargs, leafmax, factor kwargs, dtype)
CASES = {
    "exact-f64": ("poisson2d", 17, {}, 20, dict(swlevel=0), torch.float64),
    "exact-f32": ("poisson2d", 17, {}, 20, dict(swlevel=0), torch.float32),
    "compressed": ("poisson2d", 33, {}, 30, dict(swlevel=-3, swsize=8, atol=1e-8,
                                                 rtol=1e-8, leafsize=16), None),
    "lowrank-c128": ("helmholtz2d", 33, {"k": 10.0, "damping": 0.1}, 24,
                     dict(swlevel=-2, swsize=1, atol=1e-6, rtol=1e-6,
                          hss=False), None),
    "structured-c64": ("helmholtz2d", 33, {"k": 10.0, "damping": 0.1}, 24,
                       STRUCT, torch.complex64),
    "root-hss": ("helmholtz2d", 33, {"k": 10.0}, 24, BROOT_KW, None),
}
NARROW = {torch.float32: ("float32", np.float32),
          torch.complex64: ("complex64", np.complex64)}


def _problem(name):
    prob, n, pkw, leafmax, kw, dtype = CASES[name]
    A, b, shape = getattr(ht, prob)(n, **pkw)
    tree = ht.nested_dissection(shape, leafmax=leafmax)
    if name == "root-hss":
        tree = boundary_root(tree)
    return A, np.asarray(b), tree, kw, dtype


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    """The port's factorization of one case, saved and loaded on the CPU."""
    A, b, tree, kw, dtype = _problem(request.param)
    F = ht.factor(A, tree, dtype=dtype, device="cpu", **kw)
    path = str(tmp_path_factory.mktemp("ckpt") / f"{request.param}.pt")
    save_solver(path, F)
    return SimpleNamespace(name=request.param, A=A, b=b, F=F, path=path,
                           L=load_solver(path, device="cpu"))


def test_case_kinds(case):
    """The cases cover every level kind and root, and every value type."""
    kinds = {type(lv).__name__ for lv in case.F.levels}
    want = {"exact-f64": "DenseLevel", "exact-f32": "DenseLevel",
            "compressed": "StructuredLevel", "lowrank-c128": "CompressedLevel",
            "structured-c64": "StructuredLevel",
            "root-hss": "StructuredLevel"}[case.name]
    assert want in kinds
    root = {"root-hss": RootHss}.get(case.name, type(None))
    assert isinstance(case.F.root, root) and isinstance(case.L.solve_data[1], root)
    assert case.L.dtype == case.F.dtype == (CASES[case.name][5] or case.F.dtype)
    assert case.L.N == case.F.N
    assert [type(lv) for lv in case.L.solve_data[0]] == \
        [type(lv) for lv in case.F.levels]


def test_loaded_solve_is_bitwise_the_live_one(case):
    rhs2 = np.random.default_rng(3).standard_normal((case.A.shape[0], 2))
    if case.F.dtype.is_complex:
        rhs2 = rhs2 + 1j * np.random.default_rng(4).standard_normal(rhs2.shape)
    for rhs in (case.b, rhs2):
        assert torch.equal(case.L.solve(rhs), case.F.solve(rhs))
    assert torch.equal(case.L.ldiv(torch.as_tensor(case.b)),
                       case.F.solve(case.b))


def test_file_is_plain_containers(case):
    """``torch.load(weights_only=True)`` reads the file: dicts, lists,
    tensors, ints and strings, each cluster plan as its four ints, no cached
    ``_packed`` layout."""
    blob = torch.load(case.path, weights_only=True)
    assert blob["format"] == FORMAT and blob["version"] == 1
    assert blob["N"] == case.F.N
    assert blob["dtype"] == str(case.F.dtype).removeprefix("torch.")
    assert np.array_equal(blob["perm"].numpy(), case.F.perm)

    def walk(x):
        if isinstance(x, dict):
            assert "_packed" not in x
            if "depth" in x:
                assert set(x) == {"ls", "depth", "n1", "n2"}
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
        else:
            assert x is None or isinstance(x, (torch.Tensor, int, str))
    walk(blob)


def test_loaded_gmres_repeats_the_live_run(case):
    """gmres_compiled on the loaded solver's data: the live run's iterations
    and x, bit for bit (float32 and complex64 factors inside the mixed
    solve, escalation included)."""
    op, mv = ht.spmv_format(case.A, device="cpu")
    kw = dict(reltol=1e-9, restart=30, maxiter=60, mv_data=op)
    M = solve_with_data
    if case.F.dtype in NARROW:
        inner, npt = NARROW[case.F.dtype]
        dt = case.F.dtype
        kw.update(inner_dtype=inner, m_eps=1e-6,
                  mv_data_inner=ht.spmv_format(case.A, dtype=npt, device="cpu")[0])

        def M(d, v):
            return solve_with_data(d, v.to(dt)).to(v.dtype)
    b = torch.as_tensor(case.b)
    x, info = ht.gmres_compiled(mv, M, b, M_data=case.F.solve_data, **kw)
    xl, infol = ht.gmres_compiled(mv, M, b, M_data=case.L.solve_data, **kw)
    assert info["converged"] and infol["iters"] == info["iters"]
    assert torch.equal(xl, x)


@pytest.mark.parametrize("name,tol", [("exact-f64", 1e-12),
                                      ("compressed", 1e-10),
                                      ("lowrank-c128", 1e-10)])
def test_jax_factors_saved_by_the_port(name, tol, tmp_path):
    """JAX's factors carried across by factorization_from_numpy, saved and
    loaded by the port, solve within ``tol`` of the JAX package's own
    save_solver / load_solver round trip (its loaded data through its jitted
    solve).  The RootHss case is tests/test_torch_root_hss.py's."""
    prob, n, pkw, leafmax, kw, _ = CASES[name]
    A, b, shape = getattr(hsolve, prob)(n, **pkw)
    Fj = hsolve.factor(A, hsolve.nested_dissection(shape, leafmax=leafmax), **kw)
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jsave_solver(jpath, Fj)
    ref = np.asarray(jfactor._solve_jit(*jload_solver(jpath).solve_data,
                                        jnp.asarray(b)))
    save_solver(tpath, factorization_from_numpy(Fj.levels, Fj.root, Fj.perm,
                                                "cpu"))
    L = load_solver(tpath, device="cpu")
    assert isinstance(L, LoadedSolver)
    if name == "compressed":
        assert any(isinstance(lv, StructuredLevel) for lv in L.solve_data[0])
    x = L.solve(np.asarray(b)).numpy()
    assert np.abs(x - ref).max() <= tol * np.abs(ref).max()


def test_load_solver_defaults_to_the_card(tmp_path):
    """Without a device ``load_solver`` asks for the card and raises where
    there is none; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    A, b, tree, kw, _ = _problem("exact-f64")
    path = str(tmp_path / "f.pt")
    save_solver(path, ht.factor(A, tree, device="cpu", **kw))
    with pytest.raises(RuntimeError, match="cuda"):
        load_solver(path)
    assert isinstance(load_solver(path, device="cpu").solve_data[1],
                      (RootSolve, type(None)))


def test_a_jax_checkpoint_is_refused(tmp_path):
    """The JAX package's files pickle a JAX treedef: the port's
    ``weights_only`` load refuses them."""
    A, b, shape = hsolve.poisson2d(9)
    Fj = hsolve.factor(A, hsolve.nested_dissection(shape, leafmax=12), swlevel=0)
    path = str(tmp_path / "j.ckpt")
    jsave_solver(path, Fj)
    with pytest.raises(pickle.UnpicklingError, match="Weights only load failed"):
        load_solver(path, device="cpu")
