"""The port's host layer: import isolation and planner parity.

``hsolve_torch`` carries jax-free copies of the host modules (``hsolve/__init__``
imports JAX eagerly, and the machine with the card has no JAX).  These tests
hold the copies to the JAX package: same ``Plan``, array for array."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import hsolve_torch
for m in pkgutil.walk_packages(hsolve_torch.__path__, "hsolve_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "hsolve"))
print(len(list(pkgutil.walk_packages(hsolve_torch.__path__))), bad)
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_hsolve():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL.format(root=ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("[]")


def _cplan(c):
    """A ClusterPlan of either package as comparable fields (None passes)."""
    return None if c is None else (c.ls, c.depth, c.n1, c.n2)


def _assert_cross_equal(c1, c2):
    """The structured batches' cross strips: ``ni1..nb2`` arrays and eight
    ``{rows, pos, vals, rcap, r, c}`` couplings."""
    assert set(c1) == set(c2)
    for name, v1 in c1.items():
        v2 = c2[name]
        if isinstance(v1, dict):
            assert set(v1) == set(v2), name
            for f, a in v1.items():
                b = v2[f]
                if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                    a, b = np.asarray(a), np.asarray(b)
                    assert a.dtype == b.dtype and np.array_equal(a, b), (name, f)
                else:
                    assert a == b, (name, f, a, b)
        else:
            assert v1.dtype == v2.dtype and np.array_equal(v1, v2), name


def _assert_plans_equal(P1, P2):
    for f in ("N", "tree_depth", "nb_root"):
        assert getattr(P1, f) == getattr(P2, f), f
    assert np.array_equal(P1.perm, P2.perm)
    for a, b in zip(P1.A_raw, P2.A_raw):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(P1.batches) == len(P2.batches)
    for b1, b2 in zip(P1.batches, P2.batches):
        assert set(b1.__dataclass_fields__) == set(b2.__dataclass_fields__)
        for f in b1.__dataclass_fields__:
            v1, v2 = getattr(b1, f), getattr(b2, f)
            if isinstance(v1, np.ndarray) or isinstance(v2, np.ndarray):
                assert v1.dtype == v2.dtype and np.array_equal(v1, v2), f
            elif f in ("groups_l", "groups_r"):
                assert len(v1) == len(v2), f
                for g1, g2 in zip(v1, v2):
                    assert g1.src_batch == g2.src_batch
                    assert np.array_equal(g1.src_rows, g2.src_rows)
                    assert np.array_equal(g1.dst_rows, g2.dst_rows)
            elif f == "cplan":
                assert _cplan(v1) == _cplan(v2), (f, v1, v2)
            elif f == "child_cplans":
                assert (v1 is None) == (v2 is None), f
                assert v1 is None or list(map(_cplan, v1)) == list(map(_cplan, v2))
            elif f == "cross":
                assert (v1 is None) == (v2 is None), f
                if v1 is not None:
                    _assert_cross_equal(v1, v2)
            else:
                assert v1 == v2, (f, v1, v2)


@pytest.mark.parametrize("n", [2, 17, 64])
def test_2d_generators_match_jax_bit_for_bit(n):
    """The port's P1 assembly (vectorized, the entries in the reference
    loop's order) gives the JAX package's CSR arrays bit for bit: K and M,
    and the Poisson, Helmholtz and damped Helmholtz systems built on them."""
    from hsolve.models.problems import p1_fem_2d

    pairs = list(zip(ht.p1_fem_2d(n), p1_fem_2d(n)))
    for name, kw in (("poisson2d", {}), ("helmholtz2d", {"k": 9.0}),
                     ("helmholtz2d", {"k": 9.0, "damping": 0.1})):
        (A, b, shape), (A_j, b_j, shape_j) = (getattr(m, name)(n, **kw)
                                              for m in (ht, hsolve))
        assert shape == shape_j and np.array_equal(b, b_j)
        pairs.append((A, A_j))
    for got, ref in pairs:
        for f in ("data", "indices", "indptr"):
            a, r = getattr(got, f), getattr(ref, f)
            assert a.dtype == r.dtype and np.array_equal(a, r), f


@pytest.mark.parametrize("problem,n,leafmax", [("poisson2d", 17, 20),
                                               ("helmholtz2d", 33, 40),
                                               ("helmholtz2d", 48, 40)])
def test_plan_matches_jax_planner(problem, n, leafmax):
    A, _, shape = getattr(ht, problem)(n)
    A_j, _, shape_j = getattr(hsolve, problem)(n)
    assert (A != A_j).nnz == 0 and shape == shape_j
    P_t = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=leafmax),
                                ht.SolverOptions(swlevel=0))
    P_j = hsolve.plan_factorization(
        A_j, hsolve.nested_dissection(shape, leafmax=leafmax),
        hsolve.SolverOptions(swlevel=0))
    _assert_plans_equal(P_t, P_j)
    assert all(bp.front_src is not None for bp in P_t.batches)


@pytest.mark.parametrize("batch_multiple", [2, 4])
@pytest.mark.parametrize("n,leafmax,kw", [
    (33, 30, dict(swlevel=0)),
    (49, 24, dict(swlevel=-2, swsize=1, atol=1e-4, rtol=1e-4, leafsize=16))],
    ids=["exact", "structured"])
def test_padded_plan_matches_jax_planner(n, leafmax, kw, batch_multiple):
    """``batch_multiple`` rounds every level's batch up with decoupled
    identity dummy fronts, array for array as the JAX planner does."""
    A, _, shape = ht.poisson2d(n)
    P_t = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=leafmax),
                                ht.SolverOptions(**kw),
                                batch_multiple=batch_multiple)
    P_j = hsolve.plan_factorization(
        A, hsolve.nested_dissection(shape, leafmax=leafmax),
        hsolve.SolverOptions(**kw), batch_multiple=batch_multiple)
    _assert_plans_equal(P_t, P_j)
    assert all(bp.B % batch_multiple == 0 for bp in P_t.batches)
    assert any(len(bp.node_ids) < bp.B for bp in P_t.batches)   # dummies exist
    assert any(bp.structured for bp in P_t.batches) == (kw["swlevel"] < 0)


def test_compressed_planning_is_a_later_slice():
    """Compression with the default hss=True plans HSS Schur complements (the
    structured slice, now ported: the port plans and factors them as the JAX
    package does); hss=False plans the low-rank path with no cluster plans."""
    import scipy.sparse.linalg as spla

    A, b, shape = ht.poisson2d(33)
    tree = ht.nested_dissection(shape, leafmax=20)
    opts = ht.SolverOptions(swlevel=-3, swsize=8, atol=1e-8, rtol=1e-8,
                            leafsize=16)
    plan = ht.plan_factorization(A, tree, opts)
    _assert_plans_equal(plan, hsolve.plan_factorization(
        A, hsolve.nested_dissection(shape, leafmax=20),
        hsolve.SolverOptions(swlevel=-3, swsize=8, atol=1e-8, rtol=1e-8,
                             leafsize=16)))
    assert any(bp.compress and bp.cplan is not None for bp in plan.batches)
    F = ht.factor_with_plan(plan, opts, device="cpu")
    x_ref = spla.spsolve(A.tocsc(), b)
    x = F.solve(b).numpy()
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-5
    plan = ht.plan_factorization(A, tree, ht.SolverOptions(swlevel=-2, hss=False))
    assert any(bp.compress for bp in plan.batches)
    assert not any(bp.structured or bp.cplan is not None for bp in plan.batches)


def test_native_planner_builds_outside_the_jax_package():
    from hsolve_torch import native

    assert native.available()
    assert os.path.dirname(native._LIB) == os.path.join(ROOT, "build",
                                                        "hsolve_torch")
    # the port's own copy of the planner source (F5: not the JAX package's)
    assert native._SRC == os.path.join(ROOT, "hsolve_torch", "native",
                                       "gather.cpp")


def test_options_auto_explicit_inverse_is_off():
    assert ht.SolverOptions().resolve_explicit_inverse() is False
    assert ht.SolverOptions(explicit_inverse=True).resolve_explicit_inverse()
    assert not ht.SolverOptions(fast_inverse=True).resolve_fast_inverse()
    with pytest.raises(ValueError):
        ht.SolverOptions(atol=-1.0).validate()


def test_planning_without_the_native_library(monkeypatch):
    """With no C++ compiler both planners take their scipy paths; the plans
    still agree, and the port gathers the fronts from the host-built values
    (no ``front_src``) to the same solution."""
    import scipy.sparse.linalg as spla

    from hsolve import native as jnative
    from hsolve_torch import native as tnative

    monkeypatch.setattr(jnative, "_lib", False)
    monkeypatch.setattr(tnative, "_lib", False)
    A, b, shape = ht.helmholtz2d(17, k=8.0)
    P_t = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=20),
                                ht.SolverOptions(swlevel=0))
    P_j = hsolve.plan_factorization(A, hsolve.nested_dissection(shape, leafmax=20),
                                    hsolve.SolverOptions(swlevel=0))
    _assert_plans_equal(P_t, P_j)
    assert all(bp.front_src is None for bp in P_t.batches)
    F = ht.factor_with_plan(P_t, ht.SolverOptions(swlevel=0), device="cpu")
    x_ref = spla.spsolve(A.tocsc(), b)
    x = F.solve(b).numpy()
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-10
