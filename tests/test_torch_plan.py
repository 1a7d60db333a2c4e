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
            else:
                assert v1 == v2, (f, v1, v2)


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


def test_compressed_planning_is_a_later_slice():
    A, _, shape = ht.poisson2d(17)
    tree = ht.nested_dissection(shape, leafmax=20)
    with pytest.raises(NotImplementedError, match="low-rank slice"):
        ht.plan_factorization(A, tree, ht.SolverOptions(swlevel=-2))


def test_native_planner_builds_outside_the_jax_package():
    from hsolve_torch import native

    assert native.available()
    assert os.path.dirname(native._LIB) == os.path.join(ROOT, "build",
                                                        "hsolve_torch")
    assert native._SRC == os.path.join(ROOT, "hsolve", "native", "gather.cpp")


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
