"""The port's problem I/O against the JAX package: ``read_problem`` /
``write_problem`` (the reference's ``.mat`` format, scipy.io) both ways, and
the elimination-tree (de)serialization ``parse_elimtree`` /
``serialize_elimtree`` and ``contiguous``, exactly."""

import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht
from hsolve.models.matio import read_problem as jread, write_problem as jwrite

torch.set_num_threads(1)

PROBLEMS = [("poisson2d", 9, {}, 8), ("helmholtz3d", 7, {"k": 10.0}, 30)]


def _problem(name, n, kw, leafmax):
    A, b, shape = getattr(ht, name)(n, **kw)
    return A, np.asarray(b), ht.nested_dissection(shape, leafmax=leafmax)


def _assert_trees_equal(t1, t2):
    assert t1.root == t2.root and t1.nnodes == t2.nnodes
    assert np.array_equal(t1.left, t2.left)
    assert np.array_equal(t1.right, t2.right)
    for a, b in zip(t1.int_idx, t2.int_idx):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(t1.bnd_idx, t2.bnd_idx):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _assert_problems_equal(p1, p2):
    (A1, b1, t1), (A2, b2, t2) = p1, p2
    assert A1.shape == A2.shape and (A1 != A2).nnz == 0
    assert np.array_equal(b1, b2)
    _assert_trees_equal(t1, t2)


@pytest.mark.parametrize("name,n,kw,leafmax", PROBLEMS)
def test_jax_file_reads_back_through_the_port(tmp_path, name, n, kw, leafmax):
    A, b, tree = _problem(name, n, kw, leafmax)
    path = str(tmp_path / "p.mat")
    jwrite(path, A, b, tree)
    got = ht.read_problem(path)
    _assert_problems_equal(got, jread(path))
    _assert_problems_equal(got, (A, b, tree))


@pytest.mark.parametrize("name,n,kw,leafmax", PROBLEMS)
def test_port_file_reads_back_through_jax(tmp_path, name, n, kw, leafmax):
    A, b, tree = _problem(name, n, kw, leafmax)
    path = str(tmp_path / "p.mat")
    ht.write_problem(path, A, b, tree)
    got = jread(path)
    _assert_problems_equal(got, ht.read_problem(path))
    _assert_problems_equal(got, (A, b, tree))


@pytest.mark.parametrize("one_based", [True, False])
@pytest.mark.parametrize("name,n,kw,leafmax", PROBLEMS)
def test_elimtree_round_trip_agrees_with_jax(name, n, kw, leafmax, one_based):
    _, _, tree = _problem(name, n, kw, leafmax)
    ser = ht.serialize_elimtree(tree, one_based=one_based)
    jser = hsolve.serialize_elimtree(tree, one_based=one_based)
    assert len(ser) == len(jser) == 7
    for a, b in zip(ser, jser):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    back = ht.parse_elimtree(*ser, one_based=one_based)
    _assert_trees_equal(back, tree)
    _assert_trees_equal(back, hsolve.parse_elimtree(*jser,
                                                    one_based=one_based))


def test_parse_elimtree_rejects_what_jax_rejects():
    _, _, tree = _problem("poisson2d", 9, {}, 8)
    fathers, *rest = ht.serialize_elimtree(tree)
    two_roots = fathers.copy()
    two_roots[0] = -1
    for mod in (ht, hsolve):
        with pytest.raises(ValueError, match="root"):
            mod.parse_elimtree(two_roots, *rest)
        with pytest.raises(ValueError, match="inconsistent"):
            mod.parse_elimtree(fathers[:-1], *rest)


@pytest.mark.parametrize("idx", [np.arange(3, 9), np.array([2, 3, 5]),
                                 np.array([], dtype=np.int64), np.array([4])])
def test_contiguous_agrees_with_jax(idx):
    got, want = ht.contiguous(idx), hsolve.contiguous(idx)
    assert type(got) is type(want)
    assert list(got) == list(want)
