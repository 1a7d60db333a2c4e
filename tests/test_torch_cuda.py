"""The port's CUDA kernels on the card, at edge cases the main path does not
reach (several right-hand sides, sentinel ids, narrow child stacks), and the
slice end to end on ``cuda``.

Marked ``cuda``: each test skips without an NVIDIA GPU.  The machine with the
card has no JAX, which ``tests/conftest.py`` imports, so run these there with

    python -m pytest --noconftest -p no:cacheprovider \
        -W ignore::pytest.PytestUnknownMarkWarning tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import hsolve_torch as ht
from hsolve_torch import kernels
from hsolve_torch.ops.assembly import (extend_add, extend_add_plain,
                                       front_assemble, front_assemble_plain)
from hsolve_torch.ops.sparse import dia_spmv, dia_spmv_plain
from hsolve_torch.ops.sweep import sweep_update, sweep_update_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def test_front_assemble_kernel(dev):
    rng = np.random.default_rng(0)
    B, m = 3, 20
    pos = rng.permutation(B * m * m)[:500].astype(np.int32)
    src = rng.integers(-1, 300, size=500).astype(np.int32)
    adata = torch.as_tensor(rng.standard_normal(300), device=dev)
    args = (B, m, torch.as_tensor(pos, device=dev),
            torch.as_tensor(src, device=dev), adata)
    before = front_assemble.launches
    assert torch.equal(front_assemble(*args), front_assemble_plain(*args))
    assert front_assemble.launches == before + 1


def test_extend_add_kernel_narrow_and_wide_sources(dev):
    rng = np.random.default_rng(1)
    B, m, s_pad = 6, 24, 16
    front = torch.as_tensor(rng.standard_normal((B, m, m)), device=dev)
    imap = torch.as_tensor(rng.integers(-1, s_pad, size=(B, m)).astype(np.int32),
                           device=dev)
    for w, src_rows, dst_rows in ((10, [2, 0, 1], [5, 1, 3]), (20, [0], [2])):
        S = torch.as_tensor(rng.standard_normal((3, w, w)), device=dev)
        sr = torch.tensor(src_rows, dtype=torch.int32, device=dev)
        dr = torch.tensor(dst_rows, dtype=torch.int32, device=dev)
        got = extend_add(front.clone(), S, sr, dr, imap)
        want = extend_add_plain(front.clone(), S, sr, dr, imap)
        assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 3])
def test_sweep_update_kernel_with_sentinels(dev, k):
    rng = np.random.default_rng(2 + k)
    N, B, R, Cc = 500, 7, 9, 13
    C = torch.as_tensor(rng.standard_normal((N + 1, k)), device=dev)
    C[N] = 0.0
    perm = rng.permutation(N)
    ids_out = perm[: B * R].reshape(B, R).astype(np.int32)
    ids_in = perm[B * R: B * R + B * Cc].reshape(B, Cc).astype(np.int32)
    ids_out[:, -2:] = N                  # padded rows: skipped
    ids_in[:, -3:] = N                   # padded columns: read as zero
    ids_out = torch.as_tensor(ids_out, device=dev)
    ids_in = torch.as_tensor(ids_in, device=dev)
    M = torch.as_tensor(rng.standard_normal((B, R, Cc)), device=dev)
    X = torch.as_tensor(rng.standard_normal((B, Cc, k)), device=dev)
    for kw in ({"X": X}, {"ids_in": ids_in}):
        got = sweep_update(C.clone(), ids_out, M, N, **kw)
        want = sweep_update_plain(C.clone(), ids_out, M, N, **kw)
        assert _rel(got, want) < 1e-13
        assert float(got[N].abs().max()) == 0.0


@pytest.mark.parametrize("k", [1, 3])
def test_dia_spmv_kernel(dev, k):
    A, _, _ = ht.helmholtz2d(33, k=10.0)
    op = ht.to_dia(A, device=dev)
    rng = np.random.default_rng(k)
    x = torch.as_tensor(rng.standard_normal((A.shape[0], k)), device=dev)
    b = torch.as_tensor(rng.standard_normal((A.shape[0], k)), device=dev)
    assert _rel(dia_spmv(op, x), dia_spmv_plain(op, x)) < 1e-13
    assert _rel(dia_spmv(op, x, b), dia_spmv_plain(op, x, b)) < 1e-13
    np.testing.assert_allclose(dia_spmv(op, x).cpu().numpy(),
                               A @ x.cpu().numpy(), rtol=1e-12, atol=1e-12)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    A, _, _ = ht.helmholtz2d(17, k=8.0)
    op = ht.to_dia(A, device=dev)
    with pytest.raises(TypeError, match="float64"):
        dia_spmv(op, torch.zeros(A.shape[0], 1, dtype=torch.float32, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv(op, torch.zeros(2, A.shape[0], dtype=torch.float64,
                                 device=dev).T[:, :1].expand(-1, 2))
    with pytest.raises(ValueError, match="several devices"):
        dia_spmv(op, torch.zeros(A.shape[0], 1, dtype=torch.float64))


@pytest.mark.parametrize("explicit", [False, True])
def test_slice_on_cuda(dev, explicit):
    A, b, shape = ht.helmholtz2d(48, k=20.0)
    tree = ht.nested_dissection(shape, leafmax=40)
    kernels.reset_launch_counts()
    F = ht.factor(A, tree, swlevel=0, device=dev, explicit_inverse=explicit)
    x_ref = spla.spsolve(A.tocsc(), b)
    x = F.solve(b).cpu().numpy()
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-10
    X = F.solve(np.column_stack([b, 2 * b])).cpu().numpy()
    assert np.abs(X[:, 1] - 2 * X[:, 0]).max() < 1e-10 * np.abs(X).max()
    from hsolve_torch.factor import solve_with_data

    op, mv = ht.spmv_format(A, device=dev)
    xg, info = ht.gmres_compiled(mv, solve_with_data,
                                 torch.as_tensor(b, device=dev), reltol=1e-9,
                                 restart=30, maxiter=60, mv_data=op,
                                 M_data=F.solve_data)
    assert info["converged"] and info["iters"] == 1
    xg = xg.cpu().numpy()
    assert np.linalg.norm(A @ xg - b) / np.linalg.norm(b) < 1e-9
    counts = kernels.launch_counts()
    assert all(v > 0 for v in counts.values()), counts
