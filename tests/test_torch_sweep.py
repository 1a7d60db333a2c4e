"""Kernel C's two steps of a dense level against the JAX package's
``_apply_impl`` run on that one level, on the JAX factors carried over with
``factorization_from_numpy``, and the launch geometry that kernels C and L
take from Python.

- the forward step (:func:`level_forward`: ``C[bnd] -= L x`` and ``C[int] =
  D^-1 x``, the pivot solve by ``(lu, perm)`` or by ``dinv``) against
  ``_apply_impl`` on the level with ``R = 0``;
- the backward step (:func:`sweep_update`: ``C[int] -= R C[bnd]``) against
  ``_apply_impl`` on the level with ``L = 0`` and ``dinv = I``, whose forward
  half then changes nothing;

at k = 1 and k = 3, in float64 (1e-12 relative) and float32 (1e-5: both
packages solve the same float32 factors, in other summation orders), and in
complex128 (1e-12) and complex64 (1e-5) on the damped system
helmholtz2d(48, k=20, damping=0.1), on levels with padded (sentinel) ids;
C's sentinel row N stays zero.  On the CPU
the wrappers run their plain versions, which these tests pin."""

import dataclasses
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsolve
from hsolve_torch.interop import factorization_from_numpy
from hsolve_torch.ops import arnoldi as AR
from hsolve_torch.ops import dense as dk
from hsolve_torch.ops.sweep import (WINDOW_ROWS, backward_split,
                                    forward_cluster, forward_window_smem,
                                    forward_windows,
                                    level_forward, sweep_update)

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function

TOL = {"float64": 1e-12, "float32": 1e-5, "complex128": 1e-12,
       "complex64": 1e-5}
TYPES = ["float64", "float32", "complex128", "complex64"]


@functools.lru_cache(maxsize=None)
def _factors(explicit: bool, dtype: str):
    """helmholtz2d(48) factored by the JAX package in ``dtype`` (levels with
    padded ids; the damped, complex system for a complex ``dtype``), and the
    same records as the port's."""
    damping = 0.1 if dtype.startswith("complex") else 0.0
    A, _, shape = hsolve.helmholtz2d(48, k=20.0, damping=damping)
    tree = hsolve.nested_dissection(shape, leafmax=40)
    plan = hsolve.plan_factorization(A, tree, hsolve.SolverOptions(swlevel=0))
    Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(
        swlevel=0, explicit_inverse=explicit), dtype=getattr(jnp, dtype))
    Ft = factorization_from_numpy(Fj.levels, Fj.root, plan.perm, "cpu")
    return plan.N, Fj.levels, Ft.levels


def _rhs(N, k, dtype, seed):
    rng = np.random.default_rng(seed)
    C0 = rng.standard_normal((N, k))
    if dtype.startswith("complex"):
        C0 = C0 + 1j * rng.standard_normal((N, k))
    C0 = C0.astype(dtype)
    C = torch.zeros(N + 1, k, dtype=getattr(torch, dtype))
    C[:N] = torch.from_numpy(C0)
    return C0, C


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("explicit", [False, True])
def test_forward_step_matches_jax_per_level(explicit, k, dtype):
    N, jlevels, tlevels = _factors(explicit, dtype)
    padded = 0
    for i, (jl, tl) in enumerate(zip(jlevels, tlevels)):
        assert (tl.dinv is not None) == explicit and (tl.lu is None) == explicit
        padded += int((tl.int_ids == N).any()) + int((tl.bnd_ids == N).any())
        C0, C = _rhs(N, k, dtype, seed=10 * i + k)
        jl_f = dataclasses.replace(jl, R=jnp.zeros_like(jl.R))
        ref = np.asarray(jfactor._apply_impl([jl_f], None, jnp.asarray(C0)))
        out = level_forward(C, tl, N)
        assert out is C
        assert float(C[N].abs().max()) == 0.0
        assert _rel(C[:N].numpy(), ref) < TOL[dtype], f"level {i}"
    assert padded > 0


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("k", [1, 3])
def test_backward_step_matches_jax_per_level(k, dtype):
    N, jlevels, tlevels = _factors(False, dtype)
    for i, (jl, tl) in enumerate(zip(jlevels, tlevels)):
        C0, C = _rhs(N, k, dtype, seed=100 + 10 * i + k)
        ni = jl.R.shape[1]
        eye = jnp.broadcast_to(jnp.eye(ni, dtype=jl.R.dtype), jl.lu.shape)
        jl_b = dataclasses.replace(jl, L=jnp.zeros_like(jl.L), lu=None,
                                   perm=None, dinv=eye)
        ref = np.asarray(jfactor._apply_impl([jl_b], None, jnp.asarray(C0)))
        sweep_update(C, tl.int_ids, tl.R, N, ids_in=tl.bnd_ids)
        assert float(C[N].abs().max()) == 0.0
        assert _rel(C[:N].numpy(), ref) < TOL[dtype], f"level {i}"


# the n=512 exact plan's level widths (helmholtz2d(512), leafmax=100)
@pytest.mark.parametrize("ni_pad,cs,split", [
    (104, 1, 4), (32, 1, 1), (64, 1, 2), (128, 1, 4), (256, 1, 8),
    (384, 2, 12), (512, 2, 16), (1024, 4, 32), (2048, 8, 64)])
def test_kernel_c_cluster_and_split_per_level(ni_pad, cs, split):
    """The forward step gives each 32-row panel a warp, 8 per CTA: one CTA
    per front up to 256 rows, a cluster of 2 at 512 and 4 at 1024, at most 8
    (the portable size), one window; the backward step takes one CTA per 32
    output rows."""
    assert forward_cluster(ni_pad) == cs
    assert backward_split(ni_pad) == split
    assert forward_windows(ni_pad) == [(0, ni_pad, cs)]
    if cs == 8:      # one row more takes a second window
        assert forward_windows(ni_pad + 1) == [(0, 2048, 8), (2048, 2049, 1)]


@pytest.mark.parametrize("ni_pad,windows", [
    (2049, [(0, 2048, 8), (2048, 2049, 1)]),
    (4096, [(0, 2048, 8), (2048, 4096, 8)]),
    (4424, [(0, 2048, 8), (2048, 4096, 8), (4096, 4424, 2)])])
def test_kernel_c_forward_windows_above_2048_rows(ni_pad, windows):
    """A front wider than one cluster's 2048 rows (helmholtz3d(48) exact has
    a 4424-row top front) runs in windows of at most 2048 rows, each on its
    own cluster, that cover the front in order."""
    assert forward_windows(ni_pad) == windows
    assert all(r1 - r0 <= WINDOW_ROWS for r0, r1, _ in windows)


@pytest.mark.parametrize("ni_pad", [2049, 4424, 20608, 49664, 100000])
def test_kernel_c_window_shared_memory_does_not_grow(ni_pad):
    """A window's substitution keeps only its own rows' solved values in
    shared memory, so fronts far wider than 20,600 rows (float64) or 49,600
    (float32), whose LU still fits on the card, take the same shared memory
    as a front of 2049 rows, within a CTA's 227 KB."""
    wins = forward_windows(ni_pad)
    assert len(wins) == -(-ni_pad // WINDOW_ROWS)
    assert wins[-1][1] == ni_pad
    for itemsize in (4, 8):
        assert forward_window_smem(itemsize) <= 227 * 1024
        assert forward_window_smem(itemsize) == \
            min(ni_pad, WINDOW_ROWS) * 8 + 8 * 32 * 33 * itemsize


@pytest.mark.parametrize("ni", [2049, 4424])
def test_windowed_substitution_is_the_lu_solve(ni):
    """The windowed order of kernel C's forward step, written out in torch on
    the CPU (per window: its substitution, then the update of the rows
    after it by its solved values; then back again for the upper
    triangle), gives ``lu_solve`` to 1e-12 relative on a diagonally
    dominant front."""
    g = torch.Generator().manual_seed(ni)
    D = torch.randn(ni, ni, generator=g, dtype=torch.float64) / ni ** 0.5 \
        + 4.0 * torch.eye(ni, dtype=torch.float64)
    lu, perm = dk.lu_factor(D[None])
    lu, perm = lu[0], perm[0]
    x = torch.randn(ni, generator=g, dtype=torch.float64)
    z = x[perm].clone()
    Lo = torch.tril(lu, -1) + torch.eye(ni, dtype=torch.float64)
    Up = torch.triu(lu)
    wins = forward_windows(ni)
    for r0, r1, _ in wins:
        z[r0:r1] = torch.linalg.solve_triangular(Lo[r0:r1, r0:r1], z[r0:r1, None],
                                                 upper=False)[:, 0]
        z[r1:] -= Lo[r1:, r0:r1] @ z[r0:r1]
    for r0, r1, _ in reversed(wins):
        z[r0:r1] = torch.linalg.solve_triangular(Up[r0:r1, r0:r1], z[r0:r1, None],
                                                 upper=True)[:, 0]
        z[:r0] -= Up[:r0, r0:r1] @ z[r0:r1]
    ref = dk.lu_solve(lu[None], perm[None], x[None, :, None])[0, :, 0]
    assert _rel(z.numpy(), ref.numpy()) < 1e-12


@pytest.mark.parametrize("N,nb", [(5003, 5), (16129, 16), (261121, 132),
                                  (10 ** 6, 132)])
def test_kernel_l_grid_slices_and_part(N, nb):
    """Kernel L's grid is at most one CTA per SM; its slices are multiples of
    4 that cover N, leave no CTA empty and fit its shared memory; the
    state's ``part`` holds (2 m + 1) partial sums per CTA."""
    assert AR.cgs2_blocks(N) == nb
    S = AR.cgs2_slice(N, nb)
    assert S % 4 == 0 and nb * S >= N and (nb - 1) * S < N
    assert S <= AR.cgs2_max_slice(torch.float64) < AR.cgs2_max_slice(
        torch.float32)
    s = AR.arnoldi_state(30, N, torch.float32, "cpu")
    assert s.part.numel() == 61 * nb and int(s.ticket[0]) == 0
