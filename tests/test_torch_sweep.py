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
packages solve the same float32 factors, in other summation orders), on
levels with padded (sentinel) ids; C's sentinel row N stays zero.  On the CPU
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
from hsolve_torch.ops.sweep import (backward_split, forward_cluster,
                                    level_forward, sweep_update)

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function

TOL = {"float64": 1e-12, "float32": 1e-5}


@functools.lru_cache(maxsize=None)
def _factors(explicit: bool, dtype: str):
    """helmholtz2d(48) factored by the JAX package in ``dtype`` (levels with
    padded ids), and the same records as the port's."""
    A, _, shape = hsolve.helmholtz2d(48, k=20.0)
    tree = hsolve.nested_dissection(shape, leafmax=40)
    plan = hsolve.plan_factorization(A, tree, hsolve.SolverOptions(swlevel=0))
    Fj = hsolve.factor_with_plan(plan, hsolve.SolverOptions(
        swlevel=0, explicit_inverse=explicit), dtype=getattr(jnp, dtype))
    Ft = factorization_from_numpy(Fj.levels, Fj.root, plan.perm, "cpu")
    return plan.N, Fj.levels, Ft.levels


def _rhs(N, k, dtype, seed):
    C0 = np.random.default_rng(seed).standard_normal((N, k)).astype(dtype)
    C = torch.zeros(N + 1, k, dtype=getattr(torch, dtype))
    C[:N] = torch.from_numpy(C0)
    return C0, C


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
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


@pytest.mark.parametrize("dtype", ["float64", "float32"])
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
    (the portable size); the backward step takes one CTA per 32 output
    rows."""
    assert forward_cluster(ni_pad) == cs
    assert backward_split(ni_pad) == split
    if cs == 8:
        with pytest.raises(ValueError, match="at most 2048"):
            forward_cluster(ni_pad + 1)


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
