"""The invariant kernel H's early exit rests on (``csrc/hss_cpqr.cu``): once
a step of the pivot loop fails ``ok``, every later step writes ``-1`` and
changes nothing returned, so a loop stopped at ``min(rank + 1, k)`` steps
and padded with ``-1`` gives the pivots and rank of all ``k`` steps.

Held for the JAX package's ``cpqr`` (``hsolve/ops/lowrank.py:176``, a
fixed-length ``fori_loop``) and the port's ``cpqr_pivots_plain`` (the
kernel's plain version), in float64, complex128, float32 and complex64, on
matrices of known rank made from a numpy seed: rank 0 (a zero matrix: the
loop stops at step 0), ranks below ``k`` and rank equal to ``k`` (no exit).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hsolve.ops import lowrank as JL
from hsolve_torch.ops import lowrank as TL

M, N = 14, 10
RANKS = (0, 3, 6, 10)      # 10 = min(M, N) = k: the loop never exits
TOL = 1e-4                 # atol = rtol, far above float32's rounding


def _matrices(dtype):
    rng = np.random.default_rng(18)
    out = []
    for r in RANKS:
        U = rng.standard_normal((M, r))
        V = rng.standard_normal((r, N))
        if np.dtype(dtype).kind == "c":
            U = U + 1j * rng.standard_normal((M, r))
            V = V + 1j * rng.standard_normal((r, N))
        s = np.linspace(1.0, 0.2, r)
        out.append((U * s) @ V)
    return np.stack(out).astype(dtype)


def _jax(A, cap):
    f = JL.cpqr(jnp.asarray(A), TOL, TOL, cap)
    return np.asarray(f.piv), np.asarray(f.rank)


def _torch(A, cap):
    piv, rank = TL.cpqr_pivots_plain(torch.as_tensor(A), TOL, TOL,
                                     min(cap, *A.shape[-2:]))
    return piv.numpy(), rank.numpy()


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("dtype", ["float64", "complex128", "float32",
                                   "complex64"])
def test_cpqr_stops_at_the_rank(dtype, package):
    run = _jax if package == "jax" else _torch
    A = _matrices(dtype)
    k = min(M, N)
    piv, rank = run(A, k)
    assert piv.shape == (len(RANKS), k)
    np.testing.assert_array_equal(rank, RANKS)
    for b, r in enumerate(RANKS):
        # every pivot after the first -1 is -1, and rank counts the others
        first = int(np.argmax(piv[b] < 0)) if (piv[b] < 0).any() else k
        assert (piv[b, first:] == -1).all()
        assert (piv[b, :first] >= 0).all() and first == rank[b]
        # the loop cut at rank + 1 steps, padded with -1, is the full loop
        cut = min(r + 1, k)
        pc, rc = run(A[b:b + 1], cut)
        assert pc.shape == (1, cut) and int(rc[0]) == r
        np.testing.assert_array_equal(
            np.concatenate([pc[0], -np.ones(k - cut, dtype=pc.dtype)]),
            piv[b])
