"""The mixed-precision configuration's float32 preconditioner on the CPU: the
port's solve sweep on the JAX package's own float32 factors, at n=128 and
n=512.

helmholtz2d(512, k=40) is nearly singular at the top level, so one
application of the float32 exact factor leaves a large residual (JAX: about
0.07, the same factors applied in float64: about 0.04) and the residual
amplifies rounding differences of a few units in the last place.  A float32
summation of the sweep's products (torch's CPU float32 ``bmm`` against one
column is 1.8-2.6x less accurate than XLA's) left 0.44 there and cost the
mixed GMRES 120 unconverged iterations against JAX's 80 (fault F4).  The
port's float32 sweep now accumulates every product in float64 and rounds
once: its residual is at most 1.1x JAX's, and the mixed solve on JAX's
factors converges in at most 81 iterations.  Single-threaded: torch's
threaded CPU LU is not used."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht
from hsolve_torch.factor import DenseLevel, solve_with_data
from hsolve_torch.interop import factorization_from_numpy
from hsolve_torch.ops import dense as dk
from hsolve_torch.ops.sweep import level_forward_plain, sweep_update_plain

torch.set_num_threads(1)


def _upcast(lev):
    """The level record with its float32 tensors in float64."""
    kw = {}
    for f in dataclasses.fields(lev):
        v = getattr(lev, f.name)
        is32 = isinstance(v, torch.Tensor) and v.dtype == torch.float32
        kw[f.name] = v.double() if is32 else v
    return type(lev)(**kw)


_CACHE = {}


def _jax_factors(n):
    """helmholtz2d(n, k=40), leafmax 100, exact: the JAX package's float32
    factor, its solve of b, and the same factors as a port factorization
    (float32, and upcast to float64); made once per n for the module."""
    if n not in _CACHE:
        A, b, shape = hsolve.helmholtz2d(n, k=40.0)
        b = np.asarray(b)
        opts = hsolve.SolverOptions(swlevel=0)
        plan = hsolve.plan_factorization(
            A, hsolve.nested_dissection(shape, leafmax=100), opts)
        Fj = hsolve.factor_with_plan(plan, opts, dtype=jnp.float32)
        xj = np.asarray(Fj.solve(jnp.asarray(b, jnp.float32))).astype(np.float64)
        Ft = factorization_from_numpy(Fj.levels, Fj.root, plan.perm, "cpu")
        assert Ft.root is None
        F64 = dataclasses.replace(Ft, levels=[_upcast(lv) for lv in Ft.levels])
        _CACHE[n] = (A, b, xj, Ft, F64)
    return _CACHE[n]


@pytest.fixture(scope="module")
def factors():
    return _jax_factors


def _relres(A, x, b):
    return np.linalg.norm(b - A @ x) / np.linalg.norm(b)


def test_float32_sweep_on_jax_factors_is_as_accurate_as_jax_at_n512(factors):
    A, b, xj, Ft, F64 = factors(512)
    xt = Ft.solve(torch.as_tensor(b.astype(np.float32))).double().numpy()
    x64 = F64.solve(torch.as_tensor(b)).numpy()
    err_port = np.linalg.norm(xt - x64) / np.linalg.norm(x64)
    err_jax = np.linalg.norm(xj - x64) / np.linalg.norm(x64)
    assert err_port < 5e-5 and err_jax < 5e-5
    assert err_port < 2.0 * err_jax


@pytest.mark.parametrize("n", [128, 512])
def test_one_application_residual_is_within_jax_s(factors, n):
    """One application of JAX's float32 factors to b: the port's float32
    sweep leaves at most 1.1x the residual of JAX's own float32 sweep
    (n=128: 7.2e-5 against 8.7e-5; n=512: 0.045 against 0.070)."""
    A, b, xj, Ft, _ = factors(n)
    xt = Ft.solve(torch.as_tensor(b.astype(np.float32))).double().numpy()
    assert _relres(A, xt, b) <= 1.1 * _relres(A, xj, b)


def test_mixed_gmres_at_n512_on_jax_factors_converges_like_jax(factors):
    """The JAX bench's mixed configuration (float32 inner cycles, m_eps 1e-6,
    escalation) preconditioned by JAX's float32 factors through the port's
    sweep: converged in at most 81 iterations (JAX on the CPU: 80)."""
    A, b, _, Ft, _ = factors(512)
    op64, mv = ht.spmv_format(A, device="cpu")
    op32, _ = ht.spmv_format(A, dtype=np.float32, device="cpu")

    def M(d, v):
        return solve_with_data(d, v.to(torch.float32)).to(v.dtype)

    x, info = ht.gmres_compiled(mv, M, torch.as_tensor(b), reltol=1e-9,
                                restart=30, maxiter=60, mv_data=op64,
                                M_data=Ft.solve_data, inner_dtype="float32",
                                mv_data_inner=op32, m_eps=1e-6)
    assert info["converged"] and info["iters"] <= 81
    assert _relres(A, x.numpy(), b) <= 1e-9


def _level(rng, B, ni, nb, N, dinv):
    """A random float32 dense level record with distinct ids below N and a
    sentinel id in each front."""
    ids = rng.permutation(N)[:B * (ni + nb)].reshape(B, ni + nb)
    ids[:, -1] = N
    f32 = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
    D = torch.as_tensor(rng.standard_normal((B, ni, ni)) + 4 * np.eye(ni),
                        dtype=torch.float32)
    lu, perm = dk.lu_factor(D)
    ii = torch.as_tensor(ids[:, :ni], dtype=torch.int32)
    bi = torch.as_tensor(ids[:, ni:], dtype=torch.int32)
    if dinv:
        return DenseLevel(lu=None, perm=None, dinv=f32(B, ni, ni), L=f32(B, nb, ni),
                          R=f32(B, ni, nb), int_ids=ii, bnd_ids=bi)
    return DenseLevel(lu=lu, perm=perm, L=f32(B, nb, ni), R=f32(B, ni, nb),
                      int_ids=ii, bnd_ids=bi)


@pytest.mark.parametrize("dinv", [False, True])
def test_float32_plain_steps_round_the_float64_products_once(dinv):
    """For float32 operands the plain forward and backward steps equal the
    float64 computation of each product rounded to float32 once (the scatter
    itself stays in float32)."""
    rng = np.random.default_rng(7)
    N, B, ni, nb = 400, 3, 40, 24
    lev = _level(rng, B, ni, nb, N, dinv)
    C0 = torch.as_tensor(rng.standard_normal((N + 1, 2)), dtype=torch.float32)
    C0[N] = 0.0
    l64 = _upcast(lev)
    keep_i, keep_b = lev.int_ids < N, lev.bnd_ids < N

    x = C0[lev.int_ids.clamp(max=N).long()]
    ref = C0.clone()
    upd = (l64.L @ x.double()).float()
    ref.index_put_((lev.bnd_ids[keep_b].long(),), -upd[keep_b], accumulate=True)
    if dinv:
        xs = (l64.dinv @ x.double()).float()
    else:
        xs = dk.lu_solve(l64.lu, l64.perm, x.double()).float()
    ref[lev.int_ids[keep_i].long()] = xs[keep_i]
    assert torch.equal(level_forward_plain(C0.clone(), lev, N), ref)

    y = C0[lev.bnd_ids.clamp(max=N).long()]
    ref = C0.clone()
    upd = (l64.R @ y.double()).float()
    ref.index_put_((lev.int_ids[keep_i].long(),), -upd[keep_i], accumulate=True)
    assert torch.equal(sweep_update_plain(C0.clone(), lev.int_ids, lev.R, N,
                                          lev.bnd_ids), ref)
