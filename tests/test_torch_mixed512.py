"""The mixed-precision configuration's float32 preconditioner at n=512 on the
CPU: the port's solve sweep on the JAX package's own float32 factors.

helmholtz2d(512, k=40) is nearly singular at the top level, so one
application of the float32 exact factor leaves a large residual (JAX: about
0.07, the same factors applied in float64: about 0.04) and the residual
amplifies rounding differences of a few units in the last place.  The GMRES
counts of the two packages then differ (JAX 80, the port on the CPU 120,
unconverged), though both sweeps are float32-accurate: here the port's
float32 sweep on JAX's factors stays as close to the float64 sweep on the
same factors as JAX's own float32 solve does (2.4e-5 against 1.9e-5
relative in x).  Single-threaded: torch's threaded CPU LU is not used."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import hsolve
from hsolve_torch.interop import factorization_from_numpy

torch.set_num_threads(1)


def _upcast(lev):
    """The level record with its float32 tensors in float64."""
    kw = {}
    for f in dataclasses.fields(lev):
        v = getattr(lev, f.name)
        is32 = isinstance(v, torch.Tensor) and v.dtype == torch.float32
        kw[f.name] = v.double() if is32 else v
    return type(lev)(**kw)


def test_float32_sweep_on_jax_factors_is_as_accurate_as_jax_at_n512():
    A, b, shape = hsolve.helmholtz2d(512, k=40.0)
    b = np.asarray(b)
    opts = hsolve.SolverOptions(swlevel=0)
    plan = hsolve.plan_factorization(
        A, hsolve.nested_dissection(shape, leafmax=100), opts)
    Fj = hsolve.factor_with_plan(plan, opts, dtype=jnp.float32)
    xj = np.asarray(Fj.solve(jnp.asarray(b, jnp.float32))).astype(np.float64)
    Ft = factorization_from_numpy(Fj.levels, Fj.root, plan.perm, "cpu")
    xt = Ft.solve(torch.as_tensor(b.astype(np.float32))).double().numpy()
    F64 = dataclasses.replace(Ft, levels=[_upcast(lv) for lv in Ft.levels])
    assert Ft.root is None
    x64 = F64.solve(torch.as_tensor(b)).numpy()
    err_port = np.linalg.norm(xt - x64) / np.linalg.norm(x64)
    err_jax = np.linalg.norm(xj - x64) / np.linalg.norm(x64)
    assert err_port < 5e-5 and err_jax < 5e-5
    assert err_port < 2.0 * err_jax
