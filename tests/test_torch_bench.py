"""The port's bench (``python -m hsolve_torch.bench``) on the CPU, with JAX
and the JAX package blocked from import: one JSON line with ``bench.py``'s
keys (``bench.py:451-493``) and three of its own, ``bench.py``'s metric-name
tag rules (``bench.py:436-452``), the JAX package's GMRES iteration count on
the same system, relres <= 1e-9; ``--damping`` runs the complex system
(complex128 with ``--cpu``) on an exact plan and is refused on a compressed
one."""

import importlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

import hsolve
from hsolve_torch.bench import metric_tag, parse_args

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RUN = ("import runpy, sys; sys.modules['jax'] = None; "
        "sys.modules['hsolve'] = None; sys.path.insert(0, {root!r}); "
        "runpy.run_module('hsolve_torch.bench', run_name='__main__', "
        "alter_sys=True)")
# bench.py's result keys (bench.py:451-493)
KEYS = ["metric", "value", "unit", "vs_baseline", "detail"]
DETAIL = ["setup_s", "solve_s", "factor_s", "plan_s", "plan_symbolic_s",
          "plan_schedule_s", "total_incl_symbolic_s",
          "vs_baseline_incl_symbolic", "gmres_iters", "relres",
          "max_diag_ratio", "cond_risky", "cond_risk_threshold",
          "factor_gflops", "achieved_gflop_s", "nnz_per_s",
          "speed_of_light_s", "sol_fraction", "sol_violation",
          "baseline_proxy", "baseline_proxy_s", "first_rep_setup_s",
          "first_rep_solve_s", "device"]
PORT_DETAIL = ["card", "factor_dtype", "factor_peak_mb"]


def _bench(*argv):
    out = subprocess.run([sys.executable, "-c", _RUN.format(root=ROOT), *argv],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    return out


def _jax_iters(problem, n, leafmax, kw):
    A, b, shape = getattr(hsolve, problem)(n, **kw)
    opts = hsolve.SolverOptions(swlevel=0)
    plan = hsolve.plan_factorization(
        A, hsolve.nested_dissection(shape, leafmax=leafmax), opts)
    F = hsolve.factor_with_plan(plan, opts)
    _, info = hsolve.gmres_compiled(
        lambda d, v: hsolve.dia_matvec(d, v), jfactor.solve_with_data,
        jnp.asarray(b), reltol=1e-9, restart=30, maxiter=60,
        mv_data=hsolve.to_dia(A), M_data=F.solve_data)
    return int(info["iters"])


@pytest.mark.parametrize("argv,problem,n,leafmax,kw", [
    (("--n", "32", "--leafmax", "20"), "helmholtz2d", 32, 20, {"k": 40.0}),
    (("--problem", "poisson3d", "--n", "10", "--leafmax", "40"), "poisson3d",
     10, 40, {})])
def test_bench_prints_the_jax_bench_line_on_the_cpu(argv, problem, n, leafmax,
                                                    kw):
    out = _bench("--cpu", "--reps", "2", *argv)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert list(res) == KEYS
    assert list(res["detail"]) == DETAIL + PORT_DETAIL
    d = res["detail"]
    assert res["metric"] == f"{problem}_h{n}_setup_plus_gmres_solve"
    assert res["unit"] == "seconds"
    assert d["device"] == "cpu" and d["card"] is None
    assert d["factor_dtype"] == "float64" and d["factor_peak_mb"] is None
    assert d["relres"] <= 1e-9 and not d["sol_violation"]
    assert d["baseline_proxy"] == "scipy_splu_1core_seconds"
    assert res["value"] == pytest.approx(
        d["plan_schedule_s"] + d["factor_s"] + d["solve_s"], abs=2e-4)
    assert d["gmres_iters"] == _jax_iters(problem, n, leafmax, kw)


def test_bench_compressed_run_follows_the_tag_rules():
    out = _bench("--cpu", "--reps", "1", "--n", "32", "--leafmax", "20",
                 "--swlevel", "-2", "--atol", "1e-3", "--kest", "32")
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metric"] == \
        "helmholtz2d_h32_sw-2_tol0.001_k32_setup_plus_gmres_solve"
    assert res["detail"]["relres"] <= 1e-9


@pytest.mark.parametrize("argv,f64,tag", [
    (("--cpu",), True, ""),
    (("--cpu", "--swlevel", "-2", "--atol", "1e-3", "--kest", "32"), True,
     "_sw-2_tol0.001_k32"),
    (("--cpu", "--swlevel", "-3", "--rank-cap", "64", "--level-caps",
      "40,16,8"), True, "_sw-3_cap64_lc40-16-8"),
    (("--cpu", "--atol", "1e-3", "--kest", "32"), True, ""),  # exact: no tag
    (("--cpu", "--factor-dtype", "f32"), False, "_f32"),
    ((), False, ""),                          # the card's default: float32
    (("--factor-dtype", "f64"), True, "_f64"),
    (("--swlevel", "-2", "--factor-dtype", "f64"), True, "_sw-2_f64"),
    (("--cpu", "--damping", "0.1"), True, "_damp0.1"),
    (("--damping", "0.1"), False, "_damp0.1"),   # the card: complex64
    (("--damping", "0.1", "--factor-dtype", "f64"), True, "_damp0.1_f64")])
def test_metric_tag_rules(argv, f64, tag):
    """bench.py's tags, and the factor type where it is not the device's
    default (float32 on the card, float64 with --cpu)."""
    assert metric_tag(parse_args(list(argv)), f64) == tag


def test_bench_refuses_a_complex_system():
    """A complex system on a compressed plan, which the bench plans
    structured (it has no ``hss`` switch), was refused until complex
    structured levels were ported; with ``--cpu`` it now factors in
    complex128 on structured levels and prints its line (relres <= 1e-9).
    On the card the bench's default complex64 factor still refuses such a
    plan (no complex64 kernels E-K; ``tests/test_torch_cuda.py``)."""
    out = _bench("--cpu", "--damping", "0.1", "--n", "32", "--leafmax", "20",
                 "--swlevel", "-2", "--atol", "1e-3")
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"].startswith("helmholtz2d_h32_damp0.1_sw-2_tol0.001")
    d = line["detail"]
    assert d["factor_dtype"] == "complex128" and d["device"] == "cpu"
    assert d["relres"] <= 1e-9 and d["gmres_iters"] >= 1


def test_bench_runs_the_damped_system_on_the_cpu():
    """``--cpu --damping 0.1`` at n=48: the complex system in complex128,
    one JSON line tagged ``_damp0.1`` with relres <= 1e-9, in the JAX
    package's iteration count (1: the exact factor)."""
    out = _bench("--cpu", "--reps", "2", "--n", "48", "--damping", "0.1")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert list(res) == KEYS
    assert list(res["detail"]) == DETAIL + PORT_DETAIL
    d = res["detail"]
    assert res["metric"] == "helmholtz2d_h48_damp0.1_setup_plus_gmres_solve"
    assert d["factor_dtype"] == "complex128" and d["device"] == "cpu"
    assert d["relres"] <= 1e-9 and not d["sol_violation"]
    assert d["gmres_iters"] == _jax_iters("helmholtz2d", 48, 100,
                                          {"k": 40.0, "damping": 0.1}) == 1


def test_bench_runs_a_float32_structured_plan_on_the_cpu():
    """The card's default on a compressed plan, a float32 factor of the
    bench's structured levels (it has no ``hss`` switch; kernels E-K in
    float32 on the card), run on the CPU with ``--factor-dtype f32``: one
    line tagged ``_f32`` with relres <= 1e-9."""
    out = _bench("--cpu", "--factor-dtype", "f32", "--reps", "1", "--n", "32",
                 "--leafmax", "20", "--swlevel", "-2", "--swsize", "16",
                 "--atol", "1e-3", "--kest", "32")
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == \
        "helmholtz2d_h32_sw-2_tol0.001_k32_f32_setup_plus_gmres_solve"
    d = line["detail"]
    assert d["factor_dtype"] == "float32" and d["device"] == "cpu"
    assert d["relres"] <= 1e-9 and d["gmres_iters"] >= 1
