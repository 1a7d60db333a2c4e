"""The JAX bench's device configuration on structured (HSS) levels
(``hss=True``, the default, and the bench's: it has no ``hss`` switch): the
port's float32 factor against the JAX package's float32 factor
(``hsolve.factor_with_plan(..., dtype=jnp.float32)``), on the CPU, given
JAX's own float32 sketches, on ``tests/test_torch_structured.py``'s plans:
poisson2d(65) at ``atol=rtol=1e-6`` and helmholtz2d(65, k=15) at 1e-4,
nested dissection with leafmax 60, ``swlevel=-4, swsize=8, leafsize=16``.

- Every structured level, given JAX's float32 sketches: at 1e-4, far above
  float32's rounding, equal largest interpolation ranks; the low-rank Gauss
  transforms ``LU_ LV_^T`` and ``RU_ RV_^T`` and the transition batches'
  HSS Schur complements within 2e-4 of JAX's (measured: at most 1.24e-4,
  the helmholtz case's top structured L; poisson 4.1e-5).  At 1e-6
  float32's rounding noise sets the ranks in both packages, so the poisson
  case compares the products only.  The float64 test holds them to 1e-9:
  the two packages' float32 QR, SVD, LU and CPQR sum in other orders, and
  the HSS compressions and Woodbury cores compound it level by level
  (``tests/test_torch_f32_lowrank.py`` says why 2e-4).
- Mixed-precision GMRES (float32 cycles over the float32 operator inside a
  float64 solve, ``m_eps=1e-6``, escalation on) on the port's float32
  structured factor with JAX's sketches: JAX's count on its own float32
  factor, or one more or less (at 1e-6, where the two float32 factors part,
  the port's solve on JAX's records carried over); with the port's own
  float32 sketches within two; relres < 1e-9 by scipy.
- A JAX float32 structured factorization carried over with
  ``factorization_from_numpy`` solves as JAX's (1e-4: the port's sweep sums
  in float64 and rounds once, JAX's in float32).
- The plain versions of kernels H-K in float32 against the JAX functions
  they serve, on one float32 HSS matrix: ``cpqr`` and ``interp_decomp``
  (equal pivots and ranks on a decaying spectrum, R and T to 1e-5), the
  matvec both ways (J), entries (I) and the solve both ways (K inside
  ``hss_solve``) to 1e-5 of JAX's float32 results.
"""

import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsolve
import hsolve_torch as ht
from hsolve.ops import hss as J
from hsolve.ops import lowrank as JL
from hsolve.structured import densify_schur as jdensify_schur
from hsolve_torch.factor import _factor_levels, solve_with_data
from hsolve_torch.interop import (_hss_from_numpy, factorization_from_numpy,
                                  plan_to_torch)
from hsolve_torch.ops import hss as T
from hsolve_torch.ops import lowrank as TL
from hsolve_torch.structured import SchurHss, StructuredLevel, densify_schur

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function
F32 = torch.float32

# tests/test_torch_structured.py's problems and options
CASES = {
    "poisson": (("poisson2d", 65, {}),
                dict(swlevel=-4, swsize=8, atol=1e-6, rtol=1e-6, leafsize=16)),
    "helmholtz": (("helmholtz2d", 65, {"k": 15.0}),
                  dict(swlevel=-4, swsize=8, atol=1e-4, rtol=1e-4,
                       leafsize=16)),
}
LEVEL_RTOL = 2e-4   # the levels' products against JAX's (module docstring)


def jax_sketch32(seed):
    """The JAX package's draws of a float32 factor for every key of the
    port's ``Sketch`` (``tests/test_torch_structured.py``'s keys; the draws
    in float32, the factor's real type: ``hsolve/ops/lowrank.py:152``,
    ``hsolve/ops/hss.py:430``)."""
    def draw(key, shape_a, shape_b):
        root = jax.random.PRNGKey(seed)
        if isinstance(key, int):
            keys = jax.random.split(jax.random.fold_in(root, key))
            return tuple(torch.as_tensor(np.array(jax.random.normal(
                k, sh, dtype=jnp.float32)))
                for k, sh in zip(keys, (shape_a, shape_b)))
        k0, tag = key
        B, n, s = shape_a
        om, ps = [], []
        for k in jax.random.split(jax.random.fold_in(jax.random.fold_in(
                root, k0), tag), B):
            kO, kP = jax.random.split(k)
            om.append(np.array(jax.random.normal(kO, (n, s),
                                                 dtype=jnp.float32)))
            ps.append(np.array(jax.random.normal(kP, (n, s),
                                                 dtype=jnp.float32)))
        return torch.as_tensor(np.stack(om)), torch.as_tensor(np.stack(ps))
    return draw


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if not ref.size:
        return 0.0
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _lowrank(U, V):
    U = np.asarray(U, dtype=np.float64)
    return U @ np.swapaxes(np.asarray(V, dtype=np.float64), -1, -2)


def _jprec(data, v):
    return jfactor.solve_with_data(data, v.astype(jnp.float32)).astype(v.dtype)


def _tprec(data, v):
    return solve_with_data(data, v.to(F32)).to(v.dtype)


def _jax_mixed(A, b, F):
    x, info = hsolve.gmres_compiled(
        lambda d, v: hsolve.dia_matvec(d, v), _jprec,
        jnp.asarray(b, jnp.float64), reltol=1e-9, restart=30, maxiter=60,
        mv_data=hsolve.spmv_format(A, dtype=np.float64)[0],
        M_data=F.solve_data, inner_dtype="float32",
        mv_data_inner=hsolve.spmv_format(A, dtype=np.float32)[0], m_eps=1e-6)
    return info, float(np.linalg.norm(A @ np.asarray(x) - b)
                       / np.linalg.norm(b))


def _port_mixed(A, b, F):
    op64, mv = ht.spmv_format(A, device="cpu")
    op32, _ = ht.spmv_format(A, dtype=np.float32, device="cpu")
    x, info = ht.gmres_compiled(
        mv, _tprec, torch.as_tensor(b), reltol=1e-9, restart=30, maxiter=60,
        mv_data=op64, M_data=F.solve_data, inner_dtype="float32",
        mv_data_inner=op32, m_eps=1e-6)
    return info, float(np.linalg.norm(A @ x.numpy() - b) / np.linalg.norm(b))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One problem factored in float32 by both packages on the JAX plan:
    the JAX levels and Schur stacks, its mixed GMRES run, and the port's
    levels and stacks with JAX's float32 sketches."""
    (name, n, pkw), kw = CASES[request.param]
    A, b, shape = getattr(hsolve, name)(n, **pkw)
    b = np.asarray(b)
    opts_j = hsolve.SolverOptions(**kw)
    plan = hsolve.plan_factorization(
        A, hsolve.nested_dissection(shape, leafmax=60), opts_j)
    jlevels, jstacks = [], {}
    Fj = jfactor._factor_levels(plan, opts_j, jnp.float32, jlevels, jstacks,
                                None)
    opts_t = ht.SolverOptions(**kw)
    sketch = jax_sketch32(opts_t.seed)
    tlevels, troot, tstacks = _factor_levels(plan, plan_to_torch(plan, "cpu"),
                                             opts_t, F32, sketch)
    return SimpleNamespace(name=request.param, A=A, b=b, shape=shape, kw=kw,
                           plan=plan, Fj=Fj, jstacks=jstacks,
                           tlevels=tlevels, troot=troot, tstacks=tstacks,
                           sketch=sketch, jmixed=_jax_mixed(A, b, Fj))


def test_f32_structured_levels_match_jax(case):
    """With JAX's float32 sketches: per structured level the largest
    interpolation ranks (at 1e-4) and the low-rank Gauss transforms, and
    the transition batches' HSS Schur complements, within 2e-4 of JAX's
    float32 factor."""
    nstruct = ntrans = 0
    assert case.troot is None and len(case.tlevels) == len(case.Fj.levels)
    for i, (tl, jl) in enumerate(zip(case.tlevels, case.Fj.levels)):
        bp = case.plan.batches[i]
        assert isinstance(tl, StructuredLevel) == bp.structured, i
        if bp.structured:
            nstruct += 1
            assert tl.LU_.dtype == F32 and jl.LU_.dtype == jnp.float32
            assert tl.rank_cap == jl.rank_cap == bp.rank_cap
            if case.kw["atol"] >= 1e-4:
                assert np.array_equal(tl.rank_maxed.numpy(),
                                      np.asarray(jl.rank_maxed)), i
            assert _rel(_lowrank(tl.LU_, tl.LV_), _lowrank(jl.LU_, jl.LV_)) \
                < LEVEL_RTOL, (i, "L")
            assert _rel(_lowrank(tl.RU_, tl.RV_), _lowrank(jl.RU_, jl.RV_)) \
                < LEVEL_RTOL, (i, "R")
        if isinstance(case.tstacks[i], SchurHss):
            ntrans += not bp.structured
            ts, js = case.tstacks[i], case.jstacks[i]
            assert np.array_equal(ts.n1.numpy(), np.asarray(js.n1))
            assert np.array_equal(ts.n2.numpy(), np.asarray(js.n2))
            w = bp.cplan.n_pad
            live = (np.arange(w)[None, :] < (ts.n1 + ts.n2).numpy()[:, None])
            live = live[:, :, None] & live[:, None, :]
            dj = np.asarray(jdensify_schur(js, w)) * live
            assert _rel(densify_schur(ts, w).numpy() * live, dj) \
                < LEVEL_RTOL, i
    assert nstruct >= 1 and ntrans >= 1


def test_f32_structured_mixed_gmres_matches_jax(case):
    """Mixed GMRES on the port's float32 structured factor with JAX's
    sketches: at 1e-4 JAX's count on its float32 factor, or one more or
    less, and JAX's rank report.  At 1e-6 (poisson) float32's rounding
    sets the ranks in both packages and the two factors part (the port's
    takes 3 iterations, JAX's 5): there the port's count is at most one
    more than JAX's, and the port's solve on JAX's records carried over
    takes JAX's count or one more or less, so the solves agree and the
    factors part.  With the port's own float32 sketches within two of JAX's
    count, no cap saturated at 1e-4 (at 1e-6 the noise ranks fill them).
    Relres < 1e-9 by scipy throughout."""
    jinfo, jrelres = case.jmixed
    assert jinfo["converged"] and jrelres < 1e-9
    jiters = int(jinfo["iters"])
    topts = ht.SolverOptions(**case.kw)
    F_same = ht.factor_with_plan(case.plan, topts, dtype=F32, device="cpu",
                                 sketch=case.sketch)
    assert F_same.dtype == F32
    info, relres = _port_mixed(case.A, case.b, F_same)
    assert info["converged"] and relres < 1e-9
    if case.kw["atol"] >= 1e-4:
        assert abs(info["iters"] - jiters) <= 1
    else:
        assert info["iters"] <= jiters + 1
        Fc = factorization_from_numpy(case.Fj.levels, case.Fj.root,
                                      case.plan.perm, "cpu")
        info_c, relres_c = _port_mixed(case.A, case.b, Fc)
        assert info_c["converged"] and relres_c < 1e-9
        assert abs(info_c["iters"] - jiters) <= 1
    F_own = ht.factor_with_plan(case.plan, topts, dtype=F32, device="cpu")
    info, relres = _port_mixed(case.A, case.b, F_own)
    assert info["converged"] and relres < 1e-9
    assert info["iters"] <= int(jinfo["iters"]) + 2
    if case.kw["atol"] >= 1e-4:
        # at 1e-6 float32's noise fills the caps (the ranks are the noise's)
        assert not F_own.rank_report()["saturated"]
        assert F_same.rank_report() == case.Fj.rank_report()


def test_factorization_from_numpy_f32_structured(case):
    """JAX's float32 structured records carried over: the port's solve (C
    and E around ``d_apply``) gives JAX's float32 solve to 1e-4."""
    Ft = factorization_from_numpy(case.Fj.levels, case.Fj.root,
                                  case.plan.perm, "cpu")
    assert Ft.dtype == F32
    assert sum(isinstance(lv, StructuredLevel) for lv in Ft.levels) >= 1
    rng = np.random.default_rng(7)
    for rhs in (case.b, rng.standard_normal((case.A.shape[0], 2))):
        rhs = rhs.astype(np.float32)
        assert _rel(Ft.solve(rhs).numpy(), case.Fj.solve(rhs)) < 1e-4


# --- the plain versions of H-K in float32 against the JAX package's ----------------

PLAN = dict(ls=32, depth=3, n1=128, n2=128)


def _scattered32(n, seed=3):
    """``tests/test_torch_hss.py``'s tie-free compressible kernel matrix,
    in float32."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    pts = np.sort(rng.random(n))
    return (1.0 / (1.0 + 50.0 * np.abs(pts[:, None] - pts[None, :]))
            + 4.0 * np.eye(n) + 1e-3 * rng.standard_normal((n, n))
            * np.exp(-np.abs(i[:, None] - i[None, :]) / 3.0)).astype(
                np.float32)


@pytest.fixture(scope="module")
def pair32():
    """(A, JAX Hss, port Hss of the same float32 generators): JAX's
    float32 compression at 1e-3 carried over."""
    A = _scattered32(256)
    hj = J.hss_compress_dense(jnp.asarray(A), J.ClusterPlan(**PLAN), 1e-3,
                              1e-3, 24)
    ht_ = _hss_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a)[None], hj),
        lambda a, dt=None: torch.as_tensor(a, dtype=dt))
    assert ht_.D.dtype == F32 and hj.D.dtype == jnp.float32
    return A, hj, ht_


@pytest.mark.parametrize("tol", [1e-3, 1e-4])
@pytest.mark.parametrize("m,n,cap", [(40, 30, 20), (58, 32, 32), (23, 92, 24)])
def test_f32_cpqr_and_interp_decomp_match_jax(m, n, cap, tol):
    """Kernel H's plain version in float32 (the norms, threshold and steps
    in float32, the pivot norm's floor 1e-300 zero in float32 in both):
    JAX's pivots and ranks, R to 1e-5 and the interpolation matrix T to
    1e-5 (1e-4 at tol 1e-4: T solves with R11, whose condition reaches
    1 / tol; the float64 test's 1e-10 allows the like factor), on
    matrices whose rows and columns both decay (0.6 a step), so that the
    ID's CPQR of ``A^T`` meets no column whose downdated norm has fallen to
    float32's rounding of its first one (with columns alone decaying, the
    rows of ``A`` keep like norms, and at 1e-4 the last pivots of ``A^T``
    fall to that noise in both packages)."""
    rng = np.random.default_rng(m + n)
    M = (rng.standard_normal((4, m, n)) * 0.6 ** np.arange(n)
         * 0.6 ** np.arange(m)[:, None]).astype(np.float32)
    f = JL.cpqr(jnp.asarray(M), tol, tol, cap)
    g = TL.cpqr(torch.as_tensor(M), tol, tol, cap)
    assert g.R.dtype == F32
    assert np.array_equal(g.piv.numpy(), np.asarray(f.piv))
    assert np.array_equal(g.rank.numpy(), np.asarray(f.rank))
    assert 0 < int(g.rank.min()) and int(g.rank.max()) < min(m, n, cap)
    assert _rel(g.R.numpy(), f.R) < 1e-5
    Jj, Tj, rj = JL.interp_decomp(jnp.asarray(M), tol, tol, cap)
    Jt, Tt, rt = TL.interp_decomp(torch.as_tensor(M), tol, tol, cap)
    assert np.array_equal(Jt.numpy(), np.asarray(Jj))
    assert np.array_equal(rt.numpy(), np.asarray(rj))
    # T = R11^-1 R12, and R11's condition reaches 1 / tol
    assert _rel(Tt.numpy(), Tj) < (1e-5 if tol >= 1e-3 else 1e-4)


@pytest.mark.parametrize("k", [1, 3])
def test_f32_matvec_both_directions_matches_jax(pair32, k):
    """Kernel J's plain version in float32, ``A x`` and ``A^T x``."""
    A, hj, ht_ = pair32
    x = np.random.default_rng(k).standard_normal((256, k)).astype(np.float32)
    for adj in (False, True):
        yj = J.hss_matvec(hj, jnp.asarray(x), adjoint=adj)
        yt = T.hss_matvec(ht_, torch.as_tensor(x)[None], adj)[0]
        assert yt.dtype == F32 and yj.dtype == jnp.float32
        assert _rel(yt.numpy(), yj) < 1e-5


def test_f32_entries_match_jax(pair32):
    """Kernel I's plain version in float32 at random positions (every LCA
    level), and the leaf blocks bit for bit."""
    A, hj, ht_ = pair32
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 256, size=(3, 37))
    cols = rng.integers(0, 256, size=(3, 23))
    ej = jax.vmap(lambda r, c: J.hss_entries(hj, r, c))(jnp.asarray(rows),
                                                         jnp.asarray(cols))
    et = T.hss_entries(ht_, torch.as_tensor(rows)[None],
                       torch.as_tensor(cols)[None])
    assert et.dtype == F32
    assert _rel(et[0].numpy(), ej) < 1e-5
    leaf = np.arange(256).reshape(8, 32)
    blocks = T.hss_entries(ht_, torch.as_tensor(leaf)[None],
                           torch.as_tensor(leaf)[None])
    assert np.array_equal(blocks[0].numpy(), np.asarray(hj.D))


def test_f32_factor_and_solve_both_directions_match_jax(pair32):
    """The float32 HSS factor and solve (kernel K's plain version at every
    level, both directions) against JAX's float32 ``hss_factor`` /
    ``hss_solve``: 1e-5, and the residual against the HSS operator within
    1e-5."""
    A, hj, ht_ = pair32
    sj, st = J.hss_factor(hj), T.hss_factor(ht_)
    b = np.random.default_rng(1).standard_normal((256, 2)).astype(np.float32)
    op = np.asarray(J.hss_todense(hj), dtype=np.float64)
    for adj in (False, True):
        xj = J.hss_solve(sj, jnp.asarray(b), adjoint=adj)
        xt = T.hss_solve(st, torch.as_tensor(b)[None], adj)[0].numpy()
        assert xt.dtype == np.float32
        assert _rel(xt, xj) < 1e-5
        assert _rel((op.T if adj else op) @ xt, b) < 1e-5
