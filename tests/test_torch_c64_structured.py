"""The JAX bench's complex device configuration on structured (HSS) levels
(``hss=True``, the default, and the bench's: it has no ``hss`` switch): the
port's complex64 factor against the JAX package's complex64 factor
(``dtype=jnp.complex64``: ``tests/conftest.py`` enables x64), on the CPU,
on ``tests/test_torch_complex_structured.py``'s damped plan:
helmholtz2d(48, k=25, damping=0.1), leafmax 60, ``swlevel=-2, swsize=1,
atol=rtol=1e-4``, given JAX's complex64 sketches (float32 draws cast).

- The low-rank level and the transition batch's HSS Schur complements:
  JAX's ranks, and ``LU_ LV_^T``, ``RU_ RV_^T`` and the Schur complements
  within 2e-4 of JAX's complex64 factor, relative to the level's largest
  entry (measured: at most 1.9e-5).
- The structured levels: JAX's complex64 factor parts from its own
  complex128 factor there.  Its first structured level keeps interpolation
  ranks [9, 10, 10, 11] where the complex128 factor of the same draws keeps
  [10, 10, 10, 10] (a rank lost and one gained at the 1e-4 truncation:
  fault F8's kind, ROADMAP §3), so its transforms lie 2.0e-4 and then 1.0e-3
  off the complex128 ones.  The port's complex64 factor keeps the complex128
  ranks, its pivot loop running in complex128 (``cpqr_loop_type``), and
  lies 4.3e-6 and 1.2e-4 off.  So the structured levels are held to the
  port's complex128 factor of the same draws (the complex128 test holds that
  to JAX's complex128 to 1e-9): equal largest ranks, products within 2e-4;
  and JAX's complex64 levels are shown to lie further off than the port's.
- Mixed-precision GMRES (complex64 cycles over the complex64 operator
  inside a complex128 solve, ``m_eps=1e-6``, escalation on) on the port's
  complex64 factor with JAX's sketches: JAX's count on its own complex64
  factor, or one more or less (JAX 4, the port 3); with the port's own
  sketches within two; relres < 1e-9 by scipy.  JAX's complex64 records
  carried over with ``factorization_from_numpy`` solve as JAX's (1e-4)
  and take JAX's count.
- The plain versions of kernels H-K in complex64 against the JAX functions
  they serve, on one complex64 HSS matrix: ``cpqr`` and ``interp_decomp``
  (equal pivots and ranks on a decaying spectrum, R and T to 1e-5), the
  matvec both ways (J), entries (I) and the solve both ways (K inside
  ``hss_solve``) to 1e-5 of JAX's complex64 results; and the pivot loop's
  type: complex64 input runs complex128's loop, where JAX's complex64 loop
  loses a rank (F8).
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
from hsolve_torch.factor import CompressedLevel, _factor_levels, solve_with_data
from hsolve_torch.interop import (_hss_from_numpy, factorization_from_numpy,
                                  plan_to_torch)
from hsolve_torch.ops import hss as T
from hsolve_torch.ops import lowrank as TL
from hsolve_torch.structured import SchurHss, StructuredLevel, densify_schur
from test_torch_f32_structured import _scattered32, jax_sketch32

torch.set_num_threads(1)
jfactor = importlib.import_module("hsolve.factor")   # hsolve.factor is the function
C64 = torch.complex64

# tests/test_torch_complex_structured.py's plan
KW = dict(swlevel=-2, swsize=1, atol=1e-4, rtol=1e-4)
LEVEL_RTOL = 2e-4   # the levels' products (module docstring)


def _rel(got, ref):
    got = np.asarray(got, dtype=np.complex128)
    ref = np.asarray(ref, dtype=np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if not ref.size:
        return 0.0
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _lowrank(U, V):
    U = np.asarray(U, dtype=np.complex128)
    return U @ np.swapaxes(np.asarray(V, dtype=np.complex128), -1, -2)


def _cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _jprec(data, v):
    return jfactor.solve_with_data(data, v.astype(jnp.complex64)).astype(
        v.dtype)


def _tprec(data, v):
    return solve_with_data(data, v.to(C64)).to(v.dtype)


def _port_mixed(A, b, F):
    op128, mv = ht.spmv_format(A, device="cpu")
    op64, _ = ht.spmv_format(A, dtype=np.complex64, device="cpu")
    x, info = ht.gmres_compiled(
        mv, _tprec, torch.as_tensor(b), reltol=1e-9, restart=30, maxiter=60,
        mv_data=op128, M_data=F.solve_data, inner_dtype="complex64",
        mv_data_inner=op64, m_eps=1e-6)
    assert x.dtype == torch.complex128
    return info, float(np.linalg.norm(A @ x.numpy() - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def case():
    """The plan factored in complex64 by both packages (JAX: its levels,
    Schur stacks and mixed GMRES run; the port: its levels and stacks given
    JAX's complex64 sketches), and the port's complex128 levels given the
    same draws."""
    A, b, shape = hsolve.helmholtz2d(48, k=25.0, damping=0.1)
    b = np.asarray(b)
    opts_j = hsolve.SolverOptions(**KW)
    plan = hsolve.plan_factorization(
        A, hsolve.nested_dissection(shape, leafmax=60), opts_j)
    jlevels, jstacks = [], {}
    Fj = jfactor._factor_levels(plan, opts_j, jnp.complex64, jlevels, jstacks,
                                None)
    x, jinfo = hsolve.gmres_compiled(
        lambda d, v: hsolve.dia_matvec(d, v), _jprec,
        jnp.asarray(b, jnp.complex128), reltol=1e-9, restart=30, maxiter=60,
        mv_data=hsolve.spmv_format(A, dtype=np.complex128)[0],
        M_data=Fj.solve_data, inner_dtype="complex64",
        mv_data_inner=hsolve.spmv_format(A, dtype=np.complex64)[0],
        m_eps=1e-6)
    assert jinfo["converged"]
    assert np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b) < 1e-9
    opts = ht.SolverOptions(**KW)
    sketch = jax_sketch32(opts.seed)
    tp = plan_to_torch(plan, "cpu")
    tlevels, troot, tstacks = _factor_levels(plan, tp, opts, C64, sketch)
    wlevels, _, _ = _factor_levels(plan, tp, opts, torch.complex128, sketch)
    return SimpleNamespace(A=A, b=b, shape=shape, plan=plan, Fj=Fj,
                           jstacks=jstacks, jiters=int(jinfo["iters"]),
                           tlevels=tlevels, troot=troot, tstacks=tstacks,
                           wlevels=wlevels, sketch=sketch)


def test_c64_structured_levels(case):
    """The low-rank level and the transition batch's HSS Schur complements
    within 2e-4 of JAX's complex64 factor, with JAX's ranks; the structured
    levels within 2e-4 of the complex128 factor of the same draws, with its
    largest ranks, where JAX's complex64 levels lie further off (the
    module's docstring)."""
    nlow = nstruct = ntrans = 0
    assert case.troot is None and len(case.tlevels) == len(case.Fj.levels)
    for i, (tl, jl, wl) in enumerate(zip(case.tlevels, case.Fj.levels,
                                         case.wlevels)):
        bp = case.plan.batches[i]
        assert isinstance(tl, StructuredLevel) == bp.structured, i
        if isinstance(tl, CompressedLevel):
            nlow += 1
            assert tl.LU_.dtype == C64 and jl.LU_.dtype == jnp.complex64
            assert np.array_equal(tl.lrank.numpy(), np.asarray(jl.lrank)), i
            assert np.array_equal(tl.rrank.numpy(), np.asarray(jl.rrank)), i
            assert _rel(_lowrank(tl.LU_, tl.LV_), _lowrank(jl.LU_, jl.LV_)) \
                < LEVEL_RTOL, (i, "L")
            assert _rel(_lowrank(tl.RU_, tl.RV_), _lowrank(jl.RU_, jl.RV_)) \
                < LEVEL_RTOL, (i, "R")
        if bp.structured:
            nstruct += 1
            assert tl.LU_.dtype == tl.RU_.dtype == C64
            assert tl.solver1.h.D.dtype == C64
            assert tl.rank_cap == jl.rank_cap == wl.rank_cap == bp.rank_cap
            assert torch.equal(tl.rank_maxed, wl.rank_maxed), i
            assert int(tl.rank_maxed.min()) > 0
            for side in ("L", "R"):
                pair = lambda lv: _lowrank(getattr(lv, side + "U_"),
                                           getattr(lv, side + "V_"))
                e_port = _rel(pair(tl), pair(wl))
                assert e_port < LEVEL_RTOL, (i, side)
                assert _rel(pair(jl), pair(wl)) > e_port, (i, side)
        if isinstance(case.tstacks[i], SchurHss) and not bp.structured:
            ntrans += 1
            ts, js = case.tstacks[i], case.jstacks[i]
            assert ts.h.D.dtype == C64
            assert np.array_equal(ts.n1.numpy(), np.asarray(js.n1))
            assert np.array_equal(ts.n2.numpy(), np.asarray(js.n2))
            w = bp.cplan.n_pad
            live = (np.arange(w)[None, :] < (ts.n1 + ts.n2).numpy()[:, None])
            live = live[:, :, None] & live[:, None, :]
            dj = np.asarray(jdensify_schur(js, w)) * live
            assert _rel(densify_schur(ts, w).numpy() * live, dj) \
                < LEVEL_RTOL, i
    assert nlow >= 1 and nstruct >= 2 and ntrans >= 1
    # the first structured level: JAX's complex64 ranks part from the
    # complex128 factor's, the port's do not
    first = next(i for i, bp in enumerate(case.plan.batches) if bp.structured)
    assert not np.array_equal(np.asarray(case.Fj.levels[first].rank_maxed),
                              case.wlevels[first].rank_maxed.numpy())


def test_c64_structured_mixed_gmres_matches_jax(case):
    """Mixed GMRES on the port's complex64 structured factor with JAX's
    sketches: JAX's count on its own complex64 factor, or one more or less,
    JAX's largest rank; with the port's own sketches (float32 draws cast)
    within two of JAX's count and no cap saturated; relres < 1e-9 by
    scipy."""
    topts = ht.SolverOptions(**KW)
    F = ht.factor_with_plan(case.plan, topts, dtype=C64, device="cpu",
                            sketch=case.sketch)
    assert F.dtype == C64
    assert F.maxrank() == case.Fj.maxrank() > 0
    info, relres = _port_mixed(case.A, case.b, F)
    assert info["converged"] and relres < 1e-9
    assert abs(info["iters"] - case.jiters) <= 1
    F_own = ht.factor(case.A, ht.nested_dissection(case.shape, leafmax=60),
                      dtype=C64, device="cpu", **KW)
    assert any(isinstance(lv, StructuredLevel) for lv in F_own.levels)
    assert not F_own.rank_report()["saturated"]
    info, relres = _port_mixed(case.A, case.b, F_own)
    assert info["converged"] and relres < 1e-9
    assert info["iters"] <= case.jiters + 2


def test_factorization_from_numpy_c64_structured(case):
    """JAX's complex64 structured records carried over: the port's solve
    (C and E around ``d_apply``) gives JAX's complex64 solve to 1e-4, and
    its mixed GMRES takes JAX's count."""
    Fc = factorization_from_numpy(case.Fj.levels, case.Fj.root,
                                  case.plan.perm, "cpu")
    assert Fc.dtype == C64
    assert sum(isinstance(lv, StructuredLevel) for lv in Fc.levels) >= 2
    rng = np.random.default_rng(7)
    for rhs in (case.b, _cplx(rng, case.A.shape[0], 2)):
        rhs = rhs.astype(np.complex64)
        assert _rel(Fc.solve(rhs).numpy(), case.Fj.solve(rhs)) < 1e-4
    info, relres = _port_mixed(case.A, case.b, Fc)
    assert info["converged"] and relres < 1e-9
    assert info["iters"] == case.jiters


# --- the plain versions of H-K in complex64 against the JAX package's -----------------

PLAN = dict(ls=32, depth=3, n1=128, n2=128)


@pytest.fixture(scope="module")
def pair64():
    """(JAX Hss, port Hss of the same complex64 generators): JAX's
    complex64 compression at 1e-3 of a complex tie-free compressible
    kernel matrix, carried over."""
    A = (_scattered32(256) + 0.5j * _scattered32(256, seed=4)).astype(
        np.complex64)
    hj = J.hss_compress_dense(jnp.asarray(A), J.ClusterPlan(**PLAN), 1e-3,
                              1e-3, 24)
    ht_ = _hss_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a)[None], hj),
        lambda a, dt=None: torch.as_tensor(a, dtype=dt))
    assert ht_.D.dtype == C64 and hj.D.dtype == jnp.complex64
    return hj, ht_


@pytest.mark.parametrize("tol", [1e-3, 1e-4])
@pytest.mark.parametrize("m,n,cap", [(40, 30, 20), (58, 32, 32), (23, 92, 24)])
def test_c64_cpqr_and_interp_decomp_match_jax(m, n, cap, tol):
    """Kernel H's plain version on complex64 input (its loop in
    complex128) against JAX's complex64 ``cpqr``: JAX's pivots and ranks,
    R to 1e-5 and the interpolation matrix T to 1e-5 (1e-4 at tol 1e-4: T
    solves with R11, whose condition reaches 1 / tol), on matrices whose
    rows and columns both decay (0.6 a step, as the float32 test's)."""
    rng = np.random.default_rng(m + n)
    M = (_cplx(rng, 4, m, n) * 0.6 ** np.arange(n)
         * 0.6 ** np.arange(m)[:, None]).astype(np.complex64)
    f = JL.cpqr(jnp.asarray(M), tol, tol, cap)
    g = TL.cpqr(torch.as_tensor(M), tol, tol, cap)
    assert g.R.dtype == C64
    assert np.array_equal(g.piv.numpy(), np.asarray(f.piv))
    assert np.array_equal(g.rank.numpy(), np.asarray(f.rank))
    assert 0 < int(g.rank.min()) and int(g.rank.max()) < min(m, n, cap)
    assert _rel(g.R.numpy(), f.R) < 1e-5
    Jj, Tj, rj = JL.interp_decomp(jnp.asarray(M), tol, tol, cap)
    Jt, Tt, rt = TL.interp_decomp(torch.as_tensor(M), tol, tol, cap)
    assert Tt.dtype == C64
    assert np.array_equal(Jt.numpy(), np.asarray(Jj))
    assert np.array_equal(rt.numpy(), np.asarray(rj))
    assert _rel(Tt.numpy(), Tj) < (1e-5 if tol >= 1e-3 else 1e-4)


def test_c64_cpqr_loop_is_complex128s():
    """Complex64 input runs H's pivot loop in complex128
    (``cpqr_loop_type``), bit for bit the complex128 loop on the widened
    input.  Fault F8 in complex: on a complex rank-10 block whose tenth
    direction carries 3.2e-4 of its columns' norm (the transition
    compressions' truncation at 2.5e-4), the JAX package's complex64
    ``cpqr`` stops one rank short, 9; complex128 and the port find 10."""
    assert TL.cpqr_loop_type(C64) == torch.complex128
    assert TL.cpqr_loop_type(torch.complex128) == torch.complex128
    rng = np.random.default_rng(2)
    m, n, r = 92, 64, 10
    G = np.linalg.qr(rng.standard_normal((m, r))
                     + 1j * rng.standard_normal((m, r)))[0] \
        * np.logspace(0, -3.5, r)
    A = (G @ (rng.standard_normal((r, n)) + 1j * rng.standard_normal((r, n)))
         / np.sqrt(2 * r)).astype(np.complex64)
    A = np.stack([A, A])
    piv64, rank64 = TL.cpqr_pivots_plain(torch.as_tensor(A), 2.5e-4, 2.5e-4,
                                         32)
    piv128, rank128 = TL.cpqr_pivots_plain(
        torch.as_tensor(A).to(torch.complex128), 2.5e-4, 2.5e-4, 32)
    assert torch.equal(piv64, piv128) and torch.equal(rank64, rank128)
    assert rank128.tolist() == [10, 10]
    jrank = np.asarray(JL.cpqr(jnp.asarray(A), 2.5e-4, 2.5e-4, 32).rank)
    assert jrank.tolist() == [9, 9]


@pytest.mark.parametrize("k", [1, 3])
def test_c64_matvec_both_directions_matches_jax(pair64, k):
    """Kernel J's plain version in complex64, ``A x`` and ``A^T x`` (the
    plain transpose)."""
    hj, ht_ = pair64
    x = _cplx(np.random.default_rng(k), 256, k)
    for adj in (False, True):
        yj = J.hss_matvec(hj, jnp.asarray(x), adjoint=adj)
        yt = T.hss_matvec(ht_, torch.as_tensor(x)[None], adj)[0]
        assert yt.dtype == C64 and yj.dtype == jnp.complex64
        assert _rel(yt.numpy(), yj) < 1e-5


def test_c64_entries_match_jax(pair64):
    """Kernel I's plain version in complex64 at random positions (every
    LCA level), and the leaf blocks bit for bit."""
    hj, ht_ = pair64
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 256, size=(3, 37))
    cols = rng.integers(0, 256, size=(3, 23))
    ej = jax.vmap(lambda r, c: J.hss_entries(hj, r, c))(jnp.asarray(rows),
                                                         jnp.asarray(cols))
    et = T.hss_entries(ht_, torch.as_tensor(rows)[None],
                       torch.as_tensor(cols)[None])
    assert et.dtype == C64
    assert _rel(et[0].numpy(), ej) < 1e-5
    leaf = np.arange(256).reshape(8, 32)
    blocks = T.hss_entries(ht_, torch.as_tensor(leaf)[None],
                           torch.as_tensor(leaf)[None])
    assert np.array_equal(blocks[0].numpy(), np.asarray(hj.D))


def test_c64_factor_and_solve_both_directions_match_jax(pair64):
    """The complex64 HSS factor and solve (kernel K's plain version at
    every level, both directions) against JAX's complex64 ``hss_factor`` /
    ``hss_solve``: 1e-5, and the residual against the HSS operator within
    1e-5."""
    hj, ht_ = pair64
    sj, st = J.hss_factor(hj), T.hss_factor(ht_)
    b = _cplx(np.random.default_rng(1), 256, 2)
    op = np.asarray(J.hss_todense(hj), dtype=np.complex128)
    for adj in (False, True):
        xj = J.hss_solve(sj, jnp.asarray(b), adjoint=adj)
        xt = T.hss_solve(st, torch.as_tensor(b)[None], adj)[0].numpy()
        assert xt.dtype == np.complex64
        assert _rel(xt, xj) < 1e-5
        assert _rel((op.T if adj else op) @ xt, b) < 1e-5
