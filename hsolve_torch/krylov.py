"""Restarted GMRES with right preconditioning (port of ``hsolve/krylov.py``).

Capability parity with the reference's Krylov integration
(``IterativeSolvers.gmres(A, b; Pr=F, reltol, restart, maxiter, log)`` at
``test/rungmres.jl:47-48``): restarted GMRES(restart) whose right preconditioner
is a callable (the port's :class:`~hsolve_torch.factor.Factorization`), with a
residual-norm history.

:func:`gmres_compiled` is the whole solve as one device program, as the
JAX package's is: on the card its restart cycles and Arnoldi steps run as
one CUDA graph whose loops are conditional WHILE nodes driven by flags in
device memory (:class:`~hsolve_torch.ops.gmres_control.SolveGraph`; each
step one launch of kernel L with kernel M's Givens bookkeeping and the
scaling into the next basis vector as its tail, the loop control in the
kernels of ``csrc/gmres_control.cu``), and the host reads nothing until
the caller fetches the diagnostics (``fetch_info=False``, then
:func:`fetch_gmres_info`).  On the CPU a host loop runs the same functions'
plain versions.  It also runs the JAX package's mixed-precision
configuration: float32 cycles inside a float64 solve, with escalation to a
float64 phase.  :func:`gmres` is the host-loop variant (MGS, host Givens).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from hsolve_torch.factor import SolveData
from hsolve_torch.ops import gmres_control as gc
from hsolve_torch.ops.arnoldi import (DONE, GO, IT, MAXITER, NCYC,
                                      arnoldi_state, arnoldi_step)
from hsolve_torch.ops.sparse import DiaMatrix, dia_residual, torch_dtype


def _givens(a, b):
    """Complex-safe Givens pair (cs, sn) zeroing b: apply as
    [cs, sn; -conj(sn), cs] @ [a; b] = [r; 0]."""
    denom = np.sqrt(abs(a) ** 2 + abs(b) ** 2)
    if denom == 0.0:
        return 1.0, 0.0 * a
    if abs(a) == 0.0:
        return 0.0, b / abs(b) if abs(b) else 0.0
    cs = abs(a) / denom
    sn = (a * np.conj(b)) / (abs(a) * denom)
    return cs, sn


def _scalar_type(b: torch.Tensor):
    return np.complex128 if b.is_complex() else np.float64


def _mgs(V: torch.Tensor, w: torch.Tensor, j: int):
    """Modified Gram-Schmidt of w against V[0..j]; returns (w_orth, coefficients)."""
    hs = []
    for i in range(j + 1):
        h = torch.vdot(V[i], w)
        w = w - h * V[i]
        hs.append(h)
    return w, torch.stack(hs)


_ONE_DEVICE = SolveData(())


def _hooks(M: Optional[Callable], M_data) -> SolveData:
    """The solve data whose hooks (``consensus``, ``check_replicated``,
    ``prepare_graph``) a solve calls: ``M_data``, else that of the
    factorization ``M`` is a method of (``M=F.solve`` of a mesh factor is
    collective as well), else one device's, which do nothing."""
    for data in (M_data, getattr(getattr(M, "__self__", None), "solve_data",
                                 None)):
        if isinstance(data, SolveData):
            return data
    return _ONE_DEVICE


def gmres(matvec: Callable, b, M: Optional[Callable] = None, x0=None,
          reltol: float = 1e-9, abstol: float = 0.0, restart: int = 30,
          maxiter: Optional[int] = None, M_data=None):
    """Solve ``A x = b`` with right-preconditioned restarted GMRES (MGS Arnoldi).

    matvec: ``v -> A v``; M: ``v -> M^{-1} v`` (right preconditioner), or
    ``(data, v) -> M^{-1} v`` when ``M_data`` is given, as in
    :func:`gmres_compiled`.  Returns ``(x, info)``: ``info['resnorm']``
    holds the initial residual norm followed by one entry per inner
    iteration; ``info['iters']``; ``info['converged']``.

    With ``M_data`` a mesh factor's solve data
    (:class:`~hsolve_torch.parallel.sharded.MeshSolveData`), or ``M`` the
    ``solve`` or ``apply_permuted`` of a mesh factor, every rank runs this
    loop on its replicated vectors: ``M`` returns the same vector
    on every rank, the norms and Arnoldi coefficients every branch reads are
    rank 0's (one broadcast each), so every rank takes each branch alike,
    and at the end ``x`` is checked to be bit for bit the same on every
    rank."""
    b = torch.as_tensor(b)
    n = b.shape[0]
    if maxiter is None:
        maxiter = restart
    hooks = _hooks(M, M_data)
    agree = hooks.consensus
    if M is None:
        M = lambda v: v
    elif M_data is not None:
        prec = M
        M = lambda v: prec(M_data, v)
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device)
    have_x = x0 is not None

    scalar = _scalar_type(b)
    bnorm = float(torch.linalg.vector_norm(b))
    tol = max(reltol * bnorm, abstol)
    history: List[float] = []
    iters = 0
    converged = False

    while iters < maxiter and not converged:
        r = b - matvec(x) if (have_x or iters > 0) else b
        beta = float(agree(np.array([float(torch.linalg.vector_norm(r))]))[0])
        if iters == 0:
            history.append(beta)
        if beta <= tol:
            converged = True
            break
        m = min(restart, maxiter - iters)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / beta
        H = np.zeros((m + 1, m), dtype=scalar)
        cs = np.ones(m, dtype=np.float64)
        sn = np.zeros(m, dtype=scalar)
        g = np.zeros(m + 1, dtype=scalar)
        g[0] = beta
        j_done = 0
        for j in range(m):
            w = matvec(M(V[j]))
            w, hcol = _mgs(V, w, j)
            hnorm_t = torch.linalg.vector_norm(w)
            hj = agree(torch.cat([hcol, hnorm_t.to(hcol.dtype)[None]]).cpu()
                       .numpy())
            hnorm = float(abs(hj[-1]))
            H[: j + 1, j] = hj[: j + 1]
            H[j + 1, j] = hnorm
            if hnorm > 0:
                V[j + 1] = w / hnorm
            for i in range(j):  # apply accumulated rotations
                t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -np.conj(sn[i]) * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = t
            cs[j], sn[j] = _givens(H[j, j], H[j + 1, j])
            H[j, j] = cs[j] * H[j, j] + sn[j] * H[j + 1, j]
            H[j + 1, j] = 0.0
            g[j + 1] = -np.conj(sn[j]) * g[j]
            g[j] = cs[j] * g[j]
            j_done = j + 1
            res = abs(g[j + 1])
            history.append(float(res))
            if res <= tol:
                break
        if j_done:
            y = np.linalg.solve(H[:j_done, :j_done], g[:j_done])
            upd = torch.as_tensor(y, dtype=b.dtype, device=b.device) @ V[:j_done]
            x = x + M(upd)
            have_x = True
        iters += j_done
        # declare convergence only on the true residual (restarted cycles then act
        # as iterative refinement around an inexact preconditioner)
        true_res = float(agree(np.array(
            [float(torch.linalg.vector_norm(b - matvec(x)))]))[0])
        history[-1] = true_res
        converged = bool(true_res <= tol)

    hooks.check_replicated(x)
    info = {"resnorm": np.asarray(history, dtype=np.float64), "iters": iters,
            "converged": converged}
    return x, info


def gmres_compiled(matvec: Callable, M: Optional[Callable], b: torch.Tensor,
                   reltol: float = 1e-9, restart: int = 30,
                   maxiter: Optional[int] = None, M_data=None, mv_data=None,
                   m_eps: float = 0.0, inner_dtype=None, mv_data_inner=None,
                   fetch_info: bool = True, escalate: bool = True):
    """Restarted GMRES with CGS2 Arnoldi and true-residual restarts: the
    semantics and iteration counts of the JAX package's ``gmres_compiled``.
    Returns ``(x, info)`` with ``info['iters']``, ``info['resnorm']`` (initial
    and per-cycle true residual norms) and ``info['converged']``; with
    ``fetch_info=False`` ``info`` is ``{"_device": (iters, hist, res, bnorm),
    "reltol": reltol}``, device tensors read by :func:`fetch_gmres_info`
    (nothing is read on the host before).

    ``matvec``/``M`` take ``(data, v)`` when ``mv_data``/``M_data`` is given,
    else ``v``.  When ``mv_data`` is a :class:`~hsolve_torch.ops.sparse.DiaMatrix`
    the restarts' true residual ``b - A x`` is one fused pass of kernel D
    (:func:`~hsolve_torch.ops.sparse.dia_residual`), else ``b - matvec(x)``.
    ``m_eps`` floors a cycle's Givens estimate relative to its starting
    residual, so a cycle restarts once the estimate falls below what the basis
    can deliver.

    Mixed precision: ``inner_dtype="float32"`` (with a float32
    ``mv_data_inner``) runs the Arnoldi cycles (basis, orthogonalization,
    Givens bookkeeping, inner matvecs) in float32 while the solution, the
    residual and the convergence test stay in ``b``'s type; ``M`` then sees
    inner-type vectors inside a cycle and outer-type ones at its end.  With
    ``escalate`` (the default) a second phase in the outer type solves the
    remaining residual system.  Each phase has its own ``maxiter`` budget,
    so ``iters`` may exceed ``maxiter``.

    On a CUDA ``b`` the solve is one CUDA graph, captured at the first call
    (the JAX package's compile) and replayed after: one graph launch, an
    enqueued copy of ``b`` into its input and clones of its outputs, however
    many iterations it takes.  The graph is cached like a jit on the static
    arguments (``matvec``, ``M``, ``restart``, ``maxiter``, ``inner_dtype``,
    ``escalate``, ``m_eps``, ``reltol``, ``b``'s shape, type and device) and
    kept on the operator data it reads: on ``M_data`` (else ``mv_data``,
    else ``matvec``), holding ``mv_data`` and ``mv_data_inner``, so a new
    factorization captures anew and a freed one frees its graph.  A matvec or
    preconditioner that cannot be captured (a host read, a host-to-device
    copy) raises; nothing falls back to a host loop.

    ``M_data`` may be a mesh factor's solve data
    (:class:`~hsolve_torch.parallel.sharded.MeshSolveData`, every rank
    calling with its replicated ``b``).  On the card each rank captures and
    replays its own graph, the preconditioner's sums over the ranks inside
    it; that needs NCCL (its communicator is set up before the capture),
    and any other backend raises (:func:`gmres_host_driven` takes it).  On
    the CPU every rank runs the host program.  No branch reads a value that
    another rank computed: every condition comes from vectors that are bit
    for bit the same on every rank, so the ranks take each branch, and issue
    each collective, alike.  With ``fetch_info`` ``x`` is then checked to
    be the same on every rank (a collective and a host read); with
    ``fetch_info=False`` the caller checks it (``M_data.check_replicated``)."""
    if maxiter is None:
        maxiter = restart
    b = torch.as_tensor(b)
    hooks = _hooks(M, M_data)
    args = (matvec, M, float(reltol), int(restart), int(maxiter), M_data,
            mv_data, float(m_eps), inner_dtype, mv_data_inner, bool(escalate))
    if b.device.type == "cuda":
        hooks.prepare_graph(b.device)
        x, packed = _graph_for(b, *args).solve(b)
    else:
        prog = _Program(b, *args)
        prog.run_host()
        x, packed = prog.x_out, prog.packed
    info = {"_device": _device_info(packed), "reltol": reltol}
    if not fetch_info:
        return x, info
    hooks.check_replicated(x)
    return x, fetch_gmres_info(info)


def fetch_gmres_info(info: dict) -> dict:
    """Resolve a ``fetch_info=False`` result of :func:`gmres_compiled` into
    the standard info dict: one device->host copy."""
    if "_device" not in info:
        return info
    iters, hist, res, bnorm = info["_device"]
    vals = torch.cat([t.reshape(-1).to(torch.float64)
                      for t in (iters, res, bnorm, hist)]).cpu().numpy()
    it = int(vals[0])
    return {"resnorm": vals[3:][: it + 1], "iters": it,
            "converged": bool(vals[1] <= max(info["reltol"] * float(vals[2]),
                                             0.0))}


def gmres_host_driven(matvec: Callable, M: Optional[Callable], b: torch.Tensor,
                      reltol: float = 1e-9, restart: int = 30,
                      maxiter: Optional[int] = None, M_data=None,
                      mv_data=None, m_eps: float = 0.0, inner_dtype=None,
                      mv_data_inner=None, escalate: bool = True):
    """:func:`gmres_compiled`'s functions launched eagerly, the host reading
    the loop's flags after every step and cycle (:func:`_Program.run_host`):
    on the CPU the same run as ``gmres_compiled``, on the card the yardstick
    its graph is held to, and the solve of a mesh factor over a backend whose
    collectives a graph cannot capture (gloo); ``x`` is then checked to be
    the same on every rank.  Returns ``(x, info)`` as ``gmres_compiled``
    with ``fetch_info=True``."""
    if maxiter is None:
        maxiter = restart
    prog = _Program(torch.as_tensor(b), matvec, M, float(reltol), int(restart),
                    int(maxiter), M_data, mv_data, float(m_eps), inner_dtype,
                    mv_data_inner, bool(escalate))
    prog.run_host()
    _hooks(M, M_data).check_replicated(prog.x_out)
    return prog.x_out, fetch_gmres_info(
        {"_device": _device_info(prog.packed), "reltol": reltol})


def _device_info(packed: torch.Tensor):
    """``(iters, hist, res, bnorm)`` as views of the packed output ``[iters,
    res, bnorm, hist...]``."""
    return packed[0], packed[3:], packed[1], packed[2]


def _residual(mv: Callable, mv_data, b: torch.Tensor) -> Callable:
    if isinstance(mv_data, DiaMatrix):
        return lambda x: dia_residual(mv_data, x, b)
    return lambda x: b - mv(x)


class _Phase:
    """One run of the restart cycles (``hsolve/krylov.py:_gmres_cycles``) on
    static buffers: its right-hand side ``b``, ``x``, the residual ``r``, the
    scalars ``sc``, the history ``hist [maxiter + 1]`` and the Arnoldi state
    ``s`` (basis, Givens state and the int32 loop state) in the cycles' type.
    Its four parts are the bodies of JAX's loops: :meth:`pre` (the carry's
    start), :meth:`start` and :meth:`end` (a cycle's head and tail around its
    steps) and :meth:`step` (``inner_body``).  A cycle starts from the true
    residual ``r`` cast to the cycles' type and adds ``M(y V)`` cast back to
    ``b``'s type; its floor is ``max(tol, m_eps beta)`` in the inner real
    type, and a step runs while JAX's ``inner_cond`` holds: ``j < m``, the
    estimate above the floor, ``it + j < maxiter``."""

    def __init__(self, mv_i, prec, resid, b, reltol, restart, maxiter, m_eps,
                 inner_dtype, rhs=None, escalate_from=None):
        odt = b.dtype
        self.dt = odt if inner_dtype is None else inner_dtype
        ordt = torch.empty(0, dtype=odt).real.dtype
        dev = b.device
        self.mv_i, self.prec, self.resid = mv_i, prec, resid
        self.b, self.rhs, self.escalate_from = b, rhs, escalate_from
        self.m_eps, self.m = m_eps, restart
        self.x = torch.zeros_like(b)
        self.r = torch.zeros_like(b)
        self.sc = torch.zeros(gc.SC_LEN, dtype=ordt, device=dev)
        if reltol is not None:
            self.sc[gc.RELTOL] = reltol
        self.hist = torch.zeros(maxiter + 1, dtype=ordt, device=dev)
        self.s = arnoldi_state(restart, b.shape[0], self.dt, dev)
        self.s.loop[MAXITER] = maxiter
        # JAX budgets up to maxiter cycles (a done flag ends the loop)
        self.s.loop[NCYC] = maxiter

    def tensors(self):
        s = self.s
        return [self.b, self.x, self.r, self.sc, self.hist, s.V, s.H, s.cs,
                s.sn, s.g, s.hc, s.st, s.y, s.part, s.ticket, s.vj, s.floor,
                s.loop]

    def pre(self):
        if self.rhs is not None:
            self.b.copy_(self.rhs())
        torch.linalg.vector_norm(self.b, out=self.sc[gc.BNORM])
        if self.escalate_from is not None:
            gc.gmres_escalate(self.escalate_from.sc, self.sc)
        self.x.zero_()
        self.r.copy_(self.b)
        gc.gmres_init(self.sc, self.hist, self.s.loop)

    def start(self):
        gc.gmres_cycle_start(self.r, self.sc, self.s, self.m_eps)

    def step(self):
        w = self.mv_i(self.prec(self.s.vj)).to(self.dt).contiguous()
        arnoldi_step(self.s, w)

    def end(self):
        upd = self.s.y @ self.s.V[: self.m]
        self.x.add_(self.prec(upd).to(self.x.dtype))
        self.r.copy_(self.resid(self.x))
        torch.linalg.vector_norm(self.r, out=self.sc[gc.BETA])
        gc.gmres_cycle_end(self.sc, self.hist, self.s.loop)


class _Program:
    """``gmres_compiled`` on static buffers: one :class:`_Phase`, or two
    when the solve escalates (``hsolve/krylov.py:_gmres_escalated``: float32
    cycles, then a phase in ``b``'s type on ``b - A x`` at ``reltol2 =
    reltol ||b|| / ||b - A x||`` with ``m_eps = 0``; ``x += x2``, the
    iterations add up, the history is phase 1's ``[maxiter + 1]`` block
    followed by phase 2's entries after its first, the residual is phase
    2's), and :meth:`post`, which writes ``x_out`` and the packed output
    ``[iters, res, bnorm, hist...]``."""

    def __init__(self, b, matvec, M, reltol, restart, maxiter, M_data,
                 mv_data, m_eps, inner_dtype, mv_data_inner, escalate,
                 static_b=False):
        mv = (lambda v: matvec(mv_data, v)) if mv_data is not None else matvec
        mv_i = (lambda v: matvec(mv_data_inner, v)) \
            if mv_data_inner is not None else mv
        if M is None:
            prec = lambda v: v
        elif M_data is not None:
            prec = lambda v: M(M_data, v)
        else:
            prec = M
        idt = None if inner_dtype is None else torch_dtype(inner_dtype)
        self.b = torch.empty_like(b) if static_b else b
        p1 = _Phase(mv_i, prec, _residual(mv, mv_data, self.b), self.b,
                    reltol, restart, maxiter, m_eps, idt)
        self.phases = [p1]
        ordt = p1.sc.dtype
        if idt is not None and escalate:
            b2 = torch.zeros_like(b)
            r1 = _residual(mv, mv_data, self.b)
            self.phases.append(_Phase(
                mv, prec, _residual(mv, mv_data, b2), b2, None, restart,
                maxiter, 0.0, None, rhs=lambda: r1(p1.x), escalate_from=p1))
            self.x_out = torch.zeros_like(b)
            nh = 2 * maxiter + 1
        else:
            self.x_out = p1.x
            nh = maxiter + 1
        self.packed = torch.zeros(3 + nh, dtype=ordt, device=b.device)

    def post(self):
        p1, pn = self.phases[0], self.phases[-1]
        it = p1.s.loop[IT:IT + 1]
        hist = [p1.hist]
        if len(self.phases) == 2:
            torch.add(p1.x, pn.x, out=self.x_out)
            it = it + pn.s.loop[IT:IT + 1]
            hist.append(pn.hist[1:])
        torch.cat([it.to(self.packed.dtype), pn.sc[gc.BETA:gc.BETA + 1],
                   p1.sc[gc.BNORM:gc.BNORM + 1], *hist], out=self.packed)

    def tensors(self):
        return [t for p in self.phases for t in p.tensors()] + [
            self.b, self.x_out, self.packed]

    def run_host(self):
        """The host-driven loop: each part launched eagerly, the host
        reading the cycle loop's go flag and the step loop's done flag
        (``gmres_set_cond``'s plain version)."""
        for ph in self.phases:
            ph.pre()
            while gc.go_on(ph.s.loop, GO):
                ph.start()
                while gc.go_on(ph.s.loop, DONE, negate=True):
                    ph.step()
                ph.end()
        self.post()


class _GraphSolve:
    """A :class:`_Program` captured as one :class:`SolveGraph`, with the
    static input ``b`` and outputs ``x_out`` and ``packed``; it keeps the
    program's buffers and the operator data it reads, not the program's
    closures (so that the holder's lifetime ends the graph's)."""

    def __init__(self, prog: _Program, keep):
        self.b, self.x_out, self.packed = prog.b, prog.x_out, prog.packed
        self.keep = keep
        self.graph = gc.SolveGraph(
            [(ph.s.loop, ph.pre, ph.start, ph.step, ph.end)
             for ph in prog.phases], prog.post, prog.tensors(), prog.b.device)

    def solve(self, b: torch.Tensor):
        self.b.copy_(b)
        self.graph.launch()
        return self.x_out.clone(), self.packed.clone()


_CACHE = "_hs_gmres_graphs"


def _graph_for(b, matvec, M, reltol, restart, maxiter, M_data, mv_data, m_eps,
               inner_dtype, mv_data_inner, escalate) -> _GraphSolve:
    """The cached graph of this solve's static arguments (captured on a
    miss, see :func:`gmres_compiled`)."""
    # inner_dtype as given (converting it would issue a torch operation)
    key = (matvec, M, restart, maxiter, str(inner_dtype), escalate, m_eps,
           reltol, tuple(b.shape), b.dtype, b.device)
    data = (M_data, mv_data, mv_data_inner)
    holder = next(o for o in (M_data, mv_data, matvec) if o is not None)
    try:
        cache = vars(holder).setdefault(_CACHE, {})
    except TypeError:
        raise TypeError(
            f"gmres_compiled keeps its CUDA graph on M_data (else mv_data, "
            f"else matvec) so that it lives no longer than the data it "
            f"reads; a {type(holder).__name__} takes no attributes (pass "
            f"Factorization.solve_data)") from None
    ids = tuple(id(o) for o in data)
    entry = cache.get(key)
    if entry is None or entry.ids != ids:
        cache.pop(key, None)            # the old graph goes first
        prog = _Program(b, matvec, M, reltol, restart, maxiter, M_data,
                        mv_data, m_eps, inner_dtype, mv_data_inner, escalate,
                        static_b=True)
        entry = _GraphSolve(prog, [o for o in data
                                   if o is not None and o is not holder])
        entry.ids = ids
        cache[key] = entry
    return entry


def graph_stats(holder) -> list:
    """The solve graphs kept on ``holder`` (``M_data``, else ``mv_data``,
    else ``matvec``): their private pool's reserved and live bytes, the
    static state's bytes and the parts' launches counted at capture."""
    return [{"pool_bytes": e.graph.pool_bytes,
             "pool_live_bytes": e.graph.pool_live_bytes,
             "state_bytes": e.graph.state_bytes,
             "part_counts": e.graph.part_counts}
            for e in vars(holder).get(_CACHE, {}).values()]
