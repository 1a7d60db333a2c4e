"""The control of restarted GMRES on the device, and the solve as one CUDA
graph (port of the loop control of ``hsolve/krylov.py`` ``_gmres_cycles``,
:215-318, and ``_gmres_escalated``, :321-350, which XLA compiled with the
rest of the solve into one device program).

The loop state of one run of the restart cycles lives in device memory: the
Arnoldi state's int32 ``loop`` (``j``, ``it``, ``maxiter``, the step loop's
done flag, ``cyc``, the cycle budget and the cycle loop's go flag; slots in
:mod:`hsolve_torch.ops.arnoldi`) and ``floor``, and the solution-type
scalars ``sc`` (``||b||``, ``tol``, ``beta``, ``reltol``).  The control
kernels (``csrc/gmres_control.cu``) update it between the torch ops and
kernels of a cycle:

- :func:`gmres_init`: a run's start (tol, the history, the counters, the
  cycle loop's first test);
- :func:`gmres_cycle_start`: ``V[0] = r / beta``, the zeroed Givens state,
  the floor, ``j = 0`` and the step loop's first test;
- :func:`gmres_cycle_end`: ``it += j``, ``hist[it] = beta``, done and the
  cycle loop's test;
- :func:`gmres_escalate`: the escalated phase's ``reltol2``;
- ``gmres_set_cond``: a WHILE node's condition from a flag, a kernel node
  of the composed graph only (its plain version is the host reading the
  flag, :func:`go_on`).

Each wrapper runs its plain torch version for CPU tensors, the host loop's
functions, and launches its kernel for CUDA tensors.  :class:`SolveGraph`
captures the parts of a solve with torch (``CUDAGraph(keep_graph=True)``)
and composes them in nested WHILE nodes driven by those flags
(``hs_gmres_graph``): the host launches it once a solve and reads nothing.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Callable, Dict, List, Sequence

import torch

from hsolve_torch import kernels
from hsolve_torch.ops.arnoldi import CYC, DONE, GO, IT, J, MAXITER, NCYC, \
    Arnoldi
from hsolve_torch.utils.logging import logger

# the slots of ``sc`` (csrc/gmres_loop.cuh)
BNORM, TOL, BETA, RELTOL = range(4)
SC_LEN = 4


def _launch(fn, name: str, dtype: torch.dtype, device, *args) -> None:
    kernels.launch(name, device, *args)
    kernels.count_launch(fn, dtype)


def gmres_init_plain(sc: torch.Tensor, hist: torch.Tensor,
                     loop: torch.Tensor) -> None:
    """In place: ``tol = reltol ||b||``, ``beta = ||b||``, ``hist = [||b||,
    0, ...]``, ``j = it = cyc = 0``, done, and ``go = not (||b|| <= tol) and
    0 < ncycles`` (``sc[BNORM]`` and ``sc[RELTOL]`` given)."""
    bnorm = sc[BNORM].clone()
    tol = sc[RELTOL] * bnorm
    sc[TOL] = tol
    sc[BETA] = bnorm
    hist.zero_()
    hist[0] = bnorm
    loop[J] = 0
    loop[IT] = 0
    loop[CYC] = 0
    loop[DONE] = 1
    loop[GO] = (~(bnorm <= tol) & (loop[NCYC] > 0)).to(torch.int32)


def gmres_init(sc: torch.Tensor, hist: torch.Tensor, loop: torch.Tensor) -> None:
    """Kernel wrapper (see the plain version)."""
    if kernels.on_cpu(sc, hist, loop):
        return gmres_init_plain(sc, hist, loop)
    dt = kernels.value_type(sc, hist)
    kernels.require(sc, "sc", dt, (SC_LEN,))
    kernels.require(hist, "hist", dt)
    kernels.require(loop, "loop", torch.int32)
    _launch(gmres_init, kernels.symbol("hs_gmres_init", dt), dt, sc.device,
            sc.data_ptr(), hist.data_ptr(), loop.data_ptr(), hist.numel())


gmres_init.launches = 0
gmres_init.launches_by_type = {}


def gmres_cycle_start_plain(r: torch.Tensor, sc: torch.Tensor, s: Arnoldi,
                            m_eps: float) -> None:
    """In place on ``s``: ``V[0] = vj = r / beta`` (1 where beta is 0) in
    the cycles' type, ``H = 0``, ``cs = 1``, ``sn = 0``, ``g = [beta, 0,
    ...]``, ``y = 0``, ``floor = max(tol, m_eps beta)`` in the cycles' real
    type, ``j = 0`` and ``done = not (0 < m and beta > floor and it <
    maxiter)``."""
    dt, rdt = s.V.dtype, s.floor.dtype
    beta = sc[BETA]
    v0 = (r / torch.where(beta > 0, beta, torch.ones_like(beta))).to(dt)
    s.V[0] = v0
    s.vj.copy_(v0)
    beta_i = beta.to(rdt)
    s.H.zero_()
    s.cs.fill_(1.0)
    s.sn.zero_()
    s.g.zero_()
    s.g[0] = beta_i
    s.y.zero_()
    fl = torch.maximum(sc[TOL].to(rdt), torch.full_like(beta_i, m_eps) * beta_i)
    s.floor[0] = fl
    s.loop[J] = 0
    go = (beta_i > fl) & (s.loop[IT] < s.loop[MAXITER])
    s.loop[DONE] = (~go).to(torch.int32)


def gmres_cycle_start(r: torch.Tensor, sc: torch.Tensor, s: Arnoldi,
                      m_eps: float) -> None:
    """Kernel wrapper (see the plain version): one launch over ``N``; the
    cycles in the solution's type, or float32 cycles in a float64 solve."""
    if kernels.on_cpu(r, sc, s.V, s.loop):
        return gmres_cycle_start_plain(r, sc, s, m_eps)
    to = kernels.value_type(r, sc)
    ti = kernels.value_type(s.V, s.vj, s.H, s.cs, s.sn, s.g, s.y, s.floor)
    m1, N = s.V.shape
    m = m1 - 1
    if to == ti:
        name = kernels.symbol("hs_gmres_cycle_start", to)
    elif (to, ti) == (torch.float64, torch.float32):
        name = "hs_gmres_cycle_start_mixed"
    else:
        raise TypeError(f"cycles in {ti} inside a {to} solve")
    kernels.require(r, "r", to, (N,))
    kernels.require(sc, "sc", to, (SC_LEN,))
    kernels.require(s.V, "V", ti, (m1, N))
    kernels.require(s.H, "H", ti, (m + 1, m))
    kernels.require(s.loop, "loop", torch.int32)
    _launch(gmres_cycle_start, name, ti, r.device, r.data_ptr(),
            sc.data_ptr(), s.V.data_ptr(), s.vj.data_ptr(), s.H.data_ptr(),
            s.cs.data_ptr(), s.sn.data_ptr(), s.g.data_ptr(), s.y.data_ptr(),
            s.floor.data_ptr(), s.loop.data_ptr(), N, m, float(m_eps))


gmres_cycle_start.launches = 0
gmres_cycle_start.launches_by_type = {}


def gmres_cycle_end_plain(sc: torch.Tensor, hist: torch.Tensor,
                          loop: torch.Tensor) -> None:
    """In place: ``it += j``, ``hist[it] = beta``, ``cyc += 1`` and ``go =
    not (beta <= tol or it >= maxiter or j == 0) and cyc < ncycles``."""
    j = loop[J].clone()
    it = loop[IT] + j
    loop[IT] = it
    beta = sc[BETA]
    hist.index_put_((it.reshape(1).long(),), beta.reshape(1))
    done = (beta <= sc[TOL]) | (it >= loop[MAXITER]) | (j == 0)
    cyc = loop[CYC] + 1
    loop[CYC] = cyc
    loop[GO] = (~done & (cyc < loop[NCYC])).to(torch.int32)


def gmres_cycle_end(sc: torch.Tensor, hist: torch.Tensor,
                    loop: torch.Tensor) -> None:
    """Kernel wrapper (see the plain version)."""
    if kernels.on_cpu(sc, hist, loop):
        return gmres_cycle_end_plain(sc, hist, loop)
    dt = kernels.value_type(sc, hist)
    kernels.require(sc, "sc", dt, (SC_LEN,))
    kernels.require(hist, "hist", dt)
    kernels.require(loop, "loop", torch.int32)
    _launch(gmres_cycle_end, kernels.symbol("hs_gmres_cycle_end", dt), dt,
            sc.device, sc.data_ptr(), hist.data_ptr(), loop.data_ptr(),
            hist.numel())


gmres_cycle_end.launches = 0
gmres_cycle_end.launches_by_type = {}


def gmres_escalate_plain(sc1: torch.Tensor, sc2: torch.Tensor) -> None:
    """In place: ``sc2[RELTOL] = sc1[RELTOL] sc1[BNORM] / sc2[BNORM]`` (1
    where ``sc2[BNORM]``, phase 1's ``||b - A x||``, is 0)."""
    beta1 = sc2[BNORM]
    sc2[RELTOL] = (sc1[RELTOL] * sc1[BNORM]) / torch.where(
        beta1 > 0, beta1, torch.ones_like(beta1))


def gmres_escalate(sc1: torch.Tensor, sc2: torch.Tensor) -> None:
    """Kernel wrapper (see the plain version)."""
    if kernels.on_cpu(sc1, sc2):
        return gmres_escalate_plain(sc1, sc2)
    dt = kernels.value_type(sc1, sc2)
    kernels.require(sc1, "sc1", dt, (SC_LEN,))
    kernels.require(sc2, "sc2", dt, (SC_LEN,))
    _launch(gmres_escalate, kernels.symbol("hs_gmres_escalate", dt), dt,
            sc1.device, sc1.data_ptr(), sc2.data_ptr())


gmres_escalate.launches = 0
gmres_escalate.launches_by_type = {}


def go_on(loop: torch.Tensor, slot: int, negate: bool = False) -> bool:
    """The plain version of ``gmres_set_cond``: a WHILE node's condition,
    ``loop[slot] != 0`` (negated for the step loop's done flag), read on the
    host."""
    return bool(loop[slot]) != negate


def gmres_set_cond():
    """``gmres_set_cond`` runs only as the kernel nodes of a composed graph
    (:class:`SolveGraph`), which count its launches; see :func:`go_on`."""
    raise RuntimeError("gmres_set_cond runs only inside a solve's CUDA graph")


gmres_set_cond.launches = 0
gmres_set_cond.launches_by_type = {}


def gmres_graph():
    """Counts the host's launches of composed solve graphs
    (:meth:`SolveGraph.launch`)."""
    raise RuntimeError("launch a SolveGraph")


gmres_graph.launches = 0
gmres_graph.launches_by_type = {}


# ---------------------------------------------------------------------------
# the solve as one graph
# ---------------------------------------------------------------------------

_LIVE: "weakref.WeakSet[SolveGraph]" = weakref.WeakSet()


class SolveGraph:
    """A solve composed as one CUDA graph.

    ``phases``: per run of the cycles ``(loop, pre, start, step, end)``, the
    loop tensor whose GO and DONE slots drive its WHILE nodes and the four
    parts as callables; ``post``: the part after the last phase; ``keep``:
    the tensors the parts read and write outside the graph's private pool
    (the static state; the caller keeps the operator data alive).  Each part
    is run once on a side stream (the lazy library build, cuBLAS's handles,
    the wrappers' first-call checks), captured by torch into one private
    pool, and cloned into the composed graph; a part that cannot be captured
    raises.  The parts' launches are counted at capture and then multiplied
    by what the device counted: the replays, and per phase its cycles
    (``loop[CYC]``) and steps (``loop[IT]``), summed on the device after
    each replay (:meth:`fold_counts`)."""

    def __init__(self, phases: Sequence[tuple], post: Callable,
                 keep: Sequence[torch.Tensor], device: torch.device):
        self.device = device
        self.keep = list(keep)
        loops = [ph[0] for ph in phases]
        n = len(phases)
        # what the parts read outside the pool lives as long as the graph
        self.acc = torch.zeros(2 * n + 1, dtype=torch.int64, device=device)
        self.acc_idx = torch.tensor([CYC, IT], device=device)

        def post_and_count():
            post()
            self.acc[:-1].add_(torch.cat([lp.index_select(0, self.acc_idx)
                                          for lp in loops]))
            self.acc[-1:].add_(1)

        fns = [f for ph in phases for f in ph[1:]] + [post_and_count]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for fn in fns:
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        self.acc.zero_()        # the warm-up's launches counted as they ran
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved(device)
        a0 = torch.cuda.memory_allocated(device)
        pool = torch.cuda.graph_pool_handle()
        self.parts: List[torch.cuda.CUDAGraph] = []
        self.part_counts: List[Dict[str, int]] = []
        for fn in fns:
            before = kernels.snapshot_counts()
            g = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                with torch.cuda.graph(g, pool=pool):
                    fn()
            finally:
                after = kernels.snapshot_counts()
                kernels.restore_counts(before)
            self.parts.append(g)
            self.part_counts.append(kernels.counts_delta(before, after))
        torch.cuda.synchronize(device)
        self.pool_bytes = torch.cuda.memory_reserved(device) - r0
        self.pool_live_bytes = torch.cuda.memory_allocated(device) - a0
        self.state_bytes = sum(t.numel() * t.element_size() for t in self.keep)
        logger.info("solve graph: %d parts captured, private pool %.1f MiB "
                    "reserved (%.1f MiB live), static state %.1f MiB",
                    len(self.parts), self.pool_bytes / 2 ** 20,
                    self.pool_live_bytes / 2 ** 20, self.state_bytes / 2 ** 20)
        arr = (ctypes.c_void_p * len(self.parts))(
            *[g.raw_cuda_graph() for g in self.parts])
        larr = (ctypes.c_void_p * n)(*[lp.data_ptr() for lp in loops])
        graph, ex = ctypes.c_void_p(), ctypes.c_void_p()
        rc = kernels.lib().hs_gmres_graph(n, arr, larr, ctypes.byref(graph),
                                          ctypes.byref(ex))
        if rc != 0:
            kernels.raise_launch_error("hs_gmres_graph", rc)
        self.graph, self.exec = graph, ex
        self.nphase = n
        _LIVE.add(self)

    def launch(self) -> None:
        """One replay of the whole solve on the current stream."""
        rc = kernels.lib().hs_gmres_graph_launch(
            self.exec, torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            kernels.raise_launch_error("hs_gmres_graph_launch", rc)
        gmres_graph.launches += 1

    def fold_counts(self) -> None:
        """Add the launches of the replays since the last fold to the
        wrappers' counts (one host read of the device's sums)."""
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            acc = self.acc.tolist()
            self.acc.zero_()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        replays = acc[-1]
        if not replays:
            return
        total: Dict[str, int] = {}

        def add(counts, times):
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v * times

        set_cond = 0
        for p in range(self.nphase):
            cycles, steps = acc[2 * p], acc[2 * p + 1]
            pre, start, step, end = self.part_counts[4 * p: 4 * p + 4]
            add(pre, replays)
            add(start, cycles)
            add(end, cycles)
            add(step, steps)
            set_cond += replays + 2 * cycles + steps
        add(self.part_counts[-1], replays)
        total["gmres_set_cond"] = set_cond
        kernels.add_counts(total)

    def zero_counts(self) -> None:
        self.acc.zero_()

    def __del__(self):
        try:
            self.fold_counts()
        except Exception:
            pass
        try:
            kernels.lib().hs_gmres_graph_destroy(self.graph, self.exec)
        except Exception:
            pass


def fold_all_counts() -> None:
    """Fold the launches of every live solve graph's replays into the
    wrappers' counts."""
    for g in list(_LIVE):
        g.fold_counts()


def zero_all_counts() -> None:
    for g in list(_LIVE):
        g.zero_counts()
