"""The Arnoldi step of restarted GMRES on the device: kernels L and M with their
plain versions (port of ``hsolve/krylov.py`` ``_gmres_cycles``: the step
``inner_body``, :223-267, its test ``inner_cond``, :269-273, and the cycle
end's masked triangular solve, :293-298).

- :func:`arnoldi_step` is the step the GMRES loop runs: one launch of kernel
  L (``csrc/arnoldi_cgs2.cu``) whose tail is kernel M's Givens step, the
  scaling of ``w`` into ``V[j+1]`` (and into ``vj``, the fixed buffer the
  next step's preconditioner reads) and the loop's advance.  It reads its
  loop state from device memory (``loop``: j, it, maxiter; ``floor``), so a
  CUDA graph replays it: the tail evaluates ``inner_cond`` for the next step
  into ``loop[DONE]`` and sets ``j += 1``.
- :func:`arnoldi_cgs2` (kernel L alone) orthogonalizes the step's new vector
  ``w`` against ``V[:j+1]`` by classical Gram-Schmidt applied twice and
  writes the new Hessenberg column ``h1 + h2`` and ``||w||`` to a small
  device buffer.
- :func:`arnoldi_givens` (kernel M alone, ``csrc/arnoldi_givens.cu``)
  applies the earlier Givens rotations to that column, forms the new one,
  updates the rotated right-hand side ``g`` and the residual estimate, sets
  the step's done flag against a floor and a loop test the caller passes,
  and, when the step ends the cycle, solves for the cycle's coefficients
  ``y``.

The last two stay entry points so that each kernel can be read alone; the
step counts one launch of each (``kernels.launch_counts()``) and one of its
own (``arnoldi_step.launches``).  Everything stays on the device in the
cycles' (inner) value type, float32 or float64.  The plain versions are
torch ops in that type, so on the CPU they round as the JAX package's
bookkeeping in that type does.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from hsolve_torch import kernels

THREADS = 512          # kernel L's CTA
MIN_SLICE = 1024       # kernel L: no CTA takes a slice of N below this
SMEM = 230400          # kernel L's shared memory per CTA, bytes
MAX_ROWS = 512         # kernel L's h1/h2 buffers (rows of V)
ROW_BATCH = 64         # kernel L's block reduction of the dots (rows)
MAX_RESTART = 256      # kernel M's restart (its column and scratch)
H100_SMS = 132
# the int32 slots of ``Arnoldi.loop`` (csrc/gmres_loop.cuh)
J, IT, MAXITER, DONE, CYC, NCYC, GO = range(7)
LOOP_LEN = 8


@dataclasses.dataclass
class Arnoldi:
    """The Arnoldi state of one GMRES run (restart ``m``, size ``N``) in the
    cycles' value type; a new cycle overwrites what it reads."""

    V: torch.Tensor        # [m+1, N] the basis
    H: torch.Tensor        # [m+1, m] the rotated Hessenberg matrix
    cs: torch.Tensor       # [m] rotation cosines (real type)
    sn: torch.Tensor       # [m] rotation sines
    g: torch.Tensor        # [m+1] the rotated right-hand side
    hc: torch.Tensor       # [m+1] the step's new column (L's output)
    st: torch.Tensor       # [2] the residual estimate, V[j+1]'s divisor
    y: torch.Tensor        # [m] the cycle's coefficients
    part: torch.Tensor     # kernel L's per-CTA partial sums
    ticket: torch.Tensor   # [1] int32, kernel L's grid-barrier counter and
                           # last-CTA ticket (0 at rest)
    vj: torch.Tensor       # [N] V[j], the next step's input
    floor: torch.Tensor    # [1] the cycle's floor (real type)
    loop: torch.Tensor     # [LOOP_LEN] int32, the loop state (J, IT, ...)

    @property
    def done(self) -> torch.Tensor:
        """[1] int32 view of ``loop[DONE]``: 1 once the cycle takes no
        further step."""
        return self.loop[DONE:DONE + 1]


def cgs2_blocks(N: int, sms: int = H100_SMS) -> int:
    """Kernel L's grid: one CTA per SM (co-resident, as its cooperative
    launch needs), fewer where a slice of N would fall below
    ``MIN_SLICE``."""
    return max(1, min(sms, -(-N // MIN_SLICE)))


def cgs2_slice(N: int, nb: int) -> int:
    """The slice of N each of kernel L's ``nb`` CTAs owns: ``ceil(N / nb)``
    rounded up to a multiple of 4 (a 16-byte boundary in either type)."""
    return -(-(-(-N // nb)) // 4) * 4


def cgs2_max_slice(dtype: torch.dtype) -> int:
    """The largest slice kernel L keeps in shared memory, beside its h1, h2
    and reduction buffers."""
    e = torch.empty(0, dtype=dtype).element_size()
    return SMEM // e - 2 * MAX_ROWS - ROW_BATCH * (THREADS // 32)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_sms(device) -> int:
    """The SM count of a CUDA device (``H100_SMS`` for the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SMS
    return _sms(torch.cuda.current_device() if device.index is None
                else device.index)


def arnoldi_state(m: int, N: int, dtype: torch.dtype, device) -> Arnoldi:
    """A zeroed state for restart ``m`` on vectors of size ``N``; its loop
    stands at j = it = 0 with ``maxiter = m`` and a floor of 0 (one cycle;
    :func:`set_loop` places it elsewhere)."""
    rdt = torch.empty(0, dtype=dtype).real.dtype
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    s = Arnoldi(V=z(m + 1, N), H=z(m + 1, m),
                cs=torch.ones(m, dtype=rdt, device=device), sn=z(m),
                g=z(m + 1), hc=z(m + 1), st=z(2), y=z(m),
                part=z((2 * m + 1) * cgs2_blocks(N, device_sms(device))),
                ticket=z(1, dt=torch.int32), vj=z(N), floor=z(1, dt=rdt),
                loop=z(LOOP_LEN, dt=torch.int32))
    s.loop[MAXITER] = m
    return s


def set_loop(s: Arnoldi, j: int, it: int = 0, maxiter=None,
             floor: float = 0.0) -> None:
    """Place the state's loop at step ``j`` of a cycle after ``it``
    iterations, with budget ``maxiter`` (``it + m`` when None) and the
    cycle's ``floor``; ``vj`` becomes ``V[j]``.  A host write, for checks
    of single steps."""
    m = s.H.shape[1]
    s.loop[J], s.loop[IT] = j, it
    s.loop[MAXITER] = it + m if maxiter is None else maxiter
    s.floor.fill_(floor)
    s.vj.copy_(s.V[j])


def step_cont(s: Arnoldi, j: int) -> bool:
    """The part of ``inner_cond`` after step ``j`` that the loop state
    decides alone: ``j + 1 < m`` and ``it + j + 1 < maxiter`` (host read)."""
    it, maxiter = (int(v) for v in s.loop[IT:MAXITER + 1].tolist())
    return j + 1 < s.H.shape[1] and it + j + 1 < maxiter


def arnoldi_cgs2_plain(s: Arnoldi, w: torch.Tensor, j: int) -> torch.Tensor:
    """In place on ``w`` and ``s.hc``: ``h1 = conj(V[:j+1]) w``, ``w -=
    V[:j+1]^T h1``, the same again for ``h2``; ``hc[:j+1] = h1 + h2``,
    ``hc[j+1] = ||w||``.  Returns ``w``."""
    Vj = s.V[: j + 1]
    h1 = Vj.conj() @ w
    w.sub_(Vj.T @ h1)
    h2 = Vj.conj() @ w
    w.sub_(Vj.T @ h2)
    s.hc[: j + 1] = h1 + h2
    s.hc[j + 1] = torch.linalg.vector_norm(w).to(w.dtype)
    return w


def arnoldi_cgs2(s: Arnoldi, w: torch.Tensor, j: int) -> torch.Tensor:
    """Kernel L wrapper (in place on ``w`` and ``s.hc``; see the plain
    version)."""
    if kernels.on_cpu(s.V, w, s.hc):
        return arnoldi_cgs2_plain(s, w, j)
    dt = kernels.value_type(s.V, w, s.hc, s.part)
    m1, N = s.V.shape
    nb = cgs2_blocks(N, device_sms(w.device))
    if not 0 <= j < m1 - 1 or j + 1 > MAX_ROWS:
        raise ValueError(f"step j={j} outside a basis of {m1} rows (kernel "
                         f"L takes at most {MAX_ROWS})")
    if cgs2_slice(N, nb) > cgs2_max_slice(dt):
        raise ValueError(f"N={N}: kernel L's slice {cgs2_slice(N, nb)} of "
                         f"{nb} CTAs passes its shared memory "
                         f"({cgs2_max_slice(dt)} values)")
    kernels.require(s.V, "V", dt, (m1, N))
    kernels.require(w, "w", dt, (N,))
    kernels.require(s.hc, "hc", dt, (m1,))
    kernels.require(s.part, "part", dt)
    kernels.require(s.ticket, "ticket", torch.int32, (1,))
    if s.V.data_ptr() % 16:
        raise ValueError("V: kernel L reads it with 16-byte loads; its "
                         "storage must start on a 16-byte boundary")
    if s.part.numel() < (2 * (j + 1) + 1) * nb:
        raise ValueError(f"part holds {s.part.numel()} values; step j={j} "
                         f"needs {(2 * (j + 1) + 1) * nb}")
    kernels.launch(kernels.symbol("hs_arnoldi_cgs2", dt), w.device,
                   s.V.data_ptr(), w.data_ptr(), s.hc.data_ptr(),
                   s.part.data_ptr(), s.ticket.data_ptr(), j + 1, N, nb)
    kernels.count_launch(arnoldi_cgs2, dt)
    return w


arnoldi_cgs2.launches = 0
arnoldi_cgs2.launches_by_type = {}


def arnoldi_givens_plain(s: Arnoldi, j: int, floor: float, cont: bool) -> None:
    """In place on ``s``: step ``j``'s rotations, ``H[:, j]``, ``cs[j]``,
    ``sn[j]``, ``g[j:j+2]``, ``st = (|g[j+1]|, ||w|| or 1)``, ``done = not
    (cont and st[0] > floor)``, and, when done, ``y[:j+1] = H[:j+1, :j+1]^-1
    g[:j+1]``, ``y[j+1:] = 0`` (JAX's identity-masked triangular solve).
    Each product, sum, quotient and root is one torch op, in kernel M's order,
    so the two agree bit for bit."""
    col = torch.zeros_like(s.g)
    col[: j + 2] = s.hc[: j + 2]
    cs, sn = s.cs, s.sn
    for i in range(j):
        a, b = col[i].clone(), col[i + 1].clone()
        col[i] = cs[i] * a + sn[i] * b
        col[i + 1] = -sn[i].conj() * a + cs[i] * b
    a, b = col[j].clone(), col[j + 1].clone()
    absa, absb = a.abs(), b.abs()
    denom = torch.sqrt(absa * absa + absb * absb)
    if bool(denom > 0) and bool(absa > 0):
        cs_j = absa / denom
        tiny = torch.finfo(absa.dtype).tiny
        sn_j = (a * b.conj()) / torch.maximum(absa * denom,
                                               torch.full_like(absa, tiny))
    else:
        safe = bool(denom > 0)
        cs_j = torch.full_like(absa, 0.0 if safe else 1.0)
        sn_j = torch.full_like(a, 1.0 if safe else 0.0)
    col[j] = cs_j * a + sn_j * b
    col[j + 1] = 0.0
    s.H[:, j] = col
    cs[j], sn[j] = cs_j, sn_j
    gj = s.g[j].clone()
    gj1 = -sn_j.conj() * gj
    s.g[j + 1] = gj1
    s.g[j] = cs_j * gj
    res = gj1.abs()
    hn = s.hc[j + 1]
    s.st[0] = res
    s.st[1] = hn if bool(hn > 0) else 1.0
    done = not (cont and bool(res > floor))
    s.done[0] = int(done)
    if done:
        # back substitution on the upper triangular H[:j+1, :j+1], one op
        # at a time in kernel M's order
        s.y.zero_()
        for i in range(j, -1, -1):
            acc = s.g[i].clone()
            for k in range(i + 1, j + 1):
                acc = acc - s.H[i, k] * s.y[k]
            s.y[i] = acc / s.H[i, i]


def arnoldi_givens(s: Arnoldi, j: int, floor: float, cont: bool) -> None:
    """Kernel M wrapper (in place on ``s``; see the plain version).
    ``floor`` is a value of the state's real type; ``cont`` says whether the
    loop conditions the caller knows (``j + 1 < m`` and the iteration budget)
    let the cycle go on."""
    if kernels.on_cpu(s.H, s.cs, s.sn, s.g, s.hc, s.st, s.done, s.y):
        return arnoldi_givens_plain(s, j, floor, cont)
    dt = kernels.value_type(s.H, s.cs, s.sn, s.g, s.hc, s.st, s.y)
    m = s.H.shape[1]
    if not 1 <= m <= MAX_RESTART:
        raise ValueError(f"kernel M takes a restart of 1..{MAX_RESTART}, "
                         f"got {m}")
    if not 0 <= j < m:
        raise ValueError(f"step j={j} outside restart {m}")
    kernels.require(s.H, "H", dt, (m + 1, m))
    for name, t, n in (("cs", s.cs, m), ("sn", s.sn, m), ("g", s.g, m + 1),
                       ("hc", s.hc, m + 1), ("st", s.st, 2), ("y", s.y, m)):
        kernels.require(t, name, dt, (n,))
    kernels.require(s.done, "done", torch.int32, (1,))
    kernels.launch(kernels.symbol("hs_arnoldi_givens", dt), s.H.device,
                   s.H.data_ptr(), s.cs.data_ptr(), s.sn.data_ptr(),
                   s.g.data_ptr(), s.hc.data_ptr(), s.st.data_ptr(),
                   s.done.data_ptr(), s.y.data_ptr(), j, m, float(floor),
                   int(bool(cont)))
    kernels.count_launch(arnoldi_givens, dt)


arnoldi_givens.launches = 0
arnoldi_givens.launches_by_type = {}


def arnoldi_step_plain(s: Arnoldi, w: torch.Tensor) -> None:
    """One Arnoldi step on ``s`` after its matvec ``w``, at the loop's step
    j: kernel L's plain version, kernel M's against the floor with ``cont``
    from the loop (:func:`step_cont`), ``V[j+1] = w / st[1]``, ``vj =
    V[j+1]``, ``j += 1``.  ``w`` is left as L leaves it."""
    j = int(s.loop[J])
    cont = step_cont(s, j)
    arnoldi_cgs2_plain(s, w, j)
    arnoldi_givens_plain(s, j, s.floor[0], cont)
    torch.div(w, s.st[1], out=s.V[j + 1])
    s.vj.copy_(s.V[j + 1])
    s.loop[J] = j + 1


def _step_launch(s: Arnoldi, device):
    """The fused launch's arguments for state ``s``, checked once: the state
    of one GMRES run keeps its shapes, types and storage."""
    dt = kernels.value_type(s.V, s.H, s.cs, s.sn, s.g, s.hc, s.st, s.y, s.part,
                            s.vj, s.floor)
    m1, N = s.V.shape
    m = m1 - 1
    nb = cgs2_blocks(N, device_sms(device))
    if not 1 <= m <= min(MAX_RESTART, MAX_ROWS):
        raise ValueError(f"the step takes a restart of 1..{MAX_RESTART}, "
                         f"got {m}")
    if cgs2_slice(N, nb) > cgs2_max_slice(dt):
        raise ValueError(f"N={N}: kernel L's slice {cgs2_slice(N, nb)} of "
                         f"{nb} CTAs passes its shared memory "
                         f"({cgs2_max_slice(dt)} values)")
    kernels.require(s.V, "V", dt, (m1, N))
    kernels.require(s.H, "H", dt, (m + 1, m))
    for name, t, n in (("cs", s.cs, m), ("sn", s.sn, m), ("g", s.g, m + 1),
                       ("hc", s.hc, m + 1), ("st", s.st, 2), ("y", s.y, m),
                       ("vj", s.vj, N), ("floor", s.floor, 1)):
        kernels.require(t, name, dt, (n,))
    kernels.require(s.part, "part", dt)
    kernels.require(s.loop, "loop", torch.int32, (LOOP_LEN,))
    kernels.require(s.ticket, "ticket", torch.int32, (1,))
    if s.V.data_ptr() % 16:
        raise ValueError("V: kernel L reads it with 16-byte loads; its "
                         "storage must start on a 16-byte boundary")
    if s.part.numel() < (2 * m + 1) * nb:
        raise ValueError(f"part holds {s.part.numel()} values; restart {m} "
                         f"needs {(2 * m + 1) * nb}")
    fn = getattr(kernels.lib(), kernels.symbol("hs_arnoldi_step", dt))
    ptrs = (s.V.data_ptr(), s.hc.data_ptr(), s.part.data_ptr(),
            s.ticket.data_ptr(), s.H.data_ptr(), s.cs.data_ptr(),
            s.sn.data_ptr(), s.g.data_ptr(), s.st.data_ptr(), s.y.data_ptr(),
            s.vj.data_ptr(), s.loop.data_ptr(), s.floor.data_ptr())
    return dt, N, m, nb, fn, ptrs


def arnoldi_step(s: Arnoldi, w: torch.Tensor) -> None:
    """One Arnoldi step of a GMRES cycle after its matvec ``w``, at the step
    ``j`` the state's loop holds (see the plain version): on CUDA tensors one
    cooperative launch of kernel L whose tail runs kernel M's step, writes
    ``V[j+1] = w / st[1]`` and ``vj``, and advances the loop; nothing is
    read on the host, so a CUDA graph can replay it.  The kernel leaves
    ``w`` as the matvec gave it (the GMRES loop reads only ``V[j+1]``; the
    plain version leaves it orthogonalized).  The state's operands are
    checked at its first step; each step checks ``w``."""
    if kernels.on_cpu(s.V, w):
        return arnoldi_step_plain(s, w)
    launch = s.__dict__.get("_step")
    if launch is None or launch[0] != s.V.data_ptr():
        launch = (s.V.data_ptr(), _step_launch(s, w.device))
        s.__dict__["_step"] = launch
    dt, N, m, nb, fn, ptrs = launch[1]
    if w.dtype != dt or w.device != s.V.device or w.shape != (N,) \
            or not w.is_contiguous():
        raise ValueError(f"w: expected a contiguous [{N}] {dt} vector on "
                         f"{s.V.device}, got {tuple(w.shape)} {w.dtype} on "
                         f"{w.device}")
    V, hc, part, ticket, H, cs, sn, g, st, y, vj, loop, floor = ptrs
    rc = fn(V, w.data_ptr(), hc, part, ticket, H, cs, sn, g, st, y, vj, loop,
            floor, N, nb, m, torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        kernels.raise_launch_error("hs_arnoldi_step", rc)
    kernels.count_launch(arnoldi_step, dt)
    kernels.count_launch(arnoldi_cgs2, dt)
    kernels.count_launch(arnoldi_givens, dt)


arnoldi_step.launches = 0
arnoldi_step.launches_by_type = {}
