"""HSS (hierarchically semi-separable) matrices as batched level arrays (port of
``hsolve/ops/hss.py``).

The JAX package writes every function for one HSS matrix and batches across
fronts with ``jax.vmap``; here every array carries the batch axis explicitly:

- ``D [B, nleaves, ls, ls]``, leaf bases ``U, V [B, nleaves, ls, r]``,
- per internal level: translations ``R, W [B, 2m, r, r]`` and sibling
  couplings ``B12, B21 [B, m, r, r]``,

over a perfect binary cluster tree (:class:`ClusterPlan`, numpy, shared with
the planner) with one static rank cap ``r``.

Three hand kernels serve it, each beside its plain torch version:

- :func:`hss_matvec` (kernel J, ``csrc/hss_matvec.cuh``): the telescoped
  ``y = A x`` / ``A^T x``, all levels in one launch,
- :func:`hss_entries_prepared` (kernel I, ``csrc/hss_entries.cu``): entry
  extraction at the leaf pair's LCA level only, an index block's T and V
  rows read once per level,
- :func:`hss_level_correct` (kernel K, ``csrc/hss_level_correct.cu``): the
  per-level Woodbury correction of :func:`hss_solve`.

The leaf LU, the LU of the 2r x 2r Woodbury cores, the upsweeps and the basis
products are library calls (:mod:`hsolve_torch.ops.dense`, ``torch.matmul``);
the interpolative decompositions run kernel H
(:func:`hsolve_torch.ops.lowrank.cpqr`).

Values are float64, float32 (the JAX bench's device configuration: J, K,
I and H take float32 instances, no TF32, J, K and H computing in float64 on
their float32 operands, J's and K's products on the FP64 tensor cores),
complex128 (the damped Helmholtz system) or complex64 (the bench's complex
device configuration, float32's rules: J, K and H computing in
complex128).  In complex
every product here takes the plain transpose, as the JAX package's do: the
adjoint matvec and solve are ``A^T x`` and ``A^{-T} b``; only the
interpolative decompositions conjugate (the ID of ``A^H``, ``R = Q^H A``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hsolve_torch import kernels
from hsolve_torch.ops import dense as dk
from hsolve_torch.ops.lowrank import interp_decomp
from hsolve_torch.ops.sweep import accumulator


# ---------------------------------------------------------------------------
# cluster planning (numpy; the planner imports these)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """Static symmetric cluster tree: ``nleaves`` (power of two) leaves of uniform
    padded size ``ls``; the root splits between leaves nleaves/2-1 and nleaves/2."""

    ls: int
    depth: int          # number of internal levels (>= 1); nleaves = 2**depth
    n1: int             # actual size of the left half (interior DOFs)
    n2: int             # actual size of the right half (boundary DOFs)

    @property
    def nleaves(self) -> int:
        return 1 << self.depth

    @property
    def half(self) -> int:
        return (self.nleaves // 2) * self.ls

    @property
    def n_pad(self) -> int:
        return self.nleaves * self.ls

    def level_nodes(self, lev: int) -> int:
        """Internal level ``lev`` in 1..depth has this many nodes."""
        return self.nleaves >> lev

    def embed(self) -> np.ndarray:
        """Map padded HSS index -> position in the compact [0, n1+n2) ordering
        (the Schur complement's [int_loc; bnd_loc] order); sentinel n1+n2 on padding."""
        n = self.n1 + self.n2
        idx = np.full(self.n_pad, n, dtype=np.int64)
        idx[: self.n1] = np.arange(self.n1)
        idx[self.half: self.half + self.n2] = self.n1 + np.arange(self.n2)
        return idx


def plan_cluster(n1: int, n2: int, leafsize: int, min_depth: int = 1) -> ClusterPlan:
    """Choose a perfect symmetric cluster tree covering (n1 | n2) with root split
    pinned at the boundary (parity with ``bisection_cluster((n1, n1+n2))``)."""
    side = max(n1, n2, 1)
    per_side = max(1, -(-side // max(leafsize, 1)))
    per_side = 1 << max((per_side - 1).bit_length(), max(min_depth - 1, 0))
    ls = -(-side // per_side)
    ls = max(ls, 1)
    depth = per_side.bit_length()  # per_side = 2**(depth-1); total depth adds the root
    return ClusterPlan(ls=ls, depth=depth, n1=n1, n2=n2)


# ---------------------------------------------------------------------------
# representation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Hss:
    """A batch of HSS matrices on one cluster plan.  ``Rs[i]/Ws[i]/B12s[i]/
    B21s[i]`` describe internal level ``i+1`` (level 1 = parents of leaves,
    level ``depth`` = root): ``Rs[i] [B, 2m, r, r]`` holds the row-basis
    translations of the children of node j at rows ``2j, 2j+1``, ``B12s[i]
    [B, m, r, r]`` the coupling ``A[I_left, I_right] = Uhat_l B12 Vhat_r^T``.
    Every array is stored contiguous (the kernels read them in place)."""

    D: torch.Tensor
    U: torch.Tensor
    V: torch.Tensor
    Rs: List[torch.Tensor]
    Ws: List[torch.Tensor]
    B12s: List[torch.Tensor]
    B21s: List[torch.Tensor]
    plan: ClusterPlan
    _packed: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.D, self.U, self.V = (a.contiguous() for a in (self.D, self.U, self.V))
        for name in ("Rs", "Ws", "B12s", "B21s"):
            setattr(self, name, [a.contiguous() for a in getattr(self, name)])

    @property
    def r(self) -> int:
        return self.U.shape[-1]

    @property
    def B(self) -> int:
        return self.D.shape[0]

    def arrays(self) -> List[torch.Tensor]:
        return [self.D, self.U, self.V, *self.Rs, *self.Ws, *self.B12s, *self.B21s]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Hss":
        """The same plan with ``fn`` applied to every array (along the batch)."""
        return Hss(D=fn(self.D), U=fn(self.U), V=fn(self.V),
                   Rs=[fn(a) for a in self.Rs], Ws=[fn(a) for a in self.Ws],
                   B12s=[fn(a) for a in self.B12s],
                   B21s=[fn(a) for a in self.B21s], plan=self.plan)

    def packed(self):
        """``(Rs, Ws, B12s, B21s)`` each concatenated over the levels along axis 1
        (level-major), cached: the layout kernel J reads."""
        if self._packed is None:
            self._packed = tuple(torch.cat(a, dim=1).contiguous() for a in
                                 (self.Rs, self.Ws, self.B12s, self.B21s))
        return self._packed


def hss_rank(h: Hss) -> int:
    """Max true rank across generators (parity with ``hssrank``): the number of
    not-identically-zero columns."""
    r = 0
    for arr in [h.U, h.V] + h.Rs + h.Ws:
        nz = (arr.abs() > 0).reshape(-1, arr.shape[-1]).any(0)
        r = max(r, int(nz.sum()))
    return r


# ---------------------------------------------------------------------------
# materialized bases, generators, sub-blocks
# ---------------------------------------------------------------------------

def materialize_bases(h: Hss) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per-level full bases ``Ubig[lev] [B, n_pad, r]``: rows of node j at level
    ``lev`` hold its materialized ``Uhat_j`` (lev = 0 are the leaves)."""
    p, Bn, r = h.plan, h.B, h.r
    Ubig = [h.U.reshape(Bn, p.n_pad, r)]
    Vbig = [h.V.reshape(Bn, p.n_pad, r)]
    sz = p.ls
    for i in range(p.depth - 1):
        Uprev = Ubig[-1].reshape(Bn, -1, sz, r)          # [B, 2m, sz, r]
        Vprev = Vbig[-1].reshape(Bn, -1, sz, r)
        Ubig.append((Uprev @ h.Rs[i]).reshape(Bn, p.n_pad, r))
        Vbig.append((Vprev @ h.Ws[i]).reshape(Bn, p.n_pad, r))
        sz *= 2
    return Ubig, Vbig


def generators(h: Hss):
    """Materialized row/col bases of the two root children (parity with
    ``generators(S.A11)``, factorization.jl:129-132): ``(U1, V1, U2, V2)``
    with ``U1 [B, half, r]`` etc."""
    Ubig, Vbig = materialize_bases(h)
    half = h.plan.half
    Ut, Vt = Ubig[-1], Vbig[-1]
    return Ut[:, :half], Vt[:, :half], Ut[:, half:], Vt[:, half:]


def hss_sub(h: Hss, side: int) -> Hss:
    """The root child as an HSS matrix (parity with ``S.A11``/``S.A22``): side 0
    = left (interior block), 1 = right (boundary block).  Needs depth >= 2."""
    p = h.plan
    if p.depth < 2:
        raise ValueError("depth-1 HSS has dense root children")
    m = p.nleaves // 2
    sl = slice(0, m) if side == 0 else slice(m, 2 * m)
    n_half = p.n1 if side == 0 else p.n2
    sub_plan = ClusterPlan(ls=p.ls, depth=p.depth - 1,
                           n1=min(n_half, p.half // 2),
                           n2=max(n_half - p.half // 2, 0))
    Rs, Ws, B12s, B21s = [], [], [], []
    for i in range(p.depth - 1):
        mm = p.level_nodes(i + 1) // 2
        slc = slice(0, mm) if side == 0 else slice(mm, 2 * mm)
        slc2 = slice(0, 2 * mm) if side == 0 else slice(2 * mm, 4 * mm)
        Rs.append(h.Rs[i][:, slc2])
        Ws.append(h.Ws[i][:, slc2])
        B12s.append(h.B12s[i][:, slc])
        B21s.append(h.B21s[i][:, slc])
    return Hss(D=h.D[:, sl], U=h.U[:, sl], V=h.V[:, sl], Rs=Rs, Ws=Ws, B12s=B12s,
               B21s=B21s, plan=sub_plan)


# ---------------------------------------------------------------------------
# matvec (kernel J) and dense reconstruction
# ---------------------------------------------------------------------------

def hss_matvec_plain(h: Hss, x: torch.Tensor, adjoint: bool = False) -> torch.Tensor:
    """``y = A x`` (or ``A^T x``) for ``x [B, n_pad, k]``: telescoped upsweep,
    sibling couplings, downsweep (``hsolve/ops/hss.py:207-242``)."""
    p, Bn, r = h.plan, h.B, h.r
    k = x.shape[-1]
    Vl, Ul = (h.V, h.U) if not adjoint else (h.U, h.V)
    B12s = h.B12s if not adjoint else [B.transpose(-1, -2) for B in h.B21s]
    B21s = h.B21s if not adjoint else [B.transpose(-1, -2) for B in h.B12s]
    Ws = h.Ws if not adjoint else h.Rs
    Rs = h.Rs if not adjoint else h.Ws
    xl = x.reshape(Bn, p.nleaves, p.ls, k)
    xi = [Vl.transpose(-1, -2) @ xl]                           # [B, m0, r, k]
    for i in range(p.depth - 1):
        comb = Ws[i].transpose(-1, -2) @ xi[-1]
        xi.append(comb.reshape(Bn, -1, 2, r, k).sum(2))
    etas = []
    for lev in range(1, p.depth + 1):
        ch = xi[lev - 1].reshape(Bn, -1, 2, r, k)
        e_l = B12s[lev - 1] @ ch[:, :, 1]
        e_r = B21s[lev - 1] @ ch[:, :, 0]
        etas.append(torch.stack([e_l, e_r], dim=2).reshape(Bn, -1, r, k))
    acc = etas[-1]
    for lev in range(p.depth - 1, 0, -1):
        acc = Rs[lev - 1] @ acc.repeat_interleave(2, dim=1) + etas[lev - 1]
    Dop = h.D if not adjoint else h.D.transpose(-1, -2)
    y = Dop @ xl + Ul @ acc
    return y.reshape(Bn, p.n_pad, k)


SMEM_LIMIT = 232448     # dynamic shared memory a CTA may have (H100)
J_CHUNKS = (8, 16, 32)   # kernel J's columns a chunk


def hss_matvec_slots(nleaves: int, depth: int, cs: int) -> int:
    """Node slots (``[r, kc]`` each, for xi and for eta/acc) that one CTA of
    kernel J holds when ``cs`` CTAs share a matrix: its subtree of
    ``nleaves / cs`` leaves up to its root (at most the root's children), and
    one node a level above it."""
    c = cs.bit_length() - 1
    nlc, Ls = nleaves >> c, depth - c
    sub = sum(nlc >> L for L in range(min(Ls, depth - 1) + 1))
    return sub + (depth - 1 - Ls if cs > 1 else 0)


def hss_matvec_ld(kc: int) -> int:
    """Leading dimension (values) of a node slot of ``kc`` columns: 8 mod 16,
    so that an mma fragment's 32 loads of 8-byte values touch every bank
    twice."""
    return kc if kc % 16 == 8 else kc + 8


def hss_matvec_smem(nleaves: int, depth: int, r: int, cs: int, kc: int,
                    itemsize: int = 8) -> int:
    """Bytes of a CTA's state: its slots of ``itemsize``-byte values (the
    type kernel J computes in, :func:`hss_matvec_state_itemsize`)."""
    return (2 * hss_matvec_slots(nleaves, depth, cs) * r * hss_matvec_ld(kc)
            * itemsize)


def hss_matvec_state_itemsize(is_complex: bool) -> int:
    """Bytes of a state value: kernel J computes in float64 for the real
    types and in complex128 for the complex ones (float32 and complex64
    widened as they load, summed in the wide type, rounded once at y)."""
    return 16 if is_complex else 8


def hss_matvec_geometry(B: int, nleaves: int, ls: int, r: int, depth: int,
                        k: int, sms: int = 132, itemsize: int = 8,
                        is_complex: bool = False):
    """Kernel J's launch: ``(cs, kc, groups, smem, threads, rb)``.  ``kc`` columns a
    chunk: the first of 8, 16, 32 that holds ``k``, else 32.  A matrix
    gets up to ``ceil(sms / B)`` CTAs: first column groups (``groups``, each
    takes every groups-th chunk and re-reads the generators, from L2), up to
    one a chunk, then a thread block cluster of ``cs`` CTAs (at most 8 and
    ``nleaves``, never past the count) that split its tree (every cluster
    barrier sits on the path of every chunk).  ``smem``: a CTA's dynamic shared memory for its
    nodes' state, or 0 where that would pass ``SMEM_LIMIT``: the state then
    lives in a scratch region a CTA (L2).  The state holds the type the
    kernel computes in (:func:`hss_matvec_state_itemsize`): float32 values
    (``itemsize`` 4) fill float64's bytes a slot, complex64 and complex128
    values (``is_complex``) twice as many.  ``threads`` a CTA and ``rb``
    8-row blocks a warp's item (each B fragment feeds ``rb / 2`` products),
    the fastest of the forms ``tools/j_breakdown.py`` times: float64 256
    and 2 at rank 32 (4 row blocks a node), else 512 and 2 at one chunk of
    8 columns (the solve's k = 1: more warps on the few matrices of a
    level) and 256 and 4 above; float32, whose 4-byte values widen as they
    load, 512 and 2 at one chunk of 8 columns at any rank, else float64's;
    complex values, whose fragments take twice the registers, 256 and 2,
    but complex64 512 and 2 at one chunk of 8 columns (1.3-1.6x faster at
    r = 192; complex128 there 1.2x slower, its 512-thread form spilling)."""
    del ls  # the leaves' rows stream from global memory
    kc = next((c for c in J_CHUNKS if c >= k), J_CHUNKS[-1])
    chunks = -(-k // kc)
    need = -(-sms // max(B, 1))
    groups = min(chunks, need)
    cs = 1
    while 2 * cs <= min(8, nleaves) and 2 * cs * groups <= need:
        cs *= 2
    groups = max(1, min(chunks, -(-sms // max(B * cs, 1))))
    smem = hss_matvec_smem(nleaves, depth, r, cs, kc,
                           hss_matvec_state_itemsize(is_complex))
    if is_complex:
        form = (512, 2) if kc == 8 and itemsize == 8 else (256, 2)
    elif kc == 8 and (itemsize == 4 or r > 32):
        form = (512, 2)
    else:
        form = (256, 2) if r <= 32 else (256, 4)
    return (cs, kc, groups, smem if smem <= SMEM_LIMIT else 0, *form)


def hss_matvec_launch(h: Hss, x: torch.Tensor, adjoint: bool, cs: int, kc: int,
                      groups: int, smem: int, threads: int,
                      rb: int) -> torch.Tensor:
    """Kernel J at a given geometry (:func:`hss_matvec_geometry`'s, or
    another for ``tools/j_breakdown.py``); ``smem == 0`` puts the state in
    a scratch region a CTA, of the type the kernel computes in."""
    p, Bn, r = h.plan, h.B, h.r
    Rc, Wc, B12c, B21c = h.packed()
    y = torch.empty_like(x)
    nown = hss_matvec_slots(p.nleaves, p.depth, cs)
    ld = hss_matvec_ld(kc)
    state = None if smem else torch.empty(
        Bn * cs * groups * 2 * nown * r * ld, dtype=accumulator(x.dtype),
        device=x.device)
    kernels.launch(kernels.symbol("hs_hss_matvec", x.dtype), x.device,
                   h.D.data_ptr(), h.U.data_ptr(),
                   h.V.data_ptr(), Rc.data_ptr(), Wc.data_ptr(),
                   B12c.data_ptr(), B21c.data_ptr(), x.data_ptr(), y.data_ptr(),
                   None if state is None else state.data_ptr(), Bn, p.nleaves,
                   p.ls, r, p.depth, x.shape[-1], kc, threads, rb, cs, groups,
                   ld, nown,
                   smem, int(adjoint))
    return y


def hss_matvec(h: Hss, x: torch.Tensor, adjoint: bool = False) -> torch.Tensor:
    """Kernel J wrapper (see the plain version): one launch; one CTA or one
    thread block cluster per matrix walks every level over chunks of the
    columns, its nodes' state in shared memory or, where that does not fit,
    in a scratch region a CTA (:func:`hss_matvec_geometry`).  Float64,
    float32, complex64 or complex128 values, one type for ``x`` and every
    generator, the products on the FP64 tensor cores in float64 or
    complex128 (float32 and complex64 widened as they load, ``y`` rounded
    once)."""
    if kernels.on_cpu(x, h.D):
        return hss_matvec_plain(h, x, adjoint)
    p, Bn, r = h.plan, h.B, h.r
    x = x.contiguous()
    k = x.shape[-1]
    dt = kernels.lowrank_type(x, *h.arrays())
    kernels.require(x, "x", dt, (Bn, p.n_pad, k))
    for a in h.arrays():
        kernels.require(a, "hss array", dt)
    if Bn == 0 or k == 0:
        return torch.empty_like(x)
    y = hss_matvec_launch(h, x, adjoint, *hss_matvec_geometry(
        Bn, p.nleaves, p.ls, r, p.depth, k, kernels.sm_count(x.device),
        x.element_size(), dt.is_complex))
    kernels.count_launch(hss_matvec, dt)
    return y


hss_matvec.launches = 0
hss_matvec.launches_by_type = {}


def hss_todense(h: Hss) -> torch.Tensor:
    """Dense reconstruction ``[B, n_pad, n_pad]`` (tests, small blocks and the
    densified children of a dense parent): per level one batched product for
    all sibling pairs, placed through a block view."""
    p, Bn = h.plan, h.B
    n = p.n_pad
    Ubig, Vbig = materialize_bases(h)
    A = h.D.new_zeros((Bn, n, n))
    leaves = torch.arange(p.nleaves, device=A.device)
    A5 = A.view(Bn, p.nleaves, p.ls, p.nleaves, p.ls).permute(0, 1, 3, 2, 4)
    A5[:, leaves, leaves] = h.D
    for lev in range(1, p.depth + 1):
        m = p.level_nodes(lev)
        blk = n // (2 * m)
        Ub = Ubig[lev - 1].reshape(Bn, m, 2, blk, -1)
        Vb = Vbig[lev - 1].reshape(Bn, m, 2, blk, -1)
        up = Ub[:, :, 0] @ h.B12s[lev - 1] @ Vb[:, :, 1].transpose(-1, -2)
        lo = Ub[:, :, 1] @ h.B21s[lev - 1] @ Vb[:, :, 0].transpose(-1, -2)
        Ab = A.view(Bn, 2 * m, blk, 2 * m, blk).permute(0, 1, 3, 2, 4)
        ev = torch.arange(m, device=A.device) * 2
        Ab[:, ev, ev + 1] = up
        Ab[:, ev + 1, ev] = lo
    return A


# ---------------------------------------------------------------------------
# entry extraction (kernel I)
# ---------------------------------------------------------------------------

class EntryFactors(NamedTuple):
    """Per-level entry-evaluation factors (:func:`hss_entry_factors`)."""

    D: torch.Tensor      # [B, nleaves, ls, ls]
    T: torch.Tensor      # [B, depth, n_pad, r] row basis folded with B12/B21
    V: torch.Tensor      # [B, depth, n_pad, r] materialized column bases


def hss_entry_factors(h: Hss) -> EntryFactors:
    """Entry ``S[i, j]`` whose leaf pair has its LCA at level ``lev`` equals
    ``T[lev][i] . Vbig[lev][j]``, where ``T[lev][i]`` folds i's row basis with
    the B12 or B21 of its node (by which child i sits in); computed once per
    matrix (parity with ``hsolve/ops/hss.py:270-290``)."""
    p, Bn, r = h.plan, h.B, h.r
    Ubig, Vbig = materialize_bases(h)
    T = []
    for lev in range(1, p.depth + 1):
        m = p.level_nodes(lev)
        Ub = Ubig[lev - 1].reshape(Bn, m, 2, -1, r)
        T.append(torch.cat([Ub[:, :, 0] @ h.B12s[lev - 1],
                            Ub[:, :, 1] @ h.B21s[lev - 1]], dim=2)
                 .reshape(Bn, p.n_pad, r))
    return EntryFactors(D=h.D, T=torch.stack(T, 1).contiguous(),
                        V=torch.stack(Vbig, 1).contiguous())


def _batch_index(rows: torch.Tensor) -> torch.Tensor:
    return torch.arange(rows.shape[0], device=rows.device).reshape(
        (-1,) + (1,) * (rows.dim() - 1))


def hss_entries_prepared_plain(ef: EntryFactors, rows: torch.Tensor,
                               cols: torch.Tensor) -> torch.Tensor:
    """``S_b[rows[b, j, :], cols[b, j, :]]`` -> ``[B, M, p, q]`` for index
    blocks ``rows [B, M, p]``, ``cols [B, M, q]``: the leaf-D gather where both
    lie in one leaf, else every level's product, selected at the LCA level
    (``hsolve/ops/hss.py:293-312``).  The LCA level is the bit length of
    ``li ^ lj``.  An entry whose row or column lies outside ``[0, n_pad)`` is
    NaN (the JAX function clamps such indices)."""
    D, T, V = ef
    Bn, depth, n_pad, _ = T.shape
    ls = D.shape[-1]
    rows, cols = rows.long(), cols.long()
    bad = ((rows < 0) | (rows >= n_pad))[..., :, None] | \
        ((cols < 0) | (cols >= n_pad))[..., None, :]
    rows, cols = rows.clamp(0, n_pad - 1), cols.clamp(0, n_pad - 1)
    li, lj = rows // ls, cols // ls
    b3 = _batch_index(rows)
    Dflat = D.reshape(Bn, n_pad, ls)
    out = Dflat[b3[..., None], rows[..., :, None], (cols % ls)[..., None, :]]
    x = li[..., :, None] ^ lj[..., None, :]
    out = torch.where(x == 0, out, 0.0)
    lca = torch.zeros_like(x)
    for lev in range(depth):
        lca += (x >> lev) > 0
    for lev in range(1, depth + 1):
        val = T[:, lev - 1][b3, rows] @ V[:, lev - 1][b3, cols].transpose(-1, -2)
        out = torch.where(lca == lev, val, out)
    return out.masked_fill(bad, float("nan"))


def hss_entries_prepared(ef: EntryFactors, rows: torch.Tensor,
                         cols: torch.Tensor) -> torch.Tensor:
    """Kernel I wrapper (see the plain version): one CTA per 64 x 64 tile of
    an index block; per LCA level present, the tile's T and V rows staged
    once in shared memory and multiplied as a small product (or one D load
    per same-leaf entry).  Float64, float32, complex64 or complex128 values
    (a slice of T and V is 256 bytes a row: 32 float64 or complex64, 64
    float32 or 16 complex128 columns)."""
    if kernels.on_cpu(rows, cols, ef.D):
        return hss_entries_prepared_plain(ef, rows, cols)
    D, T, V = ef
    Bn, depth, n_pad, r = T.shape
    ls = D.shape[-1]
    M, p = rows.shape[1], rows.shape[2]
    q = cols.shape[2]
    # the indices are read through their strides (an expanded index block
    # costs no copy)
    rows, cols = rows.to(torch.int64), cols.to(torch.int64)
    dt = kernels.lowrank_type(D, T, V)
    kernels.require(D, "D", dt, (Bn, n_pad // ls, ls, ls))
    kernels.require(T, "T", dt, (Bn, depth, n_pad, r))
    kernels.require(V, "V", dt, (Bn, depth, n_pad, r))
    if tuple(rows.shape) != (Bn, M, p) or tuple(cols.shape) != (Bn, M, q):
        raise ValueError(f"rows {tuple(rows.shape)} / cols {tuple(cols.shape)}: "
                         f"expected [{Bn}, M, p] / [{Bn}, M, q]")
    out = torch.empty((Bn, M, p, q), dtype=D.dtype, device=D.device)
    if out.numel():
        kernels.launch(kernels.symbol("hs_hss_entries", dt), D.device,
                       D.data_ptr(), T.data_ptr(), V.data_ptr(),
                       rows.data_ptr(), cols.data_ptr(), out.data_ptr(),
                       *rows.stride(), *cols.stride(), Bn, M, p, q, n_pad, ls,
                       r, depth)
        kernels.count_launch(hss_entries_prepared, dt)
    return out


hss_entries_prepared.launches = 0
hss_entries_prepared.launches_by_type = {}


def hss_entries(h: Hss, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """One-shot entry extraction; hoist :func:`hss_entry_factors` to extract
    repeatedly from one matrix."""
    return hss_entries_prepared(hss_entry_factors(h), rows, cols)


# ---------------------------------------------------------------------------
# direct compression of dense (padded) matrices
# ---------------------------------------------------------------------------

def _take_rows(A: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``A[..., idx[..., i], :]`` along the second-to-last axis."""
    return torch.gather(A, -2, idx[..., None].expand(*idx.shape, A.shape[-1]))


def hss_compress_dense(A: torch.Tensor, plan: ClusterPlan, atol: float,
                       rtol: float, cap: int) -> Hss:
    """Direct HSS compression of ``A [B, n_pad, n_pad]`` with interpolative
    bases (parity with ``compress`` and ``hsolve/ops/hss.py:325-389``):
    bottom-up row/column IDs of the off-diagonal block rows/columns; every
    coupling is a submatrix of A (``B12 = A[J_l, K_r]``), gathered directly."""
    p = plan
    Bn, n = A.shape[0], p.n_pad
    nl, ls = p.nleaves, p.ls
    At = A.transpose(-1, -2)
    off_diag = 1.0 - torch.eye(nl, dtype=A.dtype, device=A.device)[:, None, :, None]
    rows_work = (A.reshape(Bn, nl, ls, nl, ls) * off_diag).reshape(Bn, nl, ls, n)
    J_loc, U, _ = interp_decomp(rows_work, atol, rtol, cap)
    cols_work = (At.reshape(Bn, nl, ls, nl, ls) * off_diag).reshape(Bn, nl, ls, n)
    K_loc, V, _ = interp_decomp(cols_work, atol, rtol, cap)

    offs = (torch.arange(nl, device=A.device) * ls)[:, None]
    Jg = J_loc.clamp(min=0) + offs                             # [B, nl, r]
    Kg = K_loc.clamp(min=0) + offs
    leaves = torch.arange(nl, device=A.device)
    D = A.reshape(Bn, nl, ls, nl, ls).permute(0, 1, 3, 2, 4)[:, leaves, leaves]
    b3 = _batch_index(Jg)

    Rs, Ws, B12s, B21s = [], [], [], []
    r = U.shape[-1]
    for lev in range(1, p.depth + 1):
        m = nl >> lev
        Jp = Jg.reshape(Bn, m, 2, r)
        Kp = Kg.reshape(Bn, m, 2, r)
        B12s.append(A[b3[..., None], Jp[:, :, 0, :, None], Kp[:, :, 1, None, :]])
        B21s.append(A[b3[..., None], Jp[:, :, 1, :, None], Kp[:, :, 0, None, :]])
        if lev == p.depth:
            Rs.append(A.new_zeros((Bn, 2, r, r)))
            Ws.append(A.new_zeros((Bn, 2, r, r)))
            break
        blk = n // (2 * m)
        col = torch.arange(n, device=A.device)[None, :]
        c0 = (torch.arange(m, device=A.device) * (2 * blk))[:, None]
        cmask = 1.0 - ((col >= c0) & (col < c0 + 2 * blk)).to(A.dtype)  # [m, n]
        Jm = Jg.reshape(Bn, m, 2 * r)
        Km = Kg.reshape(Bn, m, 2 * r)
        rows_sel = A[b3, Jm] * cmask[None, :, None, :]          # [B, m, 2r, n]
        Jsel, T, _ = interp_decomp(rows_sel, atol, rtol, cap)
        Rs.append(T.reshape(Bn, 2 * m, r, r))
        Jg = torch.gather(Jm, -1, Jsel.clamp(min=0))
        cols_sel = At[b3, Km] * cmask[None, :, None, :]
        Ksel, Tw, _ = interp_decomp(cols_sel, atol, rtol, cap)
        Ws.append(Tw.reshape(Bn, 2 * m, r, r))
        Kg = torch.gather(Km, -1, Ksel.clamp(min=0))
    return Hss(D=D, U=U, V=V, Rs=Rs, Ws=Ws, B12s=B12s, B21s=B21s, plan=p)


# ---------------------------------------------------------------------------
# randomized (matrix-free) compression
# ---------------------------------------------------------------------------

# sample(X [B, n_pad, s], adjoint) -> S X or S^T X; blocks(rows [B, M, p],
# cols [B, M, q]) -> the entries [B, M, p, q] (the reference's LinearMap
# closures, factorization.jl:228-235)
Sample = Callable[[torch.Tensor, bool], torch.Tensor]
Blocks = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def hss_randcompress_batched(sample: Sample, blocks: Blocks, plan: ClusterPlan,
                             Om: torch.Tensor, Ps: torch.Tensor, atol: float,
                             rtol: float, cap: int):
    """One pass of the randomized telescoping interpolative HSS construction
    over a batch of operators (parity with ``_hss_randcompress_once`` and
    ``hss_randcompress_batched``, ``hsolve/ops/hss.py:406-517, :547-575``)
    from the two-sided sketches ``Y = S Om``, ``Z = S^T Ps`` (``Om, Ps
    [B, n_pad, s]``, arguments so that the caller decides where the random
    numbers come from; the factorization's have :func:`sample_width`
    columns).  Returns ``(Hss, maxed [B])``, ``maxed`` the largest
    interpolation rank: ``maxed >= cap`` flags rank saturation (the event
    ``randcompress_adaptive`` grows its budget on, factorization.jl:110)."""
    p = plan
    nl, ls, n = p.nleaves, p.ls, p.n_pad
    Bn, s = Om.shape[0], Om.shape[-1]
    dev = Om.device
    Y = sample(Om, False)
    Z = sample(Ps, True)

    leaf_rows = torch.arange(n, device=dev).reshape(1, nl, ls).expand(Bn, nl, ls)
    D = blocks(leaf_rows, leaf_rows)                            # [B, nl, ls, ls]
    Oml = Om.reshape(Bn, nl, ls, s)
    Psl = Ps.reshape(Bn, nl, ls, s)
    Yl = Y.reshape(Bn, nl, ls, s) - D @ Oml
    Zl = Z.reshape(Bn, nl, ls, s) - D.transpose(-1, -2) @ Psl
    J_loc, U, rku = interp_decomp(Yl, atol, rtol, cap)
    K_loc, V, rkv = interp_decomp(Zl, atol, rtol, cap)
    r = U.shape[-1]
    maxed = torch.maximum(rku.amax(-1), rkv.amax(-1))

    offs = (torch.arange(nl, device=dev) * ls)[:, None]
    Jc, Kc = J_loc.clamp(min=0), K_loc.clamp(min=0)
    Jg, Kg = Jc + offs, Kc + offs
    Ysel, Zsel = _take_rows(Yl, Jc), _take_rows(Zl, Kc)         # [B, nl, r, s]
    Uloc, Vloc = _take_rows(U, Jc), _take_rows(V, Kc)           # [B, nl, r, r]
    OmP = V.transpose(-1, -2) @ Oml                             # [B, nl, r, s]
    PsP = U.transpose(-1, -2) @ Psl

    Rs, Ws, B12s, B21s = [], [], [], []
    for lev in range(1, p.depth + 1):
        m = nl >> lev
        Jp = Jg.reshape(Bn, m, 2, -1)
        Kp = Kg.reshape(Bn, m, 2, -1)
        B12 = blocks(Jp[:, :, 0], Kp[:, :, 1])                  # [B, m, r, r]
        B21 = blocks(Jp[:, :, 1], Kp[:, :, 0])
        B12s.append(B12)
        B21s.append(B21)
        if lev == p.depth:
            Rs.append(Om.new_zeros((Bn, 2, r, r)))
            Ws.append(Om.new_zeros((Bn, 2, r, r)))
            break

        def pair(A):
            A2 = A.reshape(Bn, m, 2, *A.shape[2:])
            return A2[:, :, 0], A2[:, :, 1]

        Y1, Y2 = pair(Ysel)
        Z1, Z2 = pair(Zsel)
        U1, U2 = pair(Uloc)
        V1, V2 = pair(Vloc)
        O1, O2 = pair(OmP)
        P1, P2 = pair(PsP)
        B12t, B21t = B12.transpose(-1, -2), B21.transpose(-1, -2)
        # candidate panels: selected child residuals minus the (exact)
        # sibling-coupling action
        Yp = torch.cat([Y1 - U1 @ (B12 @ O2), Y2 - U2 @ (B21 @ O1)], dim=2)
        Zp = torch.cat([Z1 - V1 @ (B21t @ P2), Z2 - V2 @ (B12t @ P1)], dim=2)
        Jsel, T, rkt = interp_decomp(Yp, atol, rtol, cap)
        Ksel, Tw, rkw = interp_decomp(Zp, atol, rtol, cap)
        maxed = torch.maximum(maxed, torch.maximum(rkt.amax(-1), rkw.amax(-1)))
        Rs.append(T.reshape(Bn, 2 * m, r, r))
        Ws.append(Tw.reshape(Bn, 2 * m, r, r))
        Jsc, Ksc = Jsel.clamp(min=0), Ksel.clamp(min=0)
        Jg = torch.gather(Jg.reshape(Bn, m, 2 * r), -1, Jsc)
        Kg = torch.gather(Kg.reshape(Bn, m, 2 * r), -1, Ksc)
        Tt, Tb = T[:, :, :r], T[:, :, r:]
        Wt, Wb = Tw[:, :, :r], Tw[:, :, r:]
        Uloc = _take_rows(torch.cat([U1 @ Tt, U2 @ Tb], dim=2), Jsc)
        Vloc = _take_rows(torch.cat([V1 @ Wt, V2 @ Wb], dim=2), Ksc)
        Ysel = _take_rows(Yp, Jsc)
        Zsel = _take_rows(Zp, Ksc)
        OmP = Wt.transpose(-1, -2) @ O1 + Wb.transpose(-1, -2) @ O2
        PsP = Tt.transpose(-1, -2) @ P1 + Tb.transpose(-1, -2) @ P2
    h = Hss(D=D, U=U, V=V, Rs=Rs, Ws=Ws, B12s=B12s, B21s=B21s, plan=p)
    return h, maxed


def sample_width(plan: ClusterPlan, cap: int, kest: int = -1,
                 stepsize: int = 16) -> int:
    """Sketch columns of :func:`hss_randcompress_batched`: ``s >= cap + slack``
    (ranks are capped at ``cap``, so a wider sample reveals nothing more),
    at most ``n_pad``."""
    slack = max(stepsize, 8)
    return min(max(kest + slack if kest > 0 else 0, cap + slack), plan.n_pad)


def hss_randcompress(sample: Sample, blocks: Blocks, plan: ClusterPlan,
                     sketch: Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]],
                     atol: float, rtol: float, cap: int, kest: int = -1,
                     stepsize: int = 16, max_tries: int = 3) -> Hss:
    """Adaptive randomized construction (parity with ``randcompress_adaptive``
    and ``hsolve/ops/hss.py:520-544``): sample with s columns, rebuild with
    twice as many while some interpolation rank fills the sample budget.
    ``sketch(t, s)`` returns the try-``t`` sketches ``(Om, Ps)``, each
    ``[B, n_pad, s]``."""
    s = (kest if kest > 0 else max(cap // 2, 16)) + stepsize
    h = None
    for t in range(max_tries):
        s_eff = min(s, plan.n_pad)
        Om, Ps = sketch(t, s_eff)
        h, maxed = hss_randcompress_batched(sample, blocks, plan, Om, Ps,
                                            atol, rtol, cap)
        mx = int(maxed.max())
        if mx < min(s_eff - stepsize // 2, cap) or s_eff >= plan.n_pad \
                or mx >= cap:
            break
        s = 2 * s
    return h


# ---------------------------------------------------------------------------
# telescoping Woodbury factorization (the ULV-solve equivalent)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HssSolver:
    """Factored form of a batch of HSS matrices: leaf LU + one rank-2r Woodbury
    correction per level (parity with the reference's ULV ``\\``,
    blockmatrix.jl:139-142, factornode.jl:72)."""

    h: Hss
    D_lu: torch.Tensor           # [B, nleaves, ls, ls]
    D_piv: torch.Tensor          # [B, nleaves, ls] int64 row permutation
    Phis: List[torch.Tensor]     # level l: [B, n_pad, r]  (A_child^{-1} Uhat_child)
    cores_lu: List[torch.Tensor]   # level l: [B, m, 2r, 2r]
    cores_piv: List[torch.Tensor]  # level l: [B, m, 2r] int64
    PhisT: List[torch.Tensor]
    coresT_lu: List[torch.Tensor]
    coresT_piv: List[torch.Tensor]


def _upsweep(h: Hss, Y: torch.Tensor, to_level: int, adjoint: bool) -> torch.Tensor:
    """``V_hat^T Y`` (or ``U_hat^T Y``) per node at ``to_level``: [B, m, r, k]."""
    p, Bn = h.plan, h.B
    k = Y.shape[-1]
    base = h.V if not adjoint else h.U
    Ws = h.Ws if not adjoint else h.Rs
    xi = base.transpose(-1, -2) @ Y.reshape(Bn, p.nleaves, p.ls, k)
    for i in range(to_level):
        comb = Ws[i].transpose(-1, -2) @ xi
        xi = comb.reshape(Bn, -1, 2, *comb.shape[2:]).sum(2)
    return xi


def _leaf_solve(sol: HssSolver, X: torch.Tensor, adjoint: bool) -> torch.Tensor:
    p, Bn = sol.h.plan, sol.h.B
    k = X.shape[-1]
    Xl = X.reshape(Bn, p.nleaves, p.ls, k)
    if not adjoint:
        Yl = dk.lu_solve(sol.D_lu, sol.D_piv, Xl)
    else:
        Yl = dk.lu_solve_right(sol.D_lu, sol.D_piv,
                               Xl.transpose(-1, -2)).transpose(-1, -2)
    # a fresh row-major buffer: kernel K corrects it in place
    return Yl.reshape(Bn, p.n_pad, k).contiguous()


def hss_level_correct_plain(Y: torch.Tensor, xi: torch.Tensor, Bl: torch.Tensor,
                            Br: torch.Tensor, lu: torch.Tensor, piv: torch.Tensor,
                            Phi: torch.Tensor, transpose: bool) -> torch.Tensor:
    """One Woodbury correction, in place on ``Y [B, n_pad, k]``:
    ``eta = [op(Bl) xi_b; op(Br) xi_a]`` per node from the children's upsweep
    ``xi [B, 2m, r, k]`` (``op`` transposes when ``transpose``), ``w = M^{-1}
    eta`` with the core LU ``(lu [B, m, 2r, 2r], piv)``, and
    ``Y_child -= Phi_child w_child`` for both children
    (``hsolve/ops/hss.py:641-658``)."""
    Bn, n_pad, k = Y.shape
    m, r = Bl.shape[1], Bl.shape[-1]
    xi2 = xi.reshape(Bn, m, 2, r, k)
    if transpose:
        Bl, Br = Bl.transpose(-1, -2), Br.transpose(-1, -2)
    eta = torch.cat([Bl @ xi2[:, :, 1], Br @ xi2[:, :, 0]], dim=2)
    w = dk.lu_solve(lu, piv, eta)
    blk = n_pad // (2 * m)
    Yb = Y.view(Bn, 2 * m, blk, k)
    Yb -= Phi.reshape(Bn, 2 * m, blk, r) @ w.reshape(Bn, 2 * m, r, k)
    return Y


# kernel K's geometry (csrc/hss_level_correct.cu).  k = 1: one CTA per node,
# the LU through a ring of 3 tiles of 32 rows by up to 64 columns.  k > 1: a
# thread block cluster of cs CTAs per node, nc right-hand sides each, every
# operand tile (up to 64 rows by 32 columns) multicast into a ring of
# `stages` stages of 64 x 32 values (one TMA box); w [2r, nc + 4] stays
# resident in the type the kernel computes in.
HSS_CORRECT_PANEL, HSS_CORRECT_TILE_COLS = 32, 64
HSS_CORRECT_STAGE = 64 * 32         # values per stage of the k > 1 ring
HSS_CORRECT_MAX_COLS = 32           # right-hand sides per CTA, at most
HSS_CORRECT_MAX_COLS_COMPLEX = 16   # complex: fragments of two parts
HSS_CORRECT_MAX_CLUSTER = 16        # CTAs per cluster (non-portable above 8)
HSS_CORRECT_MAX_SMEM = 227 * 1024   # a Hopper CTA's shared memory
# the operands kernel K copies with cp.async (not a tensor map, not 16-byte
# chunks): bits of level_correct_cp_async's mask, the kernel's K_CPA_*
# (csrc/hss_level_correct.cu; a test holds the two equal)
HSS_CORRECT_CPA = {"couplings": 1, "lu": 2, "phi": 4}


def level_correct_tiles(r2: int) -> int:
    """Tiles of a ``r2 x r2`` core's LU that kernel K streams: per 32-row
    panel its off-diagonal tiles (up to 64 columns each) and its diagonal
    block, for the lower triangle and again for the upper one."""
    P, W = HSS_CORRECT_PANEL, HSS_CORRECT_TILE_COLS
    n = 0
    for p0 in range(0, r2, P):
        n += -(-p0 // W) + 1 + -(-max(r2 - p0 - P, 0) // W) + 1
    return n


def level_correct_block_tiles(r: int, blk: int) -> int:
    """Tiles of one node that the k > 1 kernel streams, each up to 64 rows
    by a chunk of 32 columns: eta's rows of op(Bl) and op(Br), the LU's
    (right-looking: per 32-row panel its diagonal block and the tiles of its
    columns below, then above, the diagonal), and Phi's rows of both
    children."""
    R, P = 64, HSS_CORRECT_PANEL
    n = 2 * -(-r // P) * (-(-r // R) + -(-blk // R))
    for p0 in range(0, 2 * r, P):
        n += 2 + -(-max(2 * r - p0 - P, 0) // R) + -(-p0 // R)
    return n


def level_correct_itemsizes(dtype: torch.dtype) -> Tuple[int, int]:
    """Bytes of an operand value of kernel K and of a value it computes in:
    float32 operands are computed in float64 and complex64 ones in
    complex128 (widened as they are read, F4's rule: a 32-bit solve with a
    2r x 2r core's LU lands cond(core) epsilons off), float64 and
    complex128 in their own type: the solve sweeps' accumulator."""
    return dtype.itemsize, accumulator(dtype).itemsize


def level_correct_smem(r: int, nc: int, stages: int, itemsize: int = 8,
                       acc_itemsize: int = 8) -> int:
    """Dynamic shared memory of a CTA of the k > 1 kernel: the ring of
    ``itemsize``-byte operand values; w [2r, nc + 4] (eta, then the solve's
    right-hand sides: eta's products read xi from device memory), a
    diagonal block's 32 x 33 copy in ``acc_itemsize``-byte values; the
    stages' two barriers and the core's permutation."""
    return (itemsize * stages * HSS_CORRECT_STAGE
            + acc_itemsize * (2 * r * (nc + 4) + 32 * 33)
            + 16 * stages + 8 * r)


def level_correct_geometry(r: int, k: int, nodes: int = 1, sms: int = 132,
                           active: Optional[Callable[[int, int, int], int]] = None,
                           itemsize: int = 8, is_complex: bool = False):
    """``(nc, cs, groups, stages)`` of kernel K's launch for ``k > 1`` over
    ``nodes`` nodes on a card of ``sms`` SMs, for operands of ``itemsize``
    bytes (computed in float64, or complex128 where ``is_complex``): nc
    right-hand sides per CTA, cs CTAs per thread block cluster, ``groups``
    clusters per node and the ring's stages (4, or 3, or 2 where only that
    fits).

    Where every CTA fits on the card at once (``nodes ceil(k / 16) <= sms``)
    the launch is latency-bound: 16 columns a CTA, and one cluster per node
    (up to 16 CTAs) that reads the node's operands once, if the card holds
    all of the clusters at once (``active(nc, cs, stages)``: how many it
    holds; None: assume all), else clusters of 8, else none.  Otherwise it is
    bound by the SMs' throughput: 32 columns a CTA and no cluster (``cs``
    1), since a cluster of 9-16 CTAs of ~220 KB each leaves a GPC's other
    SMs idle (measured on the H100: 1.4-1.7x slower than one CTA per 32
    columns).  Complex values take at most 16 columns a CTA (their
    fragments hold two parts).  Fewer columns where shared memory is short
    with 3 stages (complex128: 8 at r = 192), but a launch bound by the
    SMs' throughput takes complex values' 16 with 2 stages where that fits
    (complex128 at r = 192: 1.3-1.4x faster than 8 with 4 stages, measured
    on the H100 by ``tools/k_breakdown.py``; its latency-bound launches
    lose as much).  Where not even 4 columns fit (complex128 above r =
    568, complex64 above 692, float64 above 1405), ``nc`` is 0: the k = 1
    kernel runs one CTA per node and column (``groups`` k)."""
    M, acc = HSS_CORRECT_MAX_SMEM, 16 if is_complex else 8
    fits = lambda c, s: level_correct_smem(r, c, s, itemsize, acc) <= M
    single = nodes * -(-k // 16) <= sms
    want = 8 if k <= 8 else (16 if single else HSS_CORRECT_MAX_COLS)
    if is_complex:
        want = min(want, HSS_CORRECT_MAX_COLS_COMPLEX)
    least = 2 if is_complex and not single else 3
    nc = next((c for c in (32, 24, 16, 8, 4)
               if c <= want and fits(c, least)), 4)
    stages = max((s for s in range(2, 5) if fits(nc, s)), default=0)
    if not stages:
        return 0, 1, k, 0
    ctas = -(-k // nc)
    if single:
        for cap in (HSS_CORRECT_MAX_CLUSTER, 8):
            cs = min(cap, ctas)
            groups = -(-k // (cs * nc))
            if active is None or active(nc, cs, stages) >= nodes * groups:
                return nc, cs, groups, stages
    return nc, 1, ctas, stages


def level_correct_cp_async(Bl: torch.Tensor, Br: torch.Tensor,
                           lu: torch.Tensor, Phi: torch.Tensor) -> int:
    """The mask (``HSS_CORRECT_CPA``) of kernel K's operands that cannot be
    a tensor map, whose rows (16-byte multiples) or base (16-byte aligned)
    break TMA's rule: a float32 rank not a multiple of 4 (couplings and
    Phi; the LU's rows of 2r values at an odd rank), an odd float64 or
    complex64 rank (couplings and Phi).  The kernel copies their tiles with
    cp.async, one value at a time (the k = 1 kernel: the LU's), each CTA
    its own, so a k > 1 launch with any of them takes no cluster (the
    kernel's launcher runs it with one CTA a cluster: a CTA that copies its
    own tiles could release a stage ahead of its peers, and the cluster's
    leader counts their releases by phase)."""
    def bad(*ts):
        return any(t.shape[-1] * t.element_size() % 16 or t.data_ptr() % 16
                   for t in ts)
    return ((HSS_CORRECT_CPA["couplings"] if bad(Bl, Br) else 0)
            | (HSS_CORRECT_CPA["lu"] if bad(lu) else 0)
            | (HSS_CORRECT_CPA["phi"] if bad(Phi) else 0))


_ACTIVE = {}


def _active_clusters(nc: int, cs: int, stages: int, r: int,
                     dtype: torch.dtype = torch.float64) -> int:
    """How many clusters of kernel K's geometry in value type ``dtype`` the
    card holds at once (asked once per geometry)."""
    key = (r, nc, cs, stages, dtype)
    if key not in _ACTIVE:
        _ACTIVE[key] = getattr(kernels.lib(), kernels.symbol(
            "hs_hss_level_correct_clusters", dtype))(r, nc, cs, stages)
    return _ACTIVE[key]


def level_correct_launch(r: int, k: int, nodes: int, device: torch.device,
                         dtype: torch.dtype = torch.float64):
    """:func:`level_correct_geometry` on ``device`` in value type ``dtype``:
    its SM count and the clusters it holds at once."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    nc, cs, groups, stages = level_correct_geometry(
        r, k, nodes, sms,
        lambda nc, cs, st: _active_clusters(nc, cs, st, r, dtype),
        dtype.itemsize, dtype.is_complex)
    return nc, cs, groups, stages


def hss_level_correct(Y: torch.Tensor, xi: torch.Tensor, Bl: torch.Tensor,
                      Br: torch.Tensor, lu: torch.Tensor, piv: torch.Tensor,
                      Phi: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Kernel K wrapper (see the plain version): k = 1, one CTA per node;
    k > 1, CTAs of up to 32 columns (16 complex), a node's on one thread
    block cluster where the launch fits the card at once
    (:func:`level_correct_geometry`).  Either forms eta, streams the core LU
    through shared memory for the pivoted solve and corrects both
    children's rows of ``Y`` in place.  Every value type takes these two
    kernels, the products on the FP64 tensor cores: float32 and complex64
    operands computed in float64 and complex128, the correction rounded
    once."""
    if kernels.on_cpu(Y, xi, Bl, lu):
        return hss_level_correct_plain(Y, xi, Bl, Br, lu, piv, Phi, transpose)
    Bn, n_pad, k = Y.shape
    m, r = Bl.shape[1], Bl.shape[-1]
    dt = kernels.lowrank_type(Y, xi, Bl, Br, lu, Phi)
    kernels.require(Y, "Y", dt)
    kernels.require(xi, "xi", dt, (Bn, 2 * m, r, k))
    kernels.require(Bl, "Bl", dt, (Bn, m, r, r))
    kernels.require(Br, "Br", dt, (Bn, m, r, r))
    kernels.require(lu, "lu", dt, (Bn, m, 2 * r, 2 * r))
    kernels.require(piv, "piv", torch.int64, (Bn, m, 2 * r))
    kernels.require(Phi, "Phi", dt, (Bn, n_pad, r))
    nc = cs = stages = 0
    cpa = level_correct_cp_async(Bl, Br, lu, Phi)
    if k > 1:
        nc, cs, _, stages = level_correct_launch(r, k, Bn * m, Y.device, dt)
    if Bn * m and k:
        kernels.launch(kernels.symbol("hs_hss_level_correct", dt), Y.device,
                       Y.data_ptr(), xi.data_ptr(), Bl.data_ptr(),
                       Br.data_ptr(), lu.data_ptr(), piv.data_ptr(),
                       Phi.data_ptr(), Bn, m, r, n_pad // (2 * m), k, nc, cs,
                       stages, int(transpose), cpa)
        kernels.count_launch(hss_level_correct, dt)
    return Y


hss_level_correct.launches = 0
hss_level_correct.launches_by_type = {}


def _apply_level_correction(sol: HssSolver, Y: torch.Tensor, lev: int,
                            adjoint: bool) -> torch.Tensor:
    """``Y <- Y - Phi (Btilde M^{-1} (Vtilde^T Y))`` at level ``lev``."""
    h = sol.h
    xi = _upsweep(h, Y, lev - 1, adjoint).contiguous()
    if not adjoint:
        return hss_level_correct(Y, xi, h.B12s[lev - 1], h.B21s[lev - 1],
                                 sol.cores_lu[lev - 1], sol.cores_piv[lev - 1],
                                 sol.Phis[lev - 1], False)
    return hss_level_correct(Y, xi, h.B21s[lev - 1], h.B12s[lev - 1],
                             sol.coresT_lu[lev - 1], sol.coresT_piv[lev - 1],
                             sol.PhisT[lev - 1], True)


def _solve_upto(sol: HssSolver, X: torch.Tensor, upto: int,
                adjoint: bool) -> torch.Tensor:
    Y = _leaf_solve(sol, X, adjoint)
    for lev in range(1, upto + 1):
        Y = _apply_level_correction(sol, Y, lev, adjoint)
    return Y


def hss_factor(h: Hss) -> HssSolver:
    """The telescoping Woodbury factorization, bottom-up: per level, apply the
    lower levels' solver to the materialized child bases, then LU the
    ``2r x 2r`` cores ``M = I + Btilde G`` (and ``N = I + Btilde^T GT`` for the
    adjoint)."""
    p, Bn, r = h.plan, h.B, h.r
    D_lu, D_piv = dk.lu_factor(h.D)
    sol = HssSolver(h=h, D_lu=D_lu.contiguous(), D_piv=D_piv, Phis=[],
                    cores_lu=[], cores_piv=[], PhisT=[], coresT_lu=[],
                    coresT_piv=[])
    Ubig, Vbig = materialize_bases(h)
    eye = torch.eye(2 * r, dtype=h.D.dtype, device=h.D.device)
    for lev in range(1, p.depth + 1):
        m = p.level_nodes(lev)
        Phi = _solve_upto(sol, Ubig[lev - 1], lev - 1, adjoint=False)
        PhiT = _solve_upto(sol, Vbig[lev - 1], lev - 1, adjoint=True)
        G2 = _upsweep(h, Phi, lev - 1, adjoint=False).reshape(Bn, m, 2, r, r)
        GT2 = _upsweep(h, PhiT, lev - 1, adjoint=True).reshape(Bn, m, 2, r, r)
        B12, B21 = h.B12s[lev - 1], h.B21s[lev - 1]
        z = h.D.new_zeros((Bn, m, r, r))
        M = eye + torch.cat([torch.cat([z, B12 @ G2[:, :, 1]], -1),
                             torch.cat([B21 @ G2[:, :, 0], z], -1)], -2)
        N = eye + torch.cat(
            [torch.cat([z, B21.transpose(-1, -2) @ GT2[:, :, 1]], -1),
             torch.cat([B12.transpose(-1, -2) @ GT2[:, :, 0], z], -1)], -2)
        M_lu, M_piv = dk.lu_factor(M)
        N_lu, N_piv = dk.lu_factor(N)
        sol.Phis.append(Phi)
        sol.cores_lu.append(M_lu.contiguous())
        sol.cores_piv.append(M_piv.contiguous())
        sol.PhisT.append(PhiT)
        sol.coresT_lu.append(N_lu.contiguous())
        sol.coresT_piv.append(N_piv.contiguous())
    return sol


def hss_solve(sol: HssSolver, b: torch.Tensor, adjoint: bool = False) -> torch.Tensor:
    """``x = A^{-1} b`` (or ``A^{-T} b``) for ``b [B, n_pad, k]``."""
    return _solve_upto(sol, b, sol.h.plan.depth, adjoint)
