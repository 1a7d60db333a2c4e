"""Host-side symbolic planner (jax-free copy of ``hsolve/planner.py``).

The copy keeps what exact (``swlevel=0``) and low-rank compressed (``hss=False``)
planning run, numpy code unchanged, so its :class:`Plan` equals the JAX
planner's array for array.  ``hss=True`` with any compressed node raises
``NotImplementedError``: the structured (HSS) batches, their cluster plans
(``cplan``, ``n1``, ``n2``) and the cross blocks belong to the port's structured
(HSS) slice.

Instead of the reference's runtime tree recursion (``factorization.jl:14-27``),
the planner turns the elimination tree into a *static, level-synchronous schedule*
of batched fixed-shape device kernels:

- symbolic phase: :func:`hsolve_torch.utils.trees.symfact` + post-order permutation
  (parity with nesteddissection.jl:29-88),
- nodes are grouped by *height* (leaves first, then branches whose children are all
  scheduled earlier); every batch is padded to shared ``(ni_pad, nb_pad)`` so the whole
  batch runs as one batched kernel,
- every sparse submatrix gather ``A[I, J]`` the numeric factorization will need is
  precomputed here as COO (positions, values) into the padded front coordinate system,
  via one native C++ call per batch (the counterpart of the reference's
  ``mygetindex.jl`` sparse-getindex monkey-patch); fronts materialize on device,
- extend-add becomes a per-node *inverse* index map (front position -> child Schur
  position) so device assembly is a gather; the maps are offset identities thanks to
  the ``[int_loc; bnd_loc]`` storage order (factorization.jl:39-41).

Front layout per batch: interior DOFs at rows/cols ``[0, ni)`` padded to ``ni_pad`` with
an identity diagonal (so the batched LU is well-defined on padding), boundary DOFs at
``[ni_pad, ni_pad + nb)`` padded to ``nb_pad`` with zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from hsolve_torch.options import SolverOptions
from hsolve_torch.utils.trees import LocTree, NDTree, permuted, postorder, symfact


def _round_up(x: int, m: int) -> int:
    return int(-(-x // m) * m) if x > 0 else 0


def _cap_rule(opts: SolverOptions, dim: int, lev: Optional[int] = None) -> int:
    """Static rank cap for a compressed batch whose relevant dimension is ``dim``
    at reference recursion level ``lev`` (root = 1).

    ``level_caps`` wins when set; then ``rank_cap``; then ``kest > 0`` - the
    reference's user-provided rank estimate for the randomized compression
    (factorization.jl:102-104) - with one ``stepsize`` of headroom (the
    reference grows its sample budget in ``stepsize`` steps).  The ``dim // 4``
    fallback is a generous over-provision for unknown problems: pair it with
    ``opts.adaptive`` or calibrate."""
    if opts.level_caps and lev is not None and lev >= 1:
        return int(opts.level_caps[min(lev - 1, len(opts.level_caps) - 1)])
    if opts.rank_cap > 0:
        return opts.rank_cap
    if opts.kest > 0:
        return opts.kest + max(opts.stepsize, 0)
    return max(dim // 4, 32)


def _rank_cap(opts: SolverOptions, compress: bool, nodes, levels, ni_pad: int,
              nb_pad: int) -> int:
    """The batch's rank cap: ``min(ni_pad, nb_pad, round_up(cap, rank_pad))``
    on a compressed batch with a boundary, else 0 (the batch stays dense)."""
    if not (compress and nb_pad > 0):
        return 0
    cap = _cap_rule(opts, nb_pad, int(levels[nodes].min()))
    return min(ni_pad, nb_pad, _round_up(cap, opts.rank_pad))


@dataclasses.dataclass
class ChildGroup:
    """One (source batch -> this batch) gather: children living in source batch
    ``src_batch`` at rows ``src_rows`` feed the parents at rows ``dst_rows``."""

    src_batch: int
    src_rows: np.ndarray   # [g] row in the source batch's S stack
    dst_rows: np.ndarray   # [g] row in this batch


@dataclasses.dataclass
class BatchPlan:
    node_ids: np.ndarray       # [B]
    is_leaf: bool
    ni_pad: int
    nb_pad: int
    ni: np.ndarray             # [B] actual interior sizes
    nb: np.ndarray             # [B] actual boundary sizes
    batch_size: int            # B, the number of fronts
    front_pos: np.ndarray      # [nnz] flat positions into the [B, m_pad, m_pad] fronts
    front_vals: np.ndarray     # [nnz] matching values (sparse part + identity padding)
    sperm: np.ndarray          # [B, nb_pad] output permutation to [int_loc; bnd_loc]
    int_ids: np.ndarray        # [B, ni_pad] global (permuted) DOF ids, sentinel N
    bnd_ids: np.ndarray        # [B, nb_pad] global (permuted) DOF ids, sentinel N
    levels: np.ndarray         # [B] reference recursion level (root = 1)
    # [nnz] source index into A_perm.data (-1 for identity padding), or None.
    # When present the numeric phase gathers the front values from a
    # device-resident copy of A.data instead of shipping front_vals over the
    # host link on every (re-)factorization.
    front_src: Optional[np.ndarray] = None
    compress: bool = False     # this batch's fronts get compressed L/R (+HSS S)
    rank_cap: int = 0          # static low-rank cap for compressed batches
    # HSS output planning (compressed batches): this batch's Schur complements are
    # emitted as batched HSS on ``cplan`` with per-node content sizes n1/n2
    cplan: object = None       # ClusterPlan of the emitted S
    n1: Optional[np.ndarray] = None   # [B] len(int_loc) per node
    n2: Optional[np.ndarray] = None   # [B] len(bnd_loc) per node
    # fully-structured batches (both children HSS): child-aligned layout
    structured: bool = False
    cross: Optional[dict] = None      # 8 cross blocks as COO (pos, vals) + per-child sizes
    smap: Optional[np.ndarray] = None  # [B, cplan.n_pad] S-pad -> child-aligned bnd pos
    child_cplans: Optional[tuple] = None  # (left ClusterPlan, right ClusterPlan)
    # branch-only extend-add data (None for the leaf batch):
    sl_pad: int = 0
    sr_pad: int = 0
    map_l: Optional[np.ndarray] = None   # [B, m_pad] front pos -> child-S index, -1 none
    map_r: Optional[np.ndarray] = None   # [B, m_pad]
    groups_l: Tuple[ChildGroup, ...] = ()
    groups_r: Tuple[ChildGroup, ...] = ()

    @property
    def B(self) -> int:
        return self.batch_size

    @property
    def m_pad(self) -> int:
        return self.ni_pad + self.nb_pad


@dataclasses.dataclass
class Plan:
    """Static schedule: ``batches[0]`` is the leaf batch, later batches only consume
    Schur complements produced by earlier batches; the last batch contains the root."""

    N: int
    perm: np.ndarray           # postorder permutation: position p holds original dof perm[p]
    batches: List[BatchPlan]
    tree_depth: int
    nb_root: int
    # permuted matrix as a raw CSR triple (indptr, indices, data); the scipy view
    # is materialized lazily via :attr:`A_perm` (constructing it eagerly cost two
    # index-dtype conversion passes inside the timed plan)
    A_raw: tuple
    tree: NDTree               # relabeled tree (indices are positions in A_perm)
    loc: LocTree
    opts: "SolverOptions" = None
    # host planning time split: 'symbolic' covers symfact/postorder/permutation
    # (work the reference does OUTSIDE its timed factor, rungmres.jl:16-19,32);
    # 'schedule' covers batch building + sparse gather maps (work the reference's
    # timed factor redoes per call via A[I,J] getindex)
    timings: Optional[dict] = None
    _A_perm_cache: Optional[sp.csr_matrix] = dataclasses.field(
        default=None, repr=False)

    @property
    def A_perm(self) -> sp.csr_matrix:
        """The permuted matrix as scipy CSR (device ELL/DIA built from this)."""
        if self._A_perm_cache is None:
            indptr, indices, data = self.A_raw
            self._A_perm_cache = sp.csr_matrix((data, indices, indptr),
                                               shape=(self.N, self.N))
        return self._A_perm_cache

    @property
    def A_dtype(self):
        return self.A_raw[2].dtype

    @property
    def nnz(self) -> int:
        return int(len(self.A_raw[2]))


def _plan_regular_batch(gather, tree, loc, nodes, ni, nb, ni_pad, nb_pad,
                        m_pad, is_leaf_batch, compress, levels,
                        s_batch, s_row, batches, opts, N, bidx,
                        pools=None, deferred=None) -> None:
    """Plan one regular (dense or compressed-with-dense-children) batch: front COO
    gathers, extend-add maps, id/perm fills.  Appends the BatchPlan to ``batches``
    and records the nodes' Schur locations in ``s_batch``/``s_row``."""
    B = len(nodes)
    rank_cap = _rank_cap(opts, compress, nodes, levels, ni_pad, nb_pad)
    if deferred is not None and B * m_pad * m_pad < 2 ** 31:
        # consolidated native path: allocate the int32 map outputs here,
        # record the request, and let plan_factorization issue ONE native
        # call for every regular batch after the schedule loop (the COO
        # views are patched into the BatchPlans then)
        pool, vals_off, locpool, loc_off, node_nnz = pools
        o_int = vals_off[nodes]
        o_bnd = o_int + ni
        bound = int(node_nnz[nodes].sum())
        if not is_leaf_batch:
            ni1 = loc.n_int[tree.left[nodes]]
            ni2 = loc.n_int[tree.right[nodes]]
            nb1 = loc.n_bnd[tree.left[nodes]]
            nb2 = loc.n_bnd[tree.right[nodes]]
            branch = (ni1, ni2, nb1, nb2)
            sl_pad = max(_round_up(int((ni1 + nb1).max()), opts.pad), 1)
            sr_pad = max(_round_up(int((ni2 + nb2).max()), opts.pad), 1)
        else:
            branch = None
            sl_pad = sr_pad = 0
        lsum = loc.n_int[nodes] + loc.n_bnd[nodes]
        int_ids = np.empty((B, ni_pad), dtype=np.int32)
        bnd_ids = np.empty((B, nb_pad), dtype=np.int32)
        sperm = np.empty((B, nb_pad), dtype=np.int32)
        if branch is not None:
            map_l = np.empty((B, m_pad), dtype=np.int32)
            map_r = np.empty((B, m_pad), dtype=np.int32)
        else:
            map_l = map_r = None
        front_pos = front_vals = None
        deferred.append({
            "bidx": bidx, "pool": pool, "locpool": locpool,
            "o_int": o_int, "o_bnd": o_bnd, "ni": ni, "nb": nb,
            "branch": branch, "lo": loc_off[nodes], "lsum": lsum,
            "B": B, "ni_pad": ni_pad, "nb_pad": nb_pad,
            "bound": bound, "int_ids": int_ids, "bnd_ids": bnd_ids,
            "sperm": sperm, "map_l": map_l, "map_r": map_r})
        groups_l = {}
        groups_r = {}
        if not is_leaf_batch:
            for kids, gd in ((tree.left[nodes], groups_l),
                             (tree.right[nodes], groups_r)):
                sb_kids = s_batch[kids]
                if len(sb_kids) and np.all(sb_kids == sb_kids[0]):
                    gd[int(sb_kids[0])] = (s_row[kids],
                                           np.arange(len(kids), dtype=np.int64))
                else:
                    for sb in np.unique(sb_kids):
                        m = np.flatnonzero(sb_kids == sb)
                        gd[int(sb)] = (s_row[kids[m]], m.astype(np.int64))
        s_batch[nodes] = bidx
        s_row[nodes] = np.arange(B, dtype=np.int64)
        batches.append(BatchPlan(
            node_ids=nodes, is_leaf=is_leaf_batch, ni_pad=ni_pad,
            nb_pad=nb_pad, ni=ni, nb=nb, batch_size=B, front_pos=front_pos,
            front_vals=front_vals, sperm=sperm, int_ids=int_ids,
            bnd_ids=bnd_ids, levels=levels[nodes].astype(np.int64),
            sl_pad=sl_pad, sr_pad=sr_pad, map_l=map_l, map_r=map_r,
            compress=rank_cap > 0, rank_cap=rank_cap,
            groups_l=tuple(ChildGroup(sb, src, dst) for sb, (src, dst)
                           in sorted(groups_l.items())),
            groups_r=tuple(ChildGroup(sb, src, dst) for sb, (src, dst)
                           in sorted(groups_r.items()))))
        return

    # device index arrays are built int32 from the start (halves the fill
    # traffic of these [B, m_pad]-class buffers); in pooled mode the C++ fill
    # below writes every row
    alloc = np.empty if pools is not None else \
        (lambda shape, dtype: np.full(shape, N, dtype=dtype))
    int_ids = alloc((B, ni_pad), dtype=np.int32)
    bnd_ids = alloc((B, nb_pad), dtype=np.int32)
    if nb_pad:
        sperm = np.empty((B, nb_pad), dtype=np.int32)
        if pools is None:        # identity default (the C++ fill writes every row)
            sperm[:] = np.arange(nb_pad, dtype=np.int32)
    else:
        sperm = np.zeros((B, 0), dtype=np.int32)

    if not is_leaf_batch:
        ni1 = loc.n_int[tree.left[nodes]]
        ni2 = loc.n_int[tree.right[nodes]]
        nb1 = loc.n_bnd[tree.left[nodes]]
        nb2 = loc.n_bnd[tree.right[nodes]]
        sl = ni1 + nb1
        sr = ni2 + nb2
        sl_pad = max(_round_up(int(sl.max()), opts.pad), 1)
        sr_pad = max(_round_up(int(sr.max()), opts.pad), 1)
        # inverse extend-add maps: front position -> child-S index (or -1), so
        # the device assembly is a gather, not a scatter
        map_alloc = np.empty if pools is not None else \
            (lambda shape, dtype: np.full(shape, -1, dtype=dtype))
        map_l = map_alloc((B, m_pad), dtype=np.int32)
        map_r = map_alloc((B, m_pad), dtype=np.int32)
    else:
        sl_pad = sr_pad = 0
        map_l = map_r = None

    groups_l: Dict[int, List[Tuple[int, int]]] = {}
    groups_r: Dict[int, List[Tuple[int, int]]] = {}
    from hsolve_torch.native import run_coo_pooled

    if pools is not None:
        # pooled symfact layout: every node's [int; bnd] is contiguous in the
        # shared pool, so block specs are (offset, length) pairs - no per-batch
        # index concatenation at all
        pool, vals_off, locpool, loc_off, node_nnz = pools
        o_int = vals_off[nodes]
        o_bnd = o_int + ni
        bound = int(node_nnz[nodes].sum())
    else:
        # fallback: one shared index pool per batch
        # ([ints_0, bnds_0, ints_1, bnds_1, ...]) assembled with vectorized numpy
        pool = np.concatenate(
            [x for n in nodes for x in (tree.int_idx[n], tree.bnd_idx[n])]
            or [np.zeros(0, dtype=np.int64)])
        seg_lens = np.empty(2 * B, dtype=np.int64)
        seg_lens[0::2] = ni
        seg_lens[1::2] = nb
        seg_off = np.concatenate([[0], np.cumsum(seg_lens)])[:-1]
        o_int = seg_off[0::2]                   # [B] pool offset of ints
        o_bnd = seg_off[1::2]                   # [B] pool offset of bnds
        bound = None
    base = np.arange(B, dtype=np.int64) * (m_pad * m_pad)

    def _specs_from(parts):
        # parts: list of (rs, rl, cs, cl, r0, c0) per block type, each [B]
        rs = np.concatenate([p[0] for p in parts])
        rl = np.concatenate([p[1] for p in parts])
        cs = np.concatenate([p[2] for p in parts])
        cl = np.concatenate([p[3] for p in parts])
        oo = np.concatenate([base + p[4] * m_pad + p[5] for p in parts])
        st = np.full(len(rs), m_pad, dtype=np.int64)
        return rs, rl, cs, cl, oo, st

    ident_done = False
    if gather.ok:
        # fused per-node gather: one pass over each front row's nonzeros with a
        # child-tagged column map (branches keep only cross-child entries)
        from hsolve_torch.native import run_front_gather, run_front_gather_ident

        z = np.zeros(B, dtype=np.int64)
        if is_leaf_batch:
            nseg = 2
            segs = ((o_int, ni, z, z), (o_bnd, nb, z, z + ni_pad))
        else:
            nseg = 4
            one = np.ones(B, dtype=np.int64)
            segs = ((o_int, ni1, one, z), (o_int + ni1, ni2, 2 * one, ni1),
                    (o_bnd, nb1, one, z + ni_pad),
                    (o_bnd + nb1, nb2, 2 * one, ni_pad + nb1))
        so = np.empty(nseg * B, dtype=np.int64)
        sl = np.empty_like(so)
        st_ = np.empty_like(so)
        sf = np.empty_like(so)
        for k, (a, b_, c_, d_) in enumerate(segs):
            so[k::nseg], sl[k::nseg], st_[k::nseg], sf[k::nseg] = a, b_, c_, d_
        seg_ptr = np.arange(B + 1, dtype=np.int64) * nseg
        if B * m_pad * m_pad < 2 ** 31:
            # identity padding + int32 positions fused into the same C++ sweep
            front_pos, front_vals = run_front_gather_ident(
                gather, pool, seg_ptr, so, sl, st_, sf, base, m_pad,
                ni, ni_pad, bound=bound)
            ident_done = True
        else:
            front_pos, front_vals = run_front_gather(
                gather, pool, seg_ptr, so, sl, st_, sf, base, m_pad,
                copy=False, bound=bound)
    else:
        if is_leaf_batch:
            z = np.zeros(B, dtype=np.int64)
            parts = [
                (o_int, ni, o_int, ni, z, z),                       # ii
                (o_int, ni, o_bnd, nb, z, z + ni_pad),              # ib
                (o_bnd, nb, o_int, ni, z + ni_pad, z),              # bi
                (o_bnd, nb, o_bnd, nb, z + ni_pad, z + ni_pad),     # bb
            ]
        else:
            # same-child entries come from the child Schur complements; only the
            # cross-child couplings are taken from A (factorization.jl:115-123)
            s_i1, l_i1 = o_int, ni1
            s_i2, l_i2 = o_int + ni1, ni2
            s_b1, l_b1 = o_bnd, nb1
            s_b2, l_b2 = o_bnd + nb1, nb2
            z = np.zeros(B, dtype=np.int64)
            off = {"i1": z, "i2": ni1, "b1": z + ni_pad, "b2": ni_pad + nb1}
            seg = {"i1": (s_i1, l_i1), "i2": (s_i2, l_i2),
                   "b1": (s_b1, l_b1), "b2": (s_b2, l_b2)}
            parts = [
                (seg[rn][0], seg[rn][1], seg[cn][0], seg[cn][1], off[rn],
                 off[cn])
                for rn, cn in (("i1", "i2"), ("i2", "i1"), ("i1", "b2"),
                               ("i2", "b1"), ("b1", "i2"), ("b2", "i1"),
                               ("b1", "b2"), ("b2", "b1"))]
        front_pos, front_vals = run_coo_pooled(gather, pool,
                                               *_specs_from(parts))

    # per-batch map fills (host symbolic time is part of the north-star setup
    # metric): one C++ sweep in pooled mode, vectorized numpy otherwise
    if pools is not None:
        from hsolve_torch.native import fill_batch_maps_native

        lsum = loc.n_int[nodes] + loc.n_bnd[nodes]
        fill_batch_maps_native(
            pool, o_int, o_bnd, ni, nb, locpool, loc_off[nodes], lsum,
            None if is_leaf_batch else (ni1, ni2, nb1, nb2),
            ni_pad, nb_pad, N, int_ids, bnd_ids, sperm, map_l, map_r)
    else:
        cols_i = np.arange(ni_pad, dtype=np.int64)
        poolx = np.empty(len(pool) + 1, dtype=np.int32)
        poolx[:-1] = pool
        poolx[-1] = N
        plim = len(pool)
        gi = np.minimum(o_int[:, None] + cols_i[None, :], plim)
        int_ids[:] = np.where(cols_i[None, :] < ni[:, None], poolx[gi], N)
        if nb_pad:
            cols_b = np.arange(nb_pad, dtype=np.int64)
            gb = np.minimum(o_bnd[:, None] + cols_b[None, :], plim)
            bnd_ids[:] = np.where(cols_b[None, :] < nb[:, None], poolx[gb], N)
            # sperm rows are [int_loc; bnd_loc] per node
            l1 = loc.n_int[nodes]
            l2 = loc.n_bnd[nodes]
            lpool = np.concatenate(
                [x for nd in nodes for x in (loc.int_loc[nd], loc.bnd_loc[nd])]
                or [np.zeros(0, dtype=np.int64)])
            lo = np.concatenate([[0], np.cumsum(l1 + l2)])[:-1]
            lpx = np.empty(len(lpool) + 1, dtype=np.int32)
            lpx[:-1] = lpool
            lpx[-1] = 0
            gs = np.minimum(lo[:, None] + cols_b[None, :], len(lpool))
            sperm[:] = np.where(cols_b[None, :] < (l1 + l2)[:, None], lpx[gs],
                                sperm)
        if not is_leaf_batch:
            # inverse extend-add maps (child S is [int_loc; bnd_loc]-permuted, so
            # placements are two contiguous runs per child)
            cols_m = np.arange(m_pad, dtype=np.int32)[None, :]
            ni1c = ni1.astype(np.int32)[:, None]
            ni2c = ni2.astype(np.int32)[:, None]
            nb1c = nb1.astype(np.int32)[:, None]
            nb2c = nb2.astype(np.int32)[:, None]
            in_i1 = cols_m < ni1c
            in_i2 = (cols_m >= ni1c) & (cols_m < ni1c + ni2c)
            in_b1 = (cols_m >= ni_pad) & (cols_m < ni_pad + nb1c)
            in_b2 = (cols_m >= ni_pad + nb1c) & (cols_m < ni_pad + nb1c + nb2c)
            map_l[:] = np.where(in_i1, cols_m,
                                np.where(in_b1, ni1c + cols_m - ni_pad, -1))
            map_r[:] = np.where(in_i2, cols_m - ni1c,
                                np.where(in_b2, ni2c + cols_m - ni_pad - nb1c,
                                         -1))

    if not is_leaf_batch:
        for kids, gd in ((tree.left[nodes], groups_l),
                         (tree.right[nodes], groups_r)):
            sb_kids = s_batch[kids]
            if len(sb_kids) and np.all(sb_kids == sb_kids[0]):
                # common case: every child's Schur lives in one source batch
                gd[int(sb_kids[0])] = (s_row[kids],
                                       np.arange(len(kids), dtype=np.int64))
            else:
                for sb in np.unique(sb_kids):
                    m = np.flatnonzero(sb_kids == sb)
                    gd[int(sb)] = (s_row[kids[m]], m.astype(np.int64))

    # identity on the padded part of the pivot block keeps the batched LU
    # well-defined (the padded rows/cols stay decoupled)
    s_batch[nodes] = bidx
    s_row[nodes] = np.arange(B, dtype=np.int64)
    if ident_done:
        ip = None
    elif pools is not None:
        from hsolve_torch.native import fill_ident_pos_native

        ip = fill_ident_pos_native(ni, ni_pad, m_pad)
    else:
        cols_i = np.arange(ni_pad, dtype=np.int64)
        pr = np.arange(B, dtype=np.int64)[:, None] * (m_pad * m_pad) \
            + cols_i[None, :] * (m_pad + 1)
        ip = pr[cols_i[None, :] >= ni[:, None]]
    if not ident_done:
        # fused pass: gathered COO (a workspace view) + identity padding, written
        # straight into the final (int32 where possible) buffers - the previous
        # copy -> concatenate -> astype chain made three passes over multi-MB
        # arrays (the native fast path fuses all of this into the gather itself)
        n0 = len(front_pos)
        ptype = np.int32 if B * m_pad * m_pad < 2 ** 31 else np.int64
        fp = np.empty(n0 + len(ip), dtype=ptype)
        fp[:n0] = front_pos
        fp[n0:] = ip
        fv = np.empty(n0 + len(ip), dtype=front_vals.dtype)
        fv[:n0] = front_vals
        fv[n0:] = 1.0
        front_pos, front_vals = fp, fv

    def _mk_groups(gd) -> Tuple[ChildGroup, ...]:
        return tuple(ChildGroup(sb, src, dst)
                     for sb, (src, dst) in sorted(gd.items()))

    batches.append(BatchPlan(
        node_ids=nodes, is_leaf=is_leaf_batch, ni_pad=ni_pad, nb_pad=nb_pad,
        ni=ni, nb=nb, batch_size=B, front_pos=front_pos, front_vals=front_vals,
        sperm=sperm, int_ids=int_ids,
        bnd_ids=bnd_ids, levels=levels[nodes].astype(np.int64),
        sl_pad=sl_pad, sr_pad=sr_pad, map_l=map_l, map_r=map_r,
        compress=rank_cap > 0, rank_cap=rank_cap,
        groups_l=_mk_groups(groups_l), groups_r=_mk_groups(groups_r)))



def plan_factorization(A: sp.spmatrix, tree: NDTree, opts: SolverOptions) -> Plan:
    """Run the symbolic phase and build the batched numeric schedule."""
    opts.validate()
    import time as _time

    t_sym0 = _time.perf_counter()
    A = sp.csr_matrix(A)
    N = A.shape[0]

    tree_in = tree
    tree = tree.shallow_copy()  # symfact/permuted reassign; caller's tree stays valid
    loc = symfact(tree)
    perm = postorder(tree)
    # permutation check via a touch-count pass (np.unique sorts - 3x the cost)
    ok_perm = False
    if len(perm) == N:
        touch = np.zeros(N, dtype=np.int8)
        touch[perm] = 1
        ok_perm = bool(touch.all())
    if not ok_perm:
        # diagnose which structural invariant broke (NDTree.validate raises with the
        # offending node); run on the caller's untouched tree
        tree_in.validate()
        raise ValueError(
            "postorder is not a permutation: the tree does not cover every DOF exactly "
            "once (check separator/boundary construction)")
    relabel = np.empty(N, dtype=np.int64)
    relabel[perm] = np.arange(N)
    from hsolve_torch.native import CsrGather, csr_permute, csr_permute_raw
    A_raw = csr_permute_raw(A, perm, relabel)
    if A_raw is not None:
        gather = CsrGather.from_raw(*A_raw, ncols=N)
        A_perm = None
    else:
        A_perm = csr_permute(A, perm)
        gather = CsrGather(A_perm)
        A_raw = (A_perm.indptr.astype(np.int64),
                 A_perm.indices.astype(np.int64), A_perm.data)
    tree = permuted(tree, relabel)
    t_sym = _time.perf_counter() - t_sym0
    depth = tree.depth()
    levels = tree.levels()
    nn = tree.nnodes
    # per-node sizes as flat arrays: the schedule below indexes them wholesale
    # (repeated per-node len() calls dominated host planning at large N)
    pool_all = getattr(tree, "_pool", None)
    if pool_all is not None and loc.pool is not None:
        # pooled symfact output: sizes are free, and the batch builders index the
        # shared pools directly instead of concatenating ~2n per-node arrays
        ni_all = tree._pool_ni
        nb_all = tree._pool_nb
        counts = gather.indptr[1:] - gather.indptr[:-1] if gather.ok else \
            np.diff(A_perm.indptr).astype(np.int64)
        cs = np.zeros(len(pool_all) + 1, dtype=np.int64)
        np.cumsum(counts[pool_all], out=cs[1:])
        vend = tree._pool_off + ni_all + nb_all
        node_nnz = cs[vend] - cs[tree._pool_off]   # nnz of each node's front rows
        pools = (pool_all, tree._pool_off, loc.pool, loc.off, node_nnz)
    else:
        ni_all = np.fromiter((len(tree.int_idx[i]) for i in range(nn)), np.int64,
                             nn)
        nb_all = np.fromiter((len(tree.bnd_idx[i]) for i in range(nn)), np.int64,
                             nn)
        pools = None

    # --- schedule: group nodes by height ---
    order = tree.topo_order()
    height = tree.heights()
    max_h = int(height[tree.root])

    # per-node compression flag (parity with factorization.jl:15:
    # level <= swlevel and |bnd| >= swsize)
    swlevel = opts.resolve_swlevel(depth)
    cflag = (levels <= swlevel) & (nb_all >= opts.swsize)
    if opts.hss and cflag.any():
        raise NotImplementedError(
            f"swlevel={opts.swlevel} with hss=True compresses "
            f"{int(cflag.sum())} node(s) into HSS Schur complements, which "
            "belong to the port's structured (HSS) slice; pass hss=False for "
            "the low-rank compressed path, or swlevel=0")

    # each height group splits by the compression flag, dense nodes first
    hsorted = order[np.argsort(height[order], kind="stable")]
    hs = height[hsorted]
    groups: List[Tuple[np.ndarray, bool, bool]] = []  # (nodes, is_leaf, compress)
    for h in range(max_h + 1):
        lo, hi = np.searchsorted(hs, [h, h + 1])
        at_h = hsorted[lo:hi]
        for want in (False, True):
            sel = at_h[cflag[at_h] == want]
            if len(sel):
                groups.append((sel, h == 0, want))

    # node -> (batch, row) location of its Schur complement (flat arrays)
    s_batch = np.full(nn, -1, dtype=np.int64)
    s_row = np.full(nn, -1, dtype=np.int64)
    batches: List[BatchPlan] = []
    # regular-batch requests accumulated for ONE consolidated native call after
    # the schedule loop (the per-batch ctypes crossing + wrapper overhead was
    # ~40% of schedule time at h=128)
    deferred: Optional[list] = [] if (pools is not None and gather.ok) else None

    for nodes, is_leaf_batch, compress in groups:
        bidx = len(batches)
        ni = ni_all[nodes].astype(np.int64)
        nb = nb_all[nodes].astype(np.int64)
        ni_pad = _round_up(int(ni.max()), opts.pad)
        nb_pad = _round_up(int(nb.max()), opts.pad) if nb.max() > 0 else 0
        m_pad = ni_pad + nb_pad
        _plan_regular_batch(
            gather, tree, loc, nodes, ni, nb, ni_pad, nb_pad, m_pad,
            is_leaf_batch, compress, levels, s_batch, s_row, batches, opts, N,
            bidx, pools, deferred)

    if deferred:
        from hsolve_torch.native import plan_batches_all_native

        for d, (fpos, fval, fsrc) in zip(
                deferred, plan_batches_all_native(gather, deferred)):
            bp = batches[d["bidx"]]
            bp.front_pos = fpos
            bp.front_vals = fval
            bp.front_src = fsrc

    nb_root = len(tree.bnd_idx[tree.root])
    # device index arrays go out as int32 (the kernels' index width)
    for bp in batches:
        for f in ("sperm", "int_ids", "bnd_ids", "map_l", "map_r", "smap"):
            v = getattr(bp, f)
            if v is not None and v.dtype != np.int32:
                setattr(bp, f, v.astype(np.int32))
        if bp.front_pos is not None and bp.front_pos.dtype != np.int32 and (
                len(bp.front_pos) == 0 or bp.front_pos.max() < 2 ** 31):
            bp.front_pos = bp.front_pos.astype(np.int32)
    return Plan(N=N, perm=perm, batches=batches, tree_depth=depth, nb_root=nb_root,
                A_raw=A_raw, tree=tree, loc=loc, opts=opts,
                timings={"symbolic_s": t_sym,
                         "schedule_s": _time.perf_counter() - t_sym0 - t_sym},
                _A_perm_cache=A_perm)
