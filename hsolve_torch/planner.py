"""Host-side symbolic planner (jax-free copy of ``hsolve/planner.py``).

The copy keeps what exact (``swlevel=0``), low-rank compressed (``hss=False``)
and structured (``hss=True``) planning run, numpy code unchanged, so its
:class:`Plan` equals the JAX planner's array for array: the structured (HSS)
batches with their cluster plans (``cplan``, ``n1``, ``n2``), the parent-S map
``smap`` and the eight cross-coupling strips included, and so does
``batch_multiple``, the decoupled identity dummy fronts that round every
level's batch up to a multiple of a device mesh's tree axis.

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


def _levels_of(levels: np.ndarray, nodes, B: int) -> np.ndarray:
    """The batch's ``[B]`` reference levels, 0 on the dummy rows."""
    out = np.zeros(B, dtype=np.int64)
    out[:len(nodes)] = levels[nodes]
    return out


def _rank_cap(opts: SolverOptions, compress: bool, nodes, levels, ni_pad: int,
              nb_pad: int) -> int:
    """The batch's rank cap: ``min(ni_pad, nb_pad, round_up(cap, rank_pad))``
    on a compressed batch with a boundary, else 0 (the batch stays dense)."""
    if not (compress and nb_pad > 0):
        return 0
    cap = _cap_rule(opts, nb_pad, int(levels[nodes].min()))
    return min(ni_pad, nb_pad, _round_up(cap, opts.rank_pad))


def _coo_to_strip(pos: np.ndarray, vals: np.ndarray, B: int, r: int, c: int,
                  pad: int = 8) -> dict:
    """Turn one cross block's batched COO (flat positions into [B, r, c]) into an
    EXACT skinny factorization ``A_blk = E @ S``: ``rows [B, rcap]`` gives each
    nonzero row's id (sentinel ``r`` on padding -> zero one-hot column) and
    ``pos/vals`` scatter the value strip ``S [B, rcap, c]``.  Junction couplings
    touch only a contact-sized set of rows, so ``rcap`` is small and the
    factorization is exact (the analog of the reference keeping these couplings
    structured: ``hss(A[int1,int2])``, factorization.jl:128)."""
    rc_ = r * c
    n_ = len(pos)
    # the pooled gather emits entries block-major, row-major (sorted by
    # (b, row, col)): one native pass builds the whole strip layout
    if n_ and bool(np.all(pos[1:] > pos[:-1])):
        from hsolve_torch.native import coo_to_strip_native

        nat = coo_to_strip_native(pos, B, r, c, pad)
        if nat is not None:
            rows_idx, strip_pos, rcap = nat
            return {"rows": rows_idx, "pos": strip_pos, "vals": vals,
                    "rcap": rcap, "r": r, "c": c}
    b = pos // rc_
    rem = pos - b * rc_
    row = rem // c
    col = rem - row * c
    key = b * np.int64(r) + row
    # dedup with O(n) change flags instead of np.unique's sort
    if n_ and bool(np.all(key[1:] >= key[:-1])):
        change = np.empty(n_, dtype=bool)
        change[0] = True
        np.not_equal(key[1:], key[:-1], out=change[1:])
        inv = np.cumsum(change) - 1
        uniq = key[change]
    else:
        uniq, inv = np.unique(key, return_inverse=True)
    if len(uniq):
        ub = uniq // r
        urow = uniq - ub * r
        nu = len(uniq)
        bchange = np.empty(nu, dtype=bool)
        bchange[0] = True
        np.not_equal(ub[1:], ub[:-1], out=bchange[1:])
        idx = np.arange(nu, dtype=np.int64)
        first = np.maximum.accumulate(np.where(bchange, idx, 0))
        slot = idx - first                          # position within its b group
        nrows = int(slot.max()) + 1
    else:
        ub = urow = slot = np.zeros(0, dtype=np.int64)
        nrows = 0
    rcap = _round_up(max(nrows, 1), pad)
    rcap = min(rcap, max(r, 1))
    rows_idx = np.full((B, rcap), r, dtype=np.int32)
    if len(uniq):
        rows_idx[ub, slot] = urow
        strip_pos = (b * rcap + slot[inv]) * c + col
    else:
        strip_pos = np.zeros(0, dtype=np.int64)
    return {"rows": rows_idx, "pos": strip_pos.astype(np.int64), "vals": vals,
            "rcap": rcap, "r": r, "c": c}


def cross_block_shapes(child_cplans) -> Dict[str, Tuple[int, int]]:
    """Per-node (rows, cols) of the 8 cross-coupling blocks of a structured batch,
    in child-aligned coordinates."""
    cpl, cpr = child_cplans
    h1, h2 = cpl.half, cpr.half
    q1, q2 = cpl.n_pad - cpl.half, cpr.n_pad - cpr.half
    return {"ci12": (h1, h2), "ci21": (h2, h1), "cib12": (h1, q2),
            "cib21": (h2, q1), "cbi12": (q1, h2), "cbi21": (q2, h1),
            "cbb12": (q1, q2), "cbb21": (q2, q1)}


# the 8 cross couplings of a structured batch: (name, row segment, col segment)
_CROSS = (("ci12", "i1", "i2"), ("ci21", "i2", "i1"),
          ("cib12", "i1", "b2"), ("cib21", "i2", "b1"),
          ("cbi12", "b1", "i2"), ("cbi21", "b2", "i1"),
          ("cbb12", "b1", "b2"), ("cbb21", "b2", "b1"))


def _plan_structured_batch(gather, tree, loc, nodes, B, ni, nb, n1, n2, cplan,
                           child_cplans, levels, s_loc, opts, N,
                           cnnz=None) -> "BatchPlan":
    """Plan a fully-structured compressed batch in *child-aligned* coordinates.

    Thanks to the ``[int_loc; bnd_loc]`` storage discipline every child-to-parent
    index map is an offset identity, so the only per-node data are the split
    sizes and one composed gather map from the parent-S HSS coordinates to the
    child-aligned boundary layout.  Only the cross-child couplings are extracted
    from A (the structured counterpart of ``_assemble_blocks`` for HSS children,
    factorization.jl:126-140).  Rows ``[len(nodes), B)`` are dummy fronts
    (see ``batch_multiple``)."""
    cpl, cpr = child_cplans
    B0 = len(nodes)
    A_dtype = np.complex128 if gather.iscomplex else np.float64
    h1, h2 = cpl.half, cpr.half
    q1, q2 = cpl.n_pad - cpl.half, cpr.n_pad - cpr.half
    np_pad = cplan.n_pad
    shapes = cross_block_shapes(child_cplans)
    nodes_arr = np.asarray(nodes, dtype=np.int64)

    pool_t = getattr(tree, "_pool", None)
    if pool_t is not None and loc.pool is not None and B0:
        # vectorized pooled path: whole-batch numpy on the shared symfact
        # pools, the cross couplings as ONE pooled native COO gather
        lefts = tree.left[nodes_arr].astype(np.int64)
        rights = tree.right[nodes_arr].astype(np.int64)
        off_n = tree._pool_off[nodes_arr].astype(np.int64)
        ki1 = loc.n_int[lefts].astype(np.int64)
        kb1 = loc.n_bnd[lefts].astype(np.int64)
        ki2 = loc.n_int[rights].astype(np.int64)
        kb2 = loc.n_bnd[rights].astype(np.int64)
        ni_n = tree._pool_ni[nodes_arr].astype(np.int64)   # = ki1 + ki2
        ni1 = np.zeros(B, dtype=np.int64)
        ni2 = np.zeros(B, dtype=np.int64)
        nb1 = np.zeros(B, dtype=np.int64)
        nb2 = np.zeros(B, dtype=np.int64)
        ni1[:B0], ni2[:B0], nb1[:B0], nb2[:B0] = ki1, ki2, kb1, kb2
        k1 = n1[:B0].astype(np.int64)
        k2 = n2[:B0].astype(np.int64)
        o_l = loc.off[nodes_arr].astype(np.int64)
        from hsolve_torch.native import fill_structured_maps_native

        int_ids = np.empty((B, h1 + h2), dtype=np.int32)
        bnd_ids = np.empty((B, q1 + q2), dtype=np.int32)
        smap = np.empty((B, np_pad), dtype=np.int32)
        if B > B0:
            int_ids[B0:] = N
            bnd_ids[B0:] = N
            smap[B0:] = q1 + q2
        if not fill_structured_maps_native(
                pool_t, loc.pool, off_n, ki1, ki2, kb1, kb2, o_l, k1, k2,
                B0, h1, h2, q1, q2, np_pad, cplan.half, N,
                int_ids, bnd_ids, smap):
            pmax = max(len(pool_t) - 1, 0)

            def _ids(width, start, count):
                j = np.arange(width, dtype=np.int64)[None, :]
                src = np.minimum(start[:, None] + j, pmax)
                return np.where(j < count[:, None], pool_t[src],
                                N).astype(np.int32)

            int_ids[:B0, :h1] = _ids(h1, off_n, ki1)
            int_ids[:B0, h1:] = _ids(h2, off_n + ki1, ki2)
            bnd_ids[:B0, :q1] = _ids(q1, off_n + ni_n, kb1)
            bnd_ids[:B0, q1:] = _ids(q2, off_n + ni_n + kb1, kb2)
            # parent-S HSS pad coord -> child-aligned boundary position
            lmax = max(len(loc.pool) - 1, 0)
            j = np.arange(np_pad, dtype=np.int64)[None, :]
            srcj = np.where(j < k1[:, None], j, np.maximum(
                k1[:, None] + j - cplan.half, 0))
            valid = (j < k1[:, None]) | ((j >= cplan.half)
                                         & (j < cplan.half + k2[:, None]))
            perm_sj = loc.pool[np.minimum(o_l[:, None] + srcj, lmax)]
            posj = np.where(perm_sj < kb1[:, None], perm_sj,
                            q1 + perm_sj - kb1[:, None])
            smap[:B0] = np.where(valid, posj, q1 + q2)

        from hsolve_torch.native import run_coo_pooled

        segs = {"i1": (off_n, ki1), "i2": (off_n + ki1, ki2),
                "b1": (off_n + ni_n, kb1), "b2": (off_n + ni_n + kb1, kb2)}
        if cnnz is None:
            counts = (gather.indptr[1:] - gather.indptr[:-1]) if gather.ok \
                else np.diff(gather.A.indptr).astype(np.int64)
            cnnz = np.zeros(len(pool_t) + 1, dtype=np.int64)
            np.cumsum(counts[pool_t], out=cnnz[1:])
        out_off0 = np.arange(B0, dtype=np.int64)
        # ONE pooled COO gather for all 8 couplings: each name gets a disjoint
        # flat-position space and the emitted stream is name-major, so the
        # per-name segments come back with one searchsorted pass
        seg_rs, seg_rl, seg_cs, seg_cl, seg_off, seg_st = \
            [], [], [], [], [], []
        name_base = []
        base = 0
        bound = 0
        for name, rseg, cseg in _CROSS:
            r_, c_ = shapes[name]
            rs, rl = segs[rseg]
            cs2, cl2 = segs[cseg]
            bound += int(np.sum(cnnz[rs + rl] - cnnz[rs]))
            seg_rs.append(rs)
            seg_rl.append(rl)
            seg_cs.append(cs2)
            seg_cl.append(cl2)
            seg_off.append(base + out_off0 * (r_ * c_))
            seg_st.append(np.full(B0, c_, dtype=np.int64))
            name_base.append(base)
            base += B0 * r_ * c_
        pos_all, vals_all = run_coo_pooled(
            gather, pool_t, np.concatenate(seg_rs), np.concatenate(seg_rl),
            np.concatenate(seg_cs), np.concatenate(seg_cl),
            np.concatenate(seg_off), np.concatenate(seg_st), bound=bound)
        bases = np.asarray(name_base + [base], dtype=np.int64)
        name_idx = np.searchsorted(bases, pos_all, side="right") - 1
        cuts = np.searchsorted(name_idx, np.arange(len(_CROSS) + 1))
        cross = {}
        for ni_, (name, _, _) in enumerate(_CROSS):
            r_, c_ = shapes[name]
            sl = slice(int(cuts[ni_]), int(cuts[ni_ + 1]))
            cross[name] = _coo_to_strip(pos_all[sl] - name_base[ni_],
                                        vals_all[sl], B, r_, c_)
    else:
        # per-node fallback (no pooled symfact layout)
        ni1 = np.zeros(B, dtype=np.int64)
        ni2 = np.zeros(B, dtype=np.int64)
        nb1 = np.zeros(B, dtype=np.int64)
        nb2 = np.zeros(B, dtype=np.int64)
        int_ids = np.full((B, h1 + h2), N, dtype=np.int32)
        bnd_ids = np.full((B, q1 + q2), N, dtype=np.int32)
        smap = np.full((B, np_pad), q1 + q2, dtype=np.int32)
        from hsolve_torch.native import BlockGatherBuilder

        builders = {name: BlockGatherBuilder(gather) for name in shapes}
        for b, node in enumerate(nodes):
            node = int(node)
            l, r = int(tree.left[node]), int(tree.right[node])
            ki1, kb1 = len(loc.int_loc[l]), len(loc.bnd_loc[l])
            ki2, kb2 = len(loc.int_loc[r]), len(loc.bnd_loc[r])
            ni1[b], ni2[b], nb1[b], nb2[b] = ki1, ki2, kb1, kb2
            ints = tree.int_idx[node]
            bnds = tree.bnd_idx[node]
            i1, i2 = ints[:ki1], ints[ki1:]
            b1, b2 = bnds[:kb1], bnds[kb1:]
            int_ids[b, :ki1] = i1
            int_ids[b, h1: h1 + ki2] = i2
            bnd_ids[b, :kb1] = b1
            bnd_ids[b, q1: q1 + kb2] = b2
            seg = {"i1": i1, "i2": i2, "b1": b1, "b2": b2}
            for name, rseg, cseg in _CROSS:
                rows, cols = seg[rseg], seg[cseg]
                if len(rows) and len(cols):
                    r_, c_ = shapes[name]
                    builders[name].add(rows, cols, b * r_ * c_, stride=c_)
            if loc.pool is not None:
                o = loc.off[node]
                perm_s = loc.pool[o: o + int(loc.n_int[node] + loc.n_bnd[node])]
            else:
                perm_s = np.concatenate([loc.int_loc[node], loc.bnd_loc[node]])
            pos = np.where(perm_s < kb1, perm_s, q1 + perm_s - kb1)
            k1, k2 = int(n1[b]), int(n2[b])
            smap[b, :k1] = pos[:k1]
            smap[b, cplan.half: cplan.half + k2] = pos[k1:]
        cross = {name: _coo_to_strip(*bld.run_coo(shapes[name][1]), B,
                                     *shapes[name])
                 for name, bld in builders.items()}

    s_batch, s_row = s_loc

    def _mk(kids):
        out = []
        for sb in np.unique(s_batch[kids]):
            m = np.flatnonzero(s_batch[kids] == sb)
            out.append(ChildGroup(int(sb), s_row[kids[m]], m.astype(np.int64)))
        return tuple(out)

    groups_l = _mk(tree.left[nodes_arr])
    groups_r = _mk(tree.right[nodes_arr])

    cross["ni1"] = ni1
    cross["ni2"] = ni2
    cross["nb1"] = nb1
    cross["nb2"] = nb2
    cap = _cap_rule(opts, q1 + q2, int(levels[nodes].min()))
    rank_cap = min(h1 + h2, q1 + q2, _round_up(cap, opts.rank_pad))
    return BatchPlan(
        node_ids=nodes, is_leaf=False, ni_pad=h1 + h2, nb_pad=q1 + q2, ni=ni, nb=nb,
        batch_size=B, front_pos=np.zeros(0, dtype=np.int64),
        front_vals=np.zeros(0, dtype=A_dtype),
        # structured batches draw their A-entries from the cross strips, not
        # from front_vals
        front_src=np.zeros(0, dtype=np.int32),
        sperm=np.zeros((B, 0), dtype=np.int64), int_ids=int_ids, bnd_ids=bnd_ids,
        levels=_levels_of(levels, nodes, B), compress=True, rank_cap=rank_cap,
        cplan=cplan, n1=n1, n2=n2, structured=True, cross=cross, smap=smap,
        child_cplans=child_cplans, groups_l=groups_l, groups_r=groups_r)


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
    batch_size: int            # B (includes sharding-padding dummy rows)
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


def _plan_regular_batch(gather, tree, loc, nodes, B, ni, nb, ni_pad, nb_pad,
                        m_pad, is_leaf_batch, compress, cplan, n1, n2, levels,
                        s_batch, s_row, batches, opts, N, bidx,
                        pools=None, deferred=None) -> None:
    """Plan one regular (dense or compressed-with-dense-children) batch: front COO
    gathers, extend-add maps, id/perm fills.  Appends the BatchPlan to ``batches``
    and records the nodes' Schur locations in ``s_batch``/``s_row``.  Rows
    ``[len(nodes), B)`` are decoupled identity dummy fronts (``batch_multiple``)."""
    B0 = len(nodes)
    niB = ni[:B0]
    nbB = nb[:B0]
    rank_cap = _rank_cap(opts, compress, nodes, levels, ni_pad, nb_pad)
    if deferred is not None and B * m_pad * m_pad < 2 ** 31:
        # consolidated native path: allocate the int32 map outputs here,
        # record the request, and let plan_factorization issue ONE native
        # call for every regular batch after the schedule loop (the COO
        # views are patched into the BatchPlans then)
        pool, vals_off, locpool, loc_off, node_nnz = pools
        o_int = vals_off[nodes]
        o_bnd = o_int + niB
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
            "o_int": o_int, "o_bnd": o_bnd, "ni": niB, "nb": nbB,
            "branch": branch, "lo": loc_off[nodes], "lsum": lsum,
            "B0": B0, "B": B, "ni_pad": ni_pad, "nb_pad": nb_pad,
            "bound": bound, "int_ids": int_ids, "bnd_ids": bnd_ids,
            "sperm": sperm, "map_l": map_l, "map_r": map_r})
        if B > B0:
            int_ids[B0:] = N
            bnd_ids[B0:] = N
            sperm[B0:] = np.arange(nb_pad, dtype=np.int32)
            if map_l is not None:
                map_l[B0:] = -1
                map_r[B0:] = -1
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
        s_row[nodes] = np.arange(B0, dtype=np.int64)
        batches.append(BatchPlan(
            node_ids=nodes, is_leaf=is_leaf_batch, ni_pad=ni_pad,
            nb_pad=nb_pad, ni=ni, nb=nb, batch_size=B, front_pos=front_pos,
            front_vals=front_vals, sperm=sperm, int_ids=int_ids,
            bnd_ids=bnd_ids, levels=_levels_of(levels, nodes, B),
            sl_pad=sl_pad, sr_pad=sr_pad, map_l=map_l, map_r=map_r,
            compress=rank_cap > 0, rank_cap=rank_cap,
            cplan=cplan if rank_cap > 0 else None, n1=n1, n2=n2,
            groups_l=tuple(ChildGroup(sb, src, dst) for sb, (src, dst)
                           in sorted(groups_l.items())),
            groups_r=tuple(ChildGroup(sb, src, dst) for sb, (src, dst)
                           in sorted(groups_r.items()))))
        return

    # device index arrays are built int32 from the start (halves the fill
    # traffic of these [B, m_pad]-class buffers); in pooled mode the C++ fill
    # below writes rows [0, B0) so only dummy rows need prefilling
    alloc = np.empty if pools is not None else \
        (lambda shape, dtype: np.full(shape, N, dtype=dtype))
    int_ids = alloc((B, ni_pad), dtype=np.int32)
    bnd_ids = alloc((B, nb_pad), dtype=np.int32)
    if nb_pad:
        sperm = np.empty((B, nb_pad), dtype=np.int32)
        # identity default (pooled mode: only the dummy rows need it)
        sperm[B0 if pools is not None else 0:] = np.arange(nb_pad,
                                                           dtype=np.int32)
    else:
        sperm = np.zeros((B, 0), dtype=np.int32)
    if pools is not None and B > B0:
        int_ids[B0:] = N
        bnd_ids[B0:] = N

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
        if pools is not None and B > B0:
            map_l[B0:] = -1
            map_r[B0:] = -1
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
        o_bnd = o_int + niB
        bound = int(node_nnz[nodes].sum())
    else:
        # fallback: one shared index pool per batch
        # ([ints_0, bnds_0, ints_1, bnds_1, ...]) assembled with vectorized numpy
        pool = np.concatenate(
            [x for n in nodes for x in (tree.int_idx[n], tree.bnd_idx[n])]
            or [np.zeros(0, dtype=np.int64)])
        seg_lens = np.empty(2 * B0, dtype=np.int64)
        seg_lens[0::2] = niB
        seg_lens[1::2] = nbB
        seg_off = np.concatenate([[0], np.cumsum(seg_lens)])[:-1]
        o_int = seg_off[0::2]                   # [B0] pool offset of ints
        o_bnd = seg_off[1::2]                   # [B0] pool offset of bnds
        bound = None
    base = np.arange(B0, dtype=np.int64) * (m_pad * m_pad)

    def _specs_from(parts):
        # parts: list of (rs, rl, cs, cl, r0, c0) per block type, each [B0]
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

        z = np.zeros(B0, dtype=np.int64)
        if is_leaf_batch:
            nseg = 2
            segs = ((o_int, niB, z, z), (o_bnd, nbB, z, z + ni_pad))
        else:
            nseg = 4
            one = np.ones(B0, dtype=np.int64)
            segs = ((o_int, ni1, one, z), (o_int + ni1, ni2, 2 * one, ni1),
                    (o_bnd, nb1, one, z + ni_pad),
                    (o_bnd + nb1, nb2, 2 * one, ni_pad + nb1))
        so = np.empty(nseg * B0, dtype=np.int64)
        sl = np.empty_like(so)
        st_ = np.empty_like(so)
        sf = np.empty_like(so)
        for k, (a, b_, c_, d_) in enumerate(segs):
            so[k::nseg], sl[k::nseg], st_[k::nseg], sf[k::nseg] = a, b_, c_, d_
        seg_ptr = np.arange(B0 + 1, dtype=np.int64) * nseg
        if B * m_pad * m_pad < 2 ** 31:
            # identity padding + int32 positions fused into the same C++ sweep
            front_pos, front_vals = run_front_gather_ident(
                gather, pool, seg_ptr, so, sl, st_, sf, base, m_pad,
                ni, B, ni_pad, bound=bound)
            ident_done = True
        else:
            front_pos, front_vals = run_front_gather(
                gather, pool, seg_ptr, so, sl, st_, sf, base, m_pad,
                copy=False, bound=bound)
    else:
        if is_leaf_batch:
            z = np.zeros(B0, dtype=np.int64)
            parts = [
                (o_int, niB, o_int, niB, z, z),                     # ii
                (o_int, niB, o_bnd, nbB, z, z + ni_pad),            # ib
                (o_bnd, nbB, o_int, niB, z + ni_pad, z),            # bi
                (o_bnd, nbB, o_bnd, nbB, z + ni_pad, z + ni_pad),   # bb
            ]
        else:
            # same-child entries come from the child Schur complements; only the
            # cross-child couplings are taken from A (factorization.jl:115-123)
            s_i1, l_i1 = o_int, ni1
            s_i2, l_i2 = o_int + ni1, ni2
            s_b1, l_b1 = o_bnd, nb1
            s_b2, l_b2 = o_bnd + nb1, nb2
            z = np.zeros(B0, dtype=np.int64)
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
            pool, o_int, o_bnd, niB, nbB, locpool, loc_off[nodes], lsum,
            None if is_leaf_batch else (ni1, ni2, nb1, nb2),
            ni_pad, nb_pad, N, int_ids, bnd_ids, sperm, map_l, map_r)
    else:
        cols_i = np.arange(ni_pad, dtype=np.int64)
        poolx = np.empty(len(pool) + 1, dtype=np.int32)
        poolx[:-1] = pool
        poolx[-1] = N
        plim = len(pool)
        gi = np.minimum(o_int[:, None] + cols_i[None, :], plim)
        int_ids[:B0] = np.where(cols_i[None, :] < niB[:, None], poolx[gi], N)
        if nb_pad:
            cols_b = np.arange(nb_pad, dtype=np.int64)
            gb = np.minimum(o_bnd[:, None] + cols_b[None, :], plim)
            bnd_ids[:B0] = np.where(cols_b[None, :] < nbB[:, None], poolx[gb],
                                    N)
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
            sperm[:B0] = np.where(cols_b[None, :] < (l1 + l2)[:, None],
                                  lpx[gs], sperm[:B0])
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
            map_l[:B0] = np.where(in_i1, cols_m,
                                  np.where(in_b1, ni1c + cols_m - ni_pad, -1))
            map_r[:B0] = np.where(in_i2, cols_m - ni1c,
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
    # well-defined (the padded rows/cols stay decoupled); dummy fronts get a
    # full identity pivot
    s_batch[nodes] = bidx
    s_row[nodes] = np.arange(B0, dtype=np.int64)
    if ident_done:
        ip = None
    elif pools is not None:
        from hsolve_torch.native import fill_ident_pos_native

        ip = fill_ident_pos_native(ni, B0, B, ni_pad, m_pad)
    else:
        ident_pos = []
        d = np.arange(ni_pad)
        for bb in range(B0, B):
            ident_pos.append(bb * m_pad * m_pad + d * (m_pad + 1))
        cols_i = np.arange(ni_pad, dtype=np.int64)
        pr = np.arange(B0, dtype=np.int64)[:, None] * (m_pad * m_pad) \
            + cols_i[None, :] * (m_pad + 1)
        ident_pos.append(pr[cols_i[None, :] >= niB[:, None]])
        ip = np.concatenate([a.ravel() for a in ident_pos])
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
        bnd_ids=bnd_ids, levels=_levels_of(levels, nodes, B),
        sl_pad=sl_pad, sr_pad=sr_pad, map_l=map_l, map_r=map_r,
        compress=rank_cap > 0, rank_cap=rank_cap,
        cplan=cplan if rank_cap > 0 else None, n1=n1, n2=n2,
        groups_l=_mk_groups(groups_l), groups_r=_mk_groups(groups_r)))



def plan_factorization(A: sp.spmatrix, tree: NDTree, opts: SolverOptions,
                       batch_multiple: int = 1) -> Plan:
    """Run the symbolic phase and build the batched numeric schedule.

    batch_multiple: round every level's batch size up to a multiple of this (with
    decoupled identity dummy fronts), so the node axis divides a device-mesh axis.
    """
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

    def _child_sig(kid: int):
        """HSS layout signature of a child's emitted Schur complement, or None
        if the child's batch does not emit (structured-consumable) HSS."""
        bp = batches[int(s_batch[kid])]
        if bp.compress and bp.cplan is not None and bp.cplan.depth >= 2:
            return (bp.cplan, bp.rank_cap)
        return None

    for nodes_all, is_leaf_batch, compress in groups:
        # per-node structured eligibility: a node assembles structurally when
        # both children emit HSS Schur complements; nodes are partitioned by
        # their (left, right) layout signature - one structured sub-batch per
        # distinct pair, one regular sub-batch for the rest
        subsets: List[Tuple[np.ndarray, Optional[tuple]]] = []
        if compress and opts.hss and not is_leaf_batch:
            sig_groups: Dict[tuple, List[int]] = {}
            regular: List[int] = []
            for nd in nodes_all:
                sl_ = _child_sig(int(tree.left[nd]))
                sr_ = _child_sig(int(tree.right[nd]))
                if sl_ is None or sr_ is None:
                    regular.append(int(nd))
                else:
                    sig_groups.setdefault((sl_, sr_), []).append(int(nd))
            if regular:
                subsets.append((np.asarray(regular, dtype=nodes_all.dtype), None))
            for (sl_, sr_), nds in sig_groups.items():
                subsets.append((np.asarray(nds, dtype=nodes_all.dtype),
                                (sl_[0], sr_[0])))
        else:
            subsets.append((nodes_all, None))

        for nodes, child_cplans in subsets:
            bidx = len(batches)
            B0 = len(nodes)
            B = _round_up(B0, batch_multiple)  # dummy rows (sharding padding)
            ni = np.zeros(B, dtype=np.int64)
            nb = np.zeros(B, dtype=np.int64)
            ni[:B0] = ni_all[nodes]
            nb[:B0] = nb_all[nodes]
            ni_pad = _round_up(int(ni.max()), opts.pad)
            nb_pad = _round_up(int(nb.max()), opts.pad) if nb.max() > 0 else 0
            m_pad = ni_pad + nb_pad

            # HSS output plan of a compressed batch: the emitted S lives on a
            # perfect cluster tree split at [int_loc | bnd_loc]
            # (factorization.jl:109); tentative for regular batches, dropped by
            # the consumption post-pass below when nothing structured reads it
            n1 = n2 = cplan = None
            if compress and opts.hss and int(nb.max()) > 0:
                from hsolve_torch.ops.hss import plan_cluster

                n1 = np.zeros(B, dtype=np.int64)
                n2 = np.zeros(B, dtype=np.int64)
                n1[:B0] = loc.n_int[nodes]
                n2[:B0] = loc.n_bnd[nodes]
                cplan = plan_cluster(int(n1.max()), int(n2.max()), opts.leafsize,
                                     min_depth=2)

            if child_cplans is not None and cplan is not None:
                batches.append(_plan_structured_batch(
                    gather, tree, loc, nodes, B, ni, nb, n1, n2, cplan,
                    child_cplans, levels, (s_batch, s_row), opts, N,
                    cnnz=cs if pools is not None else None))
                s_batch[nodes] = bidx
                s_row[nodes] = np.arange(B0, dtype=np.int64)
                continue

            _plan_regular_batch(
                gather, tree, loc, nodes, B, ni, nb, ni_pad, nb_pad, m_pad,
                is_leaf_batch, compress, cplan, n1, n2, levels, s_batch, s_row,
                batches, opts, N, bidx, pools, deferred)

    if deferred:
        from hsolve_torch.native import plan_batches_all_native

        for d, (fpos, fval, fsrc) in zip(
                deferred, plan_batches_all_native(gather, deferred)):
            bp = batches[d["bidx"]]
            bp.front_pos = fpos
            bp.front_vals = fval
            bp.front_src = fsrc

    # consumption post-pass: keep HSS emission only where a structured batch
    # (or an HSS root solve) actually consumes it
    consumed = set()
    for bp in batches:
        if bp.structured:
            for g in bp.groups_l + bp.groups_r:
                consumed.add(g.src_batch)
    if len(tree.bnd_idx[tree.root]) > 0:
        consumed.add(len(batches) - 1)   # an HSS root consumes the top stack
    for i, bp in enumerate(batches):
        if bp.cplan is not None and not bp.structured and i not in consumed:
            bp.cplan = None

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
