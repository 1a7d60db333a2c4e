"""Nested-dissection elimination trees (host-side, NumPy).

Capability parity with the reference tree layer (``reference: src/nesteddissection.jl``):

- :class:`NDTree`           <-> ``NestedDissection`` / ``NDNode`` (nesteddissection.jl:7-21),
  stored flat (arrays of children / index sets) instead of pointer-chasing nodes, so the
  symbolic planner can vectorize over it.
- :func:`symfact`           <-> ``symfact!`` (nesteddissection.jl:29-69)
- :func:`postorder`         <-> ``postorder`` (nesteddissection.jl:73-79)
- :func:`permuted`          <-> ``permuted!`` (nesteddissection.jl:82-88)

All index sets are 0-based numpy int arrays.  Key structural invariants (required by the
numeric factorization, see factor.py):

- the ``int`` sets of all nodes partition the eliminated DOFs; ``postorder`` is a
  permutation of ``0..n-1`` (ints in post-order, then the root boundary),
- for every branch node, ``left.bnd`` and ``right.bnd`` are disjoint (the extend-add
  places child Schur blocks at disjoint front positions, factorization.jl:115-123),
- ``child.bnd`` is contained in ``parent.int + parent.bnd``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

NONE = -1  # "no child" marker


class _PoolViews:
    """Lazy per-node views into a shared index pool: ``seq[i]`` is
    ``pool[off[i] : off[i] + ln[i]]``, built on access.  Materializing the ~2n
    small view objects eagerly after the pooled native symfact dominated the
    symbolic phase at h=128 (~0.4ms of numpy slice-object churn per plan).
    Supports item assignment through a sparse overlay so downstream tree surgery
    (tests, tree editing) keeps list semantics."""

    __slots__ = ("pool", "off", "ln", "_over")

    def __init__(self, pool: np.ndarray, off: np.ndarray, ln: np.ndarray):
        self.pool = pool
        self.off = off
        self.ln = ln
        self._over = None

    def __len__(self) -> int:
        return len(self.off)

    def __getitem__(self, i):
        if self._over is not None:
            v = self._over.get(int(i))
            if v is not None:
                return v
        o = self.off[i]
        return self.pool[o: o + self.ln[i]]

    def __setitem__(self, i, v) -> None:
        if self._over is None:
            self._over = {}
        self._over[int(i)] = v

    def __iter__(self):
        for i in range(len(self.off)):
            yield self[i]


@dataclasses.dataclass
class NDTree:
    """Binary nested-dissection tree stored as flat arrays over node ids."""

    left: np.ndarray        # [nnodes] child id or NONE
    right: np.ndarray       # [nnodes] child id or NONE
    int_idx: List[np.ndarray]   # per node: global DOFs eliminated at this node
    bnd_idx: List[np.ndarray]   # per node: global DOFs this subtree couples to
    root: int

    @property
    def nnodes(self) -> int:
        return len(self.int_idx)

    def copy(self) -> "NDTree":
        return NDTree(left=self.left.copy(), right=self.right.copy(),
                      int_idx=[s.copy() for s in self.int_idx],
                      bnd_idx=[s.copy() for s in self.bnd_idx], root=self.root)

    def shallow_copy(self) -> "NDTree":
        """New list containers sharing the per-node index arrays.  Sufficient for
        the planner: :func:`symfact` and :func:`permuted` only *reassign* list
        entries (new arrays) on un-pooled trees.  CAVEAT: on a tree that already
        carries a symfact pool (``_pool`` set), :func:`permuted` relabels the shared
        pool *in place*, so a shallow copy taken from an already-symfact'ed tree will
        see its view arrays change; take a deep :meth:`copy` in that case.  The
        planner is safe because its symfact always allocates a fresh pool first."""
        out = NDTree(left=self.left.copy(), right=self.right.copy(),
                     int_idx=list(self.int_idx), bnd_idx=list(self.bnd_idx),
                     root=self.root)
        for name in ("_topo_cache", "_heights_cache", "_layers_cache"):
            cached = getattr(self, name, None)
            if cached is not None:  # topology is shared and immutable
                object.__setattr__(out, name, cached)
        return out

    def layers(self) -> List[np.ndarray]:
        """Nodes grouped by level (root first), computed by vectorized BFS."""
        cached = getattr(self, "_layers_cache", None)
        if cached is not None:
            return cached
        out = []
        cur = np.asarray([self.root], dtype=np.int64)
        while len(cur):
            out.append(cur)
            kids = np.concatenate([self.left[cur], self.right[cur]])
            cur = kids[kids != NONE]
        object.__setattr__(self, "_layers_cache", out)
        return out

    def depth(self) -> int:
        """Number of node levels (single node tree -> 1); used to resolve negative
        swlevel (parity with ``depth(nd)`` at factorization.jl:8)."""
        return len(self.layers())

    def heights(self) -> np.ndarray:
        """Per-node height (leaves 0), by per-layer vectorized bottom-up passes.
        Memoized (topology is immutable in practice, like :meth:`topo_order`)."""
        cached = getattr(self, "_heights_cache", None)
        if cached is not None and len(cached) == self.nnodes:
            return cached
        h = np.zeros(self.nnodes, dtype=np.int64)
        for layer in reversed(self.layers()):
            l, r = self.left[layer], self.right[layer]
            m = l != NONE
            if m.any():
                lm = np.where(m, l, 0)
                rm = np.where(m, r, 0)
                h[layer] = np.where(m, 1 + np.maximum(h[lm], h[rm]), h[layer])
        object.__setattr__(self, "_heights_cache", h)
        return h

    def topo_order(self) -> np.ndarray:
        """Node ids in post-order (children before parents, left before right).

        Memoized - the topology (left/right/root) is immutable in practice (symfact
        and permuted only rewrite index sets); callers in the symbolic phase hit this
        several times per plan."""
        cached = getattr(self, "_topo_cache", None)
        if cached is not None and len(cached) == self.nnodes:
            return cached
        try:
            from hsolve_torch.native import tree_postorder_native

            arr = tree_postorder_native(self.left, self.right, self.root,
                                        self.nnodes)
        except Exception:
            arr = None
        if arr is None:
            order: List[int] = []
            stack = [(self.root, False)]
            while stack:
                node, expanded = stack.pop()
                if node == NONE:
                    continue
                if expanded:
                    order.append(node)
                else:
                    stack.append((node, True))
                    stack.append((self.right[node], False))
                    stack.append((self.left[node], False))
            arr = np.asarray(order, dtype=np.int64)
        object.__setattr__(self, "_topo_cache", arr)
        return arr

    def levels(self) -> np.ndarray:
        """Per-node level with root = 1 (parity with the reference's recursion level,
        factorization.jl:14-23); used for the compression switch."""
        lev = np.zeros(self.nnodes, dtype=np.int64)
        for d, layer in enumerate(self.layers()):
            lev[layer] = d + 1
        return lev

    def validate(self) -> None:
        """Check the structural invariants listed in the module docstring."""
        order = self.topo_order()
        if len(order) != self.nnodes:
            raise ValueError("tree is not connected / has unreachable nodes")
        for i in order:
            l, r = self.left[i], self.right[i]
            if (l == NONE) != (r == NONE):
                raise ValueError(
                    f"node {i} has exactly one child; expected a binary tree "
                    "(parity with factorization.jl:25)")
            if l != NONE:
                bl = set(self.bnd_idx[l].tolist())
                br = set(self.bnd_idx[r].tolist())
                if bl & br:
                    raise ValueError(f"node {i}: children boundaries overlap")
                parent_set = set(self.int_idx[i].tolist()) | set(self.bnd_idx[i].tolist())
                if not (bl | br) <= parent_set:
                    raise ValueError(f"node {i}: child boundary not covered by parent int+bnd")
        ints = np.concatenate([self.int_idx[i] for i in order] + [self.bnd_idx[self.root]])
        if len(np.unique(ints)) != len(ints):
            raise ValueError("int sets (plus root bnd) are not disjoint")


@dataclasses.dataclass
class LocTree:
    """Local-index companion tree produced by :func:`symfact` (the reference's
    ``nd_loc``, nesteddissection.jl:30-33): for each node, the positions *within its own
    boundary vector* of the DOFs its parent eliminates (``int_loc``) and of the DOFs
    that stay on the parent's boundary (``bnd_loc``).

    ``n_int``/``n_bnd`` hold the per-node lengths as flat arrays (the planner indexes
    them wholesale; per-node ``len()`` calls dominated symbolic time at scale)."""

    int_loc: List[np.ndarray]
    bnd_loc: List[np.ndarray]
    n_int: Optional[np.ndarray] = None   # [nnodes]
    n_bnd: Optional[np.ndarray] = None   # [nnodes]
    # pooled layout (native symfact): node i's [int_loc; bnd_loc] is the contiguous
    # segment pool[off[i] : off[i] + n_int[i] + n_bnd[i]]; None on the numpy path
    pool: Optional[np.ndarray] = None
    off: Optional[np.ndarray] = None


def _symfact_native(tree: NDTree, order: np.ndarray):
    """Call the pooled C++ symfact (gather.cpp symfact_pooled); None when the
    native library is unavailable."""
    try:
        from hsolve_torch.native import symfact_pooled_native
    except Exception:
        return None
    n = tree.nnodes
    if len(order) != n:
        # disconnected/malformed tree: the C loop indexes order[0:n], so a short
        # topo order would read past the array; fall back to the numpy symfact
        # whose validate() diagnostics fire
        return None
    ilens = np.fromiter((len(tree.int_idx[i]) for i in range(n)), np.int64, n)
    blens = np.fromiter((len(tree.bnd_idx[i]) for i in range(n)), np.int64, n)
    iptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(ilens, out=iptr[1:])
    bptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(blens, out=bptr[1:])
    ipool = np.concatenate(tree.int_idx) if iptr[-1] else np.empty(0, np.int64)
    bpool = np.concatenate(tree.bnd_idx) if bptr[-1] else np.empty(0, np.int64)
    ndofs = int(max(ipool.max() if len(ipool) else -1,
                    bpool.max() if len(bpool) else -1)) + 1
    return symfact_pooled_native(tree.left, tree.right, tree.root, order,
                                 iptr, ipool, bptr, bpool, ndofs)


def symfact(tree: NDTree) -> LocTree:
    """Symbolic factorization (parity with ``symfact!``, nesteddissection.jl:29-69).

    Reorders each branch node's index sets in place to the canonical ``[left; right]``
    block order and returns the local-index tree:

    - ``int_loc[child]`` = positions within ``child.bnd`` of DOFs in ``parent.int``,
    - ``bnd_loc[child]`` = positions within ``child.bnd`` of DOFs in ``parent.bnd``,
    - ``parent.int = [left.bnd[int_loc_l]; right.bnd[int_loc_r]]`` and likewise for bnd,
    - root: ``int_loc = 0..len(root.bnd)`` , ``bnd_loc = []`` (nesteddissection.jl:31-32).

    Level-vectorized: every DOF's eliminating node is fixed by the *input* tree, so
    a child-bnd DOF belongs to the parent's int iff ``elim[dof] == parent``
    (the invariant ``child.bnd subset-of parent.int + parent.bnd`` makes the complement
    exactly the parent-bnd part).  All branches at one height are then processed with a
    handful of pooled numpy ops instead of per-node membership queries (the reference's
    ``findall(in(...))`` per node, nesteddissection.jl:42-43).
    """
    n = tree.nnodes
    _E = np.empty(0, np.int64)  # shared placeholder; entries are reassigned below
    order = tree.topo_order()

    # native pooled path: one C++ pass emits every node's final [int; bnd] and
    # [int_loc; bnd_loc] contiguously into shared pools; the per-node lists become
    # zero-copy views so the existing API (and in-place pool relabeling, see
    # permuted) keeps working
    native = _symfact_native(tree, order)
    if native is not None:
        vals_pool, vals_off, ni, nb, loc_pool, loc_off, loc_icnt = native
        tree.int_idx = _PoolViews(vals_pool, vals_off, ni)
        tree.bnd_idx = _PoolViews(vals_pool, vals_off + ni, nb)
        object.__setattr__(tree, "_pool", vals_pool)
        object.__setattr__(tree, "_pool_off", vals_off)
        object.__setattr__(tree, "_pool_ni", ni)
        object.__setattr__(tree, "_pool_nb", nb)
        # every node's loc segment length is its final bnd length (the root's
        # identity segment too: loc_icnt[root] == nb[root])
        mseg = nb
        loc = LocTree(
            _PoolViews(loc_pool, loc_off, loc_icnt),
            _PoolViews(loc_pool, loc_off + loc_icnt, mseg - loc_icnt),
            n_int=loc_icnt, n_bnd=mseg - loc_icnt, pool=loc_pool, off=loc_off)
        return loc

    loc = LocTree([_E] * n, [_E] * n,
                  n_int=np.zeros(n, dtype=np.int64),
                  n_bnd=np.zeros(n, dtype=np.int64))
    # eliminating node of every DOF (from the input int sets, which partition the
    # eliminated DOFs); root-bnd DOFs keep sentinel -1 (eliminated at "the root solve")
    ipool = np.concatenate([tree.int_idx[i] for i in range(n)] or
                           [np.empty(0, np.int64)])
    rb = tree.bnd_idx[tree.root]
    nmax = max(int(ipool.max()) if len(ipool) else -1,
               int(rb.max()) if len(rb) else -1)
    elim = np.full(nmax + 1, -1, dtype=np.int64)
    elim[ipool] = np.repeat(np.arange(n, dtype=np.int64),
                            [len(tree.int_idx[i]) for i in range(n)])

    # group branches by height so children are final before parents are assembled
    height = tree.heights()
    max_h = int(height[tree.root]) if n else 0
    branches = np.flatnonzero(tree.left != NONE)
    by_h: List[np.ndarray] = [
        branches[height[branches] == h] for h in range(max_h + 1)]

    for h in range(1, max_h + 1):
        parents = by_h[h]
        if len(parents) == 0:
            continue
        # child pool, ordered [l(p0), r(p0), l(p1), r(p1), ...]
        kids = np.empty(2 * len(parents), dtype=np.int64)
        kids[0::2] = tree.left[parents]
        kids[1::2] = tree.right[parents]
        segs = [tree.bnd_idx[c] for c in kids]
        seg_len = np.array([len(s) for s in segs], dtype=np.int64)
        off = np.concatenate([[0], np.cumsum(seg_len)])
        pool = np.concatenate(segs) if len(segs) else np.empty(0, np.int64)
        owner = np.repeat(np.asarray(parents, dtype=np.int64), 2)
        seg_of = np.repeat(np.arange(len(kids)), seg_len)
        m = elim[pool] == owner[seg_of]                     # in parent's int?
        pos = np.arange(len(pool), dtype=np.int64) - off[seg_of]
        ipos = pos[m]
        bpos = pos[~m]
        ivals = pool[m]
        bvals = pool[~m]
        # per-segment split points within the masked selections
        icnt = np.zeros(len(kids), dtype=np.int64)
        np.add.at(icnt, seg_of[m], 1)
        ioff = np.concatenate([[0], np.cumsum(icnt)])
        bcnt = seg_len - icnt
        boff = np.concatenate([[0], np.cumsum(bcnt)])
        loc.n_int[kids] = icnt
        loc.n_bnd[kids] = bcnt
        for k, c in enumerate(kids):
            loc.int_loc[c] = ipos[ioff[k]: ioff[k + 1]]
            loc.bnd_loc[c] = bpos[boff[k]: boff[k + 1]]
        for k, p in enumerate(parents):
            tree.int_idx[p] = ivals[ioff[2 * k]: ioff[2 * k + 2]]
            tree.bnd_idx[p] = bvals[boff[2 * k]: boff[2 * k + 2]]

    root = tree.root
    loc.int_loc[root] = np.arange(len(tree.bnd_idx[root]), dtype=np.int64)
    loc.bnd_loc[root] = np.empty(0, np.int64)
    loc.n_int[root] = len(tree.bnd_idx[root])
    return loc


def postorder(tree: NDTree) -> np.ndarray:
    """Global elimination order: all ``int`` sets in post-order, then the root boundary
    (parity with ``postorder``, nesteddissection.jl:73-79)."""
    pool = getattr(tree, "_pool", None)
    if pool is not None:
        # pooled symfact layout: one ragged gather over the shared pool instead
        # of concatenating ~n small per-node views
        order = tree.topo_order()
        starts = tree._pool_off[order]
        lens = tree._pool_ni[order]
        root = tree.root
        starts = np.append(starts, tree._pool_off[root] + tree._pool_ni[root])
        lens = np.append(lens, tree._pool_nb[root])
        keep = lens > 0
        starts, lens = starts[keep], lens[keep]
        if not len(lens):
            return np.zeros(0, dtype=np.int64)
        cum = np.cumsum(lens)
        idx = np.ones(int(cum[-1]), dtype=np.int64)
        idx[0] = starts[0]
        idx[cum[:-1]] = starts[1:] - (starts[:-1] + lens[:-1] - 1)
        return pool[np.cumsum(idx)]
    parts = [tree.int_idx[i] for i in tree.topo_order()]
    parts.append(tree.bnd_idx[tree.root])
    return np.concatenate(parts).astype(np.int64)


def permuted(tree: NDTree, relabel: np.ndarray) -> NDTree:
    """Remap every index set through ``relabel`` (new_id = relabel[old_id]); parity with
    ``permuted!`` (nesteddissection.jl:82-88), applied in place and returned."""
    pool = getattr(tree, "_pool", None)
    if pool is not None:
        # pooled tree (native symfact): one vectorized relabel of the shared pool;
        # the per-node int_idx/bnd_idx views see the update in place
        pool[:] = relabel[pool]
        return tree
    for i in range(tree.nnodes):
        tree.int_idx[i] = relabel[tree.int_idx[i]]
        tree.bnd_idx[i] = relabel[tree.bnd_idx[i]]
    return tree


def contiguous(idx: np.ndarray):
    """Collapse a sorted-dense index vector into a range when possible (capability of
    ``contigious``, nesteddissection.jl:91, with the typo fixed)."""
    if len(idx) and np.array_equal(idx, np.arange(idx[0], idx[-1] + 1)):
        return range(int(idx[0]), int(idx[-1]) + 1)
    return idx


def parse_elimtree(fathers: np.ndarray, lsons: np.ndarray, rsons: np.ndarray,
                   ninter: np.ndarray, inter: np.ndarray,
                   nbound: np.ndarray, bound: np.ndarray,
                   one_based: bool = True) -> NDTree:
    """Deserialize the reference author's MATLAB elimination-tree format (parity with
    ``parse_elimtree``, nesteddissection.jl:105-148).

    ``inter[:, i]`` / ``bound[:, i]`` hold node i's index sets (first ``ninter[i]`` /
    ``nbound[i]`` entries); ``fathers/lsons/rsons`` use -1 for "missing".  With
    ``one_based=True`` (MATLAB data) node links and DOF indices are converted to 0-based.
    """
    fathers = np.asarray(fathers, dtype=np.int64).ravel()
    lsons = np.asarray(lsons, dtype=np.int64).ravel()
    rsons = np.asarray(rsons, dtype=np.int64).ravel()
    ninter = np.asarray(ninter, dtype=np.int64).ravel()
    nbound = np.asarray(nbound, dtype=np.int64).ravel()
    inter = np.asarray(inter, dtype=np.int64)
    bound = np.asarray(bound, dtype=np.int64)
    nnodes = len(fathers)
    if not (len(lsons) == len(rsons) == len(ninter) == len(nbound)
            == inter.shape[1] == bound.shape[1] == nnodes):
        raise ValueError("dimensions inconsistent among inputs")
    off = 1 if one_based else 0
    roots = np.flatnonzero(fathers == -1)
    if len(roots) != 1:
        raise ValueError("found either less than or more than one root")

    left = np.full(nnodes, NONE, dtype=np.int64)
    right = np.full(nnodes, NONE, dtype=np.int64)
    int_idx, bnd_idx = [], []
    for i in range(nnodes):
        if lsons[i] != -1:
            left[i] = lsons[i] - off
        if rsons[i] != -1:
            right[i] = rsons[i] - off
        int_idx.append(inter[: ninter[i], i].astype(np.int64) - off)
        bnd_idx.append(bound[: nbound[i], i].astype(np.int64) - off)
    return NDTree(left=left, right=right, int_idx=int_idx, bnd_idx=bnd_idx,
                  root=int(roots[0]))


def serialize_elimtree(tree: NDTree, one_based: bool = True):
    """Inverse of :func:`parse_elimtree` (round-trip helper for tests and .mat export)."""
    n = tree.nnodes
    off = 1 if one_based else 0
    fathers = np.full(n, -1, dtype=np.int64)
    lsons = np.full(n, -1, dtype=np.int64)
    rsons = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        for c, arr in ((tree.left[i], lsons), (tree.right[i], rsons)):
            if c != NONE:
                arr[i] = c + off
                fathers[c] = i + off
    ninter = np.array([len(s) for s in tree.int_idx], dtype=np.int64)
    nbound = np.array([len(s) for s in tree.bnd_idx], dtype=np.int64)
    mi, mb = max(int(ninter.max()), 1), max(int(nbound.max()), 1)
    inter = np.zeros((mi, n), dtype=np.int64)
    bound = np.zeros((mb, n), dtype=np.int64)
    for i in range(n):
        inter[: ninter[i], i] = tree.int_idx[i] + off
        bound[: nbound[i], i] = tree.bnd_idx[i] + off
    return fathers, lsons, rsons, ninter, inter, nbound, bound
