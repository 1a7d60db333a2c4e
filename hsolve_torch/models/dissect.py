"""Geometric nested dissection on structured grids (host-side planner input).

The reference consumes elimination trees precomputed in MATLAB and shipped inside .mat
files (``reference: util/read_problem.jl:13-24``); the trees must satisfy the
structural invariants that the numeric factorization silently relies on (see
hsolve_torch.utils.trees).  This module builds such trees natively for row-major structured
grids:

- separators are *wide* (``sep_width >= 2 * reach``): this is what makes sibling
  boundary sets disjoint, which the extend-add assembly requires (the reference places
  the two child Schur complements at disjoint positions of the parent front,
  factorization.jl:115-123),
- a node's ``int`` is its separator slab (leaf: its whole box), ``bnd`` is the ring of
  outside DOFs within stencil ``reach`` of the box.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from hsolve_torch.utils.trees import NDTree, NONE


def _box_dofs(ids: np.ndarray, box) -> np.ndarray:
    return ids[tuple(slice(lo, hi) for lo, hi in box)].ravel()


def _ring_dofs(ids: np.ndarray, box, reach: int) -> np.ndarray:
    """DOFs outside ``box`` within Chebyshev distance ``reach`` of it."""
    shape = ids.shape
    grown = [(max(lo - reach, 0), min(hi + reach, s)) for (lo, hi), s in zip(box, shape)]
    grown_d = _box_dofs(ids, grown)
    inner_d = _box_dofs(ids, box)
    return np.setdiff1d(grown_d, inner_d, assume_unique=True)


def nested_dissection(grid_shape: Tuple[int, ...], leafmax: int = 64,
                      sep_width: int = 2, reach: int = 1) -> NDTree:
    """Build a wide-separator nested-dissection tree for a row-major structured grid.

    grid_shape: the interior grid dims (matching the generators in models.problems).
    leafmax: stop splitting when a box has at most this many DOFs (the reference blobs
        use a leaf cap of 100, SURVEY.md section 2 #22).
    sep_width: separator slab thickness; must be >= 2*reach for sibling-boundary
        disjointness.
    """
    if sep_width < 2 * reach:
        raise ValueError("sep_width must be >= 2*reach for disjoint sibling boundaries")
    ids = np.arange(int(np.prod(grid_shape))).reshape(grid_shape)

    left: List[int] = []
    right: List[int] = []
    int_idx: List[np.ndarray] = []
    bnd_idx: List[np.ndarray] = []

    def build(box) -> int:
        sizes = [hi - lo for lo, hi in box]
        ndofs = int(np.prod(sizes))
        ax = int(np.argmax(sizes))
        # need at least one grid line on each side of the separator slab
        can_split = ndofs > leafmax and sizes[ax] >= sep_width + 2
        if not can_split:
            node = len(left)
            left.append(NONE)
            right.append(NONE)
            int_idx.append(_box_dofs(ids, box))
            bnd_idx.append(_ring_dofs(ids, box, reach))
            return node
        lo, hi = box[ax]
        cut = lo + (sizes[ax] - sep_width) // 2  # separator slab [cut, cut+sep_width)
        lbox = list(box)
        rbox = list(box)
        sbox = list(box)
        lbox[ax] = (lo, cut)
        rbox[ax] = (cut + sep_width, hi)
        sbox[ax] = (cut, cut + sep_width)
        l = build(tuple(lbox))
        r = build(tuple(rbox))
        node = len(left)
        left.append(l)
        right.append(r)
        int_idx.append(_box_dofs(ids, tuple(sbox)))
        bnd_idx.append(_ring_dofs(ids, box, reach))
        return node

    root = build(tuple((0, s) for s in grid_shape))
    return NDTree(left=np.asarray(left, dtype=np.int64),
                  right=np.asarray(right, dtype=np.int64),
                  int_idx=int_idx, bnd_idx=bnd_idx, root=root)
