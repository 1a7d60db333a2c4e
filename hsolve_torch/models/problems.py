"""Problem generators: P1-FEM Poisson / Helmholtz on structured meshes.

The reference ships these problems only as absent ``.mat`` blobs
(``reference: .MISSING_LARGE_BLOBS:1-4``: poisson2d_p1_h64/h128, helmholtz2d_p1_h64/
h128, P1 FEM, elimination trees precomputed in MATLAB).  This module generates the same
problem family natively:

- :func:`poisson2d` / :func:`helmholtz2d`: P1 finite elements on the structured right-
  triangulation of the unit square with mesh size h = 1/n, homogeneous Dirichlet BC
  (interior DOFs only).  ``helmholtz2d`` assembles ``K - k^2 M`` (real, indefinite) or
  the complex impedance variant ``K - k^2 M - i*k*damping*M``.
- :func:`poisson3d` / :func:`helmholtz3d`: 7-point finite differences on the unit cube.

All return scipy CSR matrices with a row-major grid numbering of interior points, which
is what :func:`hsolve_torch.models.dissect.nested_dissection` expects.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _grid_ids_2d(m1: int, m2: int) -> np.ndarray:
    return np.arange(m1 * m2).reshape(m1, m2)


def p1_fem_2d(n: int):
    """Assemble P1 stiffness K and mass M on the structured triangulation of the unit
    square (each of the n*n cells split along the same diagonal), homogeneous Dirichlet.

    Returns (K, M) as CSR over the (n-1)^2 interior DOFs.  On this mesh the stiffness
    reduces to the classic 5-point stencil; the consistent mass couples the diagonal
    neighbors of the triangulation as well (connectivity reach 1 in Chebyshev distance,
    which the wide-separator nested dissection relies on).
    """
    h = 1.0 / n
    m = n - 1
    ids = _grid_ids_2d(m, m)

    # local P1 element matrices for the two right triangles of a cell (diagonal from
    # (i, j) to (i+1, j+1)); stiffness is h-independent, mass scales with h^2/24.
    # triangle 1: vertices (0,0), (1,0), (1,1); triangle 2: (0,0), (1,1), (0,1).
    Kloc = 0.5 * np.array([[2.0, -1.0, -1.0], [-1.0, 1.0, 0.0], [-1.0, 0.0, 1.0]])
    Mloc = (h * h / 24.0) * np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]])
    # Kloc above is for a right triangle with the right angle at vertex 0.

    rows, cols, kvals, mvals = [], [], [], []

    # grid vertices are (i, j), i=0..n, j=0..n ; interior (1..n-1)^2 -> ids[i-1, j-1]
    def vid(i, j):
        if 1 <= i <= m and 1 <= j <= m:
            return ids[i - 1, j - 1]
        return -1  # boundary vertex (eliminated by Dirichlet)

    tri1 = [(0, 0), (1, 0), (1, 1)]  # right angle at (1, 0)
    tri2 = [(0, 0), (1, 1), (0, 1)]  # right angle at (0, 1)
    # per-triangle vertex order chosen so the right angle is at local vertex 0:
    tris = [
        ([(1, 0), (0, 0), (1, 1)], Kloc),
        ([(0, 1), (0, 0), (1, 1)], Kloc),
    ]
    del tri1, tri2

    for ci in range(n):
        for cj in range(n):
            for verts, Ke in tris:
                vids = [vid(ci + dv[0], cj + dv[1]) for dv in verts]
                for a in range(3):
                    if vids[a] < 0:
                        continue
                    for b in range(3):
                        if vids[b] < 0:
                            continue
                        rows.append(vids[a])
                        cols.append(vids[b])
                        kvals.append(Ke[a, b])
                        mvals.append(Mloc[a, b])
    N = m * m
    K = sp.csr_matrix((kvals, (rows, cols)), shape=(N, N))
    M = sp.csr_matrix((mvals, (rows, cols)), shape=(N, N))
    K.sum_duplicates()
    M.sum_duplicates()
    return K, M


def poisson2d(n: int):
    """P1 Poisson on the unit square, h = 1/n; returns (A, b, grid_shape) with b the
    load vector of f = 1 (capability of the absent poisson2d_p1 blobs)."""
    K, M = p1_fem_2d(n)
    b = np.asarray(M.sum(axis=1)).ravel()  # load of f(x) = 1
    m = n - 1
    return K.tocsr(), b, (m, m)


def helmholtz2d(n: int, k: float = 40.0, damping: float = 0.0):
    """P1 Helmholtz ``K - k^2 M`` (plus ``-1j*k*damping*M`` if damping > 0) on the unit
    square with Dirichlet BC; returns (A, b, grid_shape)."""
    K, M = p1_fem_2d(n)
    A = K - (k * k) * M
    if damping > 0.0:
        A = A.astype(np.complex128) - 1j * k * damping * M
    b = np.asarray(M.sum(axis=1)).ravel().astype(A.dtype)
    m = n - 1
    return A.tocsr(), b, (m, m)


def _fd_nd(shape, stencil_val, center_val):
    """Assemble an n-D finite-difference operator with the given off-diagonal value per
    axis neighbor and center value, Dirichlet BC."""
    N = int(np.prod(shape))
    ids = np.arange(N).reshape(shape)
    rows, cols, vals = [ids.ravel()], [ids.ravel()], [np.full(N, center_val)]
    for ax in range(len(shape)):
        sl_lo = [slice(None)] * len(shape)
        sl_hi = [slice(None)] * len(shape)
        sl_lo[ax] = slice(0, -1)
        sl_hi[ax] = slice(1, None)
        a = ids[tuple(sl_lo)].ravel()
        b = ids[tuple(sl_hi)].ravel()
        rows += [a, b]
        cols += [b, a]
        vals += [np.full(len(a), stencil_val)] * 2
    A = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                      shape=(N, N))
    return A


def poisson3d(n: int):
    """7-point FD Poisson on the unit cube, h = 1/n; returns (A, b, grid_shape)."""
    m = n - 1
    h2 = (1.0 / n) ** 2
    A = _fd_nd((m, m, m), -1.0 / h2, 6.0 / h2)
    b = np.ones(m ** 3)
    return A, b, (m, m, m)


def helmholtz3d(n: int, k: float = 20.0):
    """7-point FD Helmholtz (-lap - k^2) on the unit cube; returns (A, b, grid_shape)."""
    m = n - 1
    h2 = (1.0 / n) ** 2
    A = _fd_nd((m, m, m), -1.0 / h2, 6.0 / h2 - k * k)
    b = np.ones(m ** 3)
    return A, b, (m, m, m)
