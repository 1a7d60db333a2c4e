"""Problem I/O: ingest the reference's serialized .mat problem format.

Parity with the reference's ``util/read_problem.jl:5-25``: reads ``A`` (sparse), ``b``,
and the ``elim_tree`` dict with fields ``fathers/lsons/rsons/ninter/inter/nbound/bound``
(1-based MATLAB indices), and parses the elimination tree.  The reference's test blobs
are not shipped (``.MISSING_LARGE_BLOBS``), so the native generators in
hsolve_torch.models.problems are the canonical problem source; this reader exists for parity
when blobs are available.
"""

from __future__ import annotations

import numpy as np
import scipy.io
import scipy.sparse as sp

from hsolve_torch.utils.trees import NDTree, parse_elimtree, serialize_elimtree


def _field(d, name):
    # scipy.io.loadmat returns MATLAB structs as (1,1) record arrays of object fields
    out = d[name]
    while isinstance(out, np.ndarray) and out.dtype == object:
        out = out[0, 0] if out.ndim == 2 else out.item()
    return np.asarray(out)


def read_problem(filepath: str):
    """Read (A, b, tree) from a .mat file in the reference's serialized format."""
    try:
        mat = scipy.io.loadmat(filepath, simplify_cells=False)
    except NotImplementedError as e:  # MATLAB v7.3 (HDF5) files
        raise NotImplementedError(
            "MATLAB v7.3 files need an HDF5 reader; re-save as v7 or use the native "
            "generators in hsolve_torch.models.problems") from e
    A = sp.csr_matrix(mat["A"])
    b = np.asarray(mat["b"]).ravel()
    et = mat["elim_tree"]
    if isinstance(et, np.ndarray):
        et = et[0, 0]
    tree = parse_elimtree(
        np.asarray(_field(et, "fathers")).ravel(),
        np.asarray(_field(et, "lsons")).ravel(),
        np.asarray(_field(et, "rsons")).ravel(),
        np.asarray(_field(et, "ninter")).ravel(),
        np.asarray(_field(et, "inter")),
        np.asarray(_field(et, "nbound")).ravel(),
        np.asarray(_field(et, "bound")),
        one_based=True,
    )
    return A, b, tree


def write_problem(filepath: str, A, b, tree: NDTree) -> None:
    """Serialize (A, b, tree) in the reference's format (useful for fixtures)."""
    fathers, lsons, rsons, ninter, inter, nbound, bound = serialize_elimtree(tree)
    scipy.io.savemat(filepath, {
        "A": sp.csc_matrix(A),
        "b": np.asarray(b).reshape(-1, 1),
        "elim_tree": {
            "fathers": fathers.reshape(1, -1), "lsons": lsons.reshape(1, -1),
            "rsons": rsons.reshape(1, -1), "ninter": ninter.reshape(1, -1),
            "inter": inter, "nbound": nbound.reshape(1, -1), "bound": bound,
        },
    })
