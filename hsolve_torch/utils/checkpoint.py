"""Checkpoint / resume for factorizations (port of
``hsolve/utils/checkpoint.py``).

:func:`save_solver` writes everything ``solve`` needs, the level records,
the root and the permutation, as one ``torch.save`` of plain containers
(dicts, lists, tensors, ints, strings); :func:`load_solver` reads it with
``torch.load(..., weights_only=True)``, so no pickled class runs, and
rebuilds the records through
:func:`~hsolve_torch.interop.factorization_from_numpy`, the walker that also
carries the JAX package's factors across.  A loaded solver solves without
re-planning or re-factoring.

Every level kind (dense, low-rank compressed, structured HSS) and both roots
(``RootSolve``, ``RootHss``) are saved, in any value type.  A factorization
sharded over a mesh is gathered first (its solve data's ``gathered``), as
the JAX package's ``np.asarray`` gathers each sharded leaf: every rank
calls :func:`save_solver`, rank 0 writes the one-device format, and
:func:`load_solver` reads it as any checkpoint.  Each HSS record's cluster
plan is saved as its four ints.  Not saved: the CUDA graphs
that :func:`~hsolve_torch.krylov.gmres_compiled` caches on a solve data
object (a loaded solver captures its own) and ``Hss._packed`` (rebuilt on
first use).

The JAX package's checkpoints pickle a JAX treedef, so the port reads only
its own files.
"""

from __future__ import annotations

import dataclasses

import torch

from hsolve_torch.factor import SolveData, data_dtype, on_device, solve_in_type
from hsolve_torch.interop import factorization_from_numpy
from hsolve_torch.kernels import resolve_device

FORMAT = "hsolve_torch.solver"
VERSION = 1


def _record(obj):
    """A factor record as plain containers: dataclasses as dicts of their
    public fields, lists as lists, tensors as compact host copies."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _record(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if not f.name.startswith("_")}
    if isinstance(obj, list):
        return [_record(a) for a in obj]
    if isinstance(obj, torch.Tensor):
        # strides kept (a column-major LU stays so), views of a larger
        # buffer copied alone
        return obj.detach().resolve_conj().to("cpu", copy=True)
    return obj


def save_solver(path: str, F) -> None:
    """Persist the solve data of ``F`` (a ``Factorization`` or a
    :class:`LoadedSolver`): levels, root, permutation, ``N``, value type.
    For a factorization sharded over a mesh, collective: every rank calls
    it, the shards are gathered to rank 0, and rank 0 alone writes ``path``
    (the one-device format, the same ``FORMAT`` and ``VERSION``)."""
    data = F.solve_data.gathered(dst=0)
    if data is None:
        return
    levels, root, dperm, _ = data
    torch.save({"format": FORMAT, "version": VERSION, "N": int(F.N),
                "dtype": str(data_dtype(levels, root)).removeprefix("torch."),
                "perm": dperm.to("cpu", copy=True),
                "levels": [_record(lev) for lev in levels],
                "root": _record(root)}, path)


class LoadedSolver:
    """Solve-capable handle restored from a checkpoint (the ``solve`` /
    ``solve_data`` surface of ``Factorization``).  ``solve_data`` is a
    :class:`~hsolve_torch.factor.SolveData`, so ``gmres_compiled`` caches
    its graphs on it as on a live factorization's."""

    def __init__(self, N: int, solve_data: SolveData):
        self.N = N
        self.solve_data = solve_data

    @property
    def device(self) -> torch.device:
        return self.solve_data[2].device

    @property
    def dtype(self) -> torch.dtype:
        return data_dtype(self.solve_data[0], self.solve_data[1])

    def solve(self, b) -> torch.Tensor:
        """x = F^{-1} b in the original ordering, as ``Factorization.solve``."""
        return solve_in_type(self.solve_data, on_device(b, self.device))

    ldiv = solve


def load_solver(path: str, device="cuda") -> LoadedSolver:
    """Restore a :func:`save_solver` checkpoint onto ``device`` ("cuda[:i]",
    the default, or "cpu"); a missing card raises, nothing falls back to the
    CPU."""
    dev = resolve_device(device)
    blob = torch.load(path, map_location=dev, weights_only=True)
    if blob.get("format") != FORMAT or blob.get("version") != VERSION:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint of version "
                         f"{VERSION}")
    F = factorization_from_numpy(blob["levels"], blob["root"],
                                 blob["perm"].cpu().numpy(), dev)
    if str(F.dtype).removeprefix("torch.") != blob["dtype"]:
        raise ValueError(f"{path}: records of {F.dtype}, header {blob['dtype']}")
    return LoadedSolver(blob["N"], F.solve_data)
