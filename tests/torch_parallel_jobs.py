"""Rank functions of the mesh tests (``tests/test_torch_parallel*.py``).

Each runs in a child process started by
:func:`hsolve_torch.parallel.dist.run_ranks` (gloo on the CPU, a file
store), so this module imports torch and ``hsolve_torch`` only: the JAX
side of each comparison runs in the test process and reaches the ranks as
numpy arrays.  Each returns numpy values; rank 0 adds the gathered records.
"""

import numpy as np
import scipy.sparse.linalg as spla
import torch

import hsolve_torch as ht
from hsolve_torch.factor import CompressedLevel, DenseLevel
from hsolve_torch.parallel.dist import make_mesh, shard_level_input
from hsolve_torch.utils.profiling import collective_estimate

EXACT = dict(swlevel=0)
COMPRESSED = dict(swlevel=-2, swsize=1, atol=1e-4, rtol=1e-4, leafsize=16)


class TableSketch:
    """A :data:`~hsolve_torch.factor.Sketch` that hands out draws recorded
    beforehand (it pickles, so ranks can take the JAX package's draws)."""

    def __init__(self, table):
        self.table = table

    def __call__(self, key, shape_a, shape_b):
        return tuple(torch.as_tensor(a) for a in self.table[key])


class RecordingSketch:
    """Wraps a sketch and keeps every draw it hands out, by key."""

    def __init__(self, sketch):
        self.sketch, self.table = sketch, {}

    def __call__(self, key, shape_a, shape_b):
        out = self.sketch(key, shape_a, shape_b)
        self.table[key] = tuple(o.numpy() for o in out)
        return out


def records(levels) -> list:
    """Per level: its kind, its ranks, and the Gauss transforms as products
    (``L``, ``R``; a low-rank pair multiplied out)."""
    out = []
    for lev in levels:
        if isinstance(lev, DenseLevel):
            out.append({"kind": "dense", "L": lev.L.numpy(), "R": lev.R.numpy()})
            continue
        rec = {"kind": "compressed" if isinstance(lev, CompressedLevel)
               else "structured",
               "L": (lev.LU_ @ lev.LV_.transpose(-1, -2)).numpy(),
               "R": (lev.RU_ @ lev.RV_.transpose(-1, -2)).numpy()}
        if isinstance(lev, CompressedLevel):
            rec["ranks"] = np.stack([lev.lrank.numpy(), lev.rrank.numpy()])
        else:
            rec["ranks"] = lev.rank_maxed.numpy()
        out.append(rec)
    return out


def _gmres(A, b, M):
    ell = ht.to_ell(A, device="cpu")
    x, info = ht.gmres(lambda v: ht.ell_matvec(ell, v), torch.as_tensor(b), M=M,
                       reltol=1e-9, restart=30, maxiter=30)
    return x.numpy(), info


def exact_job(front: int) -> dict:
    """poisson2d(33) on the exact path, the mesh ``world / front x front``:
    the gathered levels, the single-process factor of the same padded plan,
    the solve, the bytes beside ``collective_estimate``; then GMRES on
    helmholtz2d(33, k=10) with the mesh factor as ``M``."""
    mesh = make_mesh(front=front, device="cpu")
    A, b, shape = ht.poisson2d(33)
    tree = ht.nested_dissection(shape, leafmax=40)
    F = ht.factor(A, tree, device="cpu", mesh=mesh, **EXACT)
    out = {"x": F.solve(b).numpy(), "specs": [s.kind for s in F.specs],
           "bytes": list(F.factor_bytes),
           "estimate": [lv["comm_bytes"] for lv in collective_estimate(
               F.plan, mesh.size(0), 8)["per_level"]],
           "solve_bytes": F.solve_bytes(),
           "x_ref": spla.spsolve(A.tocsc(), b)}
    F1 = ht.factor_with_plan(F.plan, ht.SolverOptions(**EXACT), device="cpu")
    out["x_single"] = F1.solve(b).numpy()
    G = F.gather_levels()
    if G is not None:
        out["levels"], out["single"] = records(G.levels), records(F1.levels)
    Ah, bh, sh = ht.helmholtz2d(33, k=10.0)
    Fh = ht.factor(Ah, ht.nested_dissection(sh, leafmax=40), device="cpu",
                   mesh=mesh, **EXACT)
    out["xh"], out["info"] = _gmres(Ah, bh, Fh.solve)
    out["xh_ref"] = spla.spsolve(Ah.tocsc(), bh)
    return out


def front_job(tree: int, front: int) -> dict:
    """The unpadded plan on a ``tree x front`` mesh: levels the tree axis
    cannot divide are held whole, their Schur products split over the
    ``front`` axis; against the single-process factor of the same plan."""
    mesh = make_mesh(tree=tree, front=front, device="cpu")
    A, b, shape = ht.poisson2d(33)
    plan = ht.plan_factorization(A, ht.nested_dissection(shape, leafmax=40),
                                 ht.SolverOptions(**EXACT))
    F = ht.factor_with_plan(plan, ht.SolverOptions(**EXACT), device="cpu",
                            mesh=mesh)
    F1 = ht.factor_with_plan(plan, ht.SolverOptions(**EXACT), device="cpu")
    out = {"x": F.solve(b).numpy(), "x_single": F1.solve(b).numpy(),
           "specs": [s.kind for s in F.specs], "bytes": list(F.factor_bytes)}
    G = F.gather_levels()
    if G is not None:
        out["levels"], out["single"] = records(G.levels), records(F1.levels)
    return out


def compressed_job(table: dict) -> dict:
    """poisson2d(49) compressed and structured on a 2-rank tree mesh, with
    the recorded sketches: gathered records, ranks, GMRES."""
    mesh = make_mesh(device="cpu")
    A, b, shape = ht.poisson2d(49)
    F = ht.factor(A, ht.nested_dissection(shape, leafmax=24), device="cpu",
                  mesh=mesh, sketch=TableSketch(table), **COMPRESSED)
    out = {"rank_report": F.rank_report(), "maxrank": F.maxrank(),
           "specs": [s.kind for s in F.specs], "bytes": list(F.factor_bytes)}
    out["x"], out["info"] = _gmres(A, b, F.solve)
    out["x_ref"] = spla.spsolve(A.tocsc(), b)
    G = F.gather_levels()
    if G is not None:
        out["levels"] = records(G.levels)
    return out


def smoke_job() -> dict:
    """Two ranks: an all-reduce, and a ``[2, 8, 8]`` level stack split one
    front a rank, factored by batched LU and solved, the squared norms
    summed over the ranks (the port of ``tests/test_distributed.py``)."""
    import torch.distributed as dist

    from hsolve_torch.ops import dense as dk

    mesh = make_mesh(device="cpu")
    rng = np.random.default_rng(0)
    Dn = rng.standard_normal((2, 8, 8)) + 8 * np.eye(8)
    bn = rng.standard_normal((2, 8, 1))
    D = shard_level_input(mesh, torch.as_tensor(Dn))
    b = shard_level_input(mesh, torch.as_tensor(bn))
    lu, perm = dk.lu_factor(D)
    x = dk.lu_solve(lu, perm, b)
    total = (x * x).sum().reshape(1)
    dist.all_reduce(total)
    one = torch.ones(1, dtype=torch.float64)
    dist.all_reduce(one)
    ref = sum(float(np.sum(np.linalg.solve(Dn[i], bn[i]) ** 2)) for i in range(2))
    return {"held": D.shape[0], "sum": float(total[0]), "ref": ref,
            "ranks": float(one[0]), "refused": _refusals(mesh)}


def _refusals(mesh) -> list:
    """What ``gmres_compiled`` and ``save_solver`` say to a mesh factor."""
    import os
    import tempfile

    from hsolve_torch.factor import solve_with_data
    from hsolve_torch.utils.checkpoint import save_solver

    A, b, shape = ht.poisson2d(17)
    F = ht.factor(A, ht.nested_dissection(shape, leafmax=20), device="cpu",
                  mesh=mesh, **EXACT)
    out = []
    for call in (
            lambda: ht.gmres_compiled(lambda v: v, solve_with_data,
                                      torch.as_tensor(b), M_data=F.solve_data),
            lambda: ht.gmres_compiled(lambda v: v, F.solve, torch.as_tensor(b)),
            lambda: save_solver(os.path.join(tempfile.gettempdir(), "no.pt"),
                                F)):
        try:
            call()
            out.append(None)
        except NotImplementedError as e:
            out.append(str(e))
    return out


def failing_job() -> int:
    """Rank 1 raises; rank 0 returns."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 stops here")
    return 0


def lowrank_job() -> dict:
    """helmholtz2d(33, k=10) on the low-rank path (``hss=False``) on a
    2-rank tree mesh, against one process on the same padded plan."""
    mesh = make_mesh(device="cpu")
    A, b, shape = ht.helmholtz2d(33, k=10.0)
    F = ht.factor(A, ht.nested_dissection(shape, leafmax=40), device="cpu",
                  mesh=mesh, swlevel=-2, hss=False)
    F1 = ht.factor_with_plan(F.plan, F.opts, device="cpu")
    out = {"x": F.solve(b).numpy(), "x_single": F1.solve(b).numpy(),
           "x_ref": spla.spsolve(A.tocsc(), b)}
    out["xg"], out["info"] = _gmres(A, b, F.solve)
    G = F.gather_levels()
    if G is not None:
        out["levels"], out["single"] = records(G.levels), records(F1.levels)
    return out
