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

import torch.distributed as dist

import hsolve_torch as ht
from hsolve_torch.factor import CompressedLevel, DenseLevel, solve_with_data
from hsolve_torch.parallel.dist import make_mesh, shard_level_input
from hsolve_torch.utils.checkpoint import load_solver, save_solver
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


def _gmres(A, b, F):
    ell = ht.to_ell(A, device="cpu")
    x, info = ht.gmres(lambda v: ht.ell_matvec(ell, v), torch.as_tensor(b),
                       M=solve_with_data, M_data=F.solve_data, reltol=1e-9,
                       restart=30, maxiter=30)
    return x.numpy(), info


def _gmres_bound(A, b, F):
    """``krylov.gmres`` with ``M=F.solve`` and no ``M_data``: the calls of
    the mesh data's ``consensus`` and ``check_replicated`` counted."""
    data, calls = F.solve_data, {"consensus": 0, "check_replicated": 0}

    def counted(name, hook):
        def call(*args):
            calls[name] += 1
            return hook(*args)
        return call

    for name in calls:
        setattr(data, name, counted(name, getattr(data, name)))
    try:
        ell = ht.to_ell(A, device="cpu")
        x, info = ht.gmres(lambda v: ht.ell_matvec(ell, v),
                           torch.as_tensor(b), M=F.solve, reltol=1e-9,
                           restart=30, maxiter=30)
    finally:
        for name in calls:
            delattr(data, name)
    return x.numpy(), info, calls


def _gmres_compiled(A, b, F):
    """``gmres_compiled`` (the host program on the CPU) with the mesh
    factor's solve data, DIA's fused residual at the restarts."""
    op, mv = ht.spmv_format(A, device="cpu")
    x, info = ht.gmres_compiled(mv, solve_with_data, torch.as_tensor(b),
                                reltol=1e-9, restart=30, maxiter=30,
                                mv_data=op, M_data=F.solve_data)
    return x.numpy(), info


def exact_job(front: int, ckpt: str) -> dict:
    """poisson2d(33) on the exact path, the mesh ``world / front x front``:
    the gathered levels, the single-process factor of the same padded plan,
    the solve, the bytes beside ``collective_estimate``; the mesh factor
    saved to ``ckpt`` (``save_solver``: rank 0 writes) and loaded on rank 0
    (the gathered factor's solve beside the loaded one's); then GMRES, both
    forms, on helmholtz2d(33, k=10) with the mesh factor as ``M`` (and
    ``krylov.gmres`` with ``M=F.solve``)."""
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
    save_solver(ckpt, F)
    dist.barrier()
    if G is not None:
        out["x_gathered"] = G.solve(b).numpy()
        out["x_loaded"] = load_solver(ckpt, device="cpu").solve(b).numpy()
    Ah, bh, sh = ht.helmholtz2d(33, k=10.0)
    Fh = ht.factor(Ah, ht.nested_dissection(sh, leafmax=40), device="cpu",
                   mesh=mesh, **EXACT)
    out["xh"], out["info"] = _gmres(Ah, bh, Fh)
    out["xb"], out["info_b"], out["hook_calls"] = _gmres_bound(Ah, bh, Fh)
    out["xc"], out["info_c"] = _gmres_compiled(Ah, bh, Fh)
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
    out["x"], out["info"] = _gmres(A, b, F)
    out["xc"], out["info_c"] = _gmres_compiled(A, b, F)
    out["x_ref"] = spla.spsolve(A.tocsc(), b)
    G = F.gather_levels()
    if G is not None:
        out["levels"] = records(G.levels)
    return out


def smoke_job() -> dict:
    """Two ranks: an all-reduce, and a ``[2, 8, 8]`` level stack split one
    front a rank, factored by batched LU and solved, the squared norms
    summed over the ranks (the port of ``tests/test_distributed.py``)."""
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
            "ranks": float(one[0]), "graph": _graph_refusal(mesh)}


def _graph_refusal(mesh) -> dict:
    """A mesh factor's solve data, and what it says to a CUDA graph of its
    solves over this gloo group (``gmres_compiled`` on CUDA tensors asks
    this before it captures)."""
    from hsolve_torch.parallel.sharded import MeshSolveData

    A, b, shape = ht.poisson2d(17)
    F = ht.factor(A, ht.nested_dissection(shape, leafmax=20), device="cpu",
                  mesh=mesh, **EXACT)
    out = {"mesh_data": isinstance(F.solve_data, MeshSolveData),
           "backend": F.solve_data.backend}
    try:
        F.solve_data.prepare_graph(torch.device("cuda"))
        out["refusal"] = None
    except RuntimeError as e:
        out["refusal"] = str(e)
    return out


def failing_job() -> int:
    """Rank 1 raises; rank 0 returns."""
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
    out["xg"], out["info"] = _gmres(A, b, F)
    G = F.gather_levels()
    if G is not None:
        out["levels"], out["single"] = records(G.levels), records(F1.levels)
    return out
