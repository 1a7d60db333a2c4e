"""Driver entry points of the port (``__graft_entry__.py:14-181``).

- :func:`entry`: one preconditioned GMRES forward step on the flagship
  problem (a sparse matvec after the hierarchical preconditioner's apply, on
  a Helmholtz-2D system factored on the exact path).
- :func:`dryrun_multichip`: the full solver step (the level-synchronous
  factorization and a preconditioned GMRES solve) on an ``n_devices``-rank
  ("tree", "front") mesh at small sizes, exact and compressed, then the
  same exact run on 1, 2, 4, ... ranks and the efficiency
  :func:`~hsolve_torch.utils.profiling.collective_estimate` predicts at
  h=256.  The solve is the JAX dry run's compiled GMRES (restart 20):
  ``gmres_compiled``, one CUDA graph a rank, over NCCL; over gloo, whose
  collectives a graph cannot capture, the same program driven by the host
  (``gmres_host_driven``).  Ranks sharing one host validate the sharded
  program's mechanics, not a link's scaling.

``python -m hsolve_torch.parallel.dryrun N [--device cpu]`` runs
:func:`dryrun_multichip`.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _build(n: int = 33, leafmax: int = 60):
    import hsolve_torch as ht

    A, b, shape = ht.helmholtz2d(n, k=10.0)
    return A, np.asarray(b), ht.nested_dissection(shape, leafmax=leafmax)


def entry(device="cuda"):
    """Returns ``(fn, example_args)``: ``fn(v) = A_perm (F^{-1} v)``, one
    right-preconditioned Krylov step on the permuted system, the factor in
    float32 (the JAX bench's device type) on ``device``."""
    import hsolve_torch as ht

    A, b, tree = _build()
    F = ht.factor(A, tree, swlevel=0, dtype=torch.float32, device=device)
    ell = ht.to_ell(F.plan.A_perm, dtype=np.float32, device=F.device)

    def step(v):
        return ht.ell_matvec(ell, F.apply_permuted(v))

    example = torch.as_tensor(b[F.perm], dtype=torch.float32, device=F.device)
    return step, (example,)


def _apply_permuted(data, v):
    """The preconditioner on the permuted system (the JAX dry run's
    identity ``dperm``)."""
    return data.apply_permuted(v)


def solver_name() -> str:
    """The GMRES form the dry run's ranks use: the graph over NCCL, else
    the host-driven program (on the CPU the two are one program)."""
    import torch.distributed as dist

    return "gmres_compiled" if dist.get_backend() == "nccl" \
        else "gmres_host_driven"


def _dryrun_one(mesh, n, leafmax, opts, reltol, accuracy, label, time_it=False,
                maxiter=24):
    """Factor on ``mesh`` and solve with preconditioned GMRES, the permuted
    system in float64; returns (relres, iters, wall_s, nnz), ``wall_s`` (a
    second factor and solve, after the first) only with ``time_it``."""
    import hsolve_torch as ht
    from hsolve_torch import krylov
    from hsolve_torch.parallel.dist import rank_device

    dev = rank_device(mesh.device_type)
    A, b, tree = _build(n=n, leafmax=leafmax)
    plan = ht.plan_factorization(A, tree, opts, batch_multiple=mesh.size(0))
    ell = ht.to_ell(plan.A_perm, device=dev)
    rhs = torch.as_tensor(b[plan.perm], device=dev)
    solve = getattr(krylov, solver_name())

    def run():
        F = ht.factor_with_plan(plan, opts, device=dev, mesh=mesh)
        return solve(ht.ell_matvec, _apply_permuted, rhs, reltol=reltol,
                     restart=20, maxiter=maxiter, M_data=F.solve_data,
                     mv_data=ell)

    x, info = run()
    wall = None
    if time_it:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        x, info = run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    xs = x.cpu().numpy()
    rel = float(np.linalg.norm(plan.A_perm @ xs - b[plan.perm])
                / max(np.linalg.norm(b), 1e-30))
    if not rel < accuracy:
        raise AssertionError(f"{label} dryrun inaccurate: relres={rel:.2e}")
    # "ok" certifies convergence, not a cap hit: GMRES must stop strictly
    # inside its iteration budget
    if not info["iters"] < maxiter:
        raise AssertionError(
            f"{label} dryrun hit the GMRES iteration cap ({info['iters']}/"
            f"{maxiter}) without converging to reltol={reltol:g}")
    return rel, int(info["iters"]), wall, plan.nnz


def _exact():
    import hsolve_torch as ht

    return ht.SolverOptions(swlevel=0)


def _dryrun_rank(n_devices: int, front: int, device: str, full: bool) -> dict:
    """One rank's share of :func:`dryrun_multichip`: with ``full`` the exact
    and compressed runs on the ``n_devices / front x front`` mesh, and the
    timed exact run on a tree-only mesh of all ranks (a separate job when
    ``front > 1``)."""
    import hsolve_torch as ht
    from hsolve_torch.parallel.dist import make_mesh

    mesh = make_mesh(n_devices, front=front if full else 1, device=device)
    out = {"mesh": {"tree": mesh.size(0), "front": mesh.size(1)},
           "solver": solver_name()}
    if full:
        out["exact"] = _dryrun_one(mesh, 17, 24, _exact(), 1e-6, 1e-4, "exact")
        comp = ht.SolverOptions(swlevel=-2, swsize=1, atol=1e-3, rtol=1e-3,
                                leafsize=16)
        out["compressed"] = _dryrun_one(mesh, 33, 24, comp, 1e-4, 1e-3,
                                        "compressed", maxiter=60)
    if mesh.size(1) == 1:
        out["scale"] = _dryrun_one(mesh, 33, 24, _exact(), 1e-6, 1e-3,
                                   f"scale{n_devices}", time_it=True)
    return out


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 600.0) -> dict:
    """Validate the multi-device path on ``n_devices`` ranks (one process
    each, started here by :func:`~hsolve_torch.parallel.dist.run_ranks`:
    NCCL on the card, one rank a card, gloo on the CPU and for more ranks
    than cards):

    1. exact path (swlevel=0): the sharded factorization and GMRES,
    2. compressed / structured path (swlevel=-2): HSS Schur complements,
       low-rank transforms and the structured extend-add on the same mesh,
    3. the exact run again on 1, 2, 4, ... ranks, nnz per second each
       (ranks sharing one host: mechanics, not a link's scaling),

    and print the JAX dryrun's two lines; returns what they print."""
    from hsolve_torch.parallel.dist import run_ranks
    from hsolve_torch.planner import plan_factorization
    from hsolve_torch.utils.profiling import collective_estimate
    import hsolve_torch as ht

    front = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    first = run_ranks(_dryrun_rank, n_devices, n_devices, front, device, True,
                      device=device, timeout=timeout)[0]
    scaling, solvers, nd = {}, {}, 1
    while nd <= n_devices:
        res = first if (nd == n_devices and front == 1) else run_ranks(
            _dryrun_rank, nd, nd, 1, device, False, device=device,
            timeout=timeout)[0]
        _, _, wall, nnz = res["scale"]
        scaling[nd], solvers[nd] = round(nnz / wall, 0), res["solver"]
        nd *= 2
    base = scaling[1]
    eff = {k: round(v / base, 3) for k, v in scaling.items()}

    # the comm model's efficiency per mesh width at h=256 (ranks on one host
    # validate mechanics only; the model predicts a multi-card machine)
    Ab, _, shb = ht.helmholtz2d(256, k=40.0)
    pb = plan_factorization(Ab, ht.nested_dissection(shb, leafmax=100), _exact())
    pred, nd = {}, 2
    while nd <= max(n_devices, 2):
        m2 = collective_estimate(pb, nd)
        t_comp = m2["sol_compute_s"] / nd
        pred[nd] = round(t_comp / (t_comp + m2["t_comm_s"]), 3)
        nd *= 2

    (rel_e, it_e, _, _), (rel_c, it_c, _, _) = first["exact"], first["compressed"]
    line1 = (f"dryrun_multichip({n_devices}): mesh={first['mesh']} "
             f"exact(relres={rel_e:.2e}, iters={it_e}) "
             f"compressed(relres={rel_c:.2e}, iters={it_c}) "
             f"({first['solver']}) ok")
    line2 = "scaling " + json.dumps({
        "nnz_per_s_by_mesh": scaling, "throughput_vs_1dev": eff,
        "solver_by_mesh": solvers,
        "predicted_nvlink_efficiency_h256": pred,
        "note": "ranks on one host: validates the sharded program's "
                "mechanics, not NVLink; predicted_nvlink_efficiency_h256 is "
                "the comm model's projection on H100s"})
    print(line1)
    print(line2)
    return {"line1": line1, "line2": line2, "first": first,
            "scaling": scaling, "predicted": pred}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dryrun_multichip(args.n_devices, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
