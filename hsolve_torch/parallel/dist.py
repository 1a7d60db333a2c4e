"""Multi-device execution: shard the level-synchronous schedule over ranks
(port of ``hsolve/parallel/dist.py``).

The JAX package runs one controller over a device ``Mesh`` and lets XLA's
partitioner insert the collectives.  Here every device is a process (a
rank) under ``torch.distributed``, the ranks laid out on a
:class:`~torch.distributed.device_mesh.DeviceMesh` with dims
``("tree", "front")``:

- **elimination-tree parallelism**: same-level fronts are independent, so a
  level's node axis is split over ``tree`` in contiguous blocks; the
  extend-add between levels moves the child Schur panels whose owner is
  another rank, one ``all_to_all_single`` per child group
  (:mod:`hsolve_torch.parallel.exchange`), and the solve sweeps sum each
  level's updates over the ranks on the rows the level touches,
- **intra-front parallelism**: a batch the tree axis cannot divide is held
  whole by every rank; the ranks of a ``front`` group split its exact Schur
  product ``Abb - Abi R`` by rows and all-gather ``S``.

The planner pads each level's batch to a multiple of the tree axis with
identity dummy fronts (``plan_factorization(..., batch_multiple=)``) so the
blocks divide evenly.  The process group uses NCCL on the card when each
rank has a card of its own, and gloo on the CPU or for ranks sharing a
card, unless the caller started it with another backend.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from hsolve_torch.kernels import resolve_device


def default_backend(device_type: str, world: int = 1) -> str:
    """The process group's backend for ``world`` ranks on a device type:
    NCCL on the card, one rank a card; gloo on the CPU, or where the ranks
    outnumber the cards (NCCL cannot run two ranks on one card)."""
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the CPU, or card ``rank % device_count`` (the
    ranks of a one-card machine share it).  A missing card raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, tree: Optional[int] = None,
              front: int = 1, device="cuda") -> DeviceMesh:
    """Build the ``("tree", "front")`` mesh over the job's ranks.

    The process group is the caller's when one is running (any backend:
    the tests start gloo from a file store); otherwise it is started from
    the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets them) with
    :func:`default_backend`.  ``n_devices`` defaults to the world size and
    must equal it; ``tree`` defaults to ``n_devices // front``."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(default_backend(
            dev.type, int(os.environ.get("WORLD_SIZE", 1))),
            init_method="env://")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if tree is None:
        tree = n_devices // front
    if tree * front != n_devices or n_devices != world:
        raise ValueError(f"a {tree} x {front} mesh over {n_devices} devices "
                         f"does not cover the job's {world} ranks")
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev))
    return init_device_mesh(dev.type, (tree, front),
                            mesh_dim_names=("tree", "front"))


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """How a ``[B, ...]`` level stack is laid out over the mesh, seen from
    one rank (the port of the ``NamedSharding`` that
    ``hsolve/parallel/dist.py:shard_batch_spec`` returns):

    - ``kind == "tree"``: rank ``(t, f)`` holds nodes ``[lo, hi)``, the
      ``t``-th of ``ntree`` contiguous blocks,
    - ``"front"``: every rank holds all ``B`` nodes; axis 1 (the front rows)
      splits over the ``front`` axis, this rank's part ``[lo, hi)`` of it,
    - ``"replicated"``: every rank holds everything."""

    kind: str
    axis: int
    parts: int
    index: int
    lo: int
    hi: int

    def rows(self, n: int) -> slice:
        """This rank's part of an axis of length ``n`` (``front``: the
        balanced split of the front rows; else the held nodes)."""
        if self.kind == "front":
            return slice(n * self.index // self.parts,
                         n * (self.index + 1) // self.parts)
        return slice(self.lo, self.hi)


def shard_batch_spec(mesh: DeviceMesh, B: int, rank: int) -> BatchSpec:
    """The layout of a ``[B, ...]`` stack of ``rank`` dims: the node axis
    over ``tree`` when it divides evenly, else the rows over ``front`` (a
    stack of 3 or more dims with front > 1), else replicated."""
    ntree, nfront = mesh.size(0), mesh.size(1)
    t, f = mesh.get_coordinate()
    if B % ntree == 0 and B >= ntree and ntree > 1:
        blk = B // ntree
        return BatchSpec("tree", 0, ntree, t, t * blk, (t + 1) * blk)
    if rank >= 3 and nfront > 1:
        return BatchSpec("front", 1, nfront, f, 0, B)
    return BatchSpec("replicated", 0, 1, 0, 0, B)


def shard_level_input(mesh: Optional[DeviceMesh], arr: torch.Tensor
                      ) -> torch.Tensor:
    """This rank's share of a ``[B, ...]`` stack (all of it without a
    mesh)."""
    if mesh is None:
        return arr
    spec = shard_batch_spec(mesh, arr.shape[0], arr.ndim)
    sl = spec.rows(arr.shape[spec.axis])
    return arr[sl] if spec.axis == 0 else arr[:, sl]


@dataclasses.dataclass
class MeshInfo:
    """What the factor and the solve read of a mesh: its sizes, this rank's
    coordinate and device, and the groups the collectives run on."""

    mesh: DeviceMesh
    ntree: int
    nfront: int
    t: int
    f: int
    rank: int
    world: int
    device: torch.device

    @classmethod
    def of(cls, mesh: DeviceMesh) -> "MeshInfo":
        t, f = mesh.get_coordinate()
        return cls(mesh=mesh, ntree=mesh.size(0), nfront=mesh.size(1), t=t,
                   f=f, rank=dist.get_rank(), world=dist.get_world_size(),
                   device=rank_device(mesh.device_type))

    def rank_of(self, t: int, f: int) -> int:
        """The global rank at mesh coordinate ``(t, f)``."""
        return int(self.mesh.mesh[t, f])

    @property
    def front_group(self):
        return self.mesh.get_group("front")



def _rank_main(fn, rank: int, world: int, store: str, device: str,
               backend: Optional[str], results, args) -> None:
    """One rank of :func:`run_ranks`: join the group, run ``fn(*args)``,
    report ``(rank, ok, value or traceback)``."""
    import traceback

    torch.set_num_threads(1)       # threaded LU in several ranks of a host can hang
    try:
        dist.init_process_group(backend or default_backend(
            torch.device(device).type, world), init_method=f"file://{store}",
            rank=rank, world_size=world)
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, *args, device: str = "cuda",
              backend: Optional[str] = None, timeout: float = 600.0,
              store_dir: Optional[str] = None) -> list:
    """Run ``fn(*args)`` in ``world`` new processes, one rank each, joined
    in one process group through a file store (``store_dir``, else a new
    temporary directory); returns the ranks' results in rank order.

    ``fn`` and its results must pickle (module-level functions, numpy and
    plain values); the ranks start by ``spawn``, so CUDA may already be
    initialised here.  The backend is :func:`default_backend` of
    ``device``'s type and ``world`` unless ``backend`` names another.  A
    rank that raises or a run longer than ``timeout`` seconds raises here,
    and every rank still running is killed."""
    import multiprocessing as mp
    import queue
    import shutil
    import tempfile
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="hsolve_ranks_", dir=store_dir)
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, store, device,
                                                 backend, results, args))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, val = results.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise TimeoutError(f"{world} ranks did not finish within "
                                   f"{timeout:g} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
