#!/usr/bin/env python3
"""Which collectives a process group runs: ``all_reduce``,
``all_gather_into_tensor``, ``all_to_all_single`` and ``broadcast`` on
float64 tensors, and an ``init_device_mesh`` of ("tree", "front"), for
gloo with 2 ranks on ``cuda`` (two ranks sharing one card), NCCL with 1
rank, and gloo with 2 ranks on the CPU; each rank prints what each call
returned or raised.

    python3 tools/collectives_probe.py        # the card
"""
import sys, tempfile, subprocess, torch, torch.distributed as dist, torch.multiprocessing as mp

def run(rank, world, path, dev, backend):
    torch.set_num_threads(1)
    if dev.startswith("cuda"):
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{path}", rank=rank, world_size=world)
    out = {}
    d = torch.device(dev)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        m = init_device_mesh(d.type, (world, 1), mesh_dim_names=("tree", "front"))
        out["mesh"] = str(m)
    except Exception as e:
        out["mesh"] = f"{type(e).__name__}: {str(e)[:300]}"
    for name in ("all_reduce", "all_gather_into_tensor", "all_to_all_single", "broadcast"):
        try:
            x = torch.arange(4, dtype=torch.float64, device=d) + rank
            if name == "all_reduce": dist.all_reduce(x); r = x
            elif name == "all_gather_into_tensor":
                r = torch.empty(4*world, dtype=x.dtype, device=d); dist.all_gather_into_tensor(r, x)
            elif name == "broadcast": dist.broadcast(x, 0); r = x
            else:
                r = torch.empty(4, dtype=x.dtype, device=d)
                dist.all_to_all_single(r, x, [4 // world]*world, [4 // world]*world)
            if dev.startswith("cuda"): torch.cuda.synchronize()
            out[name] = r.cpu().tolist()
        except Exception as e:
            out[name] = f"{type(e).__name__}: {str(e)[:300]}"
    print(backend, dev, world, rank, out, flush=True)
    dist.destroy_process_group()

if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.is_available(), flush=True)
    if torch.cuda.is_available():
        print(torch.cuda.get_device_name(0), torch.cuda.device_count(), flush=True)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout, flush=True)
    for backend, dev, world in (("gloo", "cuda", 2), ("nccl", "cuda", 1), ("gloo", "cpu", 2)):
        path = tempfile.mktemp()
        try:
            mp.start_processes(run, args=(world, path, dev, backend), nprocs=world, join=True, start_method="spawn")
        except Exception as e:
            print("SPAWN FAIL", backend, dev, world, type(e).__name__, str(e)[:500], flush=True)
