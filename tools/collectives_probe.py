#!/usr/bin/env python3
"""Which collectives a process group runs, and which of them a CUDA graph
captures (card only, about three minutes, most of it the kernels' build).

1. ``all_reduce``, ``all_gather_into_tensor``, ``all_to_all_single`` and
   ``broadcast`` on float64 tensors, and an ``init_device_mesh`` of
   ("tree", "front"), for gloo with 2 ranks on ``cuda`` (two ranks sharing
   one card), NCCL with 1 rank, and gloo with 2 ranks on the CPU; each rank
   prints what each call returned or raised.
2. One NCCL rank: the communicator warmed by an eager ``all_reduce``,
   ``broadcast`` and (out of place) ``all_gather_into_tensor``, then the
   three captured alone, and with torch operations into one part, with
   ``torch.cuda.CUDAGraph(keep_graph=True)``; the node types (child graphs
   walked, kernels by name) and three replays against the values they
   must give.
   Then the part as the step of a conditional WHILE body, composed as
   ``gmres_compiled`` composes a solve (``ops/gmres_control.py``
   ``SolveGraph``: ``KOUT`` cycles of ``KIN`` steps counted on the device),
   replayed against the host loop's count, and once more under
   ``torch.cuda.set_sync_debug_mode("error")``.
3. Two gloo ranks on ``cuda``: the same capture of an ``all_reduce``; what
   it raises, or what a replay gives.

    python3 tools/collectives_probe.py
"""
import ctypes
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KOUT, KIN = 3, 4
# CUgraphNodeType (cuda.h)
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


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


def _cuda():
    """libcuda's graph queries (they read a graph the runtime made)."""
    cu = ctypes.CDLL("libcuda.so.1")
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    cu.cuGraphGetNodes.argtypes = [vp, ctypes.POINTER(vp), ctypes.POINTER(sz)]
    cu.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphChildGraphNodeGetGraph.argtypes = [vp, ctypes.POINTER(vp)]
    cu.cuGraphKernelNodeGetParams.argtypes = [vp, ctypes.c_void_p]
    cu.cuFuncGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p), vp]
    return cu


def node_types(graph, cu=None, depth=0) -> list:
    """The node types of a CUDA graph, child graphs walked, kernels named."""
    cu = cu or _cuda()
    n = ctypes.c_size_t(0)
    cu.cuGraphGetNodes(ctypes.c_void_p(graph), None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    cu.cuGraphGetNodes(ctypes.c_void_p(graph), nodes, ctypes.byref(n))
    out = []
    for i in range(n.value):
        t = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(nodes[i], ctypes.byref(t))
        kind = NODE_TYPES.get(t.value, str(t.value))
        if kind == "graph":
            child = ctypes.c_void_p()
            cu.cuGraphChildGraphNodeGetGraph(nodes[i], ctypes.byref(child))
            out.append({"graph": node_types(child.value, cu, depth + 1)})
        elif kind == "kernel":
            params = (ctypes.c_char * 256)()
            rc = cu.cuGraphKernelNodeGetParams(nodes[i], params)
            fn = ctypes.c_void_p.from_buffer(params).value
            name = ctypes.c_char_p()
            rc2 = cu.cuFuncGetName(ctypes.byref(name), fn) if rc == 0 else rc
            out.append("kernel " + (name.value.decode()[:60] if rc2 == 0
                                    and name.value else f"(name rc {rc2})"))
        else:
            out.append(kind)
    return out


def capture_nccl(rank, world, path):
    """Part 2 on one NCCL rank."""
    from hsolve_torch.ops import arnoldi as AR
    from hsolve_torch.ops import gmres_control as GC

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"file://{path}", rank=rank,
                            world_size=world)
    v = torch.arange(8, dtype=torch.float64, device=dev)
    w = torch.zeros(8, dtype=torch.float64, device=dev)
    gathered = torch.zeros(8 * world, dtype=torch.float64, device=dev)

    def collectives():
        dist.all_reduce(v)
        dist.broadcast(w, src=0)
        dist.all_gather_into_tensor(gathered, w)     # out of place

    def part():
        v.add_(1.0)
        w.copy_(v * 2.0)
        collectives()

    part()                                   # warm: the communicator's setup
    torch.cuda.synchronize()
    print(f"nccl warm: v {v.tolist()[:3]}, w {w.tolist()[:3]}", flush=True)
    try:
        g0 = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g0):
            collectives()
        print("nccl capture of all_reduce, broadcast and all_gather alone: "
              "nodes", node_types(g0.raw_cuda_graph()), flush=True)
        v.zero_()
        w.zero_()
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            part()
        print("nccl capture: ok; part's nodes", node_types(g.raw_cuda_graph()),
              flush=True)
        g.instantiate()
        for _ in range(3):
            g.replay()
        torch.cuda.synchronize()
        print(f"nccl replay x3: v {v.tolist()[:3]}, w {w.tolist()[:3]}, "
              f"gathered {gathered.tolist()[:3]} (want 3, 6, 6)", flush=True)
    except Exception as e:
        print(f"nccl capture: {type(e).__name__}: {str(e)[:600]}", flush=True)
        dist.destroy_process_group()
        return
    # the part as a conditional WHILE body's step
    loop = torch.zeros(AR.LOOP_LEN, dtype=torch.int32, device=dev)
    steps = torch.zeros(1, dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)

    def pre():
        loop.zero_()
        steps.zero_()
        v.zero_()
        loop[AR.GO:AR.GO + 1].copy_(one)

    def start():
        loop[AR.J:AR.J + 1].zero_()
        loop[AR.DONE:AR.DONE + 1].zero_()

    def step():
        part()
        loop[AR.J:AR.J + 1].add_(1)
        steps.add_(1)
        loop[AR.DONE:AR.DONE + 1].copy_((loop[AR.J:AR.J + 1] >= KIN).int())

    def end():
        loop[AR.CYC:AR.CYC + 1].add_(1)
        loop[AR.GO:AR.GO + 1].copy_((loop[AR.CYC:AR.CYC + 1] < KOUT).int())

    try:
        sg = GC.SolveGraph([(loop, pre, start, step, end)], lambda: None,
                           [loop, steps, one, v, w, gathered], dev)
        print("nccl WHILE body: composed; the step part's nodes",
              node_types(sg.parts[2].raw_cuda_graph()), flush=True)
        loop.fill_(-1)
        sg.launch()
        torch.cuda.synchronize()
        print(f"nccl WHILE body: steps {steps.tolist()} (want "
              f"{[KOUT * KIN]}), v {v.tolist()[:3]}, w {w.tolist()[:3]}, "
              f"gathered {gathered.tolist()[:3]} (want {KOUT * KIN}, "
              f"{2 * KOUT * KIN}, {2 * KOUT * KIN})", flush=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            sg.launch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print(f"nccl WHILE body under sync debug 'error': steps "
              f"{steps.tolist()}, v {v.tolist()[:3]}", flush=True)
        del sg
    except Exception as e:
        print(f"nccl WHILE body: {type(e).__name__}: {str(e)[:600]}", flush=True)
    torch.cuda.synchronize()
    dist.destroy_process_group()


def capture_gloo(rank, world, path):
    """Part 3 on two gloo ranks sharing the card."""
    from datetime import timedelta

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=30))
    v = torch.arange(4, dtype=torch.float64, device=dev) + rank
    dist.all_reduce(v)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.graph(g):
            dist.all_reduce(v)
        print(f"gloo rank {rank} capture: ok; nodes "
              f"{node_types(g.raw_cuda_graph())}", flush=True)
        g.instantiate()
        v.fill_(float(rank))
        g.replay()
        torch.cuda.synchronize()
        print(f"gloo rank {rank} replay: v {v.tolist()} (a real sum: "
              f"{[float(sum(range(world)))] * 4})", flush=True)
    except Exception as e:
        print(f"gloo rank {rank} capture: {type(e).__name__}: "
              f"{str(e)[:400]}", flush=True)
    try:
        dist.destroy_process_group()
    except Exception:
        pass


def spawn(fn, args, nprocs, timeout=120):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r,) + args) for r in range(nprocs)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            print(f"{fn.__name__}: a rank did not finish in {timeout} s; killed",
                  flush=True)
            p.kill()
            p.join()


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.is_available(), flush=True)
    if not torch.cuda.is_available():
        sys.exit("collectives_probe: no card")
    print(torch.cuda.get_device_name(0), torch.cuda.device_count(), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout, flush=True)
    for backend, dev, world in (("gloo", "cuda", 2), ("nccl", "cuda", 1), ("gloo", "cpu", 2)):
        path = tempfile.mktemp()
        try:
            mp.start_processes(run, args=(world, path, dev, backend), nprocs=world, join=True, start_method="spawn")
        except Exception as e:
            print("SPAWN FAIL", backend, dev, world, type(e).__name__, str(e)[:500], flush=True)
    from hsolve_torch import kernels
    print(f"kernels built in {kernels.build()['seconds']:.1f} s", flush=True)
    spawn(capture_nccl, (1, tempfile.mktemp()), 1)
    spawn(capture_gloo, (2, tempfile.mktemp()), 2)
