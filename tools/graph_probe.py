#!/usr/bin/env python3
"""What a CUDA graph with conditional WHILE nodes takes on this card (card
only, about a minute).  Run from the repository root:

    python3 tools/graph_probe.py

It prints the versions of the toolkit, the runtime (and what
``cudaDriverGetVersion`` reports) and torch, then composes,
from parts captured by torch (``torch.cuda.CUDAGraph(keep_graph=True)``),
a graph of two nested WHILE nodes, as ``gmres_compiled`` does: an outer
loop of ``KOUT`` bodies, each a start part, an inner loop of ``KIN`` step
parts and an end part.  The step part holds a cooperative launch
(``cudaLaunchCooperativeKernel``, one CTA per SM with 225 KB of shared
memory, a grid barrier), a thread block cluster launch
(``cudaLaunchKernelEx``), cuBLAS's GEMV, a batched triangular solve, an LU
solve and a norm.  Each loop's condition is set on the device by a kernel
calling ``cudaGraphSetConditional`` on a flag in device memory.  The inner
loop's handle is created once on the outer loop's body graph (layout "A")
and once on the top graph (layout "B").  It prints the node types of each
captured part, whether each layout instantiates and runs its bodies the
expected number of times with the torch results equal to an eager run, and
whether a replay under ``torch.cuda.set_sync_debug_mode("error")`` raises.
The CUDA source is built with nvcc into ``build/graph_probe/``.
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "graph_probe")
KOUT, KIN = 3, 5

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <vector>
#define EXPORT extern "C" __attribute__((visibility("default")))

__global__ void coop_inc(int* counter, unsigned* ticket) {
  extern __shared__ unsigned char smem[];
  smem[threadIdx.x] = 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ticket, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(ticket) : "memory");
    } while (seen < gridDim.x);
    if (atomicAdd(ticket, 1u) == 2u * gridDim.x - 1u) {
      *ticket = 0u;
      atomicAdd(counter, (int)smem[0]);
    }
  }
}

__global__ void cluster_inc(int* counter) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(counter, 1);
}

__global__ void set_flag(const int* counter, int* flag, int k, int* reset) {
  *flag = *counter < k;
  if (reset) *reset = 0;
}

__global__ void set_cond(cudaGraphConditionalHandle h, const int* flag) {
  cudaGraphSetConditional(h, *flag != 0);
}

EXPORT int probe_versions(int* rt, int* drv) {
  cudaRuntimeGetVersion(rt);
  return (int)cudaDriverGetVersion(drv);
}

EXPORT int probe_coop(int* counter, unsigned* ticket, int G, int smem,
                      void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      coop_inc, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&counter, &ticket};
  e = cudaLaunchCooperativeKernel((const void*)coop_inc, dim3(G), dim3(512),
                                  args, (size_t)smem, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

EXPORT int probe_cluster(int* counter, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(4);
  cfg.blockDim = dim3(32);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_inc, counter);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

EXPORT int probe_flag(const int* counter, int* flag, int k, int* reset,
                      void* stream) {
  set_flag<<<1, 1, 0, (cudaStream_t)stream>>>(counter, flag, k, reset);
  return (int)cudaGetLastError();
}

EXPORT int probe_node_types(void* graph, int* counts) {
  cudaGraph_t g = (cudaGraph_t)graph;
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return (int)e;
  std::vector<cudaGraphNode_t> nodes(n);
  e = cudaGraphGetNodes(g, nodes.data(), &n);
  if (e != cudaSuccess) return (int)e;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType t;
    cudaGraphNodeGetType(nodes[i], &t);
    counts[(int)t < 31 ? (int)t : 31] += 1;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t c;
      cudaGraphChildGraphNodeGetGraph(nodes[i], &c);
      probe_node_types(c, counts);
    }
  }
  return 0;
}

static cudaError_t add_child(cudaGraph_t g, cudaGraphNode_t* dep,
                             cudaGraph_t child, cudaGraphNode_t* out) {
  return cudaGraphAddChildGraphNode(out, g, dep, dep ? 1 : 0, child);
}

static cudaError_t add_set(cudaGraph_t g, cudaGraphNode_t* dep,
                           cudaGraphConditionalHandle h, const int* flag,
                           cudaGraphNode_t* out) {
  cudaKernelNodeParams kp = {};
  kp.func = (void*)set_cond;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  void* args[] = {&h, &flag};
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(out, g, dep, dep ? 1 : 0, &kp);
}

static cudaError_t add_while(cudaGraph_t g, cudaGraphNode_t* dep,
                             cudaGraphConditionalHandle h,
                             cudaGraphNode_t* out, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  cudaError_t e = cudaGraphAddNode(out, g, dep, dep ? 1 : 0, &p);
  if (e == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return e;
}

#define TRY(x) do { cudaError_t e_ = (x); if (e_ != cudaSuccess) { \
  *stage = __LINE__; return (int)e_; } } while (0)

// pre -> set(ho) -> WHILE ho { start -> set(hi) -> WHILE hi { step ->
// set(hi) } -> end -> set(ho) }; inner handle on the outer body (A) or on
// the top graph (B)
EXPORT int probe_compose(void* pre, void* start, void* step, void* end,
                         const int* flag_o, const int* flag_i, int layout,
                         void** exec_out, int* stage) {
  cudaGraph_t G, Bo, Bi;
  TRY(cudaGraphCreate(&G, 0));
  cudaGraphNode_t a, b, w, c, d, e2, f, s1, s2;
  cudaGraphConditionalHandle ho, hi;
  TRY(cudaGraphConditionalHandleCreate(&ho, G, 0, 0));
  TRY(add_child(G, nullptr, (cudaGraph_t)pre, &a));
  TRY(add_set(G, &a, ho, flag_o, &b));
  TRY(add_while(G, &b, ho, &w, &Bo));
  if (layout == 0) {
    TRY(cudaGraphConditionalHandleCreate(&hi, Bo, 0, 0));
  } else {
    TRY(cudaGraphConditionalHandleCreate(&hi, G, 0, 0));
  }
  TRY(add_child(Bo, nullptr, (cudaGraph_t)start, &c));
  TRY(add_set(Bo, &c, hi, flag_i, &d));
  TRY(add_while(Bo, &d, hi, &e2, &Bi));
  TRY(add_child(Bo, &e2, (cudaGraph_t)end, &f));
  TRY(add_set(Bo, &f, ho, flag_o, &s1));
  TRY(add_child(Bi, nullptr, (cudaGraph_t)step, &s1));
  TRY(add_set(Bi, &s1, hi, flag_i, &s2));
  cudaGraphExec_t ex;
  TRY(cudaGraphInstantiate(&ex, G, 0));
  *exec_out = (void*)ex;
  return 0;
}

EXPORT int probe_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}
"""

TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "child graph",
         5: "empty", 6: "event wait", 7: "event record", 8: "ext sem signal",
         9: "ext sem wait", 10: "mem alloc", 11: "mem free", 12: "batch mem op",
         13: "conditional"}


def build():
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, "probe.cu"), os.path.join(OUT, "probe.so")
    open(cu, "w").write(SRC)
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    print("nvcc:", ver.stdout.strip().splitlines()[-1])
    out = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                          "-std=c++17", "-O2", "-Xcompiler", "-fPIC",
                          "-shared", "-o", so, cu], capture_output=True,
                         text=True)
    if out.returncode:
        print(out.stdout, out.stderr)
        raise SystemExit("graph_probe: nvcc failed")
    lib = ctypes.CDLL(so)
    V, I = ctypes.c_void_p, ctypes.c_int
    sigs = {"probe_versions": [V, V], "probe_coop": [V, V, I, I, V],
            "probe_cluster": [V, V], "probe_flag": [V, V, I, V, V],
            "probe_node_types": [V, V],
            "probe_compose": [V, V, V, V, V, V, I, V, V],
            "probe_launch": [V, V]}
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def check(rc, what):
    if rc != 0:
        raise SystemExit(f"graph_probe: {what} returned CUDA error {rc}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("graph_probe: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print("card:", smi)
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    lib = build()
    rt, drv = ctypes.c_int(), ctypes.c_int()
    lib.probe_versions(ctypes.byref(rt), ctypes.byref(drv))
    print("cudaRuntimeGetVersion", rt.value, "cudaDriverGetVersion", drv.value)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ctr = torch.zeros(8, dtype=torch.int32, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    p = lambda t, i=0: t.data_ptr() + 4 * i
    g = torch.Generator().manual_seed(0)
    A = torch.randn(4, 64, 64, dtype=torch.float64, generator=g).to(dev)
    A += 64 * torch.eye(64, dtype=torch.float64, device=dev)
    lu, piv = torch.linalg.lu_factor(A)
    rhs = torch.randn(4, 64, 3, dtype=torch.float64, generator=g).to(dev)
    Mv = torch.randn(30, 4096, dtype=torch.float64, generator=g).to(dev)
    vec = torch.randn(4096, dtype=torch.float64, generator=g).to(dev)
    outs = [torch.zeros(4, 64, 3, dtype=torch.float64, device=dev),
            torch.zeros(4, 64, 3, dtype=torch.float64, device=dev),
            torch.zeros(30, dtype=torch.float64, device=dev),
            torch.zeros((), dtype=torch.float64, device=dev)]
    stream = lambda: torch.cuda.current_stream().cuda_stream

    # ctr: 0 outer count, 1 inner count, 2 coop count, 3 cluster count,
    # 4 outer flag, 5 inner flag
    def pre():
        ctr.zero_()
        check(lib.probe_flag(p(ctr, 0), p(ctr, 4), KOUT, None, stream()),
              "flag")

    def start():
        check(lib.probe_flag(p(ctr, 7), p(ctr, 5), KIN, p(ctr, 1), stream()),
              "flag")

    def step():
        check(lib.probe_coop(p(ctr, 2), p(ticket), sms, 225 * 1024,
                             stream()), "cooperative launch")
        check(lib.probe_cluster(p(ctr, 3), stream()), "cluster launch")
        outs[0].copy_(torch.linalg.lu_solve(lu, piv, rhs))
        outs[1].copy_(torch.linalg.solve_triangular(lu, rhs, upper=True))
        outs[2].copy_(torch.mv(Mv, vec))
        torch.linalg.vector_norm(vec, out=outs[3])
        ctr[1:2].add_(1)
        check(lib.probe_flag(p(ctr, 1), p(ctr, 5), KIN, None, stream()),
              "flag")

    def end():
        ctr[0:1].add_(1)
        check(lib.probe_flag(p(ctr, 0), p(ctr, 4), KOUT, None, stream()),
              "flag")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in (pre, start, step, end):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    ref = [o.clone() for o in outs]
    try:
        graphs = [torch.cuda.CUDAGraph(keep_graph=True) for _ in range(4)]
    except TypeError as e:
        raise SystemExit(f"graph_probe: CUDAGraph(keep_graph=True): {e}")
    pool = torch.cuda.graph_pool_handle()
    for gr, fn, name in zip(graphs, (pre, start, step, end),
                            ("pre", "start", "step", "end")):
        with torch.cuda.graph(gr, pool=pool):
            fn()
        counts = (ctypes.c_int * 32)()
        check(lib.probe_node_types(ctypes.c_void_p(gr.raw_cuda_graph()),
                                   counts), "node types")
        print(f"part {name}: nodes",
              {TYPES.get(i, i): counts[i] for i in range(32) if counts[i]})
    raw = [ctypes.c_void_p(gr.raw_cuda_graph()) for gr in graphs]
    for layout in (0, 1):
        ex, stage = ctypes.c_void_p(), ctypes.c_int()
        rc = lib.probe_compose(*raw, p(ctr, 4), p(ctr, 5), layout,
                               ctypes.byref(ex), ctypes.byref(stage))
        name = "A (inner handle on the outer body)" if layout == 0 \
            else "B (inner handle on the top graph)"
        if rc:
            print(f"layout {name}: refused, CUDA error {rc} at source line "
                  f"{stage.value}")
            continue
        for o in outs:
            o.zero_()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rc = lib.probe_launch(ex, stream())
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        c = ctr.tolist()
        same = all(torch.equal(o, r) for o, r in zip(outs, ref))
        print(f"layout {name}: launch rc {rc}; outer bodies {c[0]} (want "
              f"{KOUT}), inner count {c[1]} (want {KIN}), cooperative "
              f"{c[2]} and cluster {c[3]} launches (want {KOUT * KIN}); "
              f"torch results equal to the eager run: {same}")
        ok = rc == 0 and c[0] == KOUT and c[2] == c[3] == KOUT * KIN and same
        print(f"layout {name}: {'ok' if ok else 'FAILED'}")


if __name__ == "__main__":
    sys.exit(main())
