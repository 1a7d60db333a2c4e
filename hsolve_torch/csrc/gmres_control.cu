// The control of restarted GMRES on the device: the small kernels that the
// bodies of hsolve/krylov.py `_gmres_cycles`' two `lax.while_loop`s run
// outside the Arnoldi step, and the host code that composes the whole solve
// as one CUDA graph whose loops are conditional WHILE nodes.
//
// Replaces what XLA made of `_gmres_cycles` (hsolve/krylov.py:215-318) and
// `_gmres_escalated` (:321-350) around the step:
//   - `gmres_init` (the carry's start, :310-311): tol = reltol ||b||,
//     hist = [||b||, 0, ...], beta = ||b||, it = cyc = 0, and the cycle
//     loop's test (~done & cyc < ncycles, :315) for its first cycle;
//   - `gmres_cycle_start` (`run`'s head, :282-292): V[0] = r / beta in the
//     cycles' type, the zeroed Givens state with g[0] = beta, y = 0 (a cycle
//     that takes no step adds nothing), floor = max(tol, m_eps beta) in the
//     cycles' real type, j = 0 and the step loop's test (`inner_cond`,
//     :269-273) before its first step;
//   - `gmres_cycle_end` (`run`'s tail, :300-306): it += j, hist[it] = beta,
//     done = beta <= tol | it >= maxiter | j == 0, cyc += 1, and the cycle
//     loop's test;
//   - `gmres_escalate` (:340): phase 2's reltol2 = reltol ||b|| /
//     ||b - A x|| (1 where that is 0);
//   - `gmres_set_cond`: a WHILE node's condition from a flag in device
//     memory (`cudaGraphSetConditional`).
// The norms, the update x += M(y V) and the residual stay torch ops and
// kernel D (dia_residual) around these, writing to device memory; nothing is
// read on the host.  Each kernel rounds as its plain torch version
// (hsolve_torch/ops/gmres_control.py) does, one operation at a time, so the
// two agree bit for bit.  Instantiated for the solution's type To (double
// or float) and, for the cycle start, the cycles' type Ti (To or float);
// the cycle start also for complex values (complex128 or complex64 cycles
// in a complex128 solve, complex64 in a complex64 one: the damped Helmholtz
// system), where r, V, sn, g and y are complex and sc, cs and the floor
// stay in the real types, as JAX's `rdtype` / `ordtype` (krylov.py:217-218);
// V[0] = r / beta divides each part by the real beta, which is JAX's
// complex division by beta + 0i bit for bit (tools/cycle_rounding.py
// --division).  The run's start, the cycle end and the escalation read and
// write only the real scalars, so a complex solve runs their real forms.
//
// Bound: latency.  Except the cycle start's pass over V[0] (bytes: r read,
// V[0] and its copy written), each kernel is a handful of dependent scalar
// operations in one thread; its time is a launch.
//
// The graph (`hs_gmres_graph`), one phase for each run of the cycles (two
// when the solve escalates), nested WHILE nodes:
//
//   pre_1 -> set(go_1) -> WHILE go_1 { start_1 -> set(!done_1) ->
//       WHILE !done_1 { step_1 -> set(!done_1) } -> end_1 -> set(go_1) }
//   -> pre_2 -> ... -> post
//
// Each part (pre, start, step, end, post) is a graph captured by torch
// (`torch.cuda.CUDAGraph(keep_graph=True)`) and added as a child graph
// node; the set nodes are `gmres_set_cond` kernel nodes added here.  The
// inner loop's handle is created on the outer loop's body graph, the graph
// that holds its node.  The host launches the instantiated graph once a
// solve.
#include "arnoldi_givens.cuh"
#include "gmres_loop.cuh"

template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  // torch.maximum / jnp.maximum: NaN if either is
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename To>
__global__ void gmres_init_kernel(To* __restrict__ sc, To* __restrict__ hist,
                                  int* __restrict__ loop, int nhist) {
  const To bnorm = sc[HS_SC_BNORM];
  for (int i = threadIdx.x + 1; i < nhist; i += blockDim.x) hist[i] = To(0);
  if (threadIdx.x == 0) {
    const To tol = mul_rn(sc[HS_SC_RELTOL], bnorm);
    sc[HS_SC_TOL] = tol;
    sc[HS_SC_BETA] = bnorm;
    hist[0] = bnorm;
    loop[HS_LOOP_J] = 0;
    loop[HS_LOOP_IT] = 0;
    loop[HS_LOOP_CYC] = 0;
    loop[HS_LOOP_DONE] = 1;
    loop[HS_LOOP_GO] = !(bnorm <= tol) && 0 < loop[HS_LOOP_NCYC];
  }
}

template <typename To, typename Ti>
__global__ void gmres_cycle_start_kernel(
    const To* __restrict__ r, const hs_real_t<To>* __restrict__ sc,
    Ti* __restrict__ V, Ti* __restrict__ vj, Ti* __restrict__ H,
    hs_real_t<Ti>* __restrict__ cs, Ti* __restrict__ sn, Ti* __restrict__ g,
    Ti* __restrict__ y, hs_real_t<Ti>* __restrict__ floor,
    int* __restrict__ loop, int64_t N, int m, double m_eps) {
  typedef hs_real_t<To> Ro;
  typedef hs_real_t<Ti> Ri;
  const Ro beta = sc[HS_SC_BETA];
  const Ro div = beta > Ro(0) ? beta : Ro(1);
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nt = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = t0; i < N; i += nt) {
    const Ti v = static_cast<Ti>(divr_rn(r[i], div));
    V[i] = v;
    vj[i] = v;
  }
  const Ri beta_i = (Ri)beta;
  for (int64_t i = t0; i < (int64_t)(m + 1) * m; i += nt) H[i] = Ti(0);
  for (int64_t i = t0; i <= m; i += nt) {
    if (i < m) {
      cs[i] = Ri(1);
      sn[i] = Ti(0);
      y[i] = Ti(0);
    }
    g[i] = i == 0 ? Ti(beta_i) : Ti(0);
  }
  if (t0 == 0) {
    const Ri fl = max_nan((Ri)sc[HS_SC_TOL], mul_rn((Ri)m_eps, beta_i));
    *floor = fl;
    loop[HS_LOOP_J] = 0;
    const bool go = 0 < m && beta_i > fl &&
                    loop[HS_LOOP_IT] < loop[HS_LOOP_MAXITER];
    loop[HS_LOOP_DONE] = !go;
  }
}

template <typename To>
__global__ void gmres_cycle_end_kernel(To* __restrict__ sc,
                                       To* __restrict__ hist,
                                       int* __restrict__ loop, int nhist) {
  const int j = loop[HS_LOOP_J];
  const int it = loop[HS_LOOP_IT] + j;
  loop[HS_LOOP_IT] = it;
  const To beta = sc[HS_SC_BETA];
  if (it < nhist) hist[it] = beta;
  const bool done = beta <= sc[HS_SC_TOL] || it >= loop[HS_LOOP_MAXITER] ||
                    j == 0;
  const int cyc = loop[HS_LOOP_CYC] + 1;
  loop[HS_LOOP_CYC] = cyc;
  loop[HS_LOOP_GO] = !done && cyc < loop[HS_LOOP_NCYC];
}

template <typename To>
__global__ void gmres_escalate_kernel(const To* __restrict__ sc1,
                                      To* __restrict__ sc2) {
  // phase 2's ||b|| is ||b - A x|| of phase 1
  const To beta1 = sc2[HS_SC_BNORM];
  sc2[HS_SC_RELTOL] = div_rn(mul_rn(sc1[HS_SC_RELTOL], sc1[HS_SC_BNORM]),
                             beta1 > To(0) ? beta1 : To(1));
}

__global__ void gmres_set_cond_kernel(cudaGraphConditionalHandle h,
                                      const int* __restrict__ flag,
                                      int negate) {
  cudaGraphSetConditional(h, (unsigned)((*flag != 0) != (negate != 0)));
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename To>
static int gmres_init(void* sc, void* hist, void* loop, int nhist,
                      void* stream) {
  if (nhist < 1) return (int)cudaErrorInvalidValue;
  gmres_init_kernel<To><<<1, 256, 0, (cudaStream_t)stream>>>(
      (To*)sc, (To*)hist, (int*)loop, nhist);
  return (int)cudaGetLastError();
}

HS_EXPORT int hs_gmres_init(void* sc, void* hist, void* loop, int nhist,
                            void* stream) {
  return gmres_init<double>(sc, hist, loop, nhist, stream);
}

HS_EXPORT int hs_gmres_init_f32(void* sc, void* hist, void* loop, int nhist,
                                void* stream) {
  return gmres_init<float>(sc, hist, loop, nhist, stream);
}

template <typename To, typename Ti>
static int gmres_cycle_start(const void* r, const void* sc, void* V, void* vj,
                             void* H, void* cs, void* sn, void* g, void* y,
                             void* floor, void* loop, long long N, int m,
                             double m_eps, void* stream) {
  if (N < 1 || m < 1) return (int)cudaErrorInvalidValue;
  gmres_cycle_start_kernel<To, Ti><<<hs_blocks(N, 256), 256, 0,
                                     (cudaStream_t)stream>>>(
      (const To*)r, (const hs_real_t<To>*)sc, (Ti*)V, (Ti*)vj, (Ti*)H,
      (hs_real_t<Ti>*)cs, (Ti*)sn, (Ti*)g, (Ti*)y, (hs_real_t<Ti>*)floor,
      (int*)loop, (int64_t)N, m, m_eps);
  return (int)cudaGetLastError();
}

#define HS_CYCLE_START(NAME, TO, TI)                                        \
  HS_EXPORT int NAME(const void* r, const void* sc, void* V, void* vj,       \
                     void* H, void* cs, void* sn, void* g, void* y,          \
                     void* floor, void* loop, long long N, int m,            \
                     double m_eps, void* stream) {                           \
    return gmres_cycle_start<TO, TI>(r, sc, V, vj, H, cs, sn, g, y, floor,   \
                                     loop, N, m, m_eps, stream);             \
  }
// the cycles in the solution's type, and float32 cycles in a float64 solve
HS_CYCLE_START(hs_gmres_cycle_start, double, double)
HS_CYCLE_START(hs_gmres_cycle_start_f32, float, float)
HS_CYCLE_START(hs_gmres_cycle_start_mixed, double, float)
// complex: the cycles in the solution's type, and complex64 cycles in a
// complex128 solve
HS_CYCLE_START(hs_gmres_cycle_start_c128, hs_c128, hs_c128)
HS_CYCLE_START(hs_gmres_cycle_start_c64, hs_c64, hs_c64)
HS_CYCLE_START(hs_gmres_cycle_start_mixed_c, hs_c128, hs_c64)

template <typename To>
static int gmres_cycle_end(void* sc, void* hist, void* loop, int nhist,
                           void* stream) {
  gmres_cycle_end_kernel<To><<<1, 1, 0, (cudaStream_t)stream>>>(
      (To*)sc, (To*)hist, (int*)loop, nhist);
  return (int)cudaGetLastError();
}

HS_EXPORT int hs_gmres_cycle_end(void* sc, void* hist, void* loop, int nhist,
                                 void* stream) {
  return gmres_cycle_end<double>(sc, hist, loop, nhist, stream);
}

HS_EXPORT int hs_gmres_cycle_end_f32(void* sc, void* hist, void* loop,
                                     int nhist, void* stream) {
  return gmres_cycle_end<float>(sc, hist, loop, nhist, stream);
}

template <typename To>
static int gmres_escalate(const void* sc1, void* sc2, void* stream) {
  gmres_escalate_kernel<To><<<1, 1, 0, (cudaStream_t)stream>>>(
      (const To*)sc1, (To*)sc2);
  return (int)cudaGetLastError();
}

HS_EXPORT int hs_gmres_escalate(const void* sc1, void* sc2, void* stream) {
  return gmres_escalate<double>(sc1, sc2, stream);
}

HS_EXPORT int hs_gmres_escalate_f32(const void* sc1, void* sc2,
                                    void* stream) {
  return gmres_escalate<float>(sc1, sc2, stream);
}

// ---------------------------------------------------------------------------
// the graph
// ---------------------------------------------------------------------------

static cudaError_t add_child(cudaGraph_t g, cudaGraphNode_t* dep,
                             cudaGraph_t child, cudaGraphNode_t* out) {
  return cudaGraphAddChildGraphNode(out, g, dep, dep ? 1 : 0, child);
}

static cudaError_t add_set(cudaGraph_t g, cudaGraphNode_t* dep,
                           cudaGraphConditionalHandle h, const int* flag,
                           int negate, cudaGraphNode_t* out) {
  cudaKernelNodeParams kp = {};
  kp.func = (void*)gmres_set_cond_kernel;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  void* args[] = {&h, &flag, &negate};
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
  const cudaError_t e = cudaGraphAddNode(out, g, dep, dep ? 1 : 0, &p);
  if (e == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return e;
}

#define HS_TRY(x)                                \
  do {                                           \
    const cudaError_t e_ = (x);                  \
    if (e_ != cudaSuccess) {                     \
      cudaGraphDestroy(G);                       \
      return (int)e_;                            \
    }                                            \
  } while (0)

// Compose and instantiate the solve's graph.  parts: for each of `nphase`
// phases its pre, start, step and end graphs, then post (4 nphase + 1
// graphs, each cloned into a child graph node); flags: for each phase its
// `loop` (gmres_loop.cuh), whose GO slot drives the cycle loop and whose
// DONE slot (negated) the step loop.  Returns the graph and its
// executable through graph_out and exec_out.
HS_EXPORT int hs_gmres_graph(int nphase, void* const* parts,
                             void* const* loops, void** graph_out,
                             void** exec_out) {
  if (nphase < 1) return (int)cudaErrorInvalidValue;
  cudaGraph_t G;
  const cudaError_t ce = cudaGraphCreate(&G, 0);
  if (ce != cudaSuccess) return (int)ce;
  cudaGraphNode_t last = nullptr, n, c, d, e, f, s;
  for (int ph = 0; ph < nphase; ++ph) {
    cudaGraph_t pre = (cudaGraph_t)parts[4 * ph];
    cudaGraph_t start = (cudaGraph_t)parts[4 * ph + 1];
    cudaGraph_t step = (cudaGraph_t)parts[4 * ph + 2];
    cudaGraph_t end = (cudaGraph_t)parts[4 * ph + 3];
    const int* go = (const int*)loops[ph] + HS_LOOP_GO;
    const int* done = (const int*)loops[ph] + HS_LOOP_DONE;
    cudaGraphConditionalHandle ho, hi;
    cudaGraph_t Bo, Bi;
    HS_TRY(add_child(G, last ? &last : nullptr, pre, &n));
    HS_TRY(cudaGraphConditionalHandleCreate(&ho, G, 0, 0));
    HS_TRY(add_set(G, &n, ho, go, 0, &c));
    HS_TRY(add_while(G, &c, ho, &last, &Bo));
    HS_TRY(cudaGraphConditionalHandleCreate(&hi, Bo, 0, 0));
    HS_TRY(add_child(Bo, nullptr, start, &c));
    HS_TRY(add_set(Bo, &c, hi, done, 1, &d));
    HS_TRY(add_while(Bo, &d, hi, &e, &Bi));
    HS_TRY(add_child(Bo, &e, end, &f));
    HS_TRY(add_set(Bo, &f, ho, go, 0, &s));
    HS_TRY(add_child(Bi, nullptr, step, &c));
    HS_TRY(add_set(Bi, &c, hi, done, 1, &d));
  }
  HS_TRY(add_child(G, &last, (cudaGraph_t)parts[4 * nphase], &n));
  cudaGraphExec_t ex;
  HS_TRY(cudaGraphInstantiate(&ex, G, 0));
  *graph_out = (void*)G;
  *exec_out = (void*)ex;
  return 0;
}

HS_EXPORT int hs_gmres_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

HS_EXPORT int hs_gmres_graph_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph) {
    const cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
    if (e == cudaSuccess) e = e2;
  }
  return (int)e;
}
