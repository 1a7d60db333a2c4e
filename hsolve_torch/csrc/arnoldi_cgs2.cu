// Kernel L: the CGS2 orthogonalization of one Arnoldi step.
//
// Replaces the classical Gram-Schmidt, applied twice, of hsolve/krylov.py
// `_gmres_cycles.inner_body` (:231-237), which XLA lowered as two GEMV pairs
// and a norm over the basis V [m+1, N]:
//
//     h1 = V[:R] w,  w -= V[:R]^T h1,  h2 = V[:R] w,  w -= V[:R]^T h2
//     hc[:R] = h1 + h2,  hc[R] = ||w||                    (R = j + 1)
//
// w is updated in place.  Instantiated for double (`hs_arnoldi_cgs2`) and
// float (`hs_arnoldi_cgs2_f32`, the inner cycles of mixed-precision GMRES).
//
// A pass cannot update w before its dot products are summed across blocks,
// so the step is three launches over the same partition of N into `nb`
// chunks, one block each:
//   0. partial dots of V[:R] with w -> P1 [R, nb];
//   1. every block sums P1 in one fixed order (so all hold the same h1),
//      updates its chunk of w and takes the partial dots of the result
//      -> P2; block 0 stores h1 in hc;
//   2. the same with P2 (h2), then the partial sums of ||w||^2 -> P3 [nb];
//      the last block to finish (an atomic ticket) sums P3 in a fixed order,
//      writes hc[R] = ||w||, hc[:R] += h2 and re-arms the ticket.
// Each update is fused with the next sweep's sums, so a step reads V three
// times instead of the four of two separate GEMV pairs; the second look at a
// chunk of V inside a launch comes from L2.  Nothing goes to the host.
//
// Bound: bytes.  A step must read the R rows of V and w and write w (the
// partial sums are R * nb values); the work is four multiply-adds per value
// of V.  One block per chunk stages its chunk of w in shared memory; the dots
// run one warp per row of V with shuffle reductions, the updates one thread
// per entry of w, both coalesced along N.
#include "hs_common.cuh"

#define HS_CGS2_THREADS 512
#define HS_CGS2_MAX_CHUNK 4096
#define HS_CGS2_MAX_ROWS 512

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// h[i] = sum_b P[i * nb + b], one warp per row, the same order in every block
template <typename T>
__device__ void sum_partials(const T* P, int nb, int R, T* h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < R; i += blockDim.x >> 5) {
    T acc = T(0);
    for (int b = lane; b < nb; b += 32) acc += P[(int64_t)i * nb + b];
    acc = warp_sum(acc);
    if (lane == 0) h[i] = acc;
  }
  __syncthreads();
}

// P[i * nb + blockIdx.x] = V[i, lo:lo+len] . ws, one warp per row
template <typename T>
__device__ void chunk_dots(const T* V, int64_t N, int R, const T* ws,
                           int64_t lo, int len, T* P, int nb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < R; i += blockDim.x >> 5) {
    const T* vrow = V + (int64_t)i * N + lo;
    T acc = T(0);
    for (int t = lane; t < len; t += 32) acc += vrow[t] * ws[t];
    acc = warp_sum(acc);
    if (lane == 0) P[(int64_t)i * nb + blockIdx.x] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(HS_CGS2_THREADS)
arnoldi_cgs2_kernel(const T* __restrict__ V, T* __restrict__ w,
                    T* __restrict__ hc, T* __restrict__ part,
                    unsigned* __restrict__ ticket, int R, int64_t N, int nb,
                    int chunk, int pass) {
  __shared__ T ws[HS_CGS2_MAX_CHUNK];
  __shared__ T h[HS_CGS2_MAX_ROWS];
  __shared__ T red[HS_CGS2_THREADS / 32];
  __shared__ bool last;
  T* P1 = part;
  T* P2 = part + (int64_t)R * nb;
  T* P3 = part + 2 * (int64_t)R * nb;
  const int64_t lo = (int64_t)blockIdx.x * chunk;
  const int len = (int)(N - lo < chunk ? N - lo : chunk);

  if (pass == 0) {
    for (int t = threadIdx.x; t < len; t += blockDim.x) ws[t] = w[lo + t];
    __syncthreads();
    chunk_dots(V, N, R, ws, lo, len, P1, nb);
    return;
  }
  sum_partials(pass == 1 ? P1 : P2, nb, R, h);
  if (pass == 1 && blockIdx.x == 0)
    for (int i = threadIdx.x; i < R; i += blockDim.x) hc[i] = h[i];
  // w -= V[:R]^T h on this chunk (the GEMV, then one subtraction, as XLA's
  // w - V.T @ h)
  T sq = T(0);
  for (int t = threadIdx.x; t < len; t += blockDim.x) {
    T acc = T(0);
    for (int i = 0; i < R; ++i) acc += V[(int64_t)i * N + lo + t] * h[i];
    const T wn = w[lo + t] - acc;
    w[lo + t] = wn;
    ws[t] = wn;
    sq += wn * wn;
  }
  __syncthreads();
  if (pass == 1) {
    chunk_dots(V, N, R, ws, lo, len, P2, nb);
    return;
  }
  // pass 2: ||w||^2 partials, then the last block finishes the step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  sq = warp_sum(sq);
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = T(0);
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) s += red[k];
    P3[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned)gridDim.x - 1u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (warp == 0) {
    T s = T(0);
    for (int b = lane; b < nb; b += 32) s += __ldcg(P3 + b);
    s = warp_sum(s);
    if (lane == 0) {
      hc[R] = sqrt(s);
      *ticket = 0u;
    }
  }
  for (int i = threadIdx.x; i < R; i += blockDim.x) hc[i] = hc[i] + h[i];
}

template <typename T>
static int arnoldi_cgs2(const void* V, void* w, void* hc, void* part,
                        void* ticket, int R, long long N, int nb,
                        void* stream) {
  if (R < 1 || R > HS_CGS2_MAX_ROWS || nb < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const long long chunk = (N + nb - 1) / nb;
  if (chunk > HS_CGS2_MAX_CHUNK) return (int)cudaErrorInvalidValue;
  for (int pass = 0; pass < 3; ++pass) {
    arnoldi_cgs2_kernel<T><<<nb, HS_CGS2_THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)V, (T*)w, (T*)hc, (T*)part, (unsigned*)ticket, R,
        (int64_t)N, nb, (int)chunk, pass);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

HS_EXPORT int hs_arnoldi_cgs2(const void* V, void* w, void* hc, void* part,
                              void* ticket, int R, long long N, int nb,
                              void* stream) {
  return arnoldi_cgs2<double>(V, w, hc, part, ticket, R, N, nb, stream);
}

HS_EXPORT int hs_arnoldi_cgs2_f32(const void* V, void* w, void* hc,
                                  void* part, void* ticket, int R,
                                  long long N, int nb, void* stream) {
  return arnoldi_cgs2<float>(V, w, hc, part, ticket, R, N, nb, stream);
}
