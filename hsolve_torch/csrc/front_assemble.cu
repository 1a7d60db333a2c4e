// Kernel A: front assembly.
//
// Replaces hsolve/factor.py `_vals_of` (:644-654) + `build_front_vals`
// (:409-417), which XLA fused into one gather-select-scatter.  For every COO
// entry e of a batch:
//
//     front.flat[pos[e]] = src[e] >= 0 ? adata[src[e]] : 1.0
//
// `adata` is the device copy of the permuted matrix's CSR values, `src` the
// planner's per-entry source index (-1 marks the identity padding of the pivot
// block) and `pos` the flat position in the zero-initialised [B, m_pad, m_pad]
// front stack.  Positions are unique, so plain stores suffice.
//
// Instantiated for double (`hs_front_assemble`) and float
// (`hs_front_assemble_f32`, the float32 factor).
//
// Bound: memory.  Each entry reads 8 bytes of index data and one value by
// gather, and writes one value at a scattered position (the positions of one
// front row are contiguous, so neighbouring threads mostly hit neighbouring
// addresses).  The design is one grid-stride pass with no staging; the
// gathered values are read through the read-only cache.
#include "hs_common.cuh"

template <typename T>
__global__ void front_assemble_kernel(T* __restrict__ front,
                                      const int* __restrict__ pos,
                                      const int* __restrict__ src,
                                      const T* __restrict__ adata,
                                      int64_t nnz) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < nnz;
       e += stride) {
    const int s = src[e];
    front[pos[e]] = s >= 0 ? __ldg(adata + s) : T(1);
  }
}

template <typename T>
static int front_assemble(void* front, const void* pos, const void* src,
                          const void* adata, long long nnz, void* stream) {
  if (nnz > 0) {
    const int threads = 256;
    front_assemble_kernel<T><<<hs_blocks(nnz, threads), threads, 0,
                               (cudaStream_t)stream>>>(
        (T*)front, (const int*)pos, (const int*)src, (const T*)adata,
        (int64_t)nnz);
  }
  return (int)cudaGetLastError();
}

HS_EXPORT int hs_front_assemble(void* front, const void* pos, const void* src,
                                const void* adata, long long nnz,
                                void* stream) {
  return front_assemble<double>(front, pos, src, adata, nnz, stream);
}

HS_EXPORT int hs_front_assemble_f32(void* front, const void* pos,
                                    const void* src, const void* adata,
                                    long long nnz, void* stream) {
  return front_assemble<float>(front, pos, src, adata, nnz, stream);
}

HS_EXPORT const char* hs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
