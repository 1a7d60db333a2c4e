// Kernel M alone: the Givens bookkeeping of one Arnoldi step on the column
// kernel L wrote to hc, one warp a launch (`hs_arnoldi_givens`).
//
// The GMRES loop runs M as the tail of kernel L's launch (`hs_arnoldi_step`
// in arnoldi_cgs2.cu, one launch a step); this entry point keeps M's own
// reading (ops/arnoldi.py `arnoldi_givens`).  The step itself, what it
// replaces in hsolve/krylov.py and its rounding are in arnoldi_givens.cuh.
// Instantiated for double (`hs_arnoldi_givens`), float
// (`hs_arnoldi_givens_f32`) and the complex types (`_c128`, `_c64`; cs and
// st in the real type).  H[:J, :J] is staged in shared memory for the
// cycle end where it fits in 48 KB with the rest (J <= 74 in float64;
// half as many values in complex128).
#include "arnoldi_givens.cuh"

template <typename T>
__global__ void arnoldi_givens_kernel(const T* __restrict__ hc,
                                      GivensArgs<T> p, int j) {
  extern __shared__ __align__(16) unsigned char hs_smem[];
  T* col = reinterpret_cast<T*>(hs_smem);  // [m+1]
  for (int i = threadIdx.x; i <= p.m; i += 32)
    col[i] = i <= j + 1 ? hc[i] : T(0);
  __syncwarp();
  givens_step(col, col + p.m + 1, p, j);
}

template <typename T>
static int arnoldi_givens(void* H, void* cs, void* sn, void* g, const void* hc,
                          void* st, void* done, void* y, int j, int m,
                          double res_floor, int cont, void* stream) {
  if (m < 1 || m > HS_GIVENS_MAX_M || j < 0 || j >= m)
    return (int)cudaErrorInvalidValue;
  typedef hs_real_t<T> R;
  GivensArgs<T> p = {(T*)H, (R*)cs, (T*)sn, (T*)g, (R*)st, (int*)done, (T*)y,
                     m, (R)res_floor, cont, 1};
  long long vals = (m + 1) + givens_smem_values(m, j + 1, true);
  if (vals * (long long)sizeof(T) > 48 * 1024) {
    p.h_smem = 0;
    vals = (m + 1) + givens_smem_values(m, j + 1, false);
  }
  arnoldi_givens_kernel<T><<<1, 32, (size_t)vals * sizeof(T),
                             (cudaStream_t)stream>>>((const T*)hc, p, j);
  return (int)cudaGetLastError();
}

HS_EXPORT int hs_arnoldi_givens(void* H, void* cs, void* sn, void* g,
                                const void* hc, void* st, void* done, void* y,
                                int j, int m, double res_floor, int cont,
                                void* stream) {
  return arnoldi_givens<double>(H, cs, sn, g, hc, st, done, y, j, m,
                                res_floor, cont, stream);
}

HS_EXPORT int hs_arnoldi_givens_f32(void* H, void* cs, void* sn, void* g,
                                    const void* hc, void* st, void* done,
                                    void* y, int j, int m, double res_floor,
                                    int cont, void* stream) {
  return arnoldi_givens<float>(H, cs, sn, g, hc, st, done, y, j, m,
                               res_floor, cont, stream);
}

#define HS_M_EXPORT(SFX, T)                                                   \
  HS_EXPORT int hs_arnoldi_givens##SFX(void* H, void* cs, void* sn, void* g,  \
                                       const void* hc, void* st, void* done,  \
                                       void* y, int j, int m,                 \
                                       double res_floor, int cont,            \
                                       void* stream) {                        \
    return arnoldi_givens<T>(H, cs, sn, g, hc, st, done, y, j, m, res_floor,  \
                             cont, stream);                                   \
  }
HS_M_EXPORT(_c128, hs_c128)
HS_M_EXPORT(_c64, hs_c64)
