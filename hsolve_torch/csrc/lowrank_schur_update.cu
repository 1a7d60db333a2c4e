// Kernel F: Schur complement of a compressed level, stored already permuted.
//
// Replaces hsolve/factor.py `_factor_front_compressed_impl`'s
//
//     S = Abb - (Abi @ RU) @ RV^T;  S = permute_sym(S, sperm)     (:378-379)
//
// which XLA lowered as a GEMM, a subtraction and two gathers, with the
// [B, nb, nb] intermediate written and read twice.  With W = Abi @ RU
// ([B, nb, kc], a plain torch.matmul) this kernel computes
//
//     S[b, i, j] = Abb[b, p_i, p_j] - sum_k W[b, p_i, k] * RV[b, p_j, k]
//
// with p = sperm[b], reading Abb in place from the front buffer
// (front[b, ni_pad + p_i, ni_pad + p_j], row stride m_pad; no copy) and
// storing S already in [int_loc; bnd_loc] order for the parent's extend-add.
//
// Bound: memory.  The B * nb^2 read of Abb and write of S dominate; the
// rank-kc product adds 2 * kc flops per entry with kc <= 64 on the main
// path's plans, and W and RV (B * nb * kc each) are read once per 32-wide
// tile row or column.  Each block computes a 32 x 32 tile of one front:
// the 32 permuted rows of W and of RV go through shared memory in chunks of
// 32 ranks, each thread accumulates four entries, and the store of S is
// coalesced along j.
#include "hs_common.cuh"

#define F_TILE 32
#define F_ROWS 8  // threads per tile column; each thread owns F_TILE / F_ROWS rows

__global__ void lowrank_schur_update_kernel(
    const double* __restrict__ front, const double* __restrict__ W,
    const double* __restrict__ V, const long long* __restrict__ sperm,
    double* __restrict__ S, long long B, int m_pad, int ni_pad, int kc) {
  __shared__ double Ws[F_TILE][F_TILE + 1];
  __shared__ double Vs[F_TILE][F_TILE + 1];
  __shared__ int pi[F_TILE], pj[F_TILE];
  const int nb = m_pad - ni_pad;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * F_TILE + tx;
  const int i0 = blockIdx.y * F_TILE, j0 = blockIdx.x * F_TILE;

  for (long long b = blockIdx.z; b < B; b += gridDim.z) {
    const long long* p = sperm + b * nb;
    if (tid < F_TILE) {
      pi[tid] = i0 + tid < nb ? (int)p[i0 + tid] : -1;
    } else if (tid < 2 * F_TILE) {
      const int u = tid - F_TILE;
      pj[u] = j0 + u < nb ? (int)p[j0 + u] : -1;
    }
    __syncthreads();
    double acc[F_TILE / F_ROWS];
#pragma unroll
    for (int q = 0; q < F_TILE / F_ROWS; ++q) acc[q] = 0.0;
    const double* Wb = W + b * nb * (long long)kc;
    const double* Vb = V + b * nb * (long long)kc;
    for (int k0 = 0; k0 < kc; k0 += F_TILE) {
      for (int e = tid; e < F_TILE * F_TILE; e += F_TILE * F_ROWS) {
        const int r = e / F_TILE, kk = e % F_TILE;
        const bool kin = k0 + kk < kc;
        Ws[r][kk] = (kin && pi[r] >= 0) ? Wb[(long long)pi[r] * kc + k0 + kk]
                                        : 0.0;
        Vs[r][kk] = (kin && pj[r] >= 0) ? Vb[(long long)pj[r] * kc + k0 + kk]
                                        : 0.0;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < F_TILE; ++kk) {
        const double v = Vs[tx][kk];
#pragma unroll
        for (int q = 0; q < F_TILE / F_ROWS; ++q)
          acc[q] += Ws[ty + q * F_ROWS][kk] * v;
      }
      __syncthreads();
    }
    const int j = j0 + tx;
    if (j < nb) {
      const double* Abb = front + b * (long long)m_pad * m_pad +
                          (long long)ni_pad * m_pad + ni_pad;
#pragma unroll
      for (int q = 0; q < F_TILE / F_ROWS; ++q) {
        const int r = ty + q * F_ROWS, i = i0 + r;
        if (i < nb)
          S[(b * nb + i) * (long long)nb + j] =
              Abb[(long long)pi[r] * m_pad + pj[tx]] - acc[q];
      }
    }
    __syncthreads();  // pi/pj are rewritten for the next front
  }
}

HS_EXPORT int hs_lowrank_schur_update(const void* front, const void* W,
                                      const void* V, const void* sperm,
                                      void* S, long long B, int m_pad,
                                      int ni_pad, int kc, void* stream) {
  const int nb = m_pad - ni_pad;
  if (B > 0 && nb > 0) {
    const unsigned tiles = (unsigned)((nb + F_TILE - 1) / F_TILE);
    dim3 grid(tiles, tiles, (unsigned)(B < 65535 ? B : 65535));
    dim3 block(F_TILE, F_ROWS);
    lowrank_schur_update_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const double*)front, (const double*)W, (const double*)V,
        (const long long*)sperm, (double*)S, B, m_pad, ni_pad, kc);
  }
  return (int)cudaGetLastError();
}
