// Kernel J: the HSS matrix-vector product y = A x (or A^T x), all levels in
// one launch.
//
// Replaces hsolve/ops/hss.py `hss_matvec` (:207-242), which XLA lowered as
// one batched GEMM pair per level and direction plus the reshapes between
// them (about 4 depth + 3 small ops).  With Vl, Ul, Ws, Rs the column basis,
// row basis, upsweep and downsweep translations (V, U, W, R forward; U, V,
// R, W for the adjoint) and B12/B21 the sibling couplings (B21^T/B12^T for
// the adjoint):
//
//   upsweep    xi_0[l]   = Vl[l]^T x[l]                        leaves
//              xi_L[j]   = sum_{t=2j,2j+1} Ws_{L-1}[t]^T xi_{L-1}[t]
//   couplings  eta_L[2j]   = B12_{L+1}[j] xi_L[2j+1]
//              eta_L[2j+1] = B21_{L+1}[j] xi_L[2j]
//   downsweep  acc_L[t]  = Rs_L[t] acc_{L+1}[t/2] + eta_L[t]  (acc_top = eta_top)
//   leaves     y[l]      = D[l] x[l] + Ul[l] acc_0[l]          (D^T: adjoint)
//
// The translation and coupling stacks arrive concatenated over the levels
// (Hss.packed()); xi and acc live in a scratch buffer the wrapper allocates,
// [B, 2 nleaves, r, k] each, one node block per tree node.
//
// Bound: latency and launch count.  At the n=512 plan a matrix has up to 32
// leaves of 32 rows, r = 48, depth 5, and k = 58 (sampling), 112 (the
// factor's pivot solves) or 1 (GMRES): a few hundred kFLOP per matrix and
// column, far below what moves the card, in 4 depth phases.  One block per
// (matrix, tile of kc columns) walks every phase with barriers between them,
// so one launch replaces the per-level chain; threads run over the (node,
// row, column) outputs of a phase, each an r- or ls-long dot.
#include "hs_common.cuh"

#define J_THREADS 256

__global__ void __launch_bounds__(J_THREADS) hss_matvec_kernel(
    const double* __restrict__ D, const double* __restrict__ U,
    const double* __restrict__ V, const double* __restrict__ Rc,
    const double* __restrict__ Wc, const double* __restrict__ B12c,
    const double* __restrict__ B21c, const double* __restrict__ x,
    double* __restrict__ y, double* up, double* down, int nleaves, int ls,
    int r, int depth, int k, int kc, int adjoint) {
  const int64_t b = blockIdx.x;
  const int c0 = blockIdx.y * kc;
  const int nc = min(kc, k - c0);
  const int tid = threadIdx.x;
  const int npad = nleaves * ls;
  const int64_t rr = (int64_t)r * r;
  const double* Db = D + b * (int64_t)nleaves * ls * ls;
  const double* Vl = (adjoint ? U : V) + b * (int64_t)npad * r;
  const double* Ul = (adjoint ? V : U) + b * (int64_t)npad * r;
  const double* Wu = (adjoint ? Rc : Wc) + b * (int64_t)(2 * nleaves - 2) * rr;
  const double* Rd = (adjoint ? Wc : Rc) + b * (int64_t)(2 * nleaves - 2) * rr;
  const double* Cl = (adjoint ? B21c : B12c) + b * (int64_t)(nleaves - 1) * rr;
  const double* Cr = (adjoint ? B12c : B21c) + b * (int64_t)(nleaves - 1) * rr;
  const double* xb = x + b * (int64_t)npad * k;
  double* yb = y + b * (int64_t)npad * k;
  double* ub = up + b * (int64_t)2 * nleaves * r * k;
  double* db = down + b * (int64_t)2 * nleaves * r * k;
  // node offset of tree level L (0 = leaves) in the scratch and in the packed
  // translations; coupling offset of internal level L + 1
#define OFF(L) (2 * nleaves - 2 * (nleaves >> (L)))
#define BOFF(L) (nleaves - 2 * (nleaves >> ((L) + 1)))

  // upsweep, leaves: xi_0[l][a][c] = sum_i Vl[l ls + i][a] x[l ls + i][c]
  for (int e = tid; e < nleaves * r * nc; e += J_THREADS) {
    const int c = e % nc, a = (e / nc) % r, l = e / (nc * r);
    const double* vp = Vl + (int64_t)l * ls * r + a;
    const double* xp = xb + (int64_t)l * ls * k + c0 + c;
    double s = 0.0;
    for (int i = 0; i < ls; ++i) s += vp[(int64_t)i * r] * xp[(int64_t)i * k];
    ub[((int64_t)l * r + a) * k + c0 + c] = s;
  }
  __syncthreads();
  // upsweep, internal levels 1..depth-1
  for (int L = 1; L < depth; ++L) {
    const int nodes = nleaves >> L;
    for (int e = tid; e < nodes * r * nc; e += J_THREADS) {
      const int c = e % nc, a = (e / nc) % r, j = e / (nc * r);
      double s = 0.0;
      for (int t = 2 * j; t < 2 * j + 2; ++t) {
        const double* wp = Wu + (OFF(L - 1) + t) * rr + a;  // W[t][:, a]
        const double* xp = ub + (int64_t)(OFF(L - 1) + t) * r * k + c0 + c;
        double st = 0.0;
        for (int i = 0; i < r; ++i) st += wp[(int64_t)i * r] * xp[(int64_t)i * k];
        s += st;
      }
      ub[((int64_t)(OFF(L) + j) * r + a) * k + c0 + c] = s;
    }
    __syncthreads();
  }
  // couplings of every internal level (independent of each other)
  for (int L = 0; L < depth; ++L) {
    const int nodes = nleaves >> L;  // children at tree level L
    for (int e = tid; e < nodes * r * nc; e += J_THREADS) {
      const int c = e % nc, a = (e / nc) % r, t = e / (nc * r);
      const int j = t >> 1, sib = t ^ 1;
      const double* cp = ((t & 1) ? Cr : Cl) + (BOFF(L) + j) * rr;
      const double* xp = ub + (int64_t)(OFF(L) + sib) * r * k + c0 + c;
      double s = 0.0;
      if (!adjoint) {
        for (int i = 0; i < r; ++i) s += cp[(int64_t)a * r + i] * xp[(int64_t)i * k];
      } else {
        for (int i = 0; i < r; ++i) s += cp[(int64_t)i * r + a] * xp[(int64_t)i * k];
      }
      db[((int64_t)(OFF(L) + t) * r + a) * k + c0 + c] = s;
    }
  }
  __syncthreads();
  // downsweep: acc_L[t] += Rd_L[t] acc_{L+1}[t / 2]
  for (int L = depth - 2; L >= 0; --L) {
    const int nodes = nleaves >> L;
    for (int e = tid; e < nodes * r * nc; e += J_THREADS) {
      const int c = e % nc, a = (e / nc) % r, t = e / (nc * r);
      const double* rp = Rd + (OFF(L) + t) * rr + (int64_t)a * r;  // R[t][a, :]
      const double* ap = db + (int64_t)(OFF(L + 1) + (t >> 1)) * r * k + c0 + c;
      double s = 0.0;
      for (int i = 0; i < r; ++i) s += rp[i] * ap[(int64_t)i * k];
      db[((int64_t)(OFF(L) + t) * r + a) * k + c0 + c] += s;
    }
    __syncthreads();
  }
  // leaves: y = D x + Ul acc_0
  for (int e = tid; e < npad * nc; e += J_THREADS) {
    const int c = e % nc, row = e / nc;
    const int l = row / ls, i = row - l * ls;
    const double* dp = Db + (int64_t)l * ls * ls;
    const double* xp = xb + (int64_t)l * ls * k + c0 + c;
    double sd = 0.0;
    if (!adjoint) {
      for (int j = 0; j < ls; ++j) sd += dp[(int64_t)i * ls + j] * xp[(int64_t)j * k];
    } else {
      for (int j = 0; j < ls; ++j) sd += dp[(int64_t)j * ls + i] * xp[(int64_t)j * k];
    }
    const double* up_ = Ul + (int64_t)row * r;
    const double* ap = db + (int64_t)l * r * k + c0 + c;
    double su = 0.0;
    for (int a = 0; a < r; ++a) su += up_[a] * ap[(int64_t)a * k];
    yb[(int64_t)row * k + c0 + c] = sd + su;
  }
#undef OFF
#undef BOFF
}

HS_EXPORT int hs_hss_matvec(const void* D, const void* U, const void* V,
                            const void* Rc, const void* Wc, const void* B12c,
                            const void* B21c, const void* x, void* y, void* up,
                            void* down, long long B, int nleaves, int ls, int r,
                            int depth, int k, int kc, int adjoint,
                            void* stream) {
  if (B > 0 && k > 0 && kc > 0 && depth >= 1) {
    int tiles = (k + kc - 1) / kc;
    dim3 grid((unsigned)B, (unsigned)tiles);
    hss_matvec_kernel<<<grid, J_THREADS, 0, (cudaStream_t)stream>>>(
        (const double*)D, (const double*)U, (const double*)V,
        (const double*)Rc, (const double*)Wc, (const double*)B12c,
        (const double*)B21c, (const double*)x, (double*)y, (double*)up,
        (double*)down, nleaves, ls, r, depth, k, kc, adjoint);
  }
  return (int)cudaGetLastError();
}
