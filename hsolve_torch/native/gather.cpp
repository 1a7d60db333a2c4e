// Native planner kernels: fast CSR submatrix gather.
//
// This is the framework's C++ runtime component, capability parity with the
// reference's sparse fancy-indexing replacement (/root/reference/src/mygetindex.jl:
// hashmap/bsearch getindex_I_sorted_* monkey-patched into SparseArrays) - the
// factorization's symbolic hot loop.  The planner extracts every A[I, J] block the
// numeric phase will need; scipy's generic fancy indexing allocates intermediate
// sparse results, while this kernel scatters straight into the padded dense front
// buffers using a column-position map (O(nnz(rows) + |J|) per block).
//
// Build: cc -O3 -shared -fPIC (see build.py); called through ctypes.

#include <complex>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// colmap: int64 workspace of size >= ncols(A), must hold -1 on entry and is
// restored before returning (stamp-free variant keeps re-entry simple).
void csr_gather_f64(const int64_t *indptr, const int64_t *indices,
                    const double *data, const int64_t *rows, int64_t nrows,
                    const int64_t *cols, int64_t ncols, int64_t *colmap,
                    double *out, int64_t out_stride) {
  for (int64_t j = 0; j < ncols; ++j) colmap[cols[j]] = j;
  for (int64_t i = 0; i < nrows; ++i) {
    const int64_t r = rows[i];
    double *orow = out + i * out_stride;
    for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
      const int64_t k = colmap[indices[p]];
      if (k >= 0) orow[k] = data[p];
    }
  }
  for (int64_t j = 0; j < ncols; ++j) colmap[cols[j]] = -1;
}

void csr_gather_c128(const int64_t *indptr, const int64_t *indices,
                     const std::complex<double> *data, const int64_t *rows,
                     int64_t nrows, const int64_t *cols, int64_t ncols,
                     int64_t *colmap, std::complex<double> *out,
                     int64_t out_stride) {
  for (int64_t j = 0; j < ncols; ++j) colmap[cols[j]] = j;
  for (int64_t i = 0; i < nrows; ++i) {
    const int64_t r = rows[i];
    std::complex<double> *orow = out + i * out_stride;
    for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
      const int64_t k = colmap[indices[p]];
      if (k >= 0) orow[k] = data[p];
    }
  }
  for (int64_t j = 0; j < ncols; ++j) colmap[cols[j]] = -1;
}

// Batched variant: K blocks in one call (ctypes binding overhead dominates per-block
// calls from the planner's node loop).  Block k gathers rows
// rows[row_ptr[k]:row_ptr[k+1]] x cols[col_ptr[k]:col_ptr[k+1]] and scatters into
// out_base + out_off[k] with row stride out_stride (elements).
void csr_gather_many_f64(const int64_t *indptr, const int64_t *indices,
                         const double *data, const int64_t *rows,
                         const int64_t *row_ptr, const int64_t *cols,
                         const int64_t *col_ptr, int64_t nblocks, int64_t *colmap,
                         double *out_base, const int64_t *out_off,
                         int64_t out_stride) {
  for (int64_t k = 0; k < nblocks; ++k) {
    const int64_t c0 = col_ptr[k], c1 = col_ptr[k + 1];
    const int64_t r0 = row_ptr[k], r1 = row_ptr[k + 1];
    for (int64_t j = c0; j < c1; ++j) colmap[cols[j]] = j - c0;
    double *out = out_base + out_off[k];
    for (int64_t i = r0; i < r1; ++i) {
      const int64_t r = rows[i];
      double *orow = out + (i - r0) * out_stride;
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        const int64_t kk = colmap[indices[p]];
        if (kk >= 0) orow[kk] = data[p];
      }
    }
    for (int64_t j = c0; j < c1; ++j) colmap[cols[j]] = -1;
  }
}

void csr_gather_many_c128(const int64_t *indptr, const int64_t *indices,
                          const std::complex<double> *data, const int64_t *rows,
                          const int64_t *row_ptr, const int64_t *cols,
                          const int64_t *col_ptr, int64_t nblocks, int64_t *colmap,
                          std::complex<double> *out_base, const int64_t *out_off,
                          int64_t out_stride) {
  for (int64_t k = 0; k < nblocks; ++k) {
    const int64_t c0 = col_ptr[k], c1 = col_ptr[k + 1];
    const int64_t r0 = row_ptr[k], r1 = row_ptr[k + 1];
    for (int64_t j = c0; j < c1; ++j) colmap[cols[j]] = j - c0;
    std::complex<double> *out = out_base + out_off[k];
    for (int64_t i = r0; i < r1; ++i) {
      const int64_t r = rows[i];
      std::complex<double> *orow = out + (i - r0) * out_stride;
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        const int64_t kk = colmap[indices[p]];
        if (kk >= 0) orow[kk] = data[p];
      }
    }
    for (int64_t j = c0; j < c1; ++j) colmap[cols[j]] = -1;
  }
}

// COO variant: instead of writing dense blocks, emit (flat position, value) pairs.
// Block k scatters A[rows_k, cols_k] entries to out positions
// out_off[k] + (i - r0) * out_stride[k] + colmap[col].  Returns the pair count.
int64_t csr_gather_coo_many_f64(const int64_t *indptr, const int64_t *indices,
                                const double *data, const int64_t *rows,
                                const int64_t *row_ptr, const int64_t *cols,
                                const int64_t *col_ptr, int64_t nblocks,
                                int64_t *colmap, const int64_t *out_off,
                                const int64_t *out_stride, int64_t *pos_out,
                                double *val_out) {
  int64_t c = 0;
  for (int64_t k = 0; k < nblocks; ++k) {
    const int64_t c0 = col_ptr[k], c1 = col_ptr[k + 1];
    const int64_t r0 = row_ptr[k], r1 = row_ptr[k + 1];
    for (int64_t j = c0; j < c1; ++j) colmap[cols[j]] = j - c0;
    for (int64_t i = r0; i < r1; ++i) {
      const int64_t r = rows[i];
      const int64_t base = out_off[k] + (i - r0) * out_stride[k];
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        const int64_t kk = colmap[indices[p]];
        if (kk >= 0) {
          pos_out[c] = base + kk;
          val_out[c] = data[p];
          ++c;
        }
      }
    }
    for (int64_t j = c0; j < c1; ++j) colmap[cols[j]] = -1;
  }
  return c;
}

int64_t csr_gather_coo_many_c128(const int64_t *indptr, const int64_t *indices,
                                 const std::complex<double> *data,
                                 const int64_t *rows, const int64_t *row_ptr,
                                 const int64_t *cols, const int64_t *col_ptr,
                                 int64_t nblocks, int64_t *colmap,
                                 const int64_t *out_off, const int64_t *out_stride,
                                 int64_t *pos_out, std::complex<double> *val_out) {
  int64_t c = 0;
  for (int64_t k = 0; k < nblocks; ++k) {
    const int64_t c0 = col_ptr[k], c1 = col_ptr[k + 1];
    const int64_t r0 = row_ptr[k], r1 = row_ptr[k + 1];
    for (int64_t j = c0; j < c1; ++j) colmap[cols[j]] = j - c0;
    for (int64_t i = r0; i < r1; ++i) {
      const int64_t r = rows[i];
      const int64_t base = out_off[k] + (i - r0) * out_stride[k];
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        const int64_t kk = colmap[indices[p]];
        if (kk >= 0) {
          pos_out[c] = base + kk;
          val_out[c] = data[p];
          ++c;
        }
      }
    }
    for (int64_t j = c0; j < c1; ++j) colmap[cols[j]] = -1;
  }
  return c;
}

// Pooled-spec COO variant: block k's row/col index vectors are segments of one
// shared index pool (pool[rs[k] : rs[k]+rl[k]] and pool[cs[k] : cs[k]+cl[k]]).
// The planner assembles the segment table with vectorized numpy instead of
// accumulating ~100k small Python arrays (which dominated symbolic time at scale).
int64_t csr_gather_coo_pooled_f64(const int64_t *indptr, const int64_t *indices,
                                  const double *data, const int64_t *pool,
                                  const int64_t *rs, const int64_t *rl,
                                  const int64_t *cs, const int64_t *cl,
                                  const int64_t *out_off, const int64_t *out_stride,
                                  int64_t nblocks, int64_t *colmap,
                                  int64_t *pos_out, double *val_out) {
  int64_t c = 0;
  for (int64_t k = 0; k < nblocks; ++k) {
    const int64_t *cols = pool + cs[k];
    const int64_t ncols = cl[k];
    if (ncols == 0 || rl[k] == 0) continue;
    for (int64_t j = 0; j < ncols; ++j) colmap[cols[j]] = j;
    const int64_t *rows = pool + rs[k];
    for (int64_t i = 0; i < rl[k]; ++i) {
      const int64_t r = rows[i];
      const int64_t base = out_off[k] + i * out_stride[k];
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        const int64_t kk = colmap[indices[p]];
        if (kk >= 0) {
          pos_out[c] = base + kk;
          val_out[c] = data[p];
          ++c;
        }
      }
    }
    for (int64_t j = 0; j < ncols; ++j) colmap[cols[j]] = -1;
  }
  return c;
}

int64_t csr_gather_coo_pooled_c128(const int64_t *indptr, const int64_t *indices,
                                   const std::complex<double> *data,
                                   const int64_t *pool, const int64_t *rs,
                                   const int64_t *rl, const int64_t *cs,
                                   const int64_t *cl, const int64_t *out_off,
                                   const int64_t *out_stride, int64_t nblocks,
                                   int64_t *colmap, int64_t *pos_out,
                                   std::complex<double> *val_out) {
  int64_t c = 0;
  for (int64_t k = 0; k < nblocks; ++k) {
    const int64_t *cols = pool + cs[k];
    const int64_t ncols = cl[k];
    if (ncols == 0 || rl[k] == 0) continue;
    for (int64_t j = 0; j < ncols; ++j) colmap[cols[j]] = j;
    const int64_t *rows = pool + rs[k];
    for (int64_t i = 0; i < rl[k]; ++i) {
      const int64_t r = rows[i];
      const int64_t base = out_off[k] + i * out_stride[k];
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        const int64_t kk = colmap[indices[p]];
        if (kk >= 0) {
          pos_out[c] = base + kk;
          val_out[c] = data[p];
          ++c;
        }
      }
    }
    for (int64_t j = 0; j < ncols; ++j) colmap[cols[j]] = -1;
  }
  return c;
}

}  // extern "C" (templates below need C++ linkage)

// Symmetric CSR permutation: out = A[perm][:, perm] with UNSORTED column order
// inside each row (every downstream consumer - the colmap gathers here and the
// ELL conversion - is column-order agnostic; scipy's two-pass fancy indexing with
// per-row sorting cost ~15ms at N=262k).  perm maps new id -> old id; relabel is
// its inverse (old -> new).  out_indptr must have n+1 entries.
template <typename T>
static void csr_permute_impl(const int64_t *indptr, const int64_t *indices,
                             const T *data, int64_t n, const int64_t *perm,
                             const int64_t *relabel, int64_t *out_indptr,
                             int64_t *out_indices, T *out_data) {
  out_indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r = perm[i];
    out_indptr[i + 1] = out_indptr[i] + (indptr[r + 1] - indptr[r]);
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r = perm[i];
    int64_t q = out_indptr[i];
    for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p, ++q) {
      out_indices[q] = relabel[indices[p]];
      out_data[q] = data[p];
    }
  }
}

extern "C" {

void csr_permute_f64(const int64_t *indptr, const int64_t *indices,
                     const double *data, int64_t n, const int64_t *perm,
                     const int64_t *relabel, int64_t *out_indptr,
                     int64_t *out_indices, double *out_data) {
  csr_permute_impl(indptr, indices, data, n, perm, relabel, out_indptr,
                   out_indices, out_data);
}

void csr_permute_c128(const int64_t *indptr, const int64_t *indices,
                      const std::complex<double> *data, int64_t n,
                      const int64_t *perm, const int64_t *relabel,
                      int64_t *out_indptr, int64_t *out_indices,
                      std::complex<double> *out_data) {
  csr_permute_impl(indptr, indices, data, n, perm, relabel, out_indptr,
                   out_indices, out_data);
}

// Post-order DFS over a flat binary tree (children before parents, left before
// right) - the symbolic phase's tree walk (nesteddissection.jl:73-79).  stack is
// an int64 workspace of >= 2*n entries; returns the number of nodes visited.
int64_t tree_postorder(const int64_t *left, const int64_t *right, int64_t root,
                       int64_t n, int64_t *stack, int64_t *out) {
  int64_t sp = 0, c = 0;
  // entries encode (node << 1) | expanded
  stack[sp++] = root << 1;
  while (sp > 0) {
    const int64_t e = stack[--sp];
    const int64_t node = e >> 1;
    if (e & 1) {
      out[c++] = node;
      continue;
    }
    stack[sp++] = (node << 1) | 1;
    if (right[node] >= 0) stack[sp++] = right[node] << 1;
    if (left[node] >= 0) stack[sp++] = left[node] << 1;
  }
  return c;
}

}  // extern "C"

// Fused per-node front gather: ONE pass over each front row's nonzeros, with a
// column map tagged by child ownership.  Replaces the 4 (leaf) / 8 (branch)
// per-node block passes of the pooled COO gather - the planner's schedule hot
// loop.  Per node: segments seg_ptr[b]..seg_ptr[b+1] of (pool offset, length,
// child tag, front offset); an entry (r, c) is emitted at
// node_base[b] + front_row(r) * m_pad + front_col(c) iff both are mapped and
// (row tag == 0 or tags differ) - leaves keep everything (tag 0), branches only
// cross-child couplings (factorization.jl:115-123).
template <typename T>
static int64_t csr_gather_front_impl(
    const int64_t *indptr, const int64_t *indices, const T *data,
    const int64_t *pool, const int64_t *seg_ptr, const int64_t *seg_off,
    const int64_t *seg_len, const int64_t *seg_tag, const int64_t *seg_fo,
    const int64_t *node_base, int64_t nnodes, int64_t m_pad, int64_t *colmap,
    int64_t *coltag, int64_t *pos_out, T *val_out) {
  int64_t c = 0;
  for (int64_t b = 0; b < nnodes; ++b) {
    const int64_t s0 = seg_ptr[b], s1 = seg_ptr[b + 1];
    for (int64_t s = s0; s < s1; ++s) {
      const int64_t *cols = pool + seg_off[s];
      for (int64_t j = 0; j < seg_len[s]; ++j) {
        colmap[cols[j]] = seg_fo[s] + j;
        coltag[cols[j]] = seg_tag[s];
      }
    }
    for (int64_t s = s0; s < s1; ++s) {
      const int64_t *rows = pool + seg_off[s];
      const int64_t rtag = seg_tag[s];
      for (int64_t i = 0; i < seg_len[s]; ++i) {
        const int64_t r = rows[i];
        const int64_t base = node_base[b] + (seg_fo[s] + i) * m_pad;
        for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
          const int64_t col = indices[p];
          const int64_t k = colmap[col];
          if (k >= 0 && (rtag == 0 || coltag[col] != rtag)) {
            pos_out[c] = base + k;
            val_out[c] = data[p];
            ++c;
          }
        }
      }
    }
    for (int64_t s = s0; s < s1; ++s) {
      const int64_t *cols = pool + seg_off[s];
      for (int64_t j = 0; j < seg_len[s]; ++j) colmap[cols[j]] = -1;
    }
  }
  return c;
}

// Variant fused with the identity-padding fill and int32 positions: the planner's
// per-batch epilogue (fill_ident_pos + concatenate + astype(int32)) made three more
// passes over the multi-100k-entry COO buffers; here the identity entries for the
// padded pivot rows ([ni[b], ni_pad) of real fronts, all of [0, ni_pad) for the
// B - nnodes dummy fronts) are appended in the same sweep and positions are written
// int32 directly (caller guarantees B * m_pad^2 < 2^31).
template <typename T>
static int64_t csr_gather_front_ident_impl(
    const int64_t *indptr, const int64_t *indices, const T *data,
    const int64_t *pool, const int64_t *seg_ptr, const int64_t *seg_off,
    const int64_t *seg_len, const int64_t *seg_tag, const int64_t *seg_fo,
    const int64_t *node_base, int64_t nnodes, int64_t m_pad, int64_t *colmap,
    int64_t *coltag, const int64_t *ni, int64_t B, int64_t ni_pad,
    int32_t *pos_out, T *val_out) {
  int64_t c = 0;
  for (int64_t b = 0; b < nnodes; ++b) {
    const int64_t s0 = seg_ptr[b], s1 = seg_ptr[b + 1];
    for (int64_t s = s0; s < s1; ++s) {
      const int64_t *cols = pool + seg_off[s];
      for (int64_t j = 0; j < seg_len[s]; ++j) {
        colmap[cols[j]] = seg_fo[s] + j;
        coltag[cols[j]] = seg_tag[s];
      }
    }
    for (int64_t s = s0; s < s1; ++s) {
      const int64_t *rows = pool + seg_off[s];
      const int64_t rtag = seg_tag[s];
      for (int64_t i = 0; i < seg_len[s]; ++i) {
        const int64_t r = rows[i];
        const int64_t base = node_base[b] + (seg_fo[s] + i) * m_pad;
        for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
          const int64_t col = indices[p];
          const int64_t k = colmap[col];
          if (k >= 0 && (rtag == 0 || coltag[col] != rtag)) {
            pos_out[c] = (int32_t)(base + k);
            val_out[c] = data[p];
            ++c;
          }
        }
      }
    }
    for (int64_t s = s0; s < s1; ++s) {
      const int64_t *cols = pool + seg_off[s];
      for (int64_t j = 0; j < seg_len[s]; ++j) colmap[cols[j]] = -1;
    }
  }
  const int64_t mm = m_pad * m_pad;
  for (int64_t b = 0; b < nnodes; ++b)
    for (int64_t j = ni[b]; j < ni_pad; ++j) {
      pos_out[c] = (int32_t)(b * mm + j * (m_pad + 1));
      val_out[c] = T(1.0);
      ++c;
    }
  for (int64_t b = nnodes; b < B; ++b)
    for (int64_t j = 0; j < ni_pad; ++j) {
      pos_out[c] = (int32_t)(b * mm + j * (m_pad + 1));
      val_out[c] = T(1.0);
      ++c;
    }
  return c;
}

extern "C" {

int64_t csr_gather_front_ident_f64(
    const int64_t *indptr, const int64_t *indices, const double *data,
    const int64_t *pool, const int64_t *seg_ptr, const int64_t *seg_off,
    const int64_t *seg_len, const int64_t *seg_tag, const int64_t *seg_fo,
    const int64_t *node_base, int64_t nnodes, int64_t m_pad, int64_t *colmap,
    int64_t *coltag, const int64_t *ni, int64_t B, int64_t ni_pad,
    int32_t *pos_out, double *val_out) {
  return csr_gather_front_ident_impl(indptr, indices, data, pool, seg_ptr,
                                     seg_off, seg_len, seg_tag, seg_fo,
                                     node_base, nnodes, m_pad, colmap, coltag,
                                     ni, B, ni_pad, pos_out, val_out);
}

int64_t csr_gather_front_ident_c128(
    const int64_t *indptr, const int64_t *indices,
    const std::complex<double> *data, const int64_t *pool,
    const int64_t *seg_ptr, const int64_t *seg_off, const int64_t *seg_len,
    const int64_t *seg_tag, const int64_t *seg_fo, const int64_t *node_base,
    int64_t nnodes, int64_t m_pad, int64_t *colmap, int64_t *coltag,
    const int64_t *ni, int64_t B, int64_t ni_pad, int32_t *pos_out,
    std::complex<double> *val_out) {
  return csr_gather_front_ident_impl(indptr, indices, data, pool, seg_ptr,
                                     seg_off, seg_len, seg_tag, seg_fo,
                                     node_base, nnodes, m_pad, colmap, coltag,
                                     ni, B, ni_pad, pos_out, val_out);
}

int64_t csr_gather_front_f64(const int64_t *indptr, const int64_t *indices,
                             const double *data, const int64_t *pool,
                             const int64_t *seg_ptr, const int64_t *seg_off,
                             const int64_t *seg_len, const int64_t *seg_tag,
                             const int64_t *seg_fo, const int64_t *node_base,
                             int64_t nnodes, int64_t m_pad, int64_t *colmap,
                             int64_t *coltag, int64_t *pos_out, double *val_out) {
  return csr_gather_front_impl(indptr, indices, data, pool, seg_ptr, seg_off,
                               seg_len, seg_tag, seg_fo, node_base, nnodes, m_pad,
                               colmap, coltag, pos_out, val_out);
}

int64_t csr_gather_front_c128(const int64_t *indptr, const int64_t *indices,
                              const std::complex<double> *data,
                              const int64_t *pool, const int64_t *seg_ptr,
                              const int64_t *seg_off, const int64_t *seg_len,
                              const int64_t *seg_tag, const int64_t *seg_fo,
                              const int64_t *node_base, int64_t nnodes,
                              int64_t m_pad, int64_t *colmap, int64_t *coltag,
                              int64_t *pos_out, std::complex<double> *val_out) {
  return csr_gather_front_impl(indptr, indices, data, pool, seg_ptr, seg_off,
                               seg_len, seg_tag, seg_fo, node_base, nnodes, m_pad,
                               colmap, coltag, pos_out, val_out);
}

// Pooled symbolic factorization (the C++ replacement for the per-node numpy
// symfact, parity with symfact!, nesteddissection.jl:29-69).  Every node's final
// index sets are emitted CONTIGUOUSLY into two pools:
//   vals_pool[vals_off[i] : +n_int[i]+n_bnd[i]]  = [int_idx(i); bnd_idx(i)]
//   loc_pool [loc_off[i]  : +m_i]                = [int_loc(i); bnd_loc(i)]
// (m_i = len(bnd(i)) for non-roots; the root's loc segment is the identity of
// length len(bnd(root))).  Contiguous [int; bnd] order is exactly the planner's
// front layout, so the scheduler indexes the pools directly instead of
// re-concatenating ~2n small arrays per plan.  A DOF of a child's boundary is in
// the parent's int iff its eliminating node (from the INPUT int sets, which
// partition the DOFs) is the parent.
//
// order: postorder node walk (children first).  in_iptr/in_ipool, in_bptr/in_bpool:
// CSR layout of the input tree's int/bnd sets.  elim: int64 workspace of size
// >= ndofs.  Outputs must be preallocated: vals_pool (sum of all int+bnd lens,
// leaves included), vals_off/n_int/n_bnd [n], loc_pool (sum of all bnd lens +
// root bnd), loc_off/loc_icnt [n].
// Returns 0 on success, -1 if a pool capacity would be exceeded (malformed tree:
// the caller sizes the pools from the input sets, which a valid tree preserves).
int64_t symfact_pooled(const int64_t *left, const int64_t *right, int64_t root,
                       int64_t n, const int64_t *order, const int64_t *in_iptr,
                       const int64_t *in_ipool, const int64_t *in_bptr,
                       const int64_t *in_bpool, int64_t ndofs, int64_t *elim,
                       int64_t vals_cap, int64_t *vals_pool, int64_t *vals_off,
                       int64_t *n_int, int64_t *n_bnd, int64_t loc_cap,
                       int64_t *loc_pool, int64_t *loc_off, int64_t *loc_icnt) {
  for (int64_t d = 0; d < ndofs; ++d) elim[d] = -1;
  for (int64_t i = 0; i < n; ++i)
    for (int64_t p = in_iptr[i]; p < in_iptr[i + 1]; ++p) elim[in_ipool[p]] = i;

  int64_t vc = 0, lc = 0;  // pool cursors
  for (int64_t t = 0; t < n; ++t) {
    const int64_t i = order[t];
    const int64_t l = left[i], r = right[i];
    vals_off[i] = vc;
    if (l < 0) {  // leaf: copy input sets verbatim
      const int64_t ni = in_iptr[i + 1] - in_iptr[i];
      const int64_t nb = in_bptr[i + 1] - in_bptr[i];
      if (vc + ni + nb > vals_cap) return -1;
      for (int64_t p = 0; p < ni; ++p) vals_pool[vc + p] = in_ipool[in_iptr[i] + p];
      for (int64_t p = 0; p < nb; ++p)
        vals_pool[vc + ni + p] = in_bpool[in_bptr[i] + p];
      n_int[i] = ni;
      n_bnd[i] = nb;
      vc += ni + nb;
      continue;
    }
    // branch: partition each child's CURRENT bnd (already in vals_pool) by
    // elim[dof] == i, emitting child loc segments and the parent's new sets
    int64_t icnt_total = 0;
    const int64_t kids[2] = {l, r};
    if (vc + n_bnd[l] + n_bnd[r] > vals_cap ||
        lc + n_bnd[l] + n_bnd[r] > loc_cap)
      return -1;
    for (int k = 0; k < 2; ++k) {
      const int64_t c = kids[k];
      const int64_t *src = vals_pool + vals_off[c] + n_int[c];
      const int64_t m = n_bnd[c];
      loc_off[c] = lc;
      int64_t ic = 0;
      for (int64_t j = 0; j < m; ++j)
        if (elim[src[j]] == i) loc_pool[lc + ic++] = j;
      int64_t bc = ic;
      for (int64_t j = 0; j < m; ++j)
        if (elim[src[j]] != i) loc_pool[lc + bc++] = j;
      loc_icnt[c] = ic;
      icnt_total += ic;
      lc += m;
    }
    // parent values: [ivals_l; ivals_r; bvals_l; bvals_r]
    int64_t pi = vc, pb = vc + icnt_total;
    for (int k = 0; k < 2; ++k) {
      const int64_t c = kids[k];
      const int64_t *src = vals_pool + vals_off[c] + n_int[c];
      const int64_t *locs = loc_pool + loc_off[c];
      const int64_t m = n_bnd[c], ic = loc_icnt[c];
      for (int64_t j = 0; j < ic; ++j) vals_pool[pi++] = src[locs[j]];
      for (int64_t j = ic; j < m; ++j) vals_pool[pb++] = src[locs[j]];
    }
    n_int[i] = icnt_total;
    n_bnd[i] = pb - vc - icnt_total;
    vc = pb;
  }
  // root loc: identity over its bnd (nesteddissection.jl:31-32)
  const int64_t mr = n_bnd[root];
  if (lc + mr > loc_cap) return -1;
  loc_off[root] = lc;
  loc_icnt[root] = mr;
  for (int64_t j = 0; j < mr; ++j) loc_pool[lc + j] = j;
  return 0;
}

// Batched schedule-map fills for one planner batch (rows [0, B0) of the int32
// device maps; the caller handles sharding-padding dummy rows, which are rare).
// Replaces ~20 [B, m_pad]-class numpy broadcast/where passes per batch with one
// cache-friendly sweep.  pool/locpool are the pooled symfact outputs; per node b:
//   int_ids[b]  = [pool[o_int[b] : +ni[b]]; N-pad]
//   bnd_ids[b]  = [pool[o_bnd[b] : +nb[b]]; N-pad]
//   sperm[b]    = [locpool[lo[b] : +lsum[b]]; identity-pad]
//   map_l/map_r = inverse extend-add maps (front position -> child-S index, -1
//                 outside; children are the two contiguous [int; bnd] runs)
// map_l/map_r/ni1..nb2 may be null (leaf batches).
void fill_batch_maps(const int64_t *pool, const int64_t *o_int,
                     const int64_t *o_bnd, const int64_t *ni, const int64_t *nb,
                     const int64_t *locpool, const int64_t *lo,
                     const int64_t *lsum, const int64_t *ni1, const int64_t *ni2,
                     const int64_t *nb1, const int64_t *nb2, int64_t B0,
                     int64_t ni_pad, int64_t nb_pad, int64_t N,
                     int32_t *int_ids, int32_t *bnd_ids, int32_t *sperm,
                     int32_t *map_l, int32_t *map_r) {
  const int64_t m_pad = ni_pad + nb_pad;
  for (int64_t b = 0; b < B0; ++b) {
    int32_t *ir = int_ids + b * ni_pad;
    const int64_t *ip = pool + o_int[b];
    for (int64_t j = 0; j < ni[b]; ++j) ir[j] = (int32_t)ip[j];
    for (int64_t j = ni[b]; j < ni_pad; ++j) ir[j] = (int32_t)N;
    if (nb_pad) {
      int32_t *br = bnd_ids + b * nb_pad;
      const int64_t *bp = pool + o_bnd[b];
      for (int64_t j = 0; j < nb[b]; ++j) br[j] = (int32_t)bp[j];
      for (int64_t j = nb[b]; j < nb_pad; ++j) br[j] = (int32_t)N;
      int32_t *sr = sperm + b * nb_pad;
      const int64_t *lp = locpool + lo[b];
      for (int64_t j = 0; j < lsum[b]; ++j) sr[j] = (int32_t)lp[j];
      for (int64_t j = lsum[b]; j < nb_pad; ++j) sr[j] = (int32_t)j;
    }
    if (map_l) {
      int32_t *ml = map_l + b * m_pad;
      int32_t *mr = map_r + b * m_pad;
      const int64_t a1 = ni1[b], a2 = ni2[b], b1 = nb1[b], b2 = nb2[b];
      for (int64_t j = 0; j < m_pad; ++j) ml[j] = -1;
      for (int64_t j = 0; j < m_pad; ++j) mr[j] = -1;
      for (int64_t j = 0; j < a1; ++j) ml[j] = (int32_t)j;
      for (int64_t j = 0; j < a2; ++j) mr[a1 + j] = (int32_t)j;
      for (int64_t j = 0; j < b1; ++j) ml[ni_pad + j] = (int32_t)(a1 + j);
      for (int64_t j = 0; j < b2; ++j) mr[ni_pad + b1 + j] = (int32_t)(a2 + j);
    }
  }
}

// Identity-diagonal positions for the padded pivot rows ([ni[b], ni_pad) of every
// real front, all of [0, ni_pad) for dummy fronts) - appended to the front COO so
// the batched LU stays well-defined on padding.  Returns the count written.
int64_t fill_ident_pos(const int64_t *ni, int64_t B0, int64_t B, int64_t ni_pad,
                       int64_t m_pad, int64_t *out) {
  int64_t c = 0;
  const int64_t mm = m_pad * m_pad;
  for (int64_t b = 0; b < B0; ++b)
    for (int64_t j = ni[b]; j < ni_pad; ++j) out[c++] = b * mm + j * (m_pad + 1);
  for (int64_t b = B0; b < B; ++b)
    for (int64_t j = 0; j < ni_pad; ++j) out[c++] = b * mm + j * (m_pad + 1);
  return c;
}

}  // extern "C" (template below needs C++ linkage)

// Consolidated regular-batch planner kernel: per node, build the segment table
// (leaf: [int; bnd], branch: child-split 4-segment layout), run the fused front
// COO gather with child-tagged masking + identity padding (int32 positions),
// and fill every int32 device map - int_ids/bnd_ids/sperm/map_l/map_r - in the
// SAME sweep.  One ctypes crossing per batch instead of three, and no Python
// seg-table assembly (each crossing + numpy pass cost ~0.1-0.2ms per plan).
template <typename T>
static int64_t plan_batch_impl(
    const int64_t *indptr, const int64_t *indices, const T *data,
    const int64_t *pool, const int64_t *o_int, const int64_t *o_bnd,
    const int64_t *ni, const int64_t *nb, const int64_t *ni1,
    const int64_t *ni2, const int64_t *nb1, const int64_t *nb2,
    const int64_t *locpool, const int64_t *lo, const int64_t *lsum,
    int64_t B0, int64_t B, int64_t ni_pad, int64_t nb_pad, int64_t N,
    int64_t *colmap, int64_t *coltag, int32_t *pos_out, T *val_out,
    int32_t *int_ids, int32_t *bnd_ids, int32_t *sperm, int32_t *map_l,
    int32_t *map_r, int32_t *src_out = nullptr) {
  // src_out (optional): per-entry source index into the CSR data array (-1 for
  // the identity-padding entries), so the factorization can re-gather the
  // front values from a DEVICE-resident copy of A instead of shipping them
  // over the host link on every (re-)factorization.
  const int64_t m_pad = ni_pad + nb_pad;
  const int64_t mm = m_pad * m_pad;
  int64_t c = 0;
  for (int64_t b = 0; b < B0; ++b) {
    int64_t so[4], slen[4], stag[4], sfo[4];
    int ns;
    if (!ni1) {
      ns = 2;
      so[0] = o_int[b]; slen[0] = ni[b]; stag[0] = 0; sfo[0] = 0;
      so[1] = o_bnd[b]; slen[1] = nb[b]; stag[1] = 0; sfo[1] = ni_pad;
    } else {
      ns = 4;
      so[0] = o_int[b];          slen[0] = ni1[b]; stag[0] = 1; sfo[0] = 0;
      so[1] = o_int[b] + ni1[b]; slen[1] = ni2[b]; stag[1] = 2; sfo[1] = ni1[b];
      so[2] = o_bnd[b];          slen[2] = nb1[b]; stag[2] = 1; sfo[2] = ni_pad;
      so[3] = o_bnd[b] + nb1[b]; slen[3] = nb2[b]; stag[3] = 2;
      sfo[3] = ni_pad + nb1[b];
    }
    for (int s = 0; s < ns; ++s) {
      const int64_t *cols = pool + so[s];
      for (int64_t j = 0; j < slen[s]; ++j) {
        colmap[cols[j]] = sfo[s] + j;
        coltag[cols[j]] = stag[s];
      }
    }
    const int64_t base = b * mm;
    for (int s = 0; s < ns; ++s) {
      const int64_t *rows = pool + so[s];
      const int64_t rtag = stag[s];
      for (int64_t i = 0; i < slen[s]; ++i) {
        const int64_t r = rows[i];
        const int64_t rb = base + (sfo[s] + i) * m_pad;
        for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
          const int64_t col = indices[p];
          const int64_t k = colmap[col];
          if (k >= 0 && (rtag == 0 || coltag[col] != rtag)) {
            pos_out[c] = (int32_t)(rb + k);
            val_out[c] = data[p];
            if (src_out) src_out[c] = (int32_t)p;
            ++c;
          }
        }
      }
    }
    for (int s = 0; s < ns; ++s) {
      const int64_t *cols = pool + so[s];
      for (int64_t j = 0; j < slen[s]; ++j) colmap[cols[j]] = -1;
    }
    for (int64_t j = ni[b]; j < ni_pad; ++j) {
      pos_out[c] = (int32_t)(base + j * (m_pad + 1));
      val_out[c] = T(1.0);
      if (src_out) src_out[c] = -1;
      ++c;
    }
    // device maps (fill_batch_maps body, fused into the same node sweep)
    int32_t *ir = int_ids + b * ni_pad;
    const int64_t *ip = pool + o_int[b];
    for (int64_t j = 0; j < ni[b]; ++j) ir[j] = (int32_t)ip[j];
    for (int64_t j = ni[b]; j < ni_pad; ++j) ir[j] = (int32_t)N;
    if (nb_pad) {
      int32_t *br = bnd_ids + b * nb_pad;
      const int64_t *bp = pool + o_bnd[b];
      for (int64_t j = 0; j < nb[b]; ++j) br[j] = (int32_t)bp[j];
      for (int64_t j = nb[b]; j < nb_pad; ++j) br[j] = (int32_t)N;
      int32_t *sr = sperm + b * nb_pad;
      const int64_t *lp = locpool + lo[b];
      for (int64_t j = 0; j < lsum[b]; ++j) sr[j] = (int32_t)lp[j];
      for (int64_t j = lsum[b]; j < nb_pad; ++j) sr[j] = (int32_t)j;
    }
    if (map_l) {
      int32_t *ml = map_l + b * m_pad;
      int32_t *mr = map_r + b * m_pad;
      const int64_t a1 = ni1[b], a2 = ni2[b], c1 = nb1[b], c2 = nb2[b];
      for (int64_t j = 0; j < m_pad; ++j) ml[j] = -1;
      for (int64_t j = 0; j < m_pad; ++j) mr[j] = -1;
      for (int64_t j = 0; j < a1; ++j) ml[j] = (int32_t)j;
      for (int64_t j = 0; j < a2; ++j) mr[a1 + j] = (int32_t)j;
      for (int64_t j = 0; j < c1; ++j) ml[ni_pad + j] = (int32_t)(a1 + j);
      for (int64_t j = 0; j < c2; ++j) mr[ni_pad + c1 + j] = (int32_t)(a2 + j);
    }
  }
  for (int64_t b = B0; b < B; ++b) {   // dummy (sharding-padding) fronts
    const int64_t base = b * mm;
    for (int64_t j = 0; j < ni_pad; ++j) {
      pos_out[c] = (int32_t)(base + j * (m_pad + 1));
      val_out[c] = T(1.0);
      if (src_out) src_out[c] = -1;
      ++c;
    }
  }
  return c;
}

// Whole-plan consolidation: run plan_batch_impl for every regular batch of a
// factorization plan in ONE ctypes crossing.  Per-node metadata arrives as
// flat arrays concatenated in batch order (node_off gives each batch's start);
// per-batch scalars in `meta` (stride 6: node_off, B0, B, ni_pad, nb_pad,
// is_branch); COO output goes to one shared [pos|val] workspace segmented by
// pos_off; the int32 map outputs are caller-allocated, their raw pointers in
// the uint64 table `outp` (stride 5: int_ids, bnd_ids, sperm, map_l, map_r;
// map entries 0 for leaf batches).  Emits each batch's COO count in `counts`.
// Batches are independent (disjoint output regions), so they are round-robin
// partitioned across a small thread pool; each extra worker gets its own
// colmap/coltag scratch (the shared ones serve worker 0).
template <typename T>
static void plan_batches_range(
    const int64_t *indptr, const int64_t *indices, const T *data,
    const int64_t *pool, const int64_t *locpool, int64_t nbatch,
    const int64_t *meta, const int64_t *o_int, const int64_t *o_bnd,
    const int64_t *ni, const int64_t *nb, const int64_t *ni1,
    const int64_t *ni2, const int64_t *nb1, const int64_t *nb2,
    const int64_t *lo, const int64_t *lsum, int64_t N, int64_t *colmap,
    int64_t *coltag, const int64_t *pos_off, int32_t *pos_base, T *val_base,
    int32_t *src_base, const uint64_t *outp, int64_t *counts, int64_t b0,
    int64_t step) {
  for (int64_t b = b0; b < nbatch; b += step) {
    const int64_t no = meta[b * 6 + 0];
    const int64_t B0 = meta[b * 6 + 1];
    const int64_t B = meta[b * 6 + 2];
    const int64_t ni_pad = meta[b * 6 + 3];
    const int64_t nb_pad = meta[b * 6 + 4];
    const bool is_branch = meta[b * 6 + 5] != 0;
    const uint64_t *op = outp + b * 5;
    counts[b] = plan_batch_impl<T>(
        indptr, indices, data, pool, o_int + no, o_bnd + no, ni + no, nb + no,
        is_branch ? ni1 + no : nullptr, is_branch ? ni2 + no : nullptr,
        is_branch ? nb1 + no : nullptr, is_branch ? nb2 + no : nullptr,
        locpool, lo + no, lsum + no, B0, B, ni_pad, nb_pad, N, colmap, coltag,
        pos_base + pos_off[b], val_base + pos_off[b], (int32_t *)op[0],
        (int32_t *)op[1], (int32_t *)op[2], (int32_t *)op[3], (int32_t *)op[4],
        src_base ? src_base + pos_off[b] : nullptr);
  }
}

template <typename T>
static void plan_batches_all_impl(
    const int64_t *indptr, const int64_t *indices, const T *data,
    const int64_t *pool, const int64_t *locpool, int64_t nbatch,
    const int64_t *meta, const int64_t *o_int, const int64_t *o_bnd,
    const int64_t *ni, const int64_t *nb, const int64_t *ni1,
    const int64_t *ni2, const int64_t *nb1, const int64_t *nb2,
    const int64_t *lo, const int64_t *lsum, int64_t N, int64_t *colmap,
    int64_t *coltag, const int64_t *pos_off, int32_t *pos_base, T *val_base,
    int32_t *src_base, const uint64_t *outp, int64_t *counts) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nw = (int64_t)(hw ? hw : 1);
  if (nw > nbatch) nw = nbatch;
  if (nw > 4) nw = 4;
  if (nw <= 1) {
    plan_batches_range(indptr, indices, data, pool, locpool, nbatch, meta,
                       o_int, o_bnd, ni, nb, ni1, ni2, nb1, nb2, lo, lsum, N,
                       colmap, coltag, pos_off, pos_base, val_base, src_base,
                       outp, counts, 0, 1);
    return;
  }
  std::vector<std::vector<int64_t>> scratch(2 * (nw - 1));
  std::vector<std::thread> workers;
  int64_t spawned = 0;
  // thread/scratch creation can throw (resource limits); this is an extern-C
  // entry point, so an escaping exception would std::terminate the whole
  // process - degrade to running the unspawned strides on the calling thread
  try {
    for (int64_t w = 1; w < nw; ++w) {
      std::vector<int64_t> &cm = scratch[2 * (w - 1)];
      std::vector<int64_t> &ct = scratch[2 * (w - 1) + 1];
      cm.assign((size_t)N, -1);
      ct.assign((size_t)N, 0);
      workers.emplace_back(plan_batches_range<T>, indptr, indices, data, pool,
                           locpool, nbatch, meta, o_int, o_bnd, ni, nb, ni1,
                           ni2, nb1, nb2, lo, lsum, N, cm.data(), ct.data(),
                           pos_off, pos_base, val_base, src_base, outp, counts,
                           w, nw);
      spawned = w;
    }
  } catch (...) {
  }
  plan_batches_range(indptr, indices, data, pool, locpool, nbatch, meta,
                     o_int, o_bnd, ni, nb, ni1, ni2, nb1, nb2, lo, lsum, N,
                     colmap, coltag, pos_off, pos_base, val_base, src_base,
                     outp, counts, 0, nw);
  // strides whose worker never spawned run here (colmap entries are reset at
  // the end of every batch, so reusing the main scratch sequentially is safe)
  for (int64_t w = spawned + 1; w < nw; ++w)
    plan_batches_range(indptr, indices, data, pool, locpool, nbatch, meta,
                       o_int, o_bnd, ni, nb, ni1, ni2, nb1, nb2, lo, lsum, N,
                       colmap, coltag, pos_off, pos_base, val_base, src_base,
                       outp, counts, w, nw);
  for (auto &t : workers) t.join();
}

extern "C" {

void plan_batches_all_f64(
    const int64_t *indptr, const int64_t *indices, const double *data,
    const int64_t *pool, const int64_t *locpool, int64_t nbatch,
    const int64_t *meta, const int64_t *o_int, const int64_t *o_bnd,
    const int64_t *ni, const int64_t *nb, const int64_t *ni1,
    const int64_t *ni2, const int64_t *nb1, const int64_t *nb2,
    const int64_t *lo, const int64_t *lsum, int64_t N, int64_t *colmap,
    int64_t *coltag, const int64_t *pos_off, int32_t *pos_base,
    double *val_base, int32_t *src_base, const uint64_t *outp,
    int64_t *counts) {
  plan_batches_all_impl(indptr, indices, data, pool, locpool, nbatch, meta,
                        o_int, o_bnd, ni, nb, ni1, ni2, nb1, nb2, lo, lsum, N,
                        colmap, coltag, pos_off, pos_base, val_base, src_base,
                        outp, counts);
}

void plan_batches_all_c128(
    const int64_t *indptr, const int64_t *indices,
    const std::complex<double> *data, const int64_t *pool,
    const int64_t *locpool, int64_t nbatch, const int64_t *meta,
    const int64_t *o_int, const int64_t *o_bnd, const int64_t *ni,
    const int64_t *nb, const int64_t *ni1, const int64_t *ni2,
    const int64_t *nb1, const int64_t *nb2, const int64_t *lo,
    const int64_t *lsum, int64_t N, int64_t *colmap, int64_t *coltag,
    const int64_t *pos_off, int32_t *pos_base, std::complex<double> *val_base,
    int32_t *src_base, const uint64_t *outp, int64_t *counts) {
  plan_batches_all_impl(indptr, indices, data, pool, locpool, nbatch, meta,
                        o_int, o_bnd, ni, nb, ni1, ni2, nb1, nb2, lo, lsum, N,
                        colmap, coltag, pos_off, pos_base, val_base, src_base,
                        outp, counts);
}

int64_t plan_batch_f64(
    const int64_t *indptr, const int64_t *indices, const double *data,
    const int64_t *pool, const int64_t *o_int, const int64_t *o_bnd,
    const int64_t *ni, const int64_t *nb, const int64_t *ni1,
    const int64_t *ni2, const int64_t *nb1, const int64_t *nb2,
    const int64_t *locpool, const int64_t *lo, const int64_t *lsum,
    int64_t B0, int64_t B, int64_t ni_pad, int64_t nb_pad, int64_t N,
    int64_t *colmap, int64_t *coltag, int32_t *pos_out, double *val_out,
    int32_t *int_ids, int32_t *bnd_ids, int32_t *sperm, int32_t *map_l,
    int32_t *map_r) {
  return plan_batch_impl(indptr, indices, data, pool, o_int, o_bnd, ni, nb,
                         ni1, ni2, nb1, nb2, locpool, lo, lsum, B0, B, ni_pad,
                         nb_pad, N, colmap, coltag, pos_out, val_out, int_ids,
                         bnd_ids, sperm, map_l, map_r);
}

int64_t plan_batch_c128(
    const int64_t *indptr, const int64_t *indices,
    const std::complex<double> *data, const int64_t *pool,
    const int64_t *o_int, const int64_t *o_bnd, const int64_t *ni,
    const int64_t *nb, const int64_t *ni1, const int64_t *ni2,
    const int64_t *nb1, const int64_t *nb2, const int64_t *locpool,
    const int64_t *lo, const int64_t *lsum, int64_t B0, int64_t B,
    int64_t ni_pad, int64_t nb_pad, int64_t N, int64_t *colmap,
    int64_t *coltag, int32_t *pos_out, std::complex<double> *val_out,
    int32_t *int_ids, int32_t *bnd_ids, int32_t *sperm, int32_t *map_l,
    int32_t *map_r) {
  return plan_batch_impl(indptr, indices, data, pool, o_int, o_bnd, ni, nb,
                         ni1, ni2, nb1, nb2, locpool, lo, lsum, B0, B, ni_pad,
                         nb_pad, N, colmap, coltag, pos_out, val_out, int_ids,
                         bnd_ids, sperm, map_l, map_r);
}

}  // extern "C"

extern "C" {

// Zero the entries of a dense block whose row and column belong to the same child
// (the extend-add same-child mask, factorization.jl:115-123 semantics), fused here
// to avoid a second Python-level pass.
void mask_same_child_f64(double *blk, int64_t n, const int64_t *child) {
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < n; ++j)
      if (child[i] == child[j]) blk[i * n + j] = 0.0;
}

void mask_same_child_c128(std::complex<double> *blk, int64_t n,
                          const int64_t *child) {
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < n; ++j)
      if (child[i] == child[j]) blk[i * n + j] = 0.0;
}

// Structured-batch device maps in one sweep (planner._plan_structured_batch
// hot path): child-aligned int/bnd id fills from the pooled symfact layout
// plus the parent-S HSS-pad -> child-aligned-boundary map (smap).  Rows
// [B0, B) are prefilled by the caller.
void fill_structured_maps(
    const int64_t *pool, const int64_t *locpool, const int64_t *off_n,
    const int64_t *ki1, const int64_t *ki2, const int64_t *kb1,
    const int64_t *kb2, const int64_t *o_l, const int64_t *k1,
    const int64_t *k2, int64_t B0, int64_t h1, int64_t h2, int64_t q1,
    int64_t q2, int64_t np_pad, int64_t half, int64_t N, int32_t *int_ids,
    int32_t *bnd_ids, int32_t *smap) {
  const int64_t hw = h1 + h2, qw = q1 + q2;
  for (int64_t b = 0; b < B0; ++b) {
    int32_t *ii = int_ids + b * hw;
    int32_t *bb = bnd_ids + b * qw;
    int32_t *sm = smap + b * np_pad;
    const int64_t *p = pool + off_n[b];
    const int64_t a1 = ki1[b], a2 = ki2[b], c1 = kb1[b], c2 = kb2[b];
    int64_t j = 0;
    for (; j < a1; ++j) ii[j] = (int32_t)p[j];
    for (; j < h1; ++j) ii[j] = (int32_t)N;
    for (j = 0; j < a2; ++j) ii[h1 + j] = (int32_t)p[a1 + j];
    for (; j < h2; ++j) ii[h1 + j] = (int32_t)N;
    const int64_t *pb = p + a1 + a2;
    for (j = 0; j < c1; ++j) bb[j] = (int32_t)pb[j];
    for (; j < q1; ++j) bb[j] = (int32_t)N;
    for (j = 0; j < c2; ++j) bb[q1 + j] = (int32_t)pb[c1 + j];
    for (; j < q2; ++j) bb[q1 + j] = (int32_t)N;
    for (j = 0; j < np_pad; ++j) sm[j] = (int32_t)qw;
    const int64_t *ls = locpool + o_l[b];
    const int64_t kk1 = k1[b], kk2 = k2[b];
    for (j = 0; j < kk1; ++j) {
      const int64_t ps = ls[j];
      sm[j] = (int32_t)(ps < c1 ? ps : q1 + ps - c1);
    }
    for (j = 0; j < kk2; ++j) {
      const int64_t ps = ls[kk1 + j];
      sm[half + j] = (int32_t)(ps < c1 ? ps : q1 + ps - c1);
    }
  }
}

// Cross-coupling strip construction (planner._coo_to_strip hot path): the
// batched COO stream of one cross block (flat positions into [B, r, c],
// sorted by (b, row, col) - the pooled gather's emission order) is turned
// into the exact skinny factorization A_blk = E @ S.  Pass 1 returns the
// max per-b distinct-row count (caller pads to rcap); pass 2 fills
// rows_idx [B, rcap] (sentinel r on padding) and strip_pos [n].
int64_t strip_nrows(const int64_t *pos, int64_t n, int64_t r, int64_t c) {
  const int64_t rc = r * c;
  int64_t best = 0, cur = 0, prev_key = -1, prev_b = -1;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t b = pos[i] / rc;
    const int64_t key = pos[i] / c;  // b * r + row
    if (b != prev_b) {
      if (cur > best) best = cur;
      cur = 0;
      prev_b = b;
      prev_key = -1;
    }
    if (key != prev_key) {
      ++cur;
      prev_key = key;
    }
  }
  if (cur > best) best = cur;
  return best;
}

void strip_fill(const int64_t *pos, int64_t n, int64_t B, int64_t r,
                int64_t c, int64_t rcap, int32_t *rows_idx,
                int64_t *strip_pos) {
  const int64_t rc = r * c;
  for (int64_t i = 0; i < B * rcap; ++i) rows_idx[i] = (int32_t)r;
  int64_t slot = -1, prev_key = -1, prev_b = -1;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t b = pos[i] / rc;
    const int64_t rem = pos[i] - b * rc;
    const int64_t row = rem / c;
    const int64_t col = rem - row * c;
    if (b != prev_b) {
      slot = -1;
      prev_b = b;
      prev_key = -1;
    }
    const int64_t key = b * r + row;
    if (key != prev_key) {
      ++slot;
      rows_idx[b * rcap + slot] = (int32_t)row;
      prev_key = key;
    }
    strip_pos[i] = (b * rcap + slot) * c + col;
  }
}

}  // extern "C"
