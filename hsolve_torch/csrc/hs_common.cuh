// Shared launch helpers for the hsolve_torch kernels (plain C interface,
// loaded with ctypes by hsolve_torch/kernels/__init__.py).
//
// Every entry point takes raw device pointers and the CUDA stream as void*,
// launches on that stream, allocates nothing and returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HS_EXPORT extern "C" __attribute__((visibility("default")))

// 1-D grid for a grid-stride loop over `work` items; capped so that very large
// inputs loop inside the kernel instead of overflowing the grid.
static inline unsigned hs_blocks(int64_t work, int threads) {
  int64_t b = (work + threads - 1) / threads;
  const int64_t cap = 132 * 64;  // 64 blocks per SM of an H100 is plenty
  if (b > cap) b = cap;
  if (b < 1) b = 1;
  return (unsigned)b;
}
