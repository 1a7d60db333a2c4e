// Value traits of the typed kernels (A-M and the GMRES control): one source
// for real and complex values.
//
// The complex types are stored as torch stores them, interleaved (re, im):
// `hs_c128` (complex128, 16 bytes, 16-byte aligned, the layout of double2)
// and `hs_c64` (complex64, 8 bytes, float2's).  A kernel written for a value
// type T takes from here:
//   - hs_acc_t<T>: the type sums accumulate in where the kernel widens them
//     (kernels C, E, H and K, fault F4's rule): double for float and double,
//     hs_c128 for both complex types; hs_widened<T>: true where that is
//     wider than T (float32 and complex64);
//   - hs_real_t<T>: the real type of T (norms, moduli, cosines, tolerances);
//   - hs_wide(x): x in hs_acc_t; static_cast<T>(acc): rounded back once
//     (each part of a complex value on its own);
//   - hs_ldg (a read-only load), hs_conj, hs_abs2, hs_inv, the warp shuffles
//     hs_shfl / hs_shfl_xor / hs_shfl_down, and hs_atomic_add (two real
//     atomics for a complex value);
//   - the complex operators (+, -, *, unary -, +=, -=, *=), which round as
//     the compiler contracts them: kernels that must match their plain
//     versions bit for bit (M, the control kernels) use the `_rn` forms in
//     arnoldi_givens.cuh instead.
// A kernel's 16-byte vector paths read 16 / sizeof(T) values at a time:
// two doubles, four floats, one complex128 or two complex64 values
// (hs_vec16; hs_load16 / hs_store16 for shared memory).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

struct __align__(16) hs_c128 {
  double re, im;
  hs_c128() = default;
  __host__ __device__ constexpr hs_c128(double r, double i = 0.0)
      : re(r), im(i) {}
};

struct __align__(8) hs_c64 {
  float re, im;
  hs_c64() = default;
  __host__ __device__ constexpr hs_c64(float r, float i = 0.0f)
      : re(r), im(i) {}
  // rounded once, each part on its own (torch's complex128 -> complex64)
  __host__ __device__ explicit hs_c64(const hs_c128& z)
      : re((float)z.re), im((float)z.im) {}
  __host__ __device__ explicit operator hs_c128() const {
    return hs_c128((double)re, (double)im);
  }
};

#define HS_CPLX_OPS(C, R)                                                     \
  __host__ __device__ __forceinline__ C operator+(C a, C b) {                 \
    return C(a.re + b.re, a.im + b.im);                                       \
  }                                                                           \
  __host__ __device__ __forceinline__ C operator-(C a, C b) {                 \
    return C(a.re - b.re, a.im - b.im);                                       \
  }                                                                           \
  __host__ __device__ __forceinline__ C operator-(C a) {                      \
    return C(-a.re, -a.im);                                                   \
  }                                                                           \
  __host__ __device__ __forceinline__ C operator*(C a, C b) {                 \
    return C(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);           \
  }                                                                           \
  __host__ __device__ __forceinline__ C operator*(R s, C a) {                 \
    return C(s * a.re, s * a.im);                                             \
  }                                                                           \
  __host__ __device__ __forceinline__ C& operator+=(C& a, C b) {              \
    a.re += b.re;                                                             \
    a.im += b.im;                                                             \
    return a;                                                                 \
  }                                                                           \
  __host__ __device__ __forceinline__ C& operator-=(C& a, C b) {              \
    a.re -= b.re;                                                             \
    a.im -= b.im;                                                             \
    return a;                                                                 \
  }                                                                           \
  __host__ __device__ __forceinline__ C& operator*=(C& a, C b) {              \
    a = a * b;                                                                \
    return a;                                                                 \
  }
HS_CPLX_OPS(hs_c128, double)
HS_CPLX_OPS(hs_c64, float)
#undef HS_CPLX_OPS

template <typename T>
struct hs_traits;
template <>
struct hs_traits<double> {
  typedef double acc;
  typedef double real;
  static constexpr bool complex = false;
};
template <>
struct hs_traits<float> {
  typedef double acc;
  typedef float real;
  static constexpr bool complex = false;
};
template <>
struct hs_traits<hs_c128> {
  typedef hs_c128 acc;
  typedef double real;
  static constexpr bool complex = true;
};
template <>
struct hs_traits<hs_c64> {
  typedef hs_c128 acc;
  typedef float real;
  static constexpr bool complex = true;
};
template <typename T>
using hs_acc_t = typename hs_traits<T>::acc;
template <typename T>
using hs_real_t = typename hs_traits<T>::real;
template <typename T>
constexpr bool hs_widened = !std::is_same<T, hs_acc_t<T>>::value;

__device__ __forceinline__ double hs_wide(double x) { return x; }
__device__ __forceinline__ double hs_wide(float x) { return (double)x; }
__device__ __forceinline__ hs_c128 hs_wide(hs_c128 x) { return x; }
__device__ __forceinline__ hs_c128 hs_wide(hs_c64 x) { return (hs_c128)x; }

__device__ __forceinline__ double hs_conj(double x) { return x; }
__device__ __forceinline__ float hs_conj(float x) { return x; }
__device__ __forceinline__ hs_c128 hs_conj(hs_c128 x) {
  return hs_c128(x.re, -x.im);
}
__device__ __forceinline__ hs_c64 hs_conj(hs_c64 x) {
  return hs_c64(x.re, -x.im);
}

// |x|^2 in the real type
__device__ __forceinline__ double hs_abs2(double x) { return x * x; }
__device__ __forceinline__ float hs_abs2(float x) { return x * x; }
__device__ __forceinline__ double hs_abs2(hs_c128 x) {
  return x.re * x.re + x.im * x.im;
}
__device__ __forceinline__ float hs_abs2(hs_c64 x) {
  return x.re * x.re + x.im * x.im;
}

// 1 / x (a complex x: conj(x) / |x|^2)
__device__ __forceinline__ double hs_inv(double x) { return 1.0 / x; }
__device__ __forceinline__ hs_c128 hs_inv(hs_c128 x) {
  const double d = x.re * x.re + x.im * x.im;
  return hs_c128(x.re / d, -x.im / d);
}

// read-only loads
__device__ __forceinline__ double hs_ldg(const double* p) { return __ldg(p); }
__device__ __forceinline__ float hs_ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ hs_c128 hs_ldg(const hs_c128* p) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  return hs_c128(v.x, v.y);
}
__device__ __forceinline__ hs_c64 hs_ldg(const hs_c64* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return hs_c64(v.x, v.y);
}

// warp shuffles (a complex value: its two parts)
__device__ __forceinline__ double hs_shfl(double v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ float hs_shfl(float v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ hs_c128 hs_shfl(hs_c128 v, int src) {
  return hs_c128(__shfl_sync(0xffffffffu, v.re, src),
                 __shfl_sync(0xffffffffu, v.im, src));
}
__device__ __forceinline__ hs_c64 hs_shfl(hs_c64 v, int src) {
  return hs_c64(__shfl_sync(0xffffffffu, v.re, src),
                __shfl_sync(0xffffffffu, v.im, src));
}
__device__ __forceinline__ double hs_shfl_xor(double v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ float hs_shfl_xor(float v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ hs_c128 hs_shfl_xor(hs_c128 v, int off) {
  return hs_c128(__shfl_xor_sync(0xffffffffu, v.re, off),
                 __shfl_xor_sync(0xffffffffu, v.im, off));
}
__device__ __forceinline__ hs_c64 hs_shfl_xor(hs_c64 v, int off) {
  return hs_c64(__shfl_xor_sync(0xffffffffu, v.re, off),
                __shfl_xor_sync(0xffffffffu, v.im, off));
}
__device__ __forceinline__ double hs_shfl_down(double v, int off) {
  return __shfl_down_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ float hs_shfl_down(float v, int off) {
  return __shfl_down_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ hs_c128 hs_shfl_down(hs_c128 v, int off) {
  return hs_c128(__shfl_down_sync(0xffffffffu, v.re, off),
                 __shfl_down_sync(0xffffffffu, v.im, off));
}
__device__ __forceinline__ hs_c64 hs_shfl_down(hs_c64 v, int off) {
  return hs_c64(__shfl_down_sync(0xffffffffu, v.re, off),
                __shfl_down_sync(0xffffffffu, v.im, off));
}

// *p += v (a complex value: two real atomics, one a part)
__device__ __forceinline__ void hs_atomic_add(double* p, double v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void hs_atomic_add(float* p, float v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void hs_atomic_add(hs_c128* p, hs_c128 v) {
  atomicAdd(&p->re, v.re);
  atomicAdd(&p->im, v.im);
}
__device__ __forceinline__ void hs_atomic_add(hs_c64* p, hs_c64 v) {
  atomicAdd(&p->re, v.re);
  atomicAdd(&p->im, v.im);
}

// values per 16-byte access, and the access itself (p 16-byte aligned)
template <typename T>
struct hs_vec16 {
  static constexpr int n = 16 / (int)sizeof(T);
};

template <typename T>
__device__ __forceinline__ void hs_load16(const T* p,
                                          T (&o)[hs_vec16<T>::n]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  memcpy(&o[0], &v, 16);
}

template <typename T>
__device__ __forceinline__ void hs_store16(T* p,
                                           const T (&v)[hs_vec16<T>::n]) {
  float4 w;
  memcpy(&w, &v[0], 16);
  *reinterpret_cast<float4*>(p) = w;
}
