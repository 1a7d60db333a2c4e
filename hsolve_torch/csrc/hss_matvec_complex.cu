// Kernel J's complex entry points, complex128 and complex64 (the kernel, its
// design and its bound: hss_matvec.cuh).
#include "hss_matvec.cuh"

HS_EXPORT int hs_hss_matvec_c128(HS_MATVEC_ARGS) {
  return hss_matvec_typed<hs_c128>(HS_MATVEC_PASS);
}

HS_EXPORT int hs_hss_matvec_c64(HS_MATVEC_ARGS) {
  return hss_matvec_typed<hs_c64>(HS_MATVEC_PASS);
}
