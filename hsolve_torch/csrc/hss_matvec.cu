// Kernel J's real entry points, float64 and float32 (the kernel, its design
// and its bound: hss_matvec.cuh).
#include "hss_matvec.cuh"

HS_EXPORT int hs_hss_matvec(HS_MATVEC_ARGS) {
  return hss_matvec_typed<double>(HS_MATVEC_PASS);
}

HS_EXPORT int hs_hss_matvec_f32(HS_MATVEC_ARGS) {
  return hss_matvec_typed<float>(HS_MATVEC_PASS);
}
