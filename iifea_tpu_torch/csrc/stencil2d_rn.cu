// The runtime-radius instances of the 2D stencil kernels
// (csrc/stencil_rn.cuh), f32 and f64, 1-3 fields: the public entries of
// csrc/stencil2d.cu call these at r >= 5. A level's smoothing call takes
// one launch per pass there: the plan answers 0 and the fused entry is
// refused.

#include "stencil2d.cuh"
#include "stencil_rn.cuh"

#define STENCIL2D_RN_ENTRIES(SUFFIX, T)                                     \
  extern "C" {                                                              \
  int stencil2d_block_##SUFFIX(const void* C, const void* x, const void* b, \
                               const void* binv, double omega, void* y,     \
                               int nx, int ny, int radius, int nf,          \
                               int mode, void* stream) {                    \
    return rn::block2d_entry<T>(C, x, b, binv, omega, y, nx, ny, radius,    \
                                nf, mode, stream);                          \
  }                                                                         \
  int stencil2d_smooth_plan_##SUFFIX(int nx, int ny, int radius, int nf) {  \
    return nx > 0 && ny > 0 && radius >= 1 && nf >= 1 && nf <= 3 ? 0 : -1;  \
  }                                                                         \
  int stencil2d_smooth_##SUFFIX(const void*, const void*, const void*,      \
                                const void*, double, int, void*, void*,     \
                                void*, int, int, int, int, void*) {         \
    return (int)cudaErrorInvalidValue;                                      \
  }                                                                         \
  }

STENCIL2D_RN_ENTRIES(rn_f32, float)
STENCIL2D_RN_ENTRIES(rn_f64, double)
