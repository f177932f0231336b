// The runtime-radius instances of the 2D stencil kernels
// (csrc/stencil_rn.cuh), f32 and f64, 1-3 fields: the public entries of
// csrc/stencil2d.cu call these at r >= 5. A level's smoothing call takes
// one cooperative launch (level2d_kernel) where the plan says so, else one
// launch per pass.

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
    return rn::smooth_plan2d_entry<T>(nx, ny, radius, nf);                  \
  }                                                                         \
  int stencil2d_smooth_##SUFFIX(const void* C, const void* binv,           \
                                const void* b, const void* x, double omega, \
                                int sweeps, void* out, void* tmp, void* res, \
                                int nx, int ny, int radius, int nf,         \
                                void* stream) {                             \
    return rn::smooth2d_entry<T>(C, binv, b, x, omega, sweeps, out, tmp,    \
                                 res, nx, ny, radius, nf, stream);          \
  }                                                                         \
  }

STENCIL2D_RN_ENTRIES(rn_f32, float)
STENCIL2D_RN_ENTRIES(rn_f64, double)
