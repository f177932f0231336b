// The runtime-radius instances of the 3D stencil kernels
// (csrc/stencil_rn.cuh), f32 and f64, 1-3 fields: the public entries of
// csrc/stencil3d.cu call these at r >= 5. They stage no x plane, so the
// plan answers split 1, all fields, and one launch per pass for a level's
// smoothing call (the fused entry is refused).

#include "stencil3d.cuh"
#include "stencil_rn.cuh"

#define STENCIL3D_RN_ENTRIES(SUFFIX, T)                                      \
  extern "C" {                                                               \
  int stencil3d_mv_##SUFFIX(const void* C, const void* x, void* y, int nx,   \
                            int ny, int nz, int radius, void* stream) {      \
    return rn::pass3d_entry<T>(C, x, nullptr, nullptr, nullptr, 0.0, 0.0,    \
                               0.0, y, nx, ny, nz, radius, 1, rn::kApply, 1, \
                               0, stream);                                   \
  }                                                                          \
  int stencil3d_plan_##SUFFIX(int nx, int ny, int nz, int radius, int nf,    \
                              int* out) {                                    \
    if (nx <= 0 || ny <= 0 || nz <= 0 || radius < 1 || nf < 1 || nf > 3) {   \
      return -1;                                                             \
    }                                                                        \
    out[0] = 1;                                                              \
    out[1] = 0;                                                              \
    out[2] = 0;                                                              \
    out[3] = 0;                                                              \
    return 0;                                                                \
  }                                                                          \
  int stencil3d_pass_##SUFFIX(const void* C, const void* x, const void* b,   \
                              const void* binv, void* d, double omega0,      \
                              double s0, double s1, void* y, int nx, int ny, \
                              int nz, int radius, int nf, int pass,          \
                              int split, int staging, void* stream) {        \
    return rn::pass3d_entry<T>(C, x, b, binv, d, omega0, s0, s1, y, nx, ny,  \
                               nz, radius, nf, pass, split, staging,         \
                               stream);                                      \
  }                                                                          \
  int stencil3d_level_##SUFFIX(const void*, const void*, const void*,        \
                               const void*, void*, void*, void*, void*,      \
                               const double*, const double*, int, int, int,  \
                               int, int, int, int, int, void*) {             \
    return (int)cudaErrorInvalidValue;                                       \
  }                                                                          \
  }

STENCIL3D_RN_ENTRIES(rn_f32, float)
STENCIL3D_RN_ENTRIES(rn_f64, double)
