// The runtime-radius instances of the 3D marching kernel (march_rn_kernel
// in csrc/stencil3d.cuh), f32 and f64, 1-3 fields, x read through the
// read-only cache (the unstaged route): the public entries of
// csrc/stencil3d.cu call these at r >= 5, and at r = 1-4 for the lattices
// whose x planes a block cannot stage. A level's smoothing call here is one
// launch per pass (the fused entry is refused).

#include "stencil3d.cuh"

#define STENCIL3D_RN_ENTRIES(SUFFIX, T)                                      \
  extern "C" {                                                               \
  int stencil3d_plan_##SUFFIX(int nx, int ny, int nz, int radius, int nf,    \
                              int* out) {                                    \
    return plan_entry_rn<T>(nx, ny, nz, radius, nf, out);                    \
  }                                                                          \
  int stencil3d_pass_##SUFFIX(const void* C, const void* x, const void* b,   \
                              const void* binv, void* d, double omega0,      \
                              double s0, double s1, void* y, int nx, int ny, \
                              int nz, int radius, int nf, int pass,          \
                              int split, int staging, void* stream) {        \
    return pass_entry_rn<T>(C, x, b, binv, d, omega0, s0, s1, y, nx, ny, nz, \
                            radius, nf, pass, split, staging, stream);       \
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
