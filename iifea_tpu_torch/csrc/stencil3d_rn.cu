// The runtime-radius instances of the 3D marching kernels (march_rn_kernel
// and march_rn_level_kernel in csrc/stencil3d.cuh), f32 and f64, 1-3
// fields, x unstaged: the public entries of csrc/stencil3d.cu call these at
// r >= 5 (a level's smoothing call in one cooperative launch where the
// plan says so, else one launch a pass), and at r = 1-4 for the lattices
// whose x planes a block cannot stage (one launch a pass).

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
  int stencil3d_level_##SUFFIX(const void* C, const void* binv,              \
                               const void* b, const void* x, void* d,        \
                               void* out, void* tmp, void* res,              \
                               const double* s0, const double* s1,           \
                               int sweeps, int cheb, int nx, int ny, int nz, \
                               int radius, int nf, int split,                \
                               void* stream) {                               \
    return level_entry_rn<T>(C, binv, b, x, d, out, tmp, res, s0, s1,        \
                             sweeps, cheb, nx, ny, nz, radius, nf, split,    \
                             stream);                                        \
  }                                                                          \
  }

STENCIL3D_RN_ENTRIES(rn_f32, float)
STENCIL3D_RN_ENTRIES(rn_f64, double)
