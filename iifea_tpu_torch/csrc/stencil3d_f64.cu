// The f64 instances of the 3D stencil kernels (csrc/stencil3d.cuh), in a
// source of their own so that nvcc compiles them beside the f32 ones; the
// public entries of csrc/stencil3d.cu call these for f64 operands.

#include "stencil3d.cuh"

extern "C" {

int stencil3d_mv_f64(const void* C, const void* x, void* y, int nx, int ny,
                     int nz, int radius, void* stream) {
  return mv_entry<double>(C, x, y, nx, ny, nz, radius, stream);
}

int stencil3d_plan_f64(int nx, int ny, int nz, int radius, int nf, int* out) {
  return plan_entry<double>(nx, ny, nz, radius, nf, out);
}

int stencil3d_pass_f64(const void* C, const void* x, const void* b,
                       const void* binv, void* d, double omega0, double s0,
                       double s1, void* y, int nx, int ny, int nz, int radius,
                       int nf, int pass, int split, void* stream) {
  return pass_entry<double>(C, x, b, binv, d, omega0, s0, s1, y, nx, ny, nz,
                            radius, nf, pass, split, stream);
}

int stencil3d_level_f64(const void* C, const void* binv, const void* b,
                        const void* x, void* d, void* out, void* tmp,
                        void* res, const double* s0, const double* s1,
                        int sweeps, int cheb, int nx, int ny, int nz,
                        int radius, int nf, int split, void* stream) {
  return level_entry<double>(C, binv, b, x, d, out, tmp, res, s0, s1,
                             sweeps, cheb, nx, ny, nz, radius, nf, split,
                             stream);
}

}  // extern "C"
