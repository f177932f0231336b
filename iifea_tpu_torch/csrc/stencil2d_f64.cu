// The f64 instances of the 2D stencil kernels (csrc/stencil2d.cuh), in a
// source of their own so that nvcc compiles them beside the f32 ones; the
// public entries of csrc/stencil2d.cu call these for f64 operands.

#include "stencil2d.cuh"

extern "C" {

int stencil2d_block_f64(const void* C, const void* x, const void* b,
                        const void* binv, double omega, void* y, int nx,
                        int ny, int radius, int nf, int mode, void* stream) {
  return block_entry<double>(C, x, b, binv, omega, y, nx, ny, radius, nf,
                             mode, stream);
}

int stencil2d_smooth_plan_f64(int nx, int ny, int radius, int nf) {
  return plan_entry<double>(nx, ny, radius, nf);
}

int stencil2d_smooth_f64(const void* C, const void* binv, const void* b,
                         const void* x, double omega, int sweeps, void* out,
                         void* tmp, void* res, int nx, int ny, int radius,
                         int nf, void* stream) {
  return level_entry<double>(C, binv, b, x, omega, sweeps, out, tmp, res, nx,
                             ny, radius, nf, stream);
}

}  // extern "C"
