// The 3D stencil kernels' public entries (plain C, loaded with ctypes) and
// their f32 instances; the kernels are in csrc/stencil3d.cuh, the f64
// instances in csrc/stencil3d_f64.cu.

#include "stencil3d.cuh"

extern "C" {

// y = A x on scalar planes; f32 and f64 at r = 1, 2, 3.
int stencil3d_mv(const void* C, const void* x, void* y, int nx, int ny,
                 int nz, int radius, int f64, void* stream) {
  if (f64 == 1) return stencil3d_mv_f64(C, x, y, nx, ny, nz, radius, stream);
  if (f64 != 0) return (int)cudaErrorInvalidValue;
  return mv_entry<float>(C, x, y, nx, ny, nz, radius, stream);
}

// The plan of a level shape for an instance: out[0] split, out[1] 1 where
// the level's smoothing call is one launch (0: one launch per pass), out[2]
// the level launch's co-resident blocks. 0 on success, negative if a query
// failed.
int stencil3d_plan(int nx, int ny, int nz, int radius, int nf, int f64,
                   int* out) {
  if (f64 == 1) return stencil3d_plan_f64(nx, ny, nz, radius, nf, out);
  if (f64 != 0) return -1;
  return plan_entry<float>(nx, ny, nz, radius, nf, out);
}

// One pass on nF fields: pass 0 y = A x, 1 y = b - A x, 2 y = x + s0 Binv
// (b - A x), 3 (nF = 1) the Chebyshev step with (s0, s1) and d, 4 y =
// omega0 Binv b (the sweep from zero; d, when not null, gets the same
// values). `split` is the plan's. Operands a pass does not read may be
// null; y must not alias x, d or b.
int stencil3d_pass(const void* C, const void* x, const void* b,
                   const void* binv, void* d, double omega0, double s0,
                   double s1, void* y, int nx, int ny, int nz, int radius,
                   int nf, int f64, int pass, int split, void* stream) {
  if (f64 == 1) {
    return stencil3d_pass_f64(C, x, b, binv, d, omega0, s0, s1, y, nx, ny,
                              nz, radius, nf, pass, split, stream);
  }
  if (f64 != 0) return (int)cudaErrorInvalidValue;
  return pass_entry<float>(C, x, b, binv, d, omega0, s0, s1, y, nx, ny, nz,
                           radius, nf, pass, split, stream);
}

// A level's smoothing call in ONE cooperative launch: `sweeps` (1 to 8)
// sweeps (cheb 0, omega s0[k]) or Chebyshev steps (cheb 1, nF = 1, (s0,
// s1)[k], s1[0] = 0) from x (x null: from zero) into out, then res = b -
// A out when res is not null. tmp is the ping-pong buffer (sweeps >= 2), d
// the Chebyshev direction (cheb, unless one step from zero). None of out,
// tmp, res, d may alias x or each other. Every block of the plan must be
// co-resident, else the launch is refused.
int stencil3d_level(const void* C, const void* binv, const void* b,
                    const void* x, void* d, void* out, void* tmp, void* res,
                    const double* s0, const double* s1, int sweeps, int cheb,
                    int nx, int ny, int nz, int radius, int nf, int f64,
                    int split, void* stream) {
  if (f64 == 1) {
    return stencil3d_level_f64(C, binv, b, x, d, out, tmp, res, s0, s1,
                               sweeps, cheb, nx, ny, nz, radius, nf, split,
                               stream);
  }
  if (f64 != 0) return (int)cudaErrorInvalidValue;
  return level_entry<float>(C, binv, b, x, d, out, tmp, res, s0, s1, sweeps,
                            cheb, nx, ny, nz, radius, nf, split, stream);
}

}  // extern "C"
