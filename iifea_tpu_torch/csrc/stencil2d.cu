// The 2D stencil kernels' public entries (plain C, loaded with ctypes) and
// their f32 instances at r = 1-3; the kernels are in csrc/stencil2d.cuh,
// the f64 instances in csrc/stencil2d_f64.cu, the r = 4 ones in
// csrc/stencil2d_r4.cu and csrc/stencil2d_r4_f64.cu, and those of every
// radius from 5 (the radius a kernel argument; csrc/stencil_rn.cuh) in
// csrc/stencil2d_rn.cu. Each public entry hands its operands to the source
// that holds their (type, radius).

#include "stencil2d.cuh"

STENCIL2D_ENTRIES(f32, float, 1, 3)

// the typed entry of FN for (f64, radius); null when f64 is neither 0 nor 1
#define TYPED2D(FN, f64, radius)                                          \
  ((f64) == 1 ? ((radius) >= 5   ? FN##_rn_f64                            \
                 : (radius) == 4 ? FN##_r4_f64                            \
                                 : FN##_f64)                              \
   : (f64) == 0 ? ((radius) >= 5   ? FN##_rn_f32                          \
                   : (radius) == 4 ? FN##_r4_f32                          \
                                   : FN##_f32)                            \
                : nullptr)

extern "C" {

// One pass on an nF-field operator of scalar type f64 ? double : float.
// mode 0: y = A x; 1: y = b - A x; 2: y = x + omega Binv (b - A x), and
// with x null the same sweep applied to omega Binv b, i.e. two sweeps from
// zero in one pass; 3: y = omega Binv b, one sweep from zero (C, x
// unread). y must not alias x.
int stencil2d_block(const void* C, const void* x, const void* b,
                    const void* binv, double omega, void* y, int nx, int ny,
                    int radius, int nf, int mode, int f64, void* stream) {
  auto fn = TYPED2D(stencil2d_block, f64, radius);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(C, x, b, binv, omega, y, nx, ny, radius, nf, mode, stream);
}

// y = A x, scalar operator
int stencil2d_mv(const void* C, const void* x, void* y, int nx, int ny,
                 int radius, int f64, void* stream) {
  return stencil2d_block(C, x, nullptr, nullptr, 0.0, y, nx, ny, radius, 1,
                         kApply, f64, stream);
}

// 1: the level's smoothing call takes one cooperative launch
// (stencil2d_smooth: every tile co-resident; the rule's data are at
// plan_level2d in csrc/stencil_rn.cuh); 0: one launch per pass
// (stencil2d_block); negative: the occupancy query failed.
int stencil2d_smooth_plan(int nx, int ny, int radius, int nf, int f64) {
  auto fn = TYPED2D(stencil2d_smooth_plan, f64, radius);
  if (fn == nullptr) return -1;
  return fn(nx, ny, radius, nf);
}

// `sweeps` >= 1 sweeps from x (x null: from zero) into out, then
// res = b - A out when res is not null, in ONE cooperative launch. tmp is
// the ping-pong buffer (read and written when sweeps >= 2); none of out,
// tmp, res may alias x or each other. The level's tiles of 8 x 32 must all
// be co-resident, else the launch is refused.
int stencil2d_smooth(const void* C, const void* binv, const void* b,
                     const void* x, double omega, int sweeps, void* out,
                     void* tmp, void* res, int nx, int ny, int radius,
                     int nf, int f64, void* stream) {
  auto fn = TYPED2D(stencil2d_smooth, f64, radius);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(C, binv, b, x, omega, sweeps, out, tmp, res, nx, ny, radius, nf,
            stream);
}

}  // extern "C"
