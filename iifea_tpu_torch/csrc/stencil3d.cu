// The 3D stencil kernels' public entries (plain C, loaded with ctypes) and
// their f32 instances at r = 1-3; the kernels are in csrc/stencil3d.cuh,
// the f64 instances in csrc/stencil3d_f64.cu, the r = 4 ones in
// csrc/stencil3d_r4.cu and csrc/stencil3d_r4_f64.cu, and those of the
// runtime-radius marching kernel (every radius from 5, and the unstaged
// route at r = 1-4) in csrc/stencil3d_rn.cu. Each public entry hands its
// operands to the source that holds their (type, radius, staging).

#include "stencil3d.cuh"

STENCIL3D_ENTRIES(f32, float, 1, 3)

// the typed entry of FN for (f64, radius; rn: the runtime-radius
// instances); null when f64 is neither 0 nor 1
#define TYPED3D(FN, f64, radius, rn)                                      \
  ((f64) == 1 ? ((rn)            ? FN##_rn_f64                            \
                 : (radius) == 4 ? FN##_r4_f64                            \
                                 : FN##_f64)                              \
   : (f64) == 0 ? ((rn)            ? FN##_rn_f32                          \
                   : (radius) == 4 ? FN##_r4_f32                          \
                                   : FN##_f32)                            \
                : nullptr)

extern "C" {

// The plan of a level shape for an instance: out[0] split, out[1] 1 where
// the level's smoothing call is one launch (its blocks all co-resident and
// the measured rule, level_pays, met; 0: one launch per pass, always where
// the planes are staged one field at a time or, below r = 5, not at all),
// out[2] the level launch's co-resident blocks (0 where it has none),
// out[3] the staging (0: every field's
// x planes at once; 1: one field's at a time, at r = 1-4 where a block
// cannot hold them all; 2: none, x read through the read-only cache: the
// runtime-radius kernel's route, at every radius from 5 and where a block
// cannot hold one field's planes). 0 on success, -1 if a query failed;
// every lattice has a plan.
int stencil3d_plan(int nx, int ny, int nz, int radius, int nf, int f64,
                   int* out) {
  auto fn = TYPED3D(stencil3d_plan, f64, radius, radius >= 5);
  if (fn == nullptr) return -1;
  const int rc = fn(nx, ny, nz, radius, nf, out);
  if (rc != kPlanTooWide) return rc;
  return TYPED3D(stencil3d_plan, f64, radius, true)(nx, ny, nz, radius, nf,
                                                    out);
}

// One pass on nF fields: pass 0 y = A x, 1 y = b - A x, 2 y = x + s0 Binv
// (b - A x), 3 (nF = 1) the Chebyshev step with (s0, s1) and d, 4 y =
// omega0 Binv b (the sweep from zero; d, when not null, gets the same
// values). `split` and `staging` are the plan's (staging 2 runs the
// runtime-radius kernel, which every radius from 5 takes). Operands a pass
// does not read may be null; y must not alias x, d or b.
int stencil3d_pass(const void* C, const void* x, const void* b,
                   const void* binv, void* d, double omega0, double s0,
                   double s1, void* y, int nx, int ny, int nz, int radius,
                   int nf, int f64, int pass, int split, int staging,
                   void* stream) {
  auto fn = TYPED3D(stencil3d_pass, f64, radius,
                    radius >= 5 || staging == kUnstaged);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(C, x, b, binv, d, omega0, s0, s1, y, nx, ny, nz, radius, nf, pass,
            split, staging, stream);
}

// A level's smoothing call in ONE cooperative launch: `sweeps` (1 to 8)
// sweeps (cheb 0, omega s0[k]) or Chebyshev steps (cheb 1, nF = 1, (s0,
// s1)[k], s1[0] = 0) from x (x null: from zero) into out, then res = b -
// A out when res is not null. tmp is the ping-pong buffer (at r = 1-4
// sweeps - (x null) >= 2, the step from zero folded into the staging; from
// r = 5 sweeps >= 2, the step from zero written), d the Chebyshev
// direction (cheb, unless one step from zero). None of out, tmp, res, d
// may alias x or each other. Every block of the plan must be co-resident,
// else the launch is refused. At r = 1-4 it stages every field's x planes
// (a lattice the plan stages otherwise takes one launch a pass); from r = 5
// it runs march_rn_level_kernel, x unstaged.
int stencil3d_level(const void* C, const void* binv, const void* b,
                    const void* x, void* d, void* out, void* tmp, void* res,
                    const double* s0, const double* s1, int sweeps, int cheb,
                    int nx, int ny, int nz, int radius, int nf, int f64,
                    int split, void* stream) {
  auto fn = TYPED3D(stencil3d_level, f64, radius, radius >= 5);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(C, binv, b, x, d, out, tmp, res, s0, s1, sweeps, cheb, nx, ny, nz,
            radius, nf, split, stream);
}

}  // extern "C"
