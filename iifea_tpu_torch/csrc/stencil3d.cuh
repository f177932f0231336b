// Variable-coefficient 3D stencil kernels for Hopper (sm_90a), in f32 and
// f64: the marching kernels behind every 3D pass (`stencil3d_pass`: the
// apply, which `stencil_mv3` launches, weighted-Jacobi and point-block
// sweeps, the Chebyshev step, block residuals) and behind a multigrid
// level's whole smoothing call (`stencil3d_level`, one cooperative launch).
// This header holds the kernels and the entries' dispatch by (radius,
// fields), shared by the sources that instantiate them, which nvcc
// compiles in parallel: csrc/stencil3d.cu (the f32 instances at r = 1-3 and
// the public entries), csrc/stencil3d_f64.cu (f64, r = 1-3),
// csrc/stencil3d_r4.cu and csrc/stencil3d_r4_f64.cu (r = 4 in f32 and f64),
// and csrc/stencil3d_rn.cu: the runtime-radius marching kernels
// (`march_rn_kernel` and its level launch `march_rn_level_kernel`, the
// radius a kernel argument), which run every radius from 5 and, at
// r = 1-4, the passes of the lattices whose x planes a block cannot stage.
//
// Replaces the Pallas TPU kernels iifea_tpu/ops/pallas_stencil.py
// `stencil_mv3` (body `_mv3_kernel`/`_taps3`) and `jacobi_smooth3` (body
// `_smooth3_kernel`), extends the latter to the Chebyshev step of the 3D
// V-cycle smoother (iifea_tpu/ops/multigrid.py StencilMultigrid3D._smooth),
// and carries the 3D block operators the reference runs as XLA ops
// (iifea_tpu/ops/stencil.py StencilOperatorBlock3D.mv, ops/multigrid.py
// StencilMultigridBlock3D._smooth). With nF fields on field-blocked vectors
// (nF, nx, ny, nz), coefficients C (nF, nF, m^3, nx, ny, nz), m = 2r+1,
// q = ((oi+r)*m + (oj+r))*m + (ok+r), node id (i*ny + j)*nz + k:
//
//   (A x)[f1] = sum_f2 sum_q C[f1,f2,q] * shift_q(x[f2])   (x zero outside)
//   apply:     y = A x
//   residual:  y = b - A x
//   sweep:     y = x + omega * Binv (b - A x)   Binv (nF, nF, n) nodal
//                                               blocks; nF = 1: 1/diag
//   cheb:      r = invd (b - A x); d' = s0 r + s1 d; y = x + d'   (nF = 1)
//   zero:      y = omega * Binv b               (a sweep from x = 0)
//
// Instances (scalar type, radius, fields): f32 and f64 at r = 1 to 4
// (r = 3: the quadratic B-spline background's 343 taps, r = 4 the cubic
// one's 729) for 1 to 3 fields, every configuration the multigrid routes
// take; from r = 5 (the quartic background's 1,331 taps) the runtime-radius
// instances, f32 and f64, 1 to 3 fields.
//
// What bounds them: memory traffic. A point reads nF^2 coefficients for
// each of its taps in the lattice once (1,125 f32 at nF = 3, r = 2; 3,087
// f64 at nF = 3, r = 3, in the interior) against ~2 flops each. At
// 3 x 97^3, r = 2 the planes are 4.1 GB in f32, 8.2 GB in f64: 1.23 / 2.46
// ms at 3.35 TB/s. A tap whose x lies outside the lattice multiplies the
// zero padding: its coefficient is never read (at 3 x 17^3, r = 4, 34% of
// the taps; r = 5, 41%).
// The small multigrid levels (3 x 13^3, 17^3) are chains of latencies
// instead: few points, each with a long list of loads.
//
// The marching design (`march`):
//
// * a block owns a RUN of tp consecutive points of the flattened (j, k)
//   plane (tp = 256 / split); only the last run of a plane is ragged (at
//   97^2, 37 runs of 256 with 99% of lanes busy, against 76% of a 32-wide
//   k tile), and the coefficient reads of a run are one contiguous,
//   coalesced stretch of each plane in the planes' own layout;
// * the 2r+1 x planes the run needs, each with r rows of halo in j and k,
//   are copied into shared memory with cp.async (where a block cannot hold
//   those of every field, f64 r = 4 with three fields from a 73-point row,
//   one field's at a time: the plan's per-field staging, whose trips keep
//   each thread's order of sums, so it equals the all-field staging
//   bitwise; one launch a pass); a block takes one i-plane
//   (blocks that walked along i through several planes, copying the next
//   while the current one's coefficients streamed, were no faster at any
//   level shape on an H100: 3 x 97^3 1.434 ms at 1 plane, 1.452 at 4);
// * a thread keeps two (f2, oi) trips of nF m^2 coefficient loads in
//   flight (one for the scalar f32 r <= 2 instances, and where two would
//   not fit the registers), with launch bounds from those loads' registers;
//   where one trip's nF m^2 loads alone would not fit (f64 r = 3 with 2 or
//   3 fields) a trip covers one output field, nF times as many trips; at
//   nF^2 m^3 >= 1,000 the large levels run one block per SM (fewer
//   coefficient planes streamed at once);
// * the padding skip: a trip whose x plane lies outside the lattice (the
//   same for the whole block) is skipped and its plane not staged, as is a
//   trip whose rows lie outside for every point of the run; at the edges a
//   lane's loads of taps outside are predicated off (ldg_if) and add
//   c 0 with c = 0, exactly the term they added when read, so every sum,
//   and every route's output, is bitwise what it was with every tap read;
// * on small levels `split` > 1 threads share a point: each takes every
//   split-th trip and the partial sums meet in shared memory in a fixed
//   order; the plan picks split from the run count and the card's
//   occupancy so that the grid fills the SMs at every level shape (splits
//   above 16 were slower at every small lattice swept, 3 x 17^3 included);
// * a level's smoothing call (nu sweeps or Chebyshev steps and the trailing
//   residual) is one cooperative launch where the plan says so
//   (`stencil3d_level`, `grid.sync()` between passes, x ping-ponged
//   through the L2; the step from zero folded into the next pass's
//   staging, or from r = 5 a phase of its own): at every radius, where
//   the level's blocks are co-resident and its coefficients fit the L2
//   (`level_pays`). Both routes run the same body on the same points with
//   the same split, so they agree bitwise.
//
// Launch contract: PyTorch's current stream, no synchronisation, no
// allocation (the caller allocates outputs and scratch; y must not alias x,
// since neighbouring blocks read x's halo). Each entry returns the launch's
// cudaError_t.

#ifndef IIFEA_STENCIL3D_CUH_
#define IIFEA_STENCIL3D_CUH_

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// -- the marching kernels ----------------------------------------------------

constexpr int kMarch = 256;      // threads per block: tp points x split
constexpr int kMaxSteps = 8;     // smoothing steps a level's launch takes

enum Pass { kApply = 0, kResidual = 1, kSweep = 2, kCheb = 3, kZero = 4 };
// how x reaches shared memory: copied with cp.async (in a level's launch
// also x that other blocks wrote before the last grid barrier, whose fence
// makes those writes visible to the copies), or computed as the sweep from
// zero, omega0 Binv b
enum Stage { kCopy = 0, kFromZero = 1 };

struct Geom {
  int nx, ny, nz, npl;   // npl = ny * nz points per i-plane
  int64_t plane;         // nx * npl
  int tp, split, runs;   // points per run, threads per point, runs per plane
  int rows, width;       // staged rows of a plane (the run's + 2r), nz + 2r
  int drow, dcol;        // kMarch = drow * width + dcol: a staging stride
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// the geometry of a pass at radius r
inline Geom make_geom(int nx, int ny, int nz, int split, int r) {
  Geom g;
  g.nx = nx; g.ny = ny; g.nz = nz;
  g.npl = ny * nz;
  g.plane = (int64_t)nx * g.npl;
  g.split = split;
  g.tp = kMarch / split;
  g.runs = cdiv(g.npl, g.tp);
  // a run of tp points starting anywhere in a row spans at most this many
  // rows
  const int run_rows = (nz + g.tp - 2) / nz + 1;
  g.rows = (run_rows < ny ? run_rows : ny) + 2 * r;
  g.width = nz + 2 * r;
  g.drow = kMarch / g.width;
  g.dcol = kMarch - g.drow * g.width;
  return g;
}

// the 2r+1 staged x planes of every field (of one field at a time where
// `staged` is 1: the per-field staging), then the split's partial sums
template <class T, int R, int NF>
size_t smem_bytes(const Geom& g, int staged = NF) {
  return ((size_t)(2 * R + 1) * staged * g.rows * g.width
          + (size_t)NF * kMarch) * sizeof(T);
}

// A trip: the loads of one (f2, oi) pair, for `trip_fields` output fields
// (all nF, or one where nF m^2 words are more than 150: f64 r = 3 with 2 or
// 3 fields, whose trips then cover one field each; every r = 4 block
// instance), and for `trip_rows` rows of oj (all m, or a third where one
// field's m^2 words are more than 150: f64 r = 4, 162 words, whose trips
// then take 3 rows, 54 words; the sums keep their order f2, oi, oj). The
// trips a thread keeps in flight (their loads unrolled together), the
// words of their coefficient loads, and the resident blocks per SM asked
// of the compiler so that those loads fit under the register cap (65536 /
// 256 threads / blocks) beside ~24 of bookkeeping (~32 in f64): two trips
// at nF = 3, r = 2
// (150 words) and f64 r = 3 (196) take 1 block (255 registers), f32 r = 3
// (98) and nF = 2, r = 2 (100) 2. The scalar f32 r <= 2 instances (the 3D
// Poisson cycle) keep one trip in flight: at 53^3 two trips' registers cost
// a wave (0.0336 ms against 0.0310 on an H100); so does a block instance
// whose two trips would be more than 150 words (f64 nF = 2, r = 2: 100 in
// one; f32 r = 3 with 2 or 3 fields: 98, 147; f64 nF = 3, r = 2: 150; f64
// r = 3 with 2 or 3 fields: 98; f32 r = 4 with 2 or 3 fields: 81). At
// r = 4: f32 scalar two trips of 81 words, 1 block; f64 two trips of 54 (2
// or 3 fields: one field's rows each), 1 block. A level's launch keeps more
// live across its passes: ~56 (~64 in f64). At least 1 block, at most 6
// (42 registers): at 7 the scalar r = 1 body spills.
template <class T, int R, int NF>
__host__ __device__ constexpr bool scalar_r2() {
  return NF == 1 && R <= 2 && sizeof(T) == 4;
}
template <class T, int R>
__host__ __device__ constexpr int trip_words(int fields) {
  return fields * (2 * R + 1) * (2 * R + 1) * (int)(sizeof(T) / 4);
}
template <class T, int R, int NF>
__host__ __device__ constexpr int trip_fields() {
  return trip_words<T, R>(NF) <= 150 ? NF : 1;
}
template <class T, int R>
__host__ __device__ constexpr int trip_rows() {
  return trip_words<T, R>(1) <= 150 ? 2 * R + 1 : (2 * R + 1) / 3;
}
// the words of one trip's coefficient loads
template <class T, int R, int NF>
__host__ __device__ constexpr int load_words() {
  return trip_words<T, R>(trip_fields<T, R, NF>()) * trip_rows<T, R>() /
         (2 * R + 1);
}
template <class T, int R, int NF>
__host__ __device__ constexpr int trips() {
  return scalar_r2<T, R, NF>() ? 1
         : NF == 1 || 2 * load_words<T, R, NF>() <= 150 ? 2
                                                         : 1;
}
template <class T, int R, int NF>
__host__ __device__ constexpr int march_blocks(int bookkeeping = 24) {
  const int regs = trips<T, R, NF>() * load_words<T, R, NF>() +
                   bookkeeping + (sizeof(T) == 8 ? 8 : 0);
  return 256 / regs > 6 ? 6 : 256 / regs < 1 ? 1 : 256 / regs;
}

template <class T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(in ? 8 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// A coefficient read through the read-only cache where `on`, else 0 with
// no memory access: one predicated load, no branch, so a trip's loads
// still issue together. The taps whose x lies outside the lattice take
// on = false: their coefficients multiply the zero padding, and are never
// read (whatever the planes hold there).
__device__ __forceinline__ float ldg_if(const float* p, bool on) {
  float v = 0.0f;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q ld.global.nc.f32 %0, [%1];\n\t}"
      : "+f"(v)
      : "l"(p), "r"((int)on));
  return v;
}
__device__ __forceinline__ double ldg_if(const double* p, bool on) {
  double v = 0.0;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q ld.global.nc.f64 %0, [%1];\n\t}"
      : "+d"(v)
      : "l"(p), "r"((int)on));
  return v;
}

// x after one sweep from zero at point p, field f1: omega Binv b.
template <class T, int NF>
__device__ __forceinline__ T from_zero(const T* __restrict__ binv,
                                       const T* __restrict__ b, T omega,
                                       int64_t plane, int64_t p, int f1) {
  T v = T(0);
#pragma unroll
  for (int f2 = 0; f2 < NF; ++f2) {
    v = fma_t(omega * __ldg(binv + (int64_t)(f1 * NF + f2) * plane + p),
              __ldg(b + f2 * plane + p), v);
  }
  return v;
}

// Stage x plane gi (every field) into `slot` ([NF][rows][width]): rows
// j0 .. j0 + rows - 1, columns -r .. nz + r - 1; zero outside the lattice.
// The thread starts at element threadIdx.x = (row0, col0) and steps by
// kMarch elements, (drow, dcol), without dividing.
template <class T, int R, int NF, int STAGE>
__device__ __forceinline__ void stage_plane(T* slot, const Geom& g, int gi,
                                            int j0, int row0, int col0,
                                            const T* x,
                                            const T* __restrict__ binv,
                                            const T* __restrict__ b,
                                            T omega0) {
  const int per = g.rows * g.width;
  const bool plane_in = gi >= 0 && gi < g.nx;
  int row = row0, col = col0;
  for (int e = threadIdx.x; e < per; e += kMarch) {
    const int gj = j0 + row;
    const int gk = col - R;
    const bool in =
        plane_in && gj >= 0 && gj < g.ny && gk >= 0 && gk < g.nz;
    const int64_t p = ((int64_t)gi * g.ny + gj) * g.nz + gk;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      if constexpr (STAGE == kCopy) {
        cp_async(slot + f * per + e, in ? x + f * g.plane + p : x, in);
      } else {
        slot[f * per + e] =
            in ? from_zero<T, NF>(binv, b, omega0, g.plane, p, f) : T(0);
      }
    }
    row += g.drow;
    col += g.dcol;
    if (col >= g.width) {
      col -= g.width;
      ++row;
    }
  }
}

// Copy x plane gi of field f alone into `slot` ([rows][width]), as
// stage_plane does for every field: the per-field staging's copy.
template <class T, int R>
__device__ __forceinline__ void stage_field(T* slot, const Geom& g, int gi,
                                            int j0, int row0, int col0,
                                            int f, const T* x) {
  const int per = g.rows * g.width;
  const bool plane_in = gi >= 0 && gi < g.nx;
  int row = row0, col = col0;
  for (int e = threadIdx.x; e < per; e += kMarch) {
    const int gj = j0 + row;
    const int gk = col - R;
    const bool in =
        plane_in && gj >= 0 && gj < g.ny && gk >= 0 && gk < g.nz;
    const int64_t p = ((int64_t)gi * g.ny + gj) * g.nz + gk;
    cp_async(slot + e, in ? x + f * g.plane + p : x, in);
    row += g.drow;
    col += g.dcol;
    if (col >= g.width) {
      col -= g.width;
      ++row;
    }
  }
}

// One (f2, oi) trip at a point: acc[f1] += sum_(oj, ok) C[f1, f2, q] *
// window for every output field f1 (NF m^2 loads), or, where a trip covers
// one field (trip_fields), for f1 = fg alone (m^2 loads; acc[fg] is picked
// and put back by selects, so acc stays in registers), over the trip's
// `trip_rows` rows of oj. Cq: C + (f2 m^3 + oi m^2 + oj0 m) plane + p; xw:
// the window slot of field f2 at the point's (row, column) offset -r, moved
// down oj0 rows. Bit oj of rm (from oj0) and bit ok of cm say that the
// tap's row and column lie in the lattice: a tap outside reads no
// coefficient and adds c 0 with c = 0, the term it added before (x is zero
// there), so the sums are bitwise those of every tap read. The output
// fields take a tap's loads one after another (each field's sum keeps its
// order of taps), so a tap's predicate serves its nF loads and dies.
template <class T, int R, int NF>
__device__ __forceinline__ void trip(const T* __restrict__ Cq, int64_t plane,
                                     const T* xw, int width, T (&acc)[NF],
                                     int fg, unsigned rm, unsigned cm) {
  constexpr int M = 2 * R + 1;
  constexpr int M3 = M * M * M;
  constexpr int ROWS = trip_rows<T, R>();
  if constexpr (trip_fields<T, R, NF>() == NF) {
#pragma unroll
    for (int oj = 0; oj < ROWS; ++oj) {
      const unsigned row = (rm >> oj) & 1u ? cm : 0u;
#pragma unroll
      for (int ok = 0; ok < M; ++ok) {
        const bool on = (row >> ok) & 1u;
        const T xv = xw[oj * width + ok];
#pragma unroll
        for (int f1 = 0; f1 < NF; ++f1) {
          acc[f1] = fma_t(
              ldg_if(Cq + ((int64_t)f1 * NF * M3 + oj * M + ok) * plane, on),
              xv, acc[f1]);
        }
      }
    }
  } else {
    T a = acc[0];
#pragma unroll
    for (int f1 = 1; f1 < NF; ++f1) a = fg == f1 ? acc[f1] : a;
    const T* Cf = Cq + (int64_t)fg * NF * M3 * plane;
#pragma unroll
    for (int oj = 0; oj < ROWS; ++oj) {
      const unsigned row = (rm >> oj) & 1u ? cm : 0u;
#pragma unroll
      for (int ok = 0; ok < M; ++ok) {
        a = fma_t(ldg_if(Cf + (int64_t)(oj * M + ok) * plane,
                         (row >> ok) & 1u),
                  xw[oj * width + ok], a);
      }
    }
#pragma unroll
    for (int f1 = 0; f1 < NF; ++f1) acc[f1] = fg == f1 ? a : acc[f1];
  }
}

// One pass over the block's run on plane i: the body of every marching
// entry. All threads of the block call it. `x` null: the pass stages the
// sweep from zero (omega0 Binv b) in place of x (STAGE must be kFromZero).
// `d` (kCheb): read at the point when s1 != 0 (from zero: the staged x is
// the direction), then written. EARLY (one field): the point's b, Binv and
// d are loaded before the staging, so their latency overlaps it and the
// epilogue waits on no load (the 3D Poisson cycle's 53^3 Jacobi /
// Chebyshev passes were 3.9% / 4.0% slower than a 32 x 4 x 2 tile kernel's
// without, +0.3% / -2.3% with, on an H100); a level's launch loads them
// after the stream, since the two registers more halve its co-resident
// blocks at f64 r = 3 (130 registers) and take the 33^3 level out of one
// launch. PF (2-3 fields): the per-field staging, for lattices whose
// planes of every field a block cannot hold: field f2's 2r+1 planes are
// staged, then that field's trips run, then the next field's planes
// replace them; each thread runs the same trips in the same order as with
// every field staged, so the sums are bitwise the same. The epilogue reads
// x at the point from memory. A pass launch alone takes it (STAGE kCopy):
// the level launch, whose blocks must all be co-resident, stages every
// field.
template <class T, int R, int NF, int STAGE, bool EARLY, bool PF = false>
__device__ __forceinline__ void march(
    const T* __restrict__ C, const T* x, const T* __restrict__ b,
    const T* __restrict__ binv, T* d, T omega0, T s0, T s1, T* y, int pass,
    const Geom& g, int run, int i, T* sm) {
  constexpr int M = 2 * R + 1;
  constexpr int M3 = M * M * M;
  static_assert(!PF || NF > 1, "one field's planes are all of them");
  static_assert(!PF || STAGE == kCopy, "the per-field staging copies x");
  const int per = g.rows * g.width;
  T* red = sm + M * (PF ? 1 : NF) * per;
  const int s = threadIdx.x / g.tp;
  const int pl = threadIdx.x - s * g.tp;
  const int q0 = run * g.tp;
  const int q = q0 + pl;
  const bool valid = q < g.npl;
  const int jf = q0 / g.nz;
  const int j = q / g.nz;
  const int k = q - j * g.nz;
  const int wr = j - jf;
  const int64_t plane = g.plane;
  const int64_t p = (int64_t)i * g.npl + q;
  const int row0 = threadIdx.x / g.width;
  const int col0 = threadIdx.x - row0 * g.width;
  T b1 = T(0), i1 = T(0), d1 = T(0);
  auto point_operands = [&] {
    if (pass != kApply) b1 = __ldg(b + p);
    if (pass == kSweep || pass == kCheb) i1 = __ldg(binv + p);
    if (pass == kCheb && x != nullptr && s1 != T(0)) d1 = d[p];
  };
  if (EARLY && NF == 1 && s == 0 && valid) point_operands();

  // trip tu = (((f2 M + oi) RG + rg) G + fg): G = NF / trip_fields field
  // groups, RG = m / trip_rows row groups
  constexpr int G = NF / trip_fields<T, R, NF>();
  constexpr int ROWS = trip_rows<T, R>();
  constexpr int RG = M / ROWS;
  static_assert(M % ROWS == 0, "a trip takes whole rows");
  constexpr int NT = NF * M * RG * G;
  // The taps in the lattice. The x planes i + oi - r in it are the same
  // for the whole block: a trip of a plane outside is skipped, and the
  // plane is not staged; so is a trip whose rows lie outside the lattice
  // for every point of the run (rows jf .. jl). Per point, bit o of rmask
  // (cmask) says that row j + o - r (column k + o - r) is in it.
  const int oi_lo = R - i > 0 ? R - i : 0;
  const int oi_hi = g.nx - 1 - i + R < M - 1 ? g.nx - 1 - i + R : M - 1;
  const int jl = ((q0 + g.tp < g.npl ? q0 + g.tp : g.npl) - 1) / g.nz;
  unsigned rmask = 0, cmask = 0;
#pragma unroll
  for (int o = 0; o < M; ++o) {
    rmask |= (unsigned)((unsigned)(j + o - R) < (unsigned)g.ny) << o;
    cmask |= (unsigned)((unsigned)(k + o - R) < (unsigned)g.nz) << o;
  }
  auto live = [&](int tu) {
    const int fo = tu / G / RG;
    const int oi = fo % M;
    if (oi < oi_lo || oi > oi_hi) return false;
    if constexpr (RG > 1) {
      const int oj0 = tu / G % RG * ROWS;
      return jl + oj0 + ROWS - 1 - R >= 0 && jf + oj0 - R < g.ny;
    }
    return true;
  };
  // the thread's first live trip from t on, stepping by split (end if none)
  auto next_live = [&](int t, int end) {
    while (t < end && !live(t)) t += g.split;
    return t;
  };
  T acc[NF];
  // trip tu at the point, on its x window in the staged slots (every
  // field: field f2's plane oi at slot oi*NF + f2; per field: at slot oi)
  auto run_trip = [&](int tu) {
    const int fg = tu % G;
    const int rg = tu / G % RG;
    const int fo = tu / G / RG;
    const int f2 = fo / M;
    const int oi = fo - f2 * M;
    const int oj0 = rg * ROWS;
    const T* xw = sm + (PF ? oi : oi * NF + f2) * per +
                  (wr + oj0) * g.width + k;
    // masks the compiler cannot see through: it computes each trip's
    // predicates anew instead of holding a trip's across the next (at
    // 2 x 81 taps, f32 r = 4, 57 registers more)
    unsigned rm = rmask >> oj0, cm = cmask;
    asm("" : "+r"(rm), "+r"(cm));
    trip<T, R, NF>(C + (int64_t)(f2 * M3 + oi * M * M + oj0 * M) * plane + p,
                   plane, xw, g.width, acc, fg, rm, cm);
  };
  // the thread's live trips among t, t + split, ... below end, in order,
  // `trips` at a time: the sums of every trip run in the same order
  auto run_trips = [&](int t, int end) {
    constexpr int TR = trips<T, R, NF>();
    t = next_live(t, end);
#pragma unroll 1
    while (t < end) {
      int tu[TR];
      tu[0] = t;
#pragma unroll
      for (int u = 1; u < TR; ++u) tu[u] = next_live(tu[u - 1] + g.split, end);
#pragma unroll
      for (int u = 0; u < TR; ++u) {
        if (tu[u] < end) run_trip(tu[u]);
      }
      t = next_live(tu[TR - 1] + g.split, end);
    }
  };
  if constexpr (!PF) {
    // planes i - r .. i + r in slots 0 .. 2r (those in the lattice)
    for (int oi = oi_lo; oi <= oi_hi; ++oi) {
      stage_plane<T, R, NF, STAGE>(sm + oi * NF * per, g, i + oi - R,
                                   jf - R, row0, col0, x, binv, b, omega0);
    }
    if (STAGE == kCopy) cp_async_wait();
    __syncthreads();
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f] = T(0);
    if (valid) run_trips(s, NT);
  } else {
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f] = T(0);
    // field f2's trips are NT / NF consecutive ones; thread s takes those
    // equal to s modulo split, as with every field staged
    constexpr int NTF = NT / NF;
#pragma unroll 1
    for (int f2 = 0; f2 < NF; ++f2) {
      for (int oi = oi_lo; oi <= oi_hi; ++oi) {
        stage_field<T, R>(sm + oi * per, g, i + oi - R, jf - R, row0, col0,
                          f2, x);
      }
      cp_async_wait();
      __syncthreads();
      if (valid) {
        run_trips(f2 * NTF + (s - f2 * NTF % g.split + g.split) % g.split,
                  (f2 + 1) * NTF);
      }
      // every thread is done with field f2's planes before they are
      // replaced
      __syncthreads();
    }
  }
  if (g.split > 1) {
    // the other splits' partial sums, added by split 0 in split order
    if (s > 0) {
#pragma unroll
      for (int f = 0; f < NF; ++f) red[(s * NF + f) * g.tp + pl] = acc[f];
    }
    __syncthreads();
    if (s == 0) {
      for (int s2 = 1; s2 < g.split; ++s2) {
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[f] += red[(s2 * NF + f) * g.tp + pl];
      }
    }
  }
  if (s != 0 || !valid) return;
  if (!EARLY && NF == 1) point_operands();
  const T* xc = sm + R * NF * per + (wr + R) * g.width + k + R;
  // x of field f at the point: staged, or (per field) from memory
  auto xat = [&](int f) -> T {
    if constexpr (!PF) {
      return xc[f * per];
    } else {
      return __ldcg(x + f * plane + p);
    }
  };
  if (pass == kApply) {
#pragma unroll
    for (int f = 0; f < NF; ++f) y[f * plane + p] = acc[f];
  } else if (pass == kResidual && NF == 1) {
    y[p] = b1 - acc[0];
  } else if (pass == kResidual) {
#pragma unroll
    for (int f = 0; f < NF; ++f) y[f * plane + p] = b[f * plane + p] - acc[f];
  } else if (pass == kSweep && NF == 1) {
    y[p] = xat(0) + s0 * (i1 * (b1 - acc[0]));
  } else if (pass == kSweep) {
    T res[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) res[f] = b[f * plane + p] - acc[f];
#pragma unroll
    for (int f1 = 0; f1 < NF; ++f1) {
      T v = T(0);
#pragma unroll
      for (int f2 = 0; f2 < NF; ++f2) {
        v = fma_t(binv[(int64_t)(f1 * NF + f2) * plane + p], res[f2], v);
      }
      y[f1 * plane + p] = xat(f1) + s0 * v;
    }
  } else if (pass == kCheb) {
    const T res = i1 * (b1 - acc[0]);
    const T dprev = x == nullptr ? xat(0) : s1 != T(0) ? d1 : T(0);
    const T dn = s1 != T(0) ? fma_t(s0, res, s1 * dprev) : s0 * res;
    d[p] = dn;
    y[p] = xat(0) + dn;
  }
}

// One pass, one block per (run, i-plane).
template <class T, int R, int NF>
__global__ void __launch_bounds__(kMarch, march_blocks<T, R, NF>())
march_kernel(const T* __restrict__ C, const T* x, const T* __restrict__ b,
             const T* __restrict__ binv, T* d, T s0, T s1, T* y, int pass,
             Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  march<T, R, NF, kCopy, true>(C, x, b, binv, d, T(0), s0, s1, y, pass,
                               g, blockIdx.x % g.runs, blockIdx.x / g.runs,
                               reinterpret_cast<T*>(smem_raw));
}

// The same pass with the per-field staging (2-3 fields).
template <class T, int R, int NF>
__global__ void __launch_bounds__(kMarch, march_blocks<T, R, NF>())
march_pf_kernel(const T* __restrict__ C, const T* x, const T* __restrict__ b,
                const T* __restrict__ binv, T* d, T s0, T s1, T* y, int pass,
                Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  march<T, R, NF, kCopy, true, true>(C, x, b, binv, d, T(0), s0, s1, y, pass,
                                     g, blockIdx.x % g.runs,
                                     blockIdx.x / g.runs,
                                     reinterpret_cast<T*>(smem_raw));
}

// y = omega Binv b: one sweep from zero, one thread per point; d, when not
// null, gets the same values (the first Chebyshev direction).
template <class T, int NF>
__global__ void march_zero_kernel(const T* __restrict__ binv,
                                  const T* __restrict__ b, T omega, T* y,
                                  T* d, int64_t plane) {
  const int64_t p = (int64_t)blockIdx.x * kMarch + threadIdx.x;
  if (p >= plane) return;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const T v = from_zero<T, NF>(binv, b, omega, plane, p, f);
    y[f * plane + p] = v;
    if (d != nullptr) d[f * plane + p] = v;
  }
}

// the sweep from zero on n points (every radius: it reads no plane)
template <class T, int NF>
int launch_zero(const void* binv, const void* b, double omega0, void* y,
                void* d, int64_t n, cudaStream_t stream) {
  march_zero_kernel<T, NF>
      <<<(unsigned)((n + kMarch - 1) / kMarch), kMarch, 0, stream>>>(
          (const T*)binv, (const T*)b, (T)omega0, (T*)y, (T*)d, n);
  return (int)cudaGetLastError();
}

// The coefficients of a level's smoothing steps: step s is a sweep with
// omega = s0[s], or a Chebyshev step with (s0, s1)[s] (s1[0] = 0).
struct Steps {
  double s0[kMaxSteps], s1[kMaxSteps];
};

// A level's smoothing call in one cooperative launch, one block per (run,
// i-plane): `sweeps` steps from x (x null: from zero; the first step is
// then omega0 = s0[0] Binv b, folded into the next pass's staging, and with
// sweeps == 1 written to out), the last written to out, the others
// ping-ponged between tmp and out; then res = b - A out when res is not
// null. A grid barrier separates passes. The pass sequence is the one the
// per-pass route launches.
template <class T, int R, int NF>
__global__ void __launch_bounds__(kMarch, march_blocks<T, R, NF>(56))
march_level_kernel(const T* __restrict__ C, const T* __restrict__ binv,
                   const T* __restrict__ b, const T* x, T* d, T* out, T* tmp,
                   T* res, int sweeps, int cheb, Steps st, Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int run = blockIdx.x % g.runs;
  const int i = blockIdx.x / g.runs;
  const int pass = cheb ? kCheb : kSweep;
  const T omega0 = (T)st.s0[0];
  const T* cur = x;
  int k = 0;
  if (x == nullptr) {
    const int q = run * g.tp + threadIdx.x;
    if (sweeps == 1 && threadIdx.x < g.tp && q < g.npl) {
      const int64_t p = (int64_t)i * g.npl + q;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        out[f * g.plane + p] =
            from_zero<T, NF>(binv, b, omega0, g.plane, p, f);
      }
    }
    k = 1;
  }
  for (; k < sweeps; ++k) {
    T* dst = ((sweeps - 1 - k) & 1) ? tmp : out;
    if (cur == nullptr) {
      march<T, R, NF, kFromZero, false>(C, cur, b, binv, d, omega0,
                                        (T)st.s0[k], (T)st.s1[k], dst, pass,
                                        g, run, i, sm);
    } else {
      march<T, R, NF, kCopy, false>(C, cur, b, binv, d, omega0, (T)st.s0[k],
                                    (T)st.s1[k], dst, pass, g, run, i, sm);
    }
    cur = dst;
    if (k + 1 < sweeps || res != nullptr) cg::this_grid().sync();
  }
  if (res != nullptr) {
    if (cur == nullptr) {
      march<T, R, NF, kFromZero, false>(C, cur, b, binv, nullptr, omega0,
                                        T(0), T(0), res, kResidual, g, run,
                                        i, sm);
    } else {
      march<T, R, NF, kCopy, false>(C, cur, b, binv, nullptr, omega0, T(0),
                                    T(0), res, kResidual, g, run, i, sm);
    }
  }
}

// Per instance: the dynamic shared memory limit raised once, and the
// resident blocks per SM of each kernel at a given shared memory size.
template <class T, int R, int NF>
cudaError_t prepare() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady) {
    int dev = 0, optin = 0;
    done = cudaGetDevice(&dev);
    if (done == cudaSuccess) {
      done = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (done == cudaSuccess) {
      done = cudaFuncSetAttribute(march_kernel<T, R, NF>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin);
    }
    if (done == cudaSuccess) {
      done = cudaFuncSetAttribute(march_level_kernel<T, R, NF>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin);
    }
    if constexpr (NF > 1) {
      if (done == cudaSuccess) {
        done = cudaFuncSetAttribute(
            march_pf_kernel<T, R, NF>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      }
    }
  }
  return done;
}

// how a block reads the x planes (the plan's out[3]): it stages every
// field's at once, or one field's at a time (2-3 fields), or none, x read
// through the read-only cache (kUnstaged: the runtime-radius kernel's
// route, at every radius from 5 and for the lattices whose planes a block
// cannot stage)
enum Staging { kAllFields = 0, kPerField = 1, kUnstaged = 2 };

// (the level launch stages every field)
template <class T, int R, int NF>
cudaError_t blocks_per_sm(bool level, size_t smem, int* out,
                          int staging = kAllFields) {
  cudaError_t e = prepare<T, R, NF>();
  if (e != cudaSuccess) return e;
  if constexpr (NF > 1) {
    if (staging == kPerField && !level) {
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, march_pf_kernel<T, R, NF>, kMarch, smem);
    }
  }
  return level ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     out, march_level_kernel<T, R, NF>, kMarch, smem)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     out, march_kernel<T, R, NF>, kMarch, smem);
}

int device_attribute(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&value, attr, dev) != cudaSuccess) {
    return 0;
  }
  return value;
}

int sm_count() {
  static const int sms = device_attribute(cudaDevAttrMultiProcessorCount);
  return sms;
}

// The measured rule of a level's one launch (the plan's out[1], at every
// radius, where the level's blocks are all co-resident): the level's
// coefficients in the lattice (nF^2 words of `word` bytes for each tap
// whose x lies in it, summed over the points) fit the card's L2. The
// V-cycle makes its smoothing calls eagerly, and eagerly (host ms a call,
// back to back, the host's launch work included) the call in one launch
// was faster than its passes at every level swept whose coefficients fit
// the L2 (H100, 50 MB; tests/compare_stencil3d.py --calls, the V-cycle's
// two calls, 2 steps from zero + residual / 2 steps from x): 3 x 13^3 f32
// r = 2 0.44 / 0.83 of the passes' time, 2 x 25^3 f32 (27 MB) 0.50 / 0.62,
// 27^3 f32 r = 2 0.36 / 0.38, 33^3 f32 r = 3 (42 MB) 0.54 / 0.91, 17^3 f64
// r = 4 0.36 / 0.59, 17^3 r = 5 0.73 / 0.94 in f64 and 0.52 / 0.31 in
// f32 (march_rn_level_kernel); and no faster above it,
// where the passes stream the planes from memory at every pass either way
// (3 x 25^3 f32, 61 MB, 0.86 / 1.02; 33^3 f64 r = 3, 84 MB, 0.87 / 1.04;
// 3 x 25^3 f64 121 MB 1.05 / 1.02; 33^3 f64 r = 4, 170 MB, 1.01 / 1.02;
// 3 x 17^3 and 3 x 19^3 f64 r = 4 1.05 / 1.01, 1.04 / 1.02). In a CUDA
// graph (device time alone) the one launch was slower at every shape, by
// 1-24% at r <= 4 (its barriers, and its occupancy below the pass
// kernel's) and by 40% at 17^3 f64 r = 5 (3% in f32), so the rule rests on
// the eager time the V-cycle pays: whole V-cycles made eagerly ran faster
// planned than with every level one launch a pass on every 3D path
// (medians of three pairs: 3D elasticity 9.99 against 10.12 ms, Poisson
// 2.71 / 2.76, biharmonic 3.00 / 3.06, the cubic 33^3 1.29 / 1.41, the
// quartic 2.41 / 2.64, f32 2.26 / 2.36; --vcycles).
inline bool level_pays(int nx, int ny, int nz, int r, int nf, int word) {
  static const int l2 = device_attribute(cudaDevAttrL2CacheSize);
  // taps of an axis of n points in the lattice, summed over its points
  auto axis = [r](int n) {
    double t = 0.0;
    for (int i = 0; i < n; ++i) {
      t += (i + r < n - 1 ? i + r : n - 1) - (i - r > 0 ? i - r : 0) + 1;
    }
    return t;
  };
  return axis(nx) * axis(ny) * axis(nz) * nf * nf * word <= (double)l2;
}

// One resident block per SM for the instances whose point streams at least
// 1,000 coefficient planes (nF = 3, r = 2: 1,125), on levels whose blocks
// make three waves of one: at two blocks per SM the 3 x 97^3 passes ran at
// 1.550 ms, at one 1.441 (H100); the 3 x 25^3 level, one wave, ran slower
// at one. The launch asks for more than half an SM's shared memory.
template <class T, int R, int NF>
bool one_block_per_sm(int64_t blocks) {
  return NF * NF * (2 * R + 1) * (2 * R + 1) * (2 * R + 1) >= 1000 &&
         blocks >= 3 * (int64_t)sm_count();
}

size_t one_block_smem() {
  static const size_t bytes =
      (size_t)device_attribute(cudaDevAttrMaxSharedMemoryPerMultiprocessor) /
          2 + 1;
  return bytes;
}

// plan's answer where a block cannot stage the 2r+1 x planes of even one
// field at split 1 (f64 r = 4 with one field from about 313 points a row,
// where the planes alone would be 179 GB; a long k row at any radius);
// larger splits stage fewer rows. The public stencil3d_plan then answers
// the unstaged route of march_rn_kernel (plan_rn).
constexpr int kPlanTooWide = -2;

// The plan of one level shape (out[0..3]): split, whether the level's
// smoothing call is one launch (1) or one launch per pass (0), the
// co-resident blocks of the level launch, and the staging (kAllFields, or
// kPerField where a block cannot hold the 2r+1 planes of every field at
// split 1: f64 r = 4 with three fields from 73 points a row on, two fields
// from about 125; f64 r = 3 with three fields from about 144; on an H100's
// 227 KB a block). A per-field lattice takes one launch a pass: its
// (run, plane) blocks outnumber by far those the card holds at once, which
// a level launch needs (and the level launch stages every field). From
// the sweep of every split at
// the 3D paths' level shapes on an H100 (tests/compare_stencil3d.py
// --sweep):
// * split: the smallest power of two whose (run, plane) blocks fill half
//   the card's resident blocks, and at most what leaves each thread
//   `trips` trips (a thread with fewer in flight only adds a reduction):
//   3 x 13^3 took 0.0061 ms at split 8 against 0.0094 at 16 and 0.0144 at
//   1, 17^3 f64 0.0069 at 4 against 0.0073 at 8;
// * a level launch, which needs every block co-resident, where the blocks
//   fit and level_pays (the rule and its data are there; it gives the
//   scalar f32 r <= 2 instances' 27^3 level one launch too, 0.36 of its
//   passes' eager time, though by device time alone one launch a pass
//   was faster there: 0.0113 ms against 0.0141 after two steps). Blocks that walked two planes to make a larger
//   level fit were slower than one launch a pass (f64 r = 3 at 33^3:
//   0.0916 ms against 0.0808), so a block takes one plane.
template <class T, int R, int NF>
int plan(int nx, int ny, int nz, int* out) {
  const int sms = sm_count();
  if (sms == 0) return -1;
  const int per_thread =
      cdiv(NF * (2 * R + 1) * (NF / trip_fields<T, R, NF>()) *
               ((2 * R + 1) / trip_rows<T, R>()),
           trips<T, R, NF>());
  const size_t optin =
      (size_t)device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const Geom g1 = make_geom(nx, ny, nz, 1, R);
  int staging = kAllFields;
  if (smem_bytes<T, R, NF>(g1) > optin) {
    if (NF == 1 || smem_bytes<T, R, NF>(g1, 1) > optin) return kPlanTooWide;
    staging = kPerField;
  }
  const int staged = staging == kPerField ? 1 : NF;
  int split = 1;
  for (;;) {
    const Geom g = make_geom(nx, ny, nz, split, R);
    int per_sm = 0;
    if (blocks_per_sm<T, R, NF>(false, smem_bytes<T, R, NF>(g, staged),
                                &per_sm, staging) != cudaSuccess ||
        per_sm == 0) {
      return -1;
    }
    if (2 * (int64_t)g.runs * nx >= (int64_t)sms * per_sm ||
        2 * split > per_thread || split == 16) {
      break;
    }
    split *= 2;
  }
  const Geom g = make_geom(nx, ny, nz, split, R);
  int level_sm = 0;
  if (staging == kAllFields &&
      blocks_per_sm<T, R, NF>(true, smem_bytes<T, R, NF>(g), &level_sm) !=
          cudaSuccess) {
    return -1;
  }
  const int level_cap = sms * level_sm;
  out[0] = split;
  out[1] = (int64_t)g.runs * nx <= level_cap &&
           level_pays(nx, ny, nz, R, NF, sizeof(T));
  out[2] = level_cap;
  out[3] = staging;
  return 0;
}

bool valid_staging(int staging, int nf) {
  return staging == kAllFields || (staging == kPerField && nf > 1);
}

bool valid_split(int split) {
  return split == 1 || split == 2 || split == 4 || split == 8 ||
         split == 16;
}

template <class T, int R, int NF>
int launch_pass(const void* C, const void* x, const void* b,
                const void* binv, void* d, double omega0, double s0,
                double s1, void* y, int nx, int ny, int nz, int pass,
                int split, int staging, cudaStream_t stream) {
  if (pass == kZero) {
    return launch_zero<T, NF>(binv, b, omega0, y, d,
                              (int64_t)nx * ny * nz, stream);
  }
  if (!valid_split(split) || !valid_staging(staging, NF) || pass < kApply ||
      pass > kCheb || (pass == kCheb && NF != 1) || x == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const Geom g = make_geom(nx, ny, nz, split, R);
  cudaError_t e = prepare<T, R, NF>();
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (int64_t)g.runs * nx;
  size_t smem = smem_bytes<T, R, NF>(g, staging == kPerField ? 1 : NF);
  if (one_block_per_sm<T, R, NF>(blocks) && smem < one_block_smem()) {
    smem = one_block_smem();
  }
  if constexpr (NF > 1) {
    if (staging == kPerField) {
      march_pf_kernel<T, R, NF><<<(unsigned)blocks, kMarch, smem, stream>>>(
          (const T*)C, (const T*)x, (const T*)b, (const T*)binv, (T*)d,
          (T)s0, (T)s1, (T*)y, pass, g);
      return (int)cudaGetLastError();
    }
  }
  march_kernel<T, R, NF><<<(unsigned)blocks, kMarch, smem, stream>>>(
      (const T*)C, (const T*)x, (const T*)b, (const T*)binv, (T*)d, (T)s0,
      (T)s1, (T*)y, pass, g);
  return (int)cudaGetLastError();
}

template <class T, int R, int NF>
int launch_level(const void* C, const void* binv, const void* b,
                 const void* x, void* d, void* out, void* tmp, void* res,
                 const double* s0, const double* s1, int sweeps, int cheb,
                 int nx, int ny, int nz, int split, cudaStream_t stream) {
  if (!valid_split(split) || sweeps < 1 || sweeps > kMaxSteps ||
      (cheb && NF != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geom g = make_geom(nx, ny, nz, split, R);
  const size_t smem = smem_bytes<T, R, NF>(g);
  int per_sm = 0;
  cudaError_t e = blocks_per_sm<T, R, NF>(true, smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  if ((int64_t)g.runs * nx > (int64_t)sm_count() * per_sm) {
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  Steps st = {};
  for (int s = 0; s < sweeps; ++s) {
    st.s0[s] = s0[s];
    st.s1[s] = s1[s];
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(g.runs * nx);
  cfg.blockDim = dim3(kMarch);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, march_level_kernel<T, R, NF>, (const T*)C, (const T*)binv,
      (const T*)b, (const T*)x, (T*)d, (T*)out, (T*)tmp, (T*)res, sweeps,
      cheb, st, g);
}


// -- the runtime-radius marching kernel ---------------------------------------
//
// march_rn_kernel is the marching design with the radius r a kernel
// argument, instantiated in csrc/stencil3d_rn.cu alone: every pass at every
// radius from 5 (the quartic background's 1,331 taps and up), and, at
// r = 1-4, the lattices whose x planes a block cannot stage. It replaced a
// one-thread-a-point kernel (blocks of 64, two coefficient loads in
// flight a thread: 0.32 of bound in f64 and 0.17 in f32 at 33^3, r = 5,
// on an H100, and 2.4-3.0x slower than cuSPARSE's SpMV on the same
// operator), latency-bound: 35,937 threads at 33^3 keep about 0.6 MB of
// loads in flight where 3.35 TB/s at the card's memory latency needs about
// 2 MB. So, as the fixed-radius kernel does:
//
// * a block owns a run of tp = 256 / split consecutive points of one
//   i-plane's flattened (j, k) plane; a run's coefficient reads are one
//   coalesced stretch of each plane;
// * a trip is one tap row (f2, oi, oj): its m = 2r+1 taps along ok for
//   every output field; trip t = (f2 m + oi) m + oj, nF m^2 of them; split
//   threads share a point, thread s taking the trips t = s mod split;
// * the taps in the lattice alone: a trip whose x plane, or whose row for
//   every point of the run, lies outside the lattice is skipped, and a tap
//   outside reads neither its coefficient nor x (march's padding skip);
// * a thread keeps rn_trips trips in flight, issuing kRnChunk taps of each
//   (nF rn_trips kRnChunk coefficient loads: a whole row at r <= 5) before
//   their multiply-adds; a trip sums into its own accumulators from zero
//   and is added to the point's in trip order, so the sums do not depend on
//   which trips travel together, nor on the trips skipped (each would add
//   zeros);
// * the partial sums of a point's split threads meet in shared memory and
//   split 0 adds them in split order: no atomics, a run repeats bitwise;
// * x is read through the read-only cache, not staged: with whole rows of
//   taps in flight the staged x planes (each field's 2r+1 planes with r
//   rows and columns of halo, copied by cp.async, a barrier between fields)
//   ran slower at every shape measured (a sweep pass at r = 5, at the best
//   split of each: f64 33^3 0.1162 ms against 0.1190 staged, f32 0.0724
//   against 0.0796, f64 17^3 0.0158 against 0.0180, three fields at
//   3 x 17^3 0.1302 against 0.1400; tests/compare_stencil3d.py --sweep,
//   H100), and unstaged a block needs no room for x, so every lattice fits.
//
// At r = 1-4 the fixed-radius plan sends here the lattices whose x planes
// a block cannot stage (kPlanTooWide: f64 r = 4 from about 313-point
// rows, long k rows at any radius), never to a plain version; a level's
// smoothing call there is one launch a pass. From r = 5 a level's call is
// one cooperative launch of march_rn_level_kernel where the plan says so
// (the same body, x read through the L2 instead of the read-only cache).

constexpr int kRnChunk = 12;  // taps of a trip issued together

// Trips a thread keeps in flight, and the resident blocks per SM asked of
// the compiler: one field, one trip and 3 blocks (at most 85 registers;
// f64 takes 80); 2-3 fields, two trips and 1 block (the three-field f64
// instance takes 250 registers). At 3 x 17^3, r = 5, f64 the sweep pass
// ran 0.1302 ms at split 8 against 0.1346 with one trip and 2 blocks
// (H100); one field with two trips and one block ran 0.1315 ms at 33^3
// against 0.1162.
template <int NF>
__host__ __device__ constexpr int rn_trips() {
  return NF == 1 ? 1 : 2;
}
template <int NF>
__host__ __device__ constexpr int rn_blocks() {
  return NF == 1 ? 3 : 1;
}

// x at p: through the read-only cache (ld.global.nc) in a pass launch; in
// a level's launch (LEVEL) by a coherent ld.global, since x there is what
// other blocks of the same launch wrote before the last grid barrier: the
// read-only cache is not coherent with those writes, while the barrier's
// fence orders them before a plain load (which, unlike ld.global.cg, keeps
// the L1 hits of the taps that share an x: 1.4x the device time of the
// passes at 17^3, r = 5, through the L2 alone, on an H100).
template <bool LEVEL, class T>
__device__ __forceinline__ T ld_x(const T* p) {
  if constexpr (LEVEL) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// One pass (apply, residual, sweep, Chebyshev step) at radius r over the
// block's run on plane i, x read through ld_x: the body of march_rn_kernel
// and march_rn_level_kernel. All threads of the block call it. The
// epilogue is march's. (g by value: taken by reference, march_rn_kernel's
// registers moved, 162 -> 168 in f32 with three fields.)
template <class T, int NF, bool LEVEL>
__device__ __forceinline__ void march_rn(
    const T* __restrict__ C, const T* x, const T* __restrict__ b,
    const T* __restrict__ binv, T* d, T s0, T s1, T* y, int pass,
    Geom g, int r) {
  __shared__ T red[NF * kMarch];   // the split's partial sums
  constexpr int TR = rn_trips<NF>();
  constexpr int KC = kRnChunk;
  const int m = 2 * r + 1;
  const int mm = m * m;
  const int64_t plane = g.plane;
  const int64_t m3p = (int64_t)mm * m * plane;   // from f2 to f2 + 1
  const int run = blockIdx.x % g.runs;
  const int i = blockIdx.x / g.runs;
  const int s = threadIdx.x / g.tp;
  const int pl = threadIdx.x - s * g.tp;
  const int q0 = run * g.tp;
  const int q = q0 + pl;
  const bool valid = q < g.npl;
  const int jf = q0 / g.nz;
  const int j = q / g.nz;
  const int k = q - j * g.nz;
  const int64_t p = (int64_t)i * g.npl + q;
  // the point's b, Binv and d, loaded before the stream (march's EARLY)
  T b1 = T(0), i1 = T(0), d1 = T(0);
  if (NF == 1 && s == 0 && valid) {
    if (pass != kApply) b1 = __ldg(b + p);
    if (pass == kSweep || pass == kCheb) i1 = __ldg(binv + p);
    if (pass == kCheb && s1 != T(0)) d1 = d[p];
  }
  // the x planes in the lattice, oi_lo .. oi_hi (the same for the block),
  // and the rows of the run's points, jf .. jl
  const int oi_lo = r - i > 0 ? r - i : 0;
  const int oi_hi = g.nx - 1 - i + r < m - 1 ? g.nx - 1 - i + r : m - 1;
  const int jl = ((q0 + g.tp < g.npl ? q0 + g.tp : g.npl) - 1) / g.nz;
  auto live = [&](int tu) {
    const int oj = tu % m;
    const int oi = tu / m % m;
    return oi >= oi_lo && oi <= oi_hi && jl + oj - r >= 0 &&
           jf + oj - r < g.ny;
  };
  auto next_live = [&](int t) {
    while (t < NF * mm && !live(t)) t += g.split;
    return t;
  };

  T acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = T(0);
  // the thread's live trips among s, s + split, ..., rn_trips at a time
  int t = next_live(s);
#pragma unroll 1
  while (valid && t < NF * mm) {
    const T* cq[TR];
    const T* xw[TR];
    bool live_u[TR], rowin[TR];
    T a[TR][NF];
    int tu = t;
#pragma unroll
    for (int u = 0; u < TR; ++u) {
      if (u > 0) tu = next_live(tu + g.split);
      live_u[u] = tu < NF * mm;
      const int tt = live_u[u] ? tu : t;
      const int oj = tt % m;
      const int fo = tt / m;
      const int oi = fo % m;
      const int f2 = fo / m;
      const int gj = j + oj - r;
      rowin[u] = live_u[u] && gj >= 0 && gj < g.ny;
      cq[u] = C + f2 * m3p + (int64_t)((oi * m + oj) * m) * plane + p;
      xw[u] = x + f2 * plane +
              (rowin[u] ? ((int64_t)(i + oi - r) * g.ny + gj) * g.nz + k - r
                        : 0);
#pragma unroll
      for (int f = 0; f < NF; ++f) a[u][f] = T(0);
    }
    t = next_live(tu + g.split);
#pragma unroll 1
    for (int ok0 = 0; ok0 < m; ok0 += KC) {
      T cv[TR][NF][KC], xv[TR][KC];
#pragma unroll
      for (int u = 0; u < TR; ++u) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int ok = ok0 + c;
          const bool in = rowin[u] && ok < m &&
                          (unsigned)(k - r + ok) < (unsigned)g.nz;
          xv[u][c] = in ? ld_x<LEVEL>(xw[u] + ok) : T(0);
#pragma unroll
          for (int f1 = 0; f1 < NF; ++f1) {
            cv[u][f1][c] =
                ldg_if(cq[u] + f1 * NF * m3p + (int64_t)ok * plane, in);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < TR; ++u) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (ok0 + c < m) {
#pragma unroll
            for (int f1 = 0; f1 < NF; ++f1) {
              a[u][f1] = fma_t(cv[u][f1][c], xv[u][c], a[u][f1]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < TR; ++u) {
      if (live_u[u]) {
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[f] += a[u][f];
      }
    }
  }
  if (g.split > 1) {
    // the other splits' partial sums, added by split 0 in split order
    if (s > 0) {
#pragma unroll
      for (int f = 0; f < NF; ++f) red[(s * NF + f) * g.tp + pl] = acc[f];
    }
    __syncthreads();
    if (s == 0) {
      for (int s2 = 1; s2 < g.split; ++s2) {
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[f] += red[(s2 * NF + f) * g.tp + pl];
      }
    }
  }
  if (s != 0 || !valid) return;
  if (pass == kApply) {
#pragma unroll
    for (int f = 0; f < NF; ++f) y[f * plane + p] = acc[f];
  } else if (pass == kResidual && NF == 1) {
    y[p] = b1 - acc[0];
  } else if (pass == kResidual) {
#pragma unroll
    for (int f = 0; f < NF; ++f) y[f * plane + p] = b[f * plane + p] - acc[f];
  } else if (pass == kSweep && NF == 1) {
    y[p] = ld_x<LEVEL>(x + p) + s0 * (i1 * (b1 - acc[0]));
  } else if (pass == kSweep) {
    T res[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) res[f] = b[f * plane + p] - acc[f];
#pragma unroll
    for (int f1 = 0; f1 < NF; ++f1) {
      T v = T(0);
#pragma unroll
      for (int f2 = 0; f2 < NF; ++f2) {
        v = fma_t(binv[(int64_t)(f1 * NF + f2) * plane + p], res[f2], v);
      }
      y[f1 * plane + p] = ld_x<LEVEL>(x + f1 * plane + p) + s0 * v;
    }
  } else if (pass == kCheb) {
    const T res = i1 * (b1 - acc[0]);
    const T dn = s1 != T(0) ? fma_t(s0, res, s1 * d1) : s0 * res;
    d[p] = dn;
    y[p] = ld_x<LEVEL>(x + p) + dn;
  }
}

// One pass at radius r, one block per (run, i-plane), x read through the
// read-only cache.
template <class T, int NF>
__global__ void __launch_bounds__(kMarch, rn_blocks<NF>())
march_rn_kernel(const T* __restrict__ C, const T* __restrict__ x,
                const T* __restrict__ b, const T* __restrict__ binv, T* d,
                T s0, T s1, T* y, int pass, Geom g, int r) {
  march_rn<T, NF, false>(C, x, b, binv, d, s0, s1, y, pass, g, r);
}

// A level's smoothing call at radius r in one cooperative launch, one
// block per (run, i-plane): the passes of the per-pass route (launch_zero
// and launch_pass_rn), in order, a grid barrier between them. From zero
// (x null) the first step, omega0 = s0[0] Binv b (and d, when not null),
// is a phase of its own written to memory before the first barrier, as
// march_zero_kernel writes it: with x unstaged there is no staging to fold
// it into. Then the other steps, the last written to out and the others
// ping-ponged between tmp and out, then res = b - A out when res is not
// null. Each pass runs march_rn on the same points at the same split as
// its own launch, so the two routes agree bitwise. x, out, tmp and d are
// read by coherent loads (ld_x<true>; d by the thread that wrote it, none
// of them __restrict__); only C, b and Binv, which no pass writes, go
// through the read-only cache.
template <class T, int NF>
__global__ void __launch_bounds__(kMarch, rn_blocks<NF>())
march_rn_level_kernel(const T* __restrict__ C, const T* __restrict__ binv,
                      const T* __restrict__ b, const T* x, T* d, T* out,
                      T* tmp, T* res, int sweeps, int cheb, Steps st, Geom g,
                      int r) {
  const int run = blockIdx.x % g.runs;
  const int i = blockIdx.x / g.runs;
  const int pass = cheb ? kCheb : kSweep;
  const T* cur = x;
  int k = 0;
  if (x == nullptr) {
    T* dst = ((sweeps - 1) & 1) ? tmp : out;
    const int q = run * g.tp + threadIdx.x;
    if (threadIdx.x < g.tp && q < g.npl) {
      const int64_t p = (int64_t)i * g.npl + q;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const T v = from_zero<T, NF>(binv, b, (T)st.s0[0], g.plane, p, f);
        dst[f * g.plane + p] = v;
        if (d != nullptr) d[f * g.plane + p] = v;
      }
    }
    cur = dst;
    k = 1;
    if (sweeps > 1 || res != nullptr) cg::this_grid().sync();
  }
  for (; k < sweeps; ++k) {
    T* dst = ((sweeps - 1 - k) & 1) ? tmp : out;
    march_rn<T, NF, true>(C, cur, b, binv, d, (T)st.s0[k], (T)st.s1[k], dst,
                          pass, g, r);
    cur = dst;
    if (k + 1 < sweeps || res != nullptr) cg::this_grid().sync();
  }
  if (res != nullptr) {
    march_rn<T, NF, true>(C, cur, b, binv, nullptr, T(0), T(0), res,
                          kResidual, g, r);
  }
}

// The plan of a level shape at radius r for march_rn_kernel (out[0..3] as
// plan's; out[3] kUnstaged). The split: the smallest up to 16 whose (run,
// plane) blocks make kRnWaves waves of the card's resident blocks, else
// the one up to 16 that fills whole waves best. A sweep pass at r = 5
// (tests/compare_stencil3d.py --sweep, H100; the plan's split within 3% of
// the best at each): f64 at 33^3 split 8 (2.9 waves) 0.1162 ms, 0.1291 at
// 2 (0.75 of one); f32 8 (2.2) 0.0724; 17^3 16 (0.82 of one) 0.0158; three
// fields (one block an SM) 3 x 17^3 16 (0.82 of three) 0.1343 against
// 0.1302 at 8, 3 x 33^3 2 (2.25) 1.020 against 1.008 at 8. Splits above
// 16 ran slower at every shape. The level launch (out[1]) at the same
// split where its blocks are all co-resident and level_pays.
constexpr int kRnWaves = 2;

// Blocks of march_rn_level_kernel<T, NF> the card holds at once, asked
// once per instance (the devices of one process are taken to be alike).
template <class T, int NF>
cudaError_t rn_level_capacity(int* capacity) {
  static int cached = 0;
  if (cached == 0) {
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, march_rn_level_kernel<T, NF>, kMarch, 0);
    if (e != cudaSuccess) return e;
    cached = sm_count() * per_sm;
  }
  *capacity = cached;
  return cudaSuccess;
}

template <class T, int NF>
int plan_rn(int nx, int ny, int nz, int r, int* out) {
  const int sms = sm_count();
  if (sms == 0) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, march_rn_kernel<T, NF>, kMarch, 0) != cudaSuccess ||
      per_sm == 0) {
    return -1;
  }
  const int64_t slots = (int64_t)sms * per_sm;
  int best = 0;
  double fill = -1.0;
  for (int split = 1; split <= 16; split *= 2) {
    const int64_t blocks = (int64_t)make_geom(nx, ny, nz, split, r).runs * nx;
    if (blocks >= kRnWaves * slots) {
      best = split;
      break;
    }
    const double f =
        (double)blocks / (double)(((blocks + slots - 1) / slots) * slots);
    if (f > fill) {
      fill = f;
      best = split;
    }
  }
  // the level launch: from r = 5 (below it the lattices planned here are
  // those too wide to stage, whose level calls take one launch a pass)
  int level_cap = 0;
  if (r >= 5 && (rn_level_capacity<T, NF>(&level_cap) != cudaSuccess ||
                 level_cap == 0)) {
    return -1;
  }
  const int64_t blocks = (int64_t)make_geom(nx, ny, nz, best, r).runs * nx;
  out[0] = best;
  out[1] = r >= 5 && blocks <= level_cap &&
           level_pays(nx, ny, nz, r, NF, sizeof(T));
  out[2] = level_cap;
  out[3] = kUnstaged;
  return 0;
}

template <class T, int NF>
int launch_pass_rn(const void* C, const void* x, const void* b,
                   const void* binv, void* d, double omega0, double s0,
                   double s1, void* y, int nx, int ny, int nz, int r,
                   int pass, int split, int staging, cudaStream_t stream) {
  if (pass == kZero) {
    return launch_zero<T, NF>(binv, b, omega0, y, d,
                              (int64_t)nx * ny * nz, stream);
  }
  if (!valid_split(split) || pass < kApply || pass > kCheb ||
      (pass == kCheb && NF != 1) || x == nullptr || staging != kUnstaged) {
    return (int)cudaErrorInvalidValue;
  }
  const Geom g = make_geom(nx, ny, nz, split, r);
  march_rn_kernel<T, NF>
      <<<(unsigned)((int64_t)g.runs * nx), kMarch, 0, stream>>>(
          (const T*)C, (const T*)x, (const T*)b, (const T*)binv, (T*)d,
          (T)s0, (T)s1, (T*)y, pass, g, r);
  return (int)cudaGetLastError();
}

// stencil3d_level at a runtime radius r >= 5: march_rn_level_kernel, whose
// blocks must all be co-resident (else refused, as launch_level).
template <class T, int NF>
int launch_level_rn(const void* C, const void* binv, const void* b,
                    const void* x, void* d, void* out, void* tmp, void* res,
                    const double* s0, const double* s1, int sweeps, int cheb,
                    int nx, int ny, int nz, int r, int split,
                    cudaStream_t stream) {
  if (!valid_split(split) || sweeps < 1 || sweeps > kMaxSteps ||
      (cheb && NF != 1) || r < 5) {
    return (int)cudaErrorInvalidValue;
  }
  const Geom g = make_geom(nx, ny, nz, split, r);
  int capacity = 0;
  const cudaError_t e = rn_level_capacity<T, NF>(&capacity);
  if (e != cudaSuccess) return (int)e;
  if ((int64_t)g.runs * nx > capacity) {
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  Steps st = {};
  for (int s = 0; s < sweeps; ++s) {
    st.s0[s] = s0[s];
    st.s1[s] = s1[s];
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(g.runs * nx);
  cfg.blockDim = dim3(kMarch);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, march_rn_level_kernel<T, NF>, (const T*)C, (const T*)binv,
      (const T*)b, (const T*)x, (T*)d, (T*)out, (T*)tmp, (T*)res, sweeps,
      cheb, st, g, r);
}

// stencil3d_plan and stencil3d_pass at a runtime radius r >= 1
template <class T>
int plan_entry_rn(int nx, int ny, int nz, int radius, int nf, int* out) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || radius < 1) return -1;
  switch (nf) {
    case 1: return plan_rn<T, 1>(nx, ny, nz, radius, out);
    case 2: return plan_rn<T, 2>(nx, ny, nz, radius, out);
    case 3: return plan_rn<T, 3>(nx, ny, nz, radius, out);
  }
  return -1;
}

template <class T>
int level_entry_rn(const void* C, const void* binv, const void* b,
                   const void* x, void* d, void* out, void* tmp, void* res,
                   const double* s0, const double* s1, int sweeps, int cheb,
                   int nx, int ny, int nz, int radius, int nf, int split,
                   void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define CALL_RN(NF)                                                          \
  launch_level_rn<T, NF>(C, binv, b, x, d, out, tmp, res, s0, s1, sweeps,    \
                         cheb, nx, ny, nz, radius, split, st)
  switch (nf) {
    case 1: return CALL_RN(1);
    case 2: return CALL_RN(2);
    case 3: return CALL_RN(3);
  }
#undef CALL_RN
  return (int)cudaErrorInvalidValue;
}

template <class T>
int pass_entry_rn(const void* C, const void* x, const void* b,
                  const void* binv, void* d, double omega0, double s0,
                  double s1, void* y, int nx, int ny, int nz, int radius,
                  int nf, int pass, int split, int staging, void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || radius < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
#define CALL_RN(NF)                                                          \
  launch_pass_rn<T, NF>(C, x, b, binv, d, omega0, s0, s1, y, nx, ny, nz,     \
                        radius, pass, split, staging, st)
  switch (nf) {
    case 1: return CALL_RN(1);
    case 2: return CALL_RN(2);
    case 3: return CALL_RN(3);
  }
#undef CALL_RN
  return (int)cudaErrorInvalidValue;
}

// The entries' bodies for one scalar type T and the radii LO..HI, by
// (radius, fields): each source that includes this header instantiates
// them for its own type and radii (STENCIL3D_ENTRIES), so the instances
// compile in parallel; a radius outside LO..HI is refused.
#define CASE3_T(T, LO, HI, R, NF, CALL)                              \
  if constexpr (LO <= R && R <= HI) return CALL(T, R, NF);           \
  else return (int)cudaErrorInvalidValue;
#define DISPATCH3_T(T, LO, HI, radius, nf, CALL)                     \
  switch ((radius) * 10 + (nf)) {                                    \
    case 11: { CASE3_T(T, LO, HI, 1, 1, CALL) }                      \
    case 12: { CASE3_T(T, LO, HI, 1, 2, CALL) }                      \
    case 13: { CASE3_T(T, LO, HI, 1, 3, CALL) }                      \
    case 21: { CASE3_T(T, LO, HI, 2, 1, CALL) }                      \
    case 22: { CASE3_T(T, LO, HI, 2, 2, CALL) }                      \
    case 23: { CASE3_T(T, LO, HI, 2, 3, CALL) }                      \
    case 31: { CASE3_T(T, LO, HI, 3, 1, CALL) }                      \
    case 32: { CASE3_T(T, LO, HI, 3, 2, CALL) }                      \
    case 33: { CASE3_T(T, LO, HI, 3, 3, CALL) }                      \
    case 41: { CASE3_T(T, LO, HI, 4, 1, CALL) }                      \
    case 42: { CASE3_T(T, LO, HI, 4, 2, CALL) }                      \
    case 43: { CASE3_T(T, LO, HI, 4, 3, CALL) }                      \
    default: return (int)cudaErrorInvalidValue;                      \
  }

template <class T, int LO, int HI>
int plan_entry(int nx, int ny, int nz, int radius, int nf, int* out) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return -1;
#define CALL(T_, R, NF) plan<T_, R, NF>(nx, ny, nz, out)
  DISPATCH3_T(T, LO, HI, radius, nf, CALL)
#undef CALL
}

template <class T, int LO, int HI>
int pass_entry(const void* C, const void* x, const void* b, const void* binv,
               void* d, double omega0, double s0, double s1, void* y, int nx,
               int ny, int nz, int radius, int nf, int pass, int split,
               int staging, void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return (int)cudaErrorInvalidValue;
#define CALL(T_, R, NF)                                                     \
  launch_pass<T_, R, NF>(C, x, b, binv, d, omega0, s0, s1, y, nx, ny, nz,   \
                         pass, split, staging, (cudaStream_t)stream)
  DISPATCH3_T(T, LO, HI, radius, nf, CALL)
#undef CALL
}

template <class T, int LO, int HI>
int level_entry(const void* C, const void* binv, const void* b, const void* x,
                void* d, void* out, void* tmp, void* res, const double* s0,
                const double* s1, int sweeps, int cheb, int nx, int ny, int nz,
                int radius, int nf, int split, void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return (int)cudaErrorInvalidValue;
#define CALL(T_, R, NF)                                                      \
  launch_level<T_, R, NF>(C, binv, b, x, d, out, tmp, res, s0, s1, sweeps,   \
                          cheb, nx, ny, nz, split, (cudaStream_t)stream)
  DISPATCH3_T(T, LO, HI, radius, nf, CALL)
#undef CALL
}

}  // namespace

// The typed entries of one source: its scalar type T and radii LO..HI,
// named by SUFFIX (f32, f64: r = 1-3; r4_f32, r4_f64: r = 4; rn_f32,
// rn_f64: march_rn_kernel, csrc/stencil3d_rn.cu). The public entries of
// csrc/stencil3d.cu call the source that holds an operand's (type,
// radius, staging).
#define STENCIL3D_DECLARE(SUFFIX)                                            \
  int stencil3d_plan_##SUFFIX(int nx, int ny, int nz, int radius, int nf,    \
                              int* out);                                     \
  int stencil3d_pass_##SUFFIX(const void* C, const void* x, const void* b,   \
                              const void* binv, void* d, double omega0,      \
                              double s0, double s1, void* y, int nx, int ny, \
                              int nz, int radius, int nf, int pass,          \
                              int split, int staging, void* stream);         \
  int stencil3d_level_##SUFFIX(const void* C, const void* binv,              \
                               const void* b, const void* x, void* d,        \
                               void* out, void* tmp, void* res,              \
                               const double* s0, const double* s1,           \
                               int sweeps, int cheb, int nx, int ny, int nz, \
                               int radius, int nf, int split, void* stream);
#define STENCIL3D_ENTRIES(SUFFIX, T, LO, HI)                                 \
  extern "C" {                                                               \
  int stencil3d_plan_##SUFFIX(int nx, int ny, int nz, int radius, int nf,    \
                              int* out) {                                    \
    return plan_entry<T, LO, HI>(nx, ny, nz, radius, nf, out);               \
  }                                                                          \
  int stencil3d_pass_##SUFFIX(const void* C, const void* x, const void* b,   \
                              const void* binv, void* d, double omega0,      \
                              double s0, double s1, void* y, int nx, int ny, \
                              int nz, int radius, int nf, int pass,          \
                              int split, int staging, void* stream) {        \
    return pass_entry<T, LO, HI>(C, x, b, binv, d, omega0, s0, s1, y, nx,    \
                                 ny, nz, radius, nf, pass, split, staging,   \
                                 stream);                                    \
  }                                                                          \
  int stencil3d_level_##SUFFIX(const void* C, const void* binv,              \
                               const void* b, const void* x, void* d,        \
                               void* out, void* tmp, void* res,              \
                               const double* s0, const double* s1,           \
                               int sweeps, int cheb, int nx, int ny, int nz, \
                               int radius, int nf, int split,                \
                               void* stream) {                               \
    return level_entry<T, LO, HI>(C, binv, b, x, d, out, tmp, res, s0, s1,   \
                                  sweeps, cheb, nx, ny, nz, radius, nf,      \
                                  split, stream);                            \
  }                                                                          \
  }

extern "C" {
STENCIL3D_DECLARE(f32)
STENCIL3D_DECLARE(f64)
STENCIL3D_DECLARE(r4_f32)
STENCIL3D_DECLARE(r4_f64)
STENCIL3D_DECLARE(rn_f32)
STENCIL3D_DECLARE(rn_f64)
}

#endif  // IIFEA_STENCIL3D_CUH_
