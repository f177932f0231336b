// Variable-coefficient 2D stencil apply, residual and weighted-Jacobi sweeps
// for Hopper (sm_90a), on scalar and block (multi-field) operators, in f32
// and f64: the kernel bodies and the entries' dispatch by (radius, fields),
// shared by the four sources that instantiate them, which nvcc compiles in
// parallel: csrc/stencil2d.cu (the f32 instances at r = 1-3 and the public
// entries), csrc/stencil2d_f64.cu (f64, r = 1-3), csrc/stencil2d_r4.cu and
// csrc/stencil2d_r4_f64.cu (r = 4 in f32 and f64). Every radius from 5
// runs the runtime-radius instances of csrc/stencil_rn.cuh
// (csrc/stencil2d_rn.cu).
//
// Replaces the Pallas TPU kernels iifea_tpu/ops/pallas_stencil.py
// `stencil_mv` (body `_mv_kernel`/`_taps`) and `jacobi_smooth` (body
// `_smooth_kernel`). With nF fields, field-blocked vectors (nF, nx, ny) and
// coefficients C (nF, nF, m*m, nx, ny), m = 2r+1, k = (oi+r)*m + (oj+r):
//
//   (A x)[f1][i,j] = sum_f2 sum_k C[f1,f2,k,i,j] * x[f2][i+oi, j+oj]
//   apply:     y = A x
//   residual:  y = b - A x
//   sweep:     y = x + omega * Binv (b - A x)     Binv (nF, nF, nx, ny), the
//                                                 nodal nF x nF blocks; for
//                                                 nF = 1 it is 1/diag
//   sweep from x = 0:  y = omega * Binv b         (no coefficient is read)
//
// with x zero outside the (nx, ny) lattice; node id = i*ny + j, no padding.
//
// Instances (scalar type, radius, fields): f32 and f64 at r = 1 to 4 (r = 3:
// the quadratic B-spline background's 49-tap stencil, r = 4 the cubic one's
// 81 taps) for 1 to 3 fields, every configuration the multigrid routes
// take. Every instance is the same body; only its register plan differs
// (see pass_blocks, streamed).
//
// What bounds it: memory traffic on the large lattices (nF*nF*m*m
// coefficients per point against 2 flops each), and on the small ones the
// chain of latencies in a pass (launch, x from the L2, coefficients, store:
// ~2.3 us whatever the size; a 17x17 level is 3 tiles on a card with 132
// SMs). The design therefore
//
// * reads each coefficient exactly once per pass, coalesced along j
//   (threadIdx.x runs along j), and stages the x tile with its r-wide halo
//   in shared memory ONCE for all nF fields, so the nF*nF*m*m shifted reads
//   of x hit shared memory; every thread keeps nF accumulators, and the
//   residual and sweep epilogues reuse them, so A x never travels through
//   device memory;
// * a point whose nF^2 m^2 coefficients are more than a pass's registers
//   hold (nF = 3, r = 2: 225 words; every f64 block instance but nF = 2,
//   r = 1, up to nF = 3, r = 4's 1,458; the f64 scalar r = 4 point's 162)
//   streams them in rolled (f2, oi) trips of nF m loads, one or two in
//   flight (`streamed`, `trips`), so no instance spills;
// * does a whole multigrid level's work in one launch where the level is
//   small (`stencil2d_smooth`): nu sweeps and, when asked, the trailing
//   residual, one block per tile. A thread keeps its point's coefficients,
//   b and Binv in registers across the passes where they fit
//   (`resident`), so they are read
//   once per call instead of once per pass; only x travels, ping-ponged
//   between two buffers in the L2, with a barrier across the blocks
//   between passes. The sweep from zero is folded into the next pass's
//   staging (omega Binv b computed on the tile and its halo): no pass, no
//   barrier. The launch is a COOPERATIVE GRID (`grid.sync()`), so every
//   block must be co-resident: `stencil2d_smooth_plan` says from the tile
//   count and an occupancy query whether a level fits; larger levels run
//   one launch per pass through `stencil2d_block`. (One thread-block
//   cluster with `cluster.sync()` was measured too: at levels of at most 8
//   tiles it was 0.5 us a call ahead of the grid on an H100, too little to
//   keep a second design.)
//
// `stage_tile` + `point_pass` are the only stencil body; every entry is an
// instance of them, so nu fused sweeps equal nu single launches bitwise.
//
// Launch contract: PyTorch's current stream, no synchronisation, no
// allocation (the caller allocates outputs and the ping-pong buffer). Each
// entry returns the launch's cudaError_t so a refused launch (a level with
// more tiles than are co-resident) is reported to the caller.

#ifndef IIFEA_STENCIL2D_CUH_
#define IIFEA_STENCIL2D_CUH_

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileX = 8;   // output rows per block (blockDim.y)
constexpr int kTileY = 32;  // output cols per block (blockDim.x), one warp
constexpr int kThreads = kTileX * kTileY;

enum Mode { kApply = 0, kResidual = 1, kSweep = 2, kSweepFromZero = 3 };

// Resident blocks per SM asked of the compiler, per instance, from the
// 32-bit words of a point's coefficients (f64 counts two). One pass: its
// coefficient loads are unrolled and ptxas front-loads them, so the cap
// (65536 / 256 threads / blocks registers) must hold them: 4 blocks (64
// registers) up to 25 words, 3 (85) up to 50, else 2 (128); block
// operators 2. A point with more words than that cap holds (nF = 3, r = 2:
// 225) streams its coefficients instead (`streamed`). A level's launch
// keeps a point's coefficients in registers across its passes where they
// fit (`resident`: nF <= 2 and not streamed, up to 100 words; the others
// reread them every pass), and its grid must be co-resident: 3 blocks per
// SM up to 25 words (the 297 tiles of a scalar f32 r = 2 257 x 257 level),
// 2 up to 50, else 1 (an f64 r = 3 point's 98 words: 255 registers, 132
// co-resident tiles; an f32 r = 4 point's 81); block operators 1 (the 85
// tiles of a 2- or 3-field 129 x 129).
template <class T, int R, int NF>
__host__ __device__ constexpr int coef_words() {
  return NF * NF * (2 * R + 1) * (2 * R + 1) * (int)(sizeof(T) / 4);
}
template <class T, int R, int NF>
__host__ __device__ constexpr int pass_blocks() {
  return NF > 1 ? 2
                : coef_words<T, R, NF>() <= 25 ? 4
                : coef_words<T, R, NF>() <= 50 ? 3 : 2;
}
template <class T, int R, int NF>
__host__ __device__ constexpr int level_blocks() {
  return NF > 1 ? 1
                : coef_words<T, R, NF>() <= 25 ? 3
                : coef_words<T, R, NF>() <= 50 ? 2 : 1;
}
// Whether a pass streams the point's coefficients in rolled (f2, oi) trips
// of nF m loads rather than unrolling all nF^2 m^2: the unrolled loads are
// front-loaded by ptxas whatever __restrict__ or clobbers say, and 225 of
// them (nF = 3, r = 2) spilled 72-88 B a thread at a pass's 128-register cap
// and ~1.1 KB at a level launch's 255. The trips keep the order of the sums
// (f2, then oi, then oj for each output field), so a streamed instance
// computes what the unrolled one did, bitwise. Two trips in flight, as in
// csrc/stencil3d.cu's marching kernel, where their loads take at most 64
// words; one where a trip's alone is more than 32 (f64 nF = 3, r = 3: 42;
// f64 nF = 2 and 3 at r = 4: 36, 54).
template <class T, int R, int NF>
__host__ __device__ constexpr bool streamed() {
  return coef_words<T, R, NF>() > 128;
}
template <class T, int R, int NF>
__host__ __device__ constexpr int trips() {
  return 2 * NF * (2 * R + 1) * (int)(sizeof(T) / 4) <= 64 ? 2 : 1;
}
// Whether a level's launch keeps a point's coefficients, b and Binv in
// registers across its passes: at most two fields, and not streamed (up to
// 100 words, f32 nF = 2, r = 2; streamed points, 162-882 words, would spill
// under the level launch's 255 registers).
template <class T, int R, int NF>
__host__ __device__ constexpr bool resident() {
  return NF <= 2 && !streamed<T, R, NF>();
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <class T, int R, int NF>
struct Tile {
  static constexpr int SX = kTileX + 2 * R;
  static constexpr int SY = kTileY + 2 * R;
  T xs[NF][SX][SY];
};

__host__ __device__ inline int tiles_of(int nx, int ny) {
  return ((nx + kTileX - 1) / kTileX) * ((ny + kTileY - 1) / kTileY);
}

// The operands of one output point: coefficient idx = (f1*NF + f2)*m*m + k,
// smoother block idx = f1*NF + f2, right-hand side f. FromMemory reads them
// where they are used (every coefficient once per pass); InRegisters loads
// them once and serves every pass of a level's launch.
template <class T, int R, int NF>
struct FromMemory {
  const T *C, *b, *binv;
  int64_t plane, p;
  __device__ __forceinline__ void load(const T* C_, const T* b_,
                                       const T* binv_, int64_t plane_,
                                       int64_t p_) {
    C = C_; b = b_; binv = binv_; plane = plane_; p = p_;
  }
  __device__ __forceinline__ T coef(int idx) const {
    return C[idx * plane + p];
  }
  __device__ __forceinline__ T rhs(int f) const { return b[f * plane + p]; }
  __device__ __forceinline__ T blk(int idx) const {
    return binv[idx * plane + p];
  }
};

template <class T, int R, int NF>
struct InRegisters {
  static constexpr int N = NF * NF * (2 * R + 1) * (2 * R + 1);
  T c[N], rb[NF], bi[NF * NF];
  __device__ __forceinline__ void load(const T* __restrict__ C,
                                       const T* __restrict__ b,
                                       const T* __restrict__ binv,
                                       int64_t plane, int64_t p) {
#pragma unroll
    for (int idx = 0; idx < N; ++idx) c[idx] = C[idx * plane + p];
#pragma unroll
    for (int f = 0; f < NF; ++f) rb[f] = b[f * plane + p];
#pragma unroll
    for (int idx = 0; idx < NF * NF; ++idx) bi[idx] = binv[idx * plane + p];
  }
  __device__ __forceinline__ T coef(int idx) const { return c[idx]; }
  __device__ __forceinline__ T rhs(int f) const { return rb[f]; }
  __device__ __forceinline__ T blk(int idx) const { return bi[idx]; }
};

// x after one sweep from zero at a point: omega * Binv b (field f1).
template <class T, int NF, class Ops>
__device__ __forceinline__ T from_zero(const Ops& op, T omega, int f1) {
  T v = T(0);
#pragma unroll
  for (int f2 = 0; f2 < NF; ++f2) {
    v = fma_t(omega * op.blk(f1 * NF + f2), op.rhs(f2), v);
  }
  return v;
}

// Stage the x tile at (i0, j0) with its halo, all fields, zero outside the
// lattice. x is read through the L2 (__ldcg): in a level's launch other
// blocks wrote it before the last barrier. With x null the tile is x after
// one sweep from zero, computed where it is needed from Binv and b (the
// same values a sweep from zero writes), so that sweep costs no pass of its
// own and no barrier. All threads of the block must call it.
template <class T, int R, int NF>
__device__ __forceinline__ void stage_tile(
    const T* x, const T* __restrict__ b, const T* __restrict__ binv,
    T omega, int nx, int ny, int i0, int j0, Tile<T, R, NF>& sm) {
  constexpr int SX = Tile<T, R, NF>::SX;
  constexpr int SY = Tile<T, R, NF>::SY;
  const int tid = threadIdx.y * kTileY + threadIdx.x;
  const int64_t plane = (int64_t)nx * ny;
  if (x != nullptr) {
    for (int t = tid; t < NF * SX * SY; t += kThreads) {
      const int f = t / (SX * SY);
      const int rem = t - f * (SX * SY);
      const int li = rem / SY;
      const int lj = rem - li * SY;
      const int gi = i0 + li - R;
      const int gj = j0 + lj - R;
      T v = T(0);
      if (gi >= 0 && gi < nx && gj >= 0 && gj < ny) {
        v = __ldcg(x + f * plane + (int64_t)gi * ny + gj);
      }
      sm.xs[f][li][lj] = v;
    }
  } else {
    for (int t = tid; t < SX * SY; t += kThreads) {
      const int li = t / SY;
      const int lj = t - li * SY;
      const int gi = i0 + li - R;
      const int gj = j0 + lj - R;
      const bool in = gi >= 0 && gi < nx && gj >= 0 && gj < ny;
      FromMemory<T, R, NF> op;
      op.load(nullptr, b, binv, plane, (int64_t)gi * ny + gj);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        sm.xs[f][li][lj] = in ? from_zero<T, NF>(op, omega, f) : T(0);
      }
    }
  }
  __syncthreads();
}

// One pass of MODE at the thread's point p of the staged tile: accumulate
// A x per output field, write the epilogue to y.
template <class T, int R, int NF, int MODE, class Ops>
__device__ __forceinline__ void point_pass(const Ops& op, T omega, T* y,
                                           int64_t plane, int64_t p,
                                           const Tile<T, R, NF>& sm) {
  constexpr int M = 2 * R + 1;
  T acc[NF];
#pragma unroll
  for (int f1 = 0; f1 < NF; ++f1) acc[f1] = T(0);
  if constexpr (streamed<T, R, NF>()) {
    static_assert(!resident<T, R, NF>(),
                  "a streamed point reads C from memory");
    constexpr int kTrips = trips<T, R, NF>();
    // trip t = (f2, oi): acc[f1] += sum_oj C[f1, f2, oi, oj] x[f2](oi, oj)
#pragma unroll 1
    for (int t0 = 0; t0 < NF * M; t0 += kTrips) {
#pragma unroll
      for (int u = 0; u < kTrips; ++u) {
        const int t = t0 + u;
        if (NF * M % kTrips == 0 || t < NF * M) {
          const int f2 = t / M;
          const int oi = t - f2 * M;
          const T* Cq = op.C + (int64_t)(f2 * M * M + oi * M) * plane + p;
          const T* xw = &sm.xs[f2][threadIdx.y + oi][threadIdx.x];
#pragma unroll
          for (int f1 = 0; f1 < NF; ++f1) {
#pragma unroll
            for (int oj = 0; oj < M; ++oj) {
              acc[f1] = fma_t(
                  __ldg(Cq + (int64_t)(f1 * NF * M * M + oj) * plane),
                  xw[oj], acc[f1]);
            }
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int f1 = 0; f1 < NF; ++f1) {
#pragma unroll
      for (int f2 = 0; f2 < NF; ++f2) {
#pragma unroll
        for (int k = 0; k < M * M; ++k) {
          acc[f1] = fma_t(op.coef((f1 * NF + f2) * M * M + k),
                          sm.xs[f2][threadIdx.y + k / M][threadIdx.x + k % M],
                          acc[f1]);
        }
      }
    }
  }
  if (MODE == kApply) {
#pragma unroll
    for (int f1 = 0; f1 < NF; ++f1) y[f1 * plane + p] = acc[f1];
  } else {
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f] = op.rhs(f) - acc[f];
#pragma unroll
    for (int f1 = 0; f1 < NF; ++f1) {
      T v = acc[f1];
      if (MODE == kSweep) {
        v = sm.xs[f1][threadIdx.y + R][threadIdx.x + R];
#pragma unroll
        for (int f2 = 0; f2 < NF; ++f2) {
          v = fma_t(omega * op.blk(f1 * NF + f2), acc[f2], v);
        }
      }
      y[f1 * plane + p] = v;
    }
  }
}

// One pass, one block per tile (kSweepFromZero: one thread per point).
template <class T, int R, int NF, int MODE>
__global__ void __launch_bounds__(kThreads, pass_blocks<T, R, NF>())
pass_kernel(const T* __restrict__ C, const T* x, const T* __restrict__ b,
            const T* __restrict__ binv, T omega, T* y, int nx, int ny) {
  const int64_t plane = (int64_t)nx * ny;
  FromMemory<T, R, NF> op;
  if constexpr (MODE == kSweepFromZero) {
    const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.y * kTileY +
                      threadIdx.x;
    if (p < plane) {
      op.load(nullptr, b, binv, plane, p);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        y[f * plane + p] = from_zero<T, NF>(op, omega, f);
      }
    }
  } else {
    __shared__ Tile<T, R, NF> sm;
    const int tiles_y = (ny + kTileY - 1) / kTileY;
    const int i0 = (blockIdx.x / tiles_y) * kTileX;
    const int j0 = (blockIdx.x % tiles_y) * kTileY;
    stage_tile<T, R, NF>(x, b, binv, omega, nx, ny, i0, j0, sm);
    const int i = i0 + threadIdx.y;
    const int j = j0 + threadIdx.x;
    if (i < nx && j < ny) {
      const int64_t p = (int64_t)i * ny + j;
      op.load(C, b, binv, plane, p);
      point_pass<T, R, NF, MODE>(op, omega, y, plane, p, sm);
    }
  }
}

// A level's work in one launch, one block per tile: `sweeps` sweeps from x
// (from zero when x is null), the last one written to `out` (the others
// ping-pong between `tmp` and `out`), then res = b - A out when res is not
// null. A point's
// coefficients, b and Binv are loaded once and serve every pass where they
// fit in registers (`resident`).
// Between passes every block waits at a grid barrier (a cooperative
// launch), which also orders the x written before it. The sweep from zero
// needs neither a pass nor a barrier: the next pass stages its result from
// Binv and b.
template <class T, int R, int NF>
__global__ void __launch_bounds__(kThreads, level_blocks<T, R, NF>())
level_kernel(const T* __restrict__ C, const T* __restrict__ binv,
             const T* __restrict__ b, const T* x, T omega, int sweeps,
             T* out, T* tmp, T* res, int nx, int ny) {
  __shared__ Tile<T, R, NF> sm;
  const int tiles_y = (ny + kTileY - 1) / kTileY;
  const int i0 = (blockIdx.x / tiles_y) * kTileX;
  const int j0 = (blockIdx.x % tiles_y) * kTileY;
  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  const bool in = i < nx && j < ny;
  const int64_t plane = (int64_t)nx * ny;
  const int64_t p = (int64_t)i * ny + j;
  typename std::conditional<resident<T, R, NF>(), InRegisters<T, R, NF>,
                            FromMemory<T, R, NF>>::type op;
  if (in) op.load(C, b, binv, plane, p);

  const T* cur = x;
  int s = 0;
  if (x == nullptr) {  // the sweep from zero
    if (sweeps == 1 && in) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        out[f * plane + p] = from_zero<T, NF>(op, omega, f);
      }
    }
    s = 1;
  }
  for (; s < sweeps; ++s) {
    T* dst = ((sweeps - 1 - s) & 1) ? tmp : out;
    stage_tile<T, R, NF>(cur, b, binv, omega, nx, ny, i0, j0, sm);
    if (in) point_pass<T, R, NF, kSweep>(op, omega, dst, plane, p, sm);
    cur = dst;
    if (s + 1 < sweeps || res != nullptr) cg::this_grid().sync();
  }
  if (res != nullptr) {
    stage_tile<T, R, NF>(cur, b, binv, omega, nx, ny, i0, j0, sm);
    if (in) point_pass<T, R, NF, kResidual>(op, omega, res, plane, p, sm);
  }
}

template <class T, int R, int NF, int MODE>
cudaError_t launch_pass(const T* C, const T* x, const T* b, const T* binv,
                        T omega, T* y, int nx, int ny, cudaStream_t stream) {
  const int blocks = MODE == kSweepFromZero
                         ? (int)(((int64_t)nx * ny + kThreads - 1) / kThreads)
                         : tiles_of(nx, ny);
  pass_kernel<T, R, NF, MODE><<<blocks, dim3(kTileY, kTileX), 0, stream>>>(
      C, x, b, binv, omega, y, nx, ny);
  return cudaGetLastError();
}

template <class T, int R, int NF>
cudaError_t launch_pass_mode(int mode, const void* C, const void* x,
                             const void* b, const void* binv, double omega,
                             void* y, int nx, int ny, cudaStream_t stream) {
  const T *Ct = (const T*)C, *xt = (const T*)x, *bt = (const T*)b,
          *bi = (const T*)binv;
  T* yt = (T*)y;
  const T w = (T)omega;
  switch (mode) {
    case kApply:
      return launch_pass<T, R, NF, kApply>(Ct, xt, bt, bi, w, yt, nx, ny,
                                           stream);
    case kResidual:
      return launch_pass<T, R, NF, kResidual>(Ct, xt, bt, bi, w, yt, nx, ny,
                                              stream);
    case kSweep:
      return launch_pass<T, R, NF, kSweep>(Ct, xt, bt, bi, w, yt, nx, ny,
                                           stream);
    case kSweepFromZero:
      return launch_pass<T, R, NF, kSweepFromZero>(Ct, xt, bt, bi, w, yt, nx,
                                                   ny, stream);
  }
  return cudaErrorInvalidValue;
}

// Blocks of level_kernel<T, R, NF> the current device holds at once.
// Cached per instance: the devices of one process are taken to be alike.
template <class T, int R, int NF>
cudaError_t grid_capacity(int* capacity) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, level_kernel<T, R, NF>, kThreads, 0);
    }
    if (e != cudaSuccess) return e;
    cached = sms * per_sm;
  }
  *capacity = cached;
  return cudaSuccess;
}

template <class T, int R, int NF>
cudaError_t launch_level(const void* C, const void* binv, const void* b,
                         const void* x, double omega, int sweeps, void* out,
                         void* tmp, void* res, int nx, int ny,
                         cudaStream_t stream) {
  const int tiles = tiles_of(nx, ny);
  int capacity = 0;
  cudaError_t e = grid_capacity<T, R, NF>(&capacity);
  if (e != cudaSuccess) return e;
  if (tiles > capacity) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(tiles);
  cfg.blockDim = dim3(kTileY, kTileX);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  return cudaLaunchKernelEx(&cfg, level_kernel<T, R, NF>, (const T*)C,
                            (const T*)binv, (const T*)b, (const T*)x,
                            (T)omega, sweeps, (T*)out, (T*)tmp, (T*)res, nx,
                            ny);
}

// Whether a level's fused launch fits, from what the code can observe: the
// tile count and how many blocks the card holds at once. 1: fits; 0: no;
// negative: the occupancy query failed.
template <class T, int R, int NF>
int plan_level(int nx, int ny) {
  int capacity = 0;
  if (grid_capacity<T, R, NF>(&capacity) != cudaSuccess) return -1;
  return tiles_of(nx, ny) <= capacity ? 1 : 0;
}


// The entries' bodies for one scalar type T and the radii LO..HI, by
// (radius, fields): each source that includes this header instantiates
// them for its own type and radii (STENCIL2D_ENTRIES), so the instances
// compile in parallel; a radius outside LO..HI is refused.
#define CASE_T(T, LO, HI, R, NF, CALL)                               \
  if constexpr (LO <= R && R <= HI) return (int)(CALL(T, R, NF));    \
  else return (int)cudaErrorInvalidValue;
#define DISPATCH_T(T, LO, HI, radius, nf, CALL)                      \
  switch ((radius) * 10 + (nf)) {                                    \
    case 11: { CASE_T(T, LO, HI, 1, 1, CALL) }                       \
    case 12: { CASE_T(T, LO, HI, 1, 2, CALL) }                       \
    case 13: { CASE_T(T, LO, HI, 1, 3, CALL) }                       \
    case 21: { CASE_T(T, LO, HI, 2, 1, CALL) }                       \
    case 22: { CASE_T(T, LO, HI, 2, 2, CALL) }                       \
    case 23: { CASE_T(T, LO, HI, 2, 3, CALL) }                       \
    case 31: { CASE_T(T, LO, HI, 3, 1, CALL) }                       \
    case 32: { CASE_T(T, LO, HI, 3, 2, CALL) }                       \
    case 33: { CASE_T(T, LO, HI, 3, 3, CALL) }                       \
    case 41: { CASE_T(T, LO, HI, 4, 1, CALL) }                       \
    case 42: { CASE_T(T, LO, HI, 4, 2, CALL) }                       \
    case 43: { CASE_T(T, LO, HI, 4, 3, CALL) }                       \
    default: return (int)cudaErrorInvalidValue;                      \
  }

template <class T, int LO, int HI>
int block_entry(const void* C, const void* x, const void* b, const void* binv,
                double omega, void* y, int nx, int ny, int radius, int nf,
                int mode, void* stream) {
  if (nx <= 0 || ny <= 0) return (int)cudaErrorInvalidValue;
#define CALL(T_, R, NF)                                                    \
  launch_pass_mode<T_, R, NF>(mode, C, x, b, binv, omega, y, nx, ny,       \
                              (cudaStream_t)stream)
  DISPATCH_T(T, LO, HI, radius, nf, CALL)
#undef CALL
}

template <class T, int LO, int HI>
int plan_entry(int nx, int ny, int radius, int nf) {
  if (nx <= 0 || ny <= 0) return -1;
#define CALL(T_, R, NF) plan_level<T_, R, NF>(nx, ny)
  DISPATCH_T(T, LO, HI, radius, nf, CALL)
#undef CALL
}

template <class T, int LO, int HI>
int level_entry(const void* C, const void* binv, const void* b, const void* x,
                double omega, int sweeps, void* out, void* tmp, void* res,
                int nx, int ny, int radius, int nf, void* stream) {
  if (nx <= 0 || ny <= 0 || sweeps < 1) return (int)cudaErrorInvalidValue;
#define CALL(T_, R, NF)                                                    \
  launch_level<T_, R, NF>(C, binv, b, x, omega, sweeps, out, tmp, res, nx, \
                          ny, (cudaStream_t)stream)
  DISPATCH_T(T, LO, HI, radius, nf, CALL)
#undef CALL
}

}  // namespace

// The typed entries of one source: its scalar type T and radii LO..HI,
// named by SUFFIX (f32, f64: r = 1-3; r4_f32, r4_f64: r = 4; rn_f32,
// rn_f64: every radius from 5, csrc/stencil2d_rn.cu). The public entries of
// csrc/stencil2d.cu call the source that holds an operand's (type,
// radius).
#define STENCIL2D_DECLARE(SUFFIX)                                           \
  int stencil2d_block_##SUFFIX(const void* C, const void* x, const void* b, \
                               const void* binv, double omega, void* y,     \
                               int nx, int ny, int radius, int nf,          \
                               int mode, void* stream);                     \
  int stencil2d_smooth_plan_##SUFFIX(int nx, int ny, int radius, int nf);   \
  int stencil2d_smooth_##SUFFIX(const void* C, const void* binv,            \
                                const void* b, const void* x, double omega, \
                                int sweeps, void* out, void* tmp,           \
                                void* res, int nx, int ny, int radius,      \
                                int nf, void* stream);
#define STENCIL2D_ENTRIES(SUFFIX, T, LO, HI)                                \
  extern "C" {                                                              \
  int stencil2d_block_##SUFFIX(const void* C, const void* x, const void* b, \
                               const void* binv, double omega, void* y,     \
                               int nx, int ny, int radius, int nf,          \
                               int mode, void* stream) {                    \
    return block_entry<T, LO, HI>(C, x, b, binv, omega, y, nx, ny, radius,  \
                                  nf, mode, stream);                        \
  }                                                                         \
  int stencil2d_smooth_plan_##SUFFIX(int nx, int ny, int radius, int nf) {  \
    return plan_entry<T, LO, HI>(nx, ny, radius, nf);                       \
  }                                                                         \
  int stencil2d_smooth_##SUFFIX(const void* C, const void* binv,            \
                                const void* b, const void* x, double omega, \
                                int sweeps, void* out, void* tmp,           \
                                void* res, int nx, int ny, int radius,      \
                                int nf, void* stream) {                     \
    return level_entry<T, LO, HI>(C, binv, b, x, omega, sweeps, out, tmp,   \
                                  res, nx, ny, radius, nf, stream);         \
  }                                                                         \
  }

extern "C" {
STENCIL2D_DECLARE(f32)
STENCIL2D_DECLARE(f64)
STENCIL2D_DECLARE(r4_f32)
STENCIL2D_DECLARE(r4_f64)
STENCIL2D_DECLARE(rn_f32)
STENCIL2D_DECLARE(rn_f64)
}

#endif  // IIFEA_STENCIL2D_CUH_
