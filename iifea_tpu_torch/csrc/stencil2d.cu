// Variable-coefficient 2D stencil apply, residual and weighted-Jacobi sweeps
// for Hopper (sm_90a), f32, on scalar and block (multi-field) operators.
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
// * does a whole multigrid level's work in one launch where the level is
//   small (`stencil2d_smooth`): nu sweeps and, when asked, the trailing
//   residual, one block per tile. A thread keeps its point's coefficients,
//   b and Binv in registers across the passes (nF <= 2), so they are read
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

// Resident blocks per SM asked of the compiler. One pass: the block
// operators unroll nF*nF*m*m coefficient loads and may take up to 128
// registers a thread. A level's launch keeps a point's coefficients in
// registers across its passes where they fit (nF <= 2: up to 106 values;
// nF = 3 rereads them, and at r = 2 ptxas still front-loads its 225
// coefficients and spills about 1 KB a thread at the 255-register cap),
// and its grid must be co-resident: 3 blocks per SM hold the 297 tiles of a
// scalar 257 x 257 level, 1 block per SM the 85 tiles of a block 129 x 129.
__host__ __device__ constexpr int pass_blocks(int nf) {
  return nf == 1 ? 4 : 2;
}
__host__ __device__ constexpr int level_blocks(int nf) {
  return nf == 1 ? 3 : 1;
}
__host__ __device__ constexpr bool resident(int nf) { return nf <= 2; }

template <int R, int NF>
struct Tile {
  static constexpr int SX = kTileX + 2 * R;
  static constexpr int SY = kTileY + 2 * R;
  float xs[NF][SX][SY];
};

__host__ __device__ inline int tiles_of(int nx, int ny) {
  return ((nx + kTileX - 1) / kTileX) * ((ny + kTileY - 1) / kTileY);
}

// The operands of one output point: coefficient idx = (f1*NF + f2)*m*m + k,
// smoother block idx = f1*NF + f2, right-hand side f. FromMemory reads them
// where they are used (every coefficient once per pass); InRegisters loads
// them once and serves every pass of a level's launch.
template <int R, int NF>
struct FromMemory {
  const float *C, *b, *binv;
  int64_t plane, p;
  __device__ __forceinline__ void load(const float* C_, const float* b_,
                                       const float* binv_, int64_t plane_,
                                       int64_t p_) {
    C = C_; b = b_; binv = binv_; plane = plane_; p = p_;
  }
  __device__ __forceinline__ float coef(int idx) const {
    return C[idx * plane + p];
  }
  __device__ __forceinline__ float rhs(int f) const {
    return b[f * plane + p];
  }
  __device__ __forceinline__ float blk(int idx) const {
    return binv[idx * plane + p];
  }
};

template <int R, int NF>
struct InRegisters {
  static constexpr int N = NF * NF * (2 * R + 1) * (2 * R + 1);
  float c[N], rb[NF], bi[NF * NF];
  __device__ __forceinline__ void load(const float* __restrict__ C,
                                       const float* __restrict__ b,
                                       const float* __restrict__ binv,
                                       int64_t plane, int64_t p) {
#pragma unroll
    for (int idx = 0; idx < N; ++idx) c[idx] = C[idx * plane + p];
#pragma unroll
    for (int f = 0; f < NF; ++f) rb[f] = b[f * plane + p];
#pragma unroll
    for (int idx = 0; idx < NF * NF; ++idx) bi[idx] = binv[idx * plane + p];
  }
  __device__ __forceinline__ float coef(int idx) const { return c[idx]; }
  __device__ __forceinline__ float rhs(int f) const { return rb[f]; }
  __device__ __forceinline__ float blk(int idx) const { return bi[idx]; }
};

// x after one sweep from zero at a point: omega * Binv b (field f1).
template <int NF, class Ops>
__device__ __forceinline__ float from_zero(const Ops& op, float omega,
                                           int f1) {
  float v = 0.0f;
#pragma unroll
  for (int f2 = 0; f2 < NF; ++f2) {
    v = fmaf(omega * op.blk(f1 * NF + f2), op.rhs(f2), v);
  }
  return v;
}

// Stage the x tile at (i0, j0) with its halo, all fields, zero outside the
// lattice. x is read through the L2 (__ldcg): in a level's launch other
// blocks wrote it before the last barrier. With x null the tile is x after
// one sweep from zero, computed where it is needed from Binv and b (the
// same values a sweep from zero writes), so that sweep costs no pass of its
// own and no barrier. All threads of the block must call it.
template <int R, int NF>
__device__ __forceinline__ void stage_tile(
    const float* x, const float* __restrict__ b,
    const float* __restrict__ binv, float omega, int nx, int ny, int i0,
    int j0, Tile<R, NF>& sm) {
  constexpr int SX = Tile<R, NF>::SX;
  constexpr int SY = Tile<R, NF>::SY;
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
      float v = 0.0f;
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
      FromMemory<R, NF> op;
      op.load(nullptr, b, binv, plane, (int64_t)gi * ny + gj);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        sm.xs[f][li][lj] = in ? from_zero<NF>(op, omega, f) : 0.0f;
      }
    }
  }
  __syncthreads();
}

// One pass of MODE at the thread's point p of the staged tile: accumulate
// A x per output field, write the epilogue to y.
template <int R, int NF, int MODE, class Ops>
__device__ __forceinline__ void point_pass(const Ops& op, float omega,
                                           float* y, int64_t plane, int64_t p,
                                           const Tile<R, NF>& sm) {
  constexpr int M = 2 * R + 1;
  float acc[NF];
#pragma unroll
  for (int f1 = 0; f1 < NF; ++f1) {
    acc[f1] = 0.0f;
#pragma unroll
    for (int f2 = 0; f2 < NF; ++f2) {
#pragma unroll
      for (int k = 0; k < M * M; ++k) {
        acc[f1] = fmaf(op.coef((f1 * NF + f2) * M * M + k),
                       sm.xs[f2][threadIdx.y + k / M][threadIdx.x + k % M],
                       acc[f1]);
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
      float v = acc[f1];
      if (MODE == kSweep) {
        v = sm.xs[f1][threadIdx.y + R][threadIdx.x + R];
#pragma unroll
        for (int f2 = 0; f2 < NF; ++f2) {
          v = fmaf(omega * op.blk(f1 * NF + f2), acc[f2], v);
        }
      }
      y[f1 * plane + p] = v;
    }
  }
}

// One pass, one block per tile (kSweepFromZero: one thread per point).
template <int R, int NF, int MODE>
__global__ void __launch_bounds__(kThreads, pass_blocks(NF))
pass_kernel(const float* __restrict__ C, const float* x,
            const float* __restrict__ b, const float* __restrict__ binv,
            float omega, float* y, int nx, int ny) {
  const int64_t plane = (int64_t)nx * ny;
  FromMemory<R, NF> op;
  if constexpr (MODE == kSweepFromZero) {
    const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.y * kTileY +
                      threadIdx.x;
    if (p < plane) {
      op.load(nullptr, b, binv, plane, p);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        y[f * plane + p] = from_zero<NF>(op, omega, f);
      }
    }
  } else {
    __shared__ Tile<R, NF> sm;
    const int tiles_y = (ny + kTileY - 1) / kTileY;
    const int i0 = (blockIdx.x / tiles_y) * kTileX;
    const int j0 = (blockIdx.x % tiles_y) * kTileY;
    stage_tile<R, NF>(x, b, binv, omega, nx, ny, i0, j0, sm);
    const int i = i0 + threadIdx.y;
    const int j = j0 + threadIdx.x;
    if (i < nx && j < ny) {
      const int64_t p = (int64_t)i * ny + j;
      op.load(C, b, binv, plane, p);
      point_pass<R, NF, MODE>(op, omega, y, plane, p, sm);
    }
  }
}

// A level's work in one launch, one block per tile: `sweeps` sweeps from x
// (from zero when x is null), the last one written to `out` (the others
// ping-pong between `tmp` and `out`), then res = b - A out when res is not
// null. A point's
// coefficients, b and Binv are loaded once and serve every pass (nF <= 2).
// Between passes every block waits at a grid barrier (a cooperative
// launch), which also orders the x written before it. The sweep from zero
// needs neither a pass nor a barrier: the next pass stages its result from
// Binv and b.
template <int R, int NF>
__global__ void __launch_bounds__(kThreads, level_blocks(NF))
level_kernel(const float* __restrict__ C, const float* __restrict__ binv,
             const float* __restrict__ b, const float* x, float omega,
             int sweeps, float* out, float* tmp, float* res, int nx, int ny) {
  __shared__ Tile<R, NF> sm;
  const int tiles_y = (ny + kTileY - 1) / kTileY;
  const int i0 = (blockIdx.x / tiles_y) * kTileX;
  const int j0 = (blockIdx.x % tiles_y) * kTileY;
  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  const bool in = i < nx && j < ny;
  const int64_t plane = (int64_t)nx * ny;
  const int64_t p = (int64_t)i * ny + j;
  typename std::conditional<resident(NF), InRegisters<R, NF>,
                            FromMemory<R, NF>>::type op;
  if (in) op.load(C, b, binv, plane, p);

  const float* cur = x;
  int s = 0;
  if (x == nullptr) {  // the sweep from zero
    if (sweeps == 1 && in) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        out[f * plane + p] = from_zero<NF>(op, omega, f);
      }
    }
    s = 1;
  }
  for (; s < sweeps; ++s) {
    float* dst = ((sweeps - 1 - s) & 1) ? tmp : out;
    stage_tile<R, NF>(cur, b, binv, omega, nx, ny, i0, j0, sm);
    if (in) point_pass<R, NF, kSweep>(op, omega, dst, plane, p, sm);
    cur = dst;
    if (s + 1 < sweeps || res != nullptr) cg::this_grid().sync();
  }
  if (res != nullptr) {
    stage_tile<R, NF>(cur, b, binv, omega, nx, ny, i0, j0, sm);
    if (in) point_pass<R, NF, kResidual>(op, omega, res, plane, p, sm);
  }
}

template <int R, int NF, int MODE>
cudaError_t launch_pass(const float* C, const float* x, const float* b,
                        const float* binv, float omega, float* y, int nx,
                        int ny, cudaStream_t stream) {
  const int blocks = MODE == kSweepFromZero
                         ? (int)(((int64_t)nx * ny + kThreads - 1) / kThreads)
                         : tiles_of(nx, ny);
  pass_kernel<R, NF, MODE><<<blocks, dim3(kTileY, kTileX), 0, stream>>>(
      C, x, b, binv, omega, y, nx, ny);
  return cudaGetLastError();
}

template <int R, int NF>
cudaError_t launch_pass_mode(int mode, const float* C, const float* x,
                             const float* b, const float* binv, float omega,
                             float* y, int nx, int ny, cudaStream_t stream) {
  switch (mode) {
    case kApply:
      return launch_pass<R, NF, kApply>(C, x, b, binv, omega, y, nx, ny,
                                        stream);
    case kResidual:
      return launch_pass<R, NF, kResidual>(C, x, b, binv, omega, y, nx, ny,
                                           stream);
    case kSweep:
      return launch_pass<R, NF, kSweep>(C, x, b, binv, omega, y, nx, ny,
                                        stream);
    case kSweepFromZero:
      return launch_pass<R, NF, kSweepFromZero>(C, x, b, binv, omega, y, nx,
                                                ny, stream);
  }
  return cudaErrorInvalidValue;
}

// Blocks of level_kernel<R, NF> the current device holds at once.
// Cached per instance: the devices of one process are taken to be alike.
template <int R, int NF>
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
          &per_sm, level_kernel<R, NF>, kThreads, 0);
    }
    if (e != cudaSuccess) return e;
    cached = sms * per_sm;
  }
  *capacity = cached;
  return cudaSuccess;
}

template <int R, int NF>
cudaError_t launch_level(const float* C, const float* binv, const float* b,
                         const float* x, float omega, int sweeps, float* out,
                         float* tmp, float* res, int nx, int ny,
                         cudaStream_t stream) {
  const int tiles = tiles_of(nx, ny);
  int capacity = 0;
  cudaError_t e = grid_capacity<R, NF>(&capacity);
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
  return cudaLaunchKernelEx(&cfg, level_kernel<R, NF>, C, binv, b, x, omega,
                            sweeps, out, tmp, res, nx, ny);
}

// Whether a level's fused launch fits, from what the code can observe: the
// tile count and how many blocks the card holds at once. 1: fits; 0: no;
// negative: the occupancy query failed.
template <int R, int NF>
int plan_level(int nx, int ny) {
  int capacity = 0;
  if (grid_capacity<R, NF>(&capacity) != cudaSuccess) return -1;
  return tiles_of(nx, ny) <= capacity ? 1 : 0;
}

}  // namespace

#define DISPATCH_R_NF(radius, nf, CALL)        \
  switch ((radius) * 10 + (nf)) {              \
    case 11: return (int)(CALL(1, 1));         \
    case 12: return (int)(CALL(1, 2));         \
    case 13: return (int)(CALL(1, 3));         \
    case 21: return (int)(CALL(2, 1));         \
    case 22: return (int)(CALL(2, 2));         \
    case 23: return (int)(CALL(2, 3));         \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// One pass on an nF-field operator. mode 0: y = A x; 1: y = b - A x;
// 2: y = x + omega Binv (b - A x), and with x null the same sweep applied to
// omega Binv b, i.e. two sweeps from zero in one pass; 3: y = omega Binv b,
// one sweep from zero (C, x unread). y must not alias x.
int stencil2d_block(const float* C, const float* x, const float* b,
                    const float* binv, float omega, float* y, int nx, int ny,
                    int radius, int nf, int mode, void* stream) {
  if (nx <= 0 || ny <= 0) return (int)cudaErrorInvalidValue;
#define CALL(R, NF)                                                        \
  launch_pass_mode<R, NF>(mode, C, x, b, binv, omega, y, nx, ny,           \
                          (cudaStream_t)stream)
  DISPATCH_R_NF(radius, nf, CALL)
#undef CALL
}

// y = A x, scalar operator
int stencil2d_mv(const float* C, const float* x, float* y, int nx, int ny,
                 int radius, void* stream) {
  return stencil2d_block(C, x, nullptr, nullptr, 0.0f, y, nx, ny, radius, 1,
                         kApply, stream);
}

// 1: the level's smoothing call fits one cooperative launch
// (stencil2d_smooth); 0: it takes one launch per pass (stencil2d_block);
// negative: the occupancy query failed.
int stencil2d_smooth_plan(int nx, int ny, int radius, int nf) {
  if (nx <= 0 || ny <= 0) return -1;
#define CALL(R, NF) plan_level<R, NF>(nx, ny)
  DISPATCH_R_NF(radius, nf, CALL)
#undef CALL
}

// `sweeps` >= 1 sweeps from x (x null: from zero) into out, then
// res = b - A out when res is not null, in ONE cooperative launch. tmp is
// the ping-pong buffer (read and written when sweeps >= 2); none of out,
// tmp, res may alias x or each other. The level's tiles of 8 x 32 must all
// be co-resident, else the launch is refused.
int stencil2d_smooth(const float* C, const float* binv, const float* b,
                     const float* x, float omega, int sweeps, float* out,
                     float* tmp, float* res, int nx, int ny, int radius,
                     int nf, void* stream) {
  if (nx <= 0 || ny <= 0 || sweeps < 1) return (int)cudaErrorInvalidValue;
#define CALL(R, NF)                                                        \
  launch_level<R, NF>(C, binv, b, x, omega, sweeps, out, tmp, res, nx, ny, \
                      (cudaStream_t)stream)
  DISPATCH_R_NF(radius, nf, CALL)
#undef CALL
}

}  // extern "C"
