// Runtime-radius instances of the 2D stencil kernels for Hopper (sm_90a):
// the radius is a kernel argument, so one instance per (scalar type,
// fields, pass), and one of the level kernel per (scalar type, fields),
// serves every radius above the fixed-radius ones of csrc/stencil2d.cuh
// (r = 1-4). The public entries of csrc/stencil2d.cu hand r >= 5 (a
// quartic or higher B-spline background: 121 taps at r = 5) to the source
// that instantiates these, csrc/stencil2d_rn.cu. (The 3D runtime-radius
// kernels are march_rn_kernel and march_rn_level_kernel in
// csrc/stencil3d.cuh.)
//
// Replaces, at those radii, the Pallas TPU kernels of
// iifea_tpu/ops/pallas_stencil.py `stencil_mv` (`_mv_kernel`) and
// `jacobi_smooth` (`_smooth_kernel`), which take the radius as a static
// argument with no limit; and the port's extensions of them: the block
// (1-3 field) apply, residual and point-block sweep. The operands and
// their layouts are those of the fixed-radius kernels (see their headers):
//
//   (A x)[f1] = sum_f2 sum_q C[f1, f2, q] * shift_q(x[f2])   (x zero outside)
//
// with q = (oi, oj) in the planes' order, and every output field summed in
// the order (f2, oi, oj), as the fixed-radius kernels sum.
//
// What bounds them: memory traffic. A point reads nF^2 (2r+1)^2
// coefficients once (r = 5: 121 per field pair) against two flops each.
// The design is the simple one:
//
// * one thread per output point, all nF output fields in registers; the
//   coefficient planes are read coalesced in their own plane-major layout
//   (neighbouring threads on neighbouring points of a plane);
// * a 16 x 16 tile of x with its runtime 2r halo, every field, is staged in
//   dynamic shared memory (26^2 x 3 f64 = 16 KB at r = 5), so the shifted
//   reads of x hit shared memory; the radius a block can stage is the
//   limit of the 2D instances (the wrappers refuse a larger one);
// * a multigrid level's smoothing call (nu sweeps and the trailing
//   residual) is one cooperative launch of level2d_kernel where every tile
//   of the level is co-resident (the plan entry, plan_level2d, whose
//   comment holds the measurements), a grid barrier between passes, each pass the pass kernel's
//   body on the same tile, x staged through the L2 (ld.global.cg: the
//   read-only cache is not coherent with the launch's own writes), so it
//   equals the per-pass route bitwise; else one launch per pass.
//
// Launch contract: PyTorch's current stream, no synchronisation, no
// allocation; y must not alias x or b. Each entry returns the launch's
// cudaError_t.

#ifndef IIFEA_STENCIL_RN_CUH_
#define IIFEA_STENCIL_RN_CUH_

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace rn {

namespace cg = cooperative_groups;

__device__ __forceinline__ float fma_r(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_r(double a, double b, double c) {
  return fma(a, b, c);
}

// passes: 2D modes 0-3 as stencil2d_block's
enum Pass { kApply = 0, kResidual = 1, kSweep = 2 };
constexpr int kSweepFromZero2 = 3;   // stencil2d_block's mode 3

// x after one sweep from zero at point p, field f1: omega Binv b.
template <class T, int NF>
__device__ __forceinline__ T from_zero(const T* __restrict__ binv,
                                       const T* __restrict__ b, T omega,
                                       int64_t plane, int64_t p, int f1) {
  T v = T(0);
#pragma unroll
  for (int f2 = 0; f2 < NF; ++f2) {
    v = fma_r(omega * __ldg(binv + (int64_t)(f1 * NF + f2) * plane + p),
              __ldg(b + f2 * plane + p), v);
  }
  return v;
}

// y = omega Binv b, one thread per point (d, when not null, gets the same
// values).
template <class T, int NF>
__global__ void zero_kernel(const T* __restrict__ binv,
                            const T* __restrict__ b, T omega, T* y, T* d,
                            int64_t plane) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const T v = from_zero<T, NF>(binv, b, omega, plane, p, f);
    y[f * plane + p] = v;
    if (d != nullptr) d[f * plane + p] = v;
  }
}

template <class T, int NF>
cudaError_t launch_zero(const void* binv, const void* b, double omega,
                        void* y, void* d, int64_t n, cudaStream_t stream) {
  zero_kernel<T, NF><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      (const T*)binv, (const T*)b, (T)omega, (T*)y, (T*)d, n);
  return cudaGetLastError();
}

// A block's opt-in shared memory limit on this card: on an H100 232,448
// bytes, which the wrappers take as H100_SMEM_OPTIN_BYTES
// (ops/stencil_kernels.py) to refuse a 2D radius before any work.
int optin_bytes() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return v;
}

// -- 2D ----------------------------------------------------------------------

constexpr int kTile2 = 16;   // 16 x 16 output points per block

// the dynamic shared memory of a 2D block: the x tile and its 2r halo, nF
// fields
template <class T>
size_t tile_bytes(int radius, int nf) {
  const size_t side = kTile2 + 2 * (size_t)radius;
  return side * side * nf * sizeof(T);
}

// x at q: through the read-only cache in a pass launch; in a level's
// launch (LEVEL) through the L2 alone (ld.global.cg), since x there is
// what other blocks of the same launch wrote before the last grid barrier,
// and the read-only and L1 caches are not coherent with those writes.
template <bool LEVEL, class T>
__device__ __forceinline__ T ld_x(const T* q) {
  if constexpr (LEVEL) {
    return __ldcg(q);
  } else {
    return __ldg(q);
  }
}

// One pass of MODE on the 16 x 16 tile at (i0, j0) (stencil2d_block's
// modes 0-2; x null in the sweep: the tile is staged as the sweep from
// zero, omega Binv b), x read through ld_x: the body of pass2d_kernel and
// level2d_kernel. All threads of the block call it; xs is the tile.
template <class T, int NF, int MODE, bool LEVEL>
__device__ __forceinline__ void pass2d(const T* __restrict__ C,
                                       const T* __restrict__ x,
                                       const T* __restrict__ b,
                                       const T* __restrict__ binv, T omega,
                                       T* __restrict__ y, int nx, int ny,
                                       int r, int i0, int j0, T* xs) {
  const int m = 2 * r + 1;
  const int side = kTile2 + 2 * r;
  const int tid = threadIdx.y * kTile2 + threadIdx.x;
  const int64_t plane = (int64_t)nx * ny;
  for (int t = tid; t < NF * side * side; t += kTile2 * kTile2) {
    const int f = t / (side * side);
    const int rem = t - f * side * side;
    const int li = rem / side;
    const int gi = i0 + li - r;
    const int gj = j0 + (rem - li * side) - r;
    T v = T(0);
    if (gi >= 0 && gi < nx && gj >= 0 && gj < ny) {
      const int64_t q = (int64_t)gi * ny + gj;
      v = x != nullptr ? ld_x<LEVEL>(x + f * plane + q)
                       : from_zero<T, NF>(binv, b, omega, plane, q, f);
    }
    xs[t] = v;
  }
  __syncthreads();
  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  if (i >= nx || j >= ny) return;
  const int64_t p = (int64_t)i * ny + j;
  const int64_t m2 = (int64_t)m * m;
  T acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = T(0);
#pragma unroll 1
  for (int f2 = 0; f2 < NF; ++f2) {
#pragma unroll 1
    for (int oi = 0; oi < m; ++oi) {
      const T* xr = xs + ((int64_t)f2 * side + threadIdx.y + oi) * side +
                    threadIdx.x;
      const T* Cq = C + (f2 * m2 + oi * m) * plane + p;
#pragma unroll 2
      for (int oj = 0; oj < m; ++oj) {
        const T xv = xr[oj];
#pragma unroll
        for (int f1 = 0; f1 < NF; ++f1) {
          acc[f1] = fma_r(__ldg(Cq + (f1 * NF * m2 + oj) * plane), xv,
                          acc[f1]);
        }
      }
    }
  }
  if (MODE == kApply) {
#pragma unroll
    for (int f = 0; f < NF; ++f) y[f * plane + p] = acc[f];
    return;
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = __ldg(b + f * plane + p) - acc[f];
#pragma unroll
  for (int f1 = 0; f1 < NF; ++f1) {
    T v = acc[f1];
    if (MODE == kSweep) {
      v = xs[((int64_t)f1 * side + threadIdx.y + r) * side + threadIdx.x + r];
#pragma unroll
      for (int f2 = 0; f2 < NF; ++f2) {
        v = fma_r(omega * __ldg(binv + (int64_t)(f1 * NF + f2) * plane + p),
                  acc[f2], v);
      }
    }
    y[f1 * plane + p] = v;
  }
}

template <class T, int NF, int MODE>
__global__ void __launch_bounds__(kTile2 * kTile2)
pass2d_kernel(const T* __restrict__ C, const T* __restrict__ x,
              const T* __restrict__ b, const T* __restrict__ binv, T omega,
              T* __restrict__ y, int nx, int ny, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  pass2d<T, NF, MODE, false>(C, x, b, binv, omega, y, nx, ny, r,
                             blockIdx.y * kTile2, blockIdx.x * kTile2,
                             reinterpret_cast<T*>(smem_raw));
}

template <class T, int NF, int MODE>
cudaError_t launch_pass2d(const void* C, const void* x, const void* b,
                          const void* binv, double omega, void* y, int nx,
                          int ny, int r, cudaStream_t stream) {
  static cudaError_t raised = cudaErrorNotReady;
  const size_t smem = tile_bytes<T>(r, NF);
  if (smem > (size_t)optin_bytes()) return cudaErrorInvalidValue;
  if (smem > 48 * 1024 && raised != cudaSuccess) {
    raised = cudaFuncSetAttribute(pass2d_kernel<T, NF, MODE>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin_bytes());
    if (raised != cudaSuccess) return raised;
  }
  const dim3 grid((ny + kTile2 - 1) / kTile2, (nx + kTile2 - 1) / kTile2);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  pass2d_kernel<T, NF, MODE><<<grid, dim3(kTile2, kTile2), smem, stream>>>(
      (const T*)C, (const T*)x, (const T*)b, (const T*)binv, (T)omega,
      (T*)y, nx, ny, r);
  return cudaGetLastError();
}

template <class T, int NF>
cudaError_t pass2d_mode(int mode, const void* C, const void* x,
                        const void* b, const void* binv, double omega,
                        void* y, int nx, int ny, int r,
                        cudaStream_t stream) {
  switch (mode) {
    case kApply:
      return launch_pass2d<T, NF, kApply>(C, x, b, binv, omega, y, nx, ny, r,
                                          stream);
    case kResidual:
      return launch_pass2d<T, NF, kResidual>(C, x, b, binv, omega, y, nx, ny,
                                             r, stream);
    case kSweep:
      return launch_pass2d<T, NF, kSweep>(C, x, b, binv, omega, y, nx, ny, r,
                                          stream);
    case kSweepFromZero2:
      return launch_zero<T, NF>(binv, b, omega, y, nullptr,
                                (int64_t)nx * ny, stream);
  }
  return cudaErrorInvalidValue;
}

// Resident blocks per SM asked of the compiler for a level's launch: the
// 289 tiles of a 257 x 257 scalar level need 3 on the H100's 132 SMs (at
// most 80 registers); the block instances 1, where only small levels are
// co-resident.
template <int NF>
__host__ __device__ constexpr int level2d_blocks() {
  return NF == 1 ? 3 : 1;
}

// A level's smoothing call at radius r in one cooperative launch, one
// block per 16 x 16 tile: `sweeps` sweeps from x (x null: from zero, the
// first sweep omega Binv b folded into the next pass's staging, or with
// sweeps == 1 written to out, as zero_kernel writes it), the last written
// to out, the others ping-ponged between tmp and out; then res = b - A out
// when res is not null. A grid barrier separates the passes. The passes
// are pass2d_kernel's (the per-pass route's launches, in order) on the
// same tiles, so the two routes agree bitwise; x, out and tmp are staged
// through the L2 alone (ld_x<true>).
template <class T, int NF>
__global__ void __launch_bounds__(kTile2 * kTile2, level2d_blocks<NF>())
level2d_kernel(const T* __restrict__ C, const T* __restrict__ binv,
               const T* __restrict__ b, const T* x, T omega, int sweeps,
               T* out, T* tmp, T* res, int nx, int ny, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  const int i0 = blockIdx.y * kTile2;
  const int j0 = blockIdx.x * kTile2;
  const T* cur = x;
  int s = 0;
  if (x == nullptr) {
    const int i = i0 + threadIdx.y;
    const int j = j0 + threadIdx.x;
    if (sweeps == 1 && i < nx && j < ny) {
      const int64_t plane = (int64_t)nx * ny;
      const int64_t p = (int64_t)i * ny + j;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        out[f * plane + p] = from_zero<T, NF>(binv, b, omega, plane, p, f);
      }
    }
    s = 1;
  }
  for (; s < sweeps; ++s) {
    T* dst = ((sweeps - 1 - s) & 1) ? tmp : out;
    pass2d<T, NF, kSweep, true>(C, cur, b, binv, omega, dst, nx, ny, r, i0,
                                j0, xs);
    cur = dst;
    if (s + 1 < sweeps || res != nullptr) cg::this_grid().sync();
  }
  if (res != nullptr) {
    pass2d<T, NF, kResidual, true>(C, cur, b, binv, omega, res, nx, ny, r,
                                   i0, j0, xs);
  }
}

// Blocks of level2d_kernel<T, NF> the card holds at once with a radius-r
// tile each, the kernel's shared memory limit raised first where the tile
// needs it; asked once per instance and radius below kCachedRadii (the
// devices of one process are taken to be alike). An error where a query
// failed.
constexpr int kCachedRadii = 128;

template <class T, int NF>
cudaError_t level2d_capacity(int r, int* capacity) {
  static int cached[kCachedRadii] = {};
  if (r < kCachedRadii && cached[r] > 0) {
    *capacity = cached[r];
    return cudaSuccess;
  }
  static cudaError_t raised = cudaErrorNotReady;
  const size_t smem = tile_bytes<T>(r, NF);
  if (smem > (size_t)optin_bytes()) return cudaErrorInvalidValue;
  if (smem > 48 * 1024 && raised != cudaSuccess) {
    raised = cudaFuncSetAttribute(level2d_kernel<T, NF>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin_bytes());
    if (raised != cudaSuccess) return raised;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, level2d_kernel<T, NF>, kTile2 * kTile2, smem);
  }
  *capacity = sms * per_sm;
  if (e == cudaSuccess && r < kCachedRadii) cached[r] = *capacity;
  return e;
}

inline int64_t tiles2d(int nx, int ny) {
  return (int64_t)((nx + kTile2 - 1) / kTile2) * ((ny + kTile2 - 1) / kTile2);
}

// The plan of a level's smoothing call at radius r: 1 (one launch) where
// every tile is co-resident, else 0; -1 where a query failed. The measured
// rule of the 2D level launches at every radius (tests/
// compare_smooth_routing.py --levels, H100, the V-cycle's two calls at
// every 2D path's levels that fit): eagerly, as the V-cycle makes the
// call, one launch took 0.32-1.01 of its passes' time (r = 5 f64: 257^2
// 0.98 / 0.98, 129^2 0.57 / 1.01, 65^2 0.70 / 0.62), and in a CUDA graph
// 0.73-1.05 (r = 5: 1.01-1.05); unlike the 3D level kernels these hold the
// pass kernel's occupancy, so a level whose planes outgrow the L2 loses
// nothing (r = 5 257^2, 63 MB; three fields r = 2 at 257^2, 59 MB, 0.98 /
// 0.92 eagerly).
template <class T, int NF>
int plan_level2d(int nx, int ny, int r) {
  int capacity = 0;
  if (level2d_capacity<T, NF>(r, &capacity) != cudaSuccess ||
      capacity == 0) {
    return -1;
  }
  return tiles2d(nx, ny) <= capacity;
}

template <class T, int NF>
cudaError_t launch_level2d(const void* C, const void* binv, const void* b,
                           const void* x, double omega, int sweeps, void* out,
                           void* tmp, void* res, int nx, int ny, int r,
                           cudaStream_t stream) {
  if (sweeps < 1) return cudaErrorInvalidValue;
  int capacity = 0;
  const cudaError_t e = level2d_capacity<T, NF>(r, &capacity);
  if (e != cudaSuccess) return e;
  if (tiles2d(nx, ny) > capacity) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((ny + kTile2 - 1) / kTile2, (nx + kTile2 - 1) / kTile2);
  cfg.blockDim = dim3(kTile2, kTile2);
  cfg.dynamicSmemBytes = tile_bytes<T>(r, NF);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  return cudaLaunchKernelEx(&cfg, level2d_kernel<T, NF>, (const T*)C,
                            (const T*)binv, (const T*)b, (const T*)x,
                            (T)omega, sweeps, (T*)out, (T*)tmp, (T*)res, nx,
                            ny, r);
}

// stencil2d_smooth_plan and stencil2d_smooth at a runtime radius r >= 1
template <class T>
int smooth_plan2d_entry(int nx, int ny, int radius, int nf) {
  if (nx <= 0 || ny <= 0 || radius < 1) return -1;
  switch (nf) {
    case 1: return plan_level2d<T, 1>(nx, ny, radius);
    case 2: return plan_level2d<T, 2>(nx, ny, radius);
    case 3: return plan_level2d<T, 3>(nx, ny, radius);
  }
  return -1;
}

template <class T>
int smooth2d_entry(const void* C, const void* binv, const void* b,
                   const void* x, double omega, int sweeps, void* out,
                   void* tmp, void* res, int nx, int ny, int radius, int nf,
                   void* stream) {
  if (nx <= 0 || ny <= 0 || radius < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL_RN(NF)                                                        \
  (int)launch_level2d<T, NF>(C, binv, b, x, omega, sweeps, out, tmp, res,  \
                             nx, ny, radius, s)
  switch (nf) {
    case 1: return CALL_RN(1);
    case 2: return CALL_RN(2);
    case 3: return CALL_RN(3);
  }
#undef CALL_RN
  return (int)cudaErrorInvalidValue;
}

// stencil2d_block at a runtime radius r >= 1
template <class T>
int block2d_entry(const void* C, const void* x, const void* b,
                  const void* binv, double omega, void* y, int nx, int ny,
                  int radius, int nf, int mode, void* stream) {
  if (nx <= 0 || ny <= 0 || radius < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (nf) {
    case 1:
      return (int)pass2d_mode<T, 1>(mode, C, x, b, binv, omega, y, nx, ny,
                                    radius, s);
    case 2:
      return (int)pass2d_mode<T, 2>(mode, C, x, b, binv, omega, y, nx, ny,
                                    radius, s);
    case 3:
      return (int)pass2d_mode<T, 3>(mode, C, x, b, binv, omega, y, nx, ny,
                                    radius, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace rn
}  // namespace

#endif  // IIFEA_STENCIL_RN_CUH_
