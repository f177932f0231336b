// Variable-coefficient 3D stencil apply, fused weighted-Jacobi sweep and
// fused Chebyshev smoothing step for Hopper (sm_90a), f32; and the block
// (multi-field) apply, residual and point-block sweep `stencil3d_block`
// (second half of this file).
//
// Replaces the Pallas TPU kernels iifea_tpu/ops/pallas_stencil.py
// `stencil_mv3` (body `_mv3_kernel`/`_taps3`) and `jacobi_smooth3` (body
// `_smooth3_kernel`), and extends the latter to the Chebyshev step of the
// 3D V-cycle smoother (iifea_tpu/ops/multigrid.py StencilMultigrid3D._smooth):
//
//   A x:    y[i,j,k] = sum_q C[q,i,j,k] * x[i+oi, j+oj, k+ok],
//           q = ((oi+r)*m + (oj+r))*m + (ok+r), m = 2r+1
//   jacobi: y = x + omega * invd * (b - A x)
//   cheb:   r = invd * (b - A x);  d' = alpha * r + beta * d;  y = x + d'
//           (d is updated in place; beta == 0 never reads d)
//
// with x zero outside the (nx, ny, nz) lattice. C is stored as m^3
// contiguous logical (nx, ny, nz) volumes, node id = (i*ny + j)*nz + k; no
// tile padding. Plane offsets are 64-bit (125 planes of 105^3 exceed 2^31
// elements' worth of bytes).
//
// What bounds it: memory traffic. Every output point reads its m^3
// coefficients once (125 f32 for r=2) plus one x value and writes one y
// value: ~127 loads per 250 flops, far below the card's flop/byte balance.
// Compulsory traffic at 105^3, r=2: 125 * 4.63 MB + x + y = 588 MB, i.e.
// 0.176 ms at 3.35 TB/s (the Chebyshev step adds invd, b and d read + d
// written: 607 MB, 0.181 ms). The design therefore reads each coefficient
// exactly once, coalesced along k (threadIdx.x runs along k, the contiguous
// axis), and stages the x tile with its r-wide halo in shared memory so the
// m^3 shifted reads of x hit shared memory instead of device memory. The
// halo is zero-filled outside the lattice, which is the boundary masking of
// the zero-padded apply. The smoothing variants read x[i,j,k] from the same
// shared tile, so a sweep never writes A x to device memory. Blocks are
// independent (no carried sum as on the TPU's sequential x-offset grid).
//
// Launch contract: PyTorch's current stream, no synchronisation, no
// allocation (the caller allocates y; y must not alias x, since
// neighbouring blocks read x's halo). Each entry returns cudaGetLastError()
// so a refused launch is reported to the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTZ = 32;  // output points along k per block (blockDim.x)
constexpr int kTY = 4;   // along j (blockDim.y)
constexpr int kTX = 2;   // along i (blockDim.z)
constexpr int kThreads = kTX * kTY * kTZ;

enum Mode { kMv = 0, kJacobi = 1, kCheb = 2 };

template <int R, int MODE>
__global__ void __launch_bounds__(kThreads)
stencil3d_kernel(const float* __restrict__ C, const float* __restrict__ x,
                 const float* __restrict__ invd, const float* __restrict__ b,
                 float* __restrict__ d, float s0, float s1,
                 float* __restrict__ y, int nx, int ny, int nz) {
  constexpr int M = 2 * R + 1;
  constexpr int SX = kTX + 2 * R;
  constexpr int SY = kTY + 2 * R;
  constexpr int SZ = kTZ + 2 * R;
  __shared__ float xs[SX][SY][SZ];

  const int i0 = blockIdx.z * kTX;
  const int j0 = blockIdx.y * kTY;
  const int k0 = blockIdx.x * kTZ;
  const int tid = (threadIdx.z * kTY + threadIdx.y) * kTZ + threadIdx.x;

  // x tile plus halo; zero outside the lattice
  for (int t = tid; t < SX * SY * SZ; t += kThreads) {
    const int li = t / (SY * SZ);
    const int rem = t - li * (SY * SZ);
    const int lj = rem / SZ;
    const int lk = rem - lj * SZ;
    const int gi = i0 + li - R;
    const int gj = j0 + lj - R;
    const int gk = k0 + lk - R;
    float v = 0.0f;
    if (gi >= 0 && gi < nx && gj >= 0 && gj < ny && gk >= 0 && gk < nz) {
      v = x[((int64_t)gi * ny + gj) * nz + gk];
    }
    xs[li][lj][lk] = v;
  }
  __syncthreads();

  const int i = i0 + threadIdx.z;
  const int j = j0 + threadIdx.y;
  const int k = k0 + threadIdx.x;
  if (i >= nx || j >= ny || k >= nz) return;

  const int64_t plane = (int64_t)nx * ny * nz;
  const int64_t p = ((int64_t)i * ny + j) * nz + k;
  const float* Cp = C + p;
  float acc = 0.0f;
#pragma unroll
  for (int oi = 0; oi < M; ++oi) {
#pragma unroll
    for (int oj = 0; oj < M; ++oj) {
#pragma unroll
      for (int ok = 0; ok < M; ++ok) {
        const int q = (oi * M + oj) * M + ok;
        acc = fmaf(__ldg(Cp + q * plane),
                   xs[threadIdx.z + oi][threadIdx.y + oj][threadIdx.x + ok],
                   acc);
      }
    }
  }
  if (MODE == kMv) {
    y[p] = acc;
    return;
  }
  const float xc = xs[threadIdx.z + R][threadIdx.y + R][threadIdx.x + R];
  const float res = invd[p] * (b[p] - acc);
  if (MODE == kJacobi) {
    y[p] = xc + s0 * res;
  } else {
    const float dn = s1 != 0.0f ? fmaf(s0, res, s1 * d[p]) : s0 * res;
    d[p] = dn;
    y[p] = xc + dn;
  }
}

template <int MODE>
int launch(const float* C, const float* x, const float* invd, const float* b,
           float* d, float s0, float s1, float* y, int nx, int ny, int nz,
           int radius, cudaStream_t stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kTZ, kTY, kTX);
  const dim3 grid((nz + kTZ - 1) / kTZ, (ny + kTY - 1) / kTY,
                  (nx + kTX - 1) / kTX);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  if (radius == 1) {
    stencil3d_kernel<1, MODE><<<grid, block, 0, stream>>>(
        C, x, invd, b, d, s0, s1, y, nx, ny, nz);
  } else if (radius == 2) {
    stencil3d_kernel<2, MODE><<<grid, block, 0, stream>>>(
        C, x, invd, b, d, s0, s1, y, nx, ny, nz);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}


// -- block (multi-field) operators -------------------------------------------
//
// `stencil3d_block`: for NF = 1..3 fields on field-blocked vectors (NF*n,),
// coefficients C[f1][f2][q] as NF*NF*m^3 contiguous (nx, ny, nz) volumes and
// nodal smoother blocks Binv[f1][f2] as NF*NF volumes (NF = 1: the flat
// 1/diag), in ONE launch
//
//   apply:    y[f1] = sum_f2 sum_q C[f1,f2,q] * shift_q(x[f2])
//   residual: y = b - A x
//   sweep:    y[f1] = x[f1] + omega * sum_f2 Binv[f1,f2] * (b - A x)[f2]
//   zero:     y[f1] = omega * sum_f2 Binv[f1,f2] * b[f2]   (the sweep from
//             x = 0: no coefficient is read)
//
// The reference computes the apply as a scan of NF^2 * m^3 slice
// multiply-adds (iifea_tpu/ops/stencil.py StencilOperatorBlock3D.mv) and
// the sweep as an einsum over b - A x
// (iifea_tpu/ops/multigrid.py StencilMultigridBlock3D._smooth).
//
// What bounds it: the coefficient planes. At 3 x 97^3, r = 2 the 9 * 125
// volumes are 4.1 GB against 11 MB of x: ~1.23 ms at 3.35 TB/s. So: the x
// tiles of all NF fields, with halo, are staged once in shared memory
// (NF * 6*8*36 floats = 20.7 KB for r = 2, NF = 3); a thread keeps NF
// accumulators and reads each of its NF*NF*m^3 coefficients once, coalesced
// along k; volume offsets are 64-bit. Registers: the loop over (f2, oi) is
// kept rolled, so at most NF * m^2 coefficient loads are in flight per
// thread (75 for NF = 3, r = 2) instead of all NF*NF*m^3 = 1,125, which the
// compiler would otherwise hoist and spill.

enum BlockMode { kApply = 0, kResidual = 1, kSweep = 2, kZero = 3 };

template <int R, int NF, int MODE>
__global__ void __launch_bounds__(kThreads)
stencil3d_block_kernel(const float* __restrict__ C,
                       const float* __restrict__ x,
                       const float* __restrict__ b,
                       const float* __restrict__ binv, float omega,
                       float* __restrict__ y, int nx, int ny, int nz) {
  constexpr int M = 2 * R + 1;
  constexpr int M3 = M * M * M;
  constexpr int SX = kTX + 2 * R;
  constexpr int SY = kTY + 2 * R;
  constexpr int SZ = kTZ + 2 * R;
  __shared__ float xs[MODE == kZero ? 1 : NF][SX][SY][SZ];

  const int i0 = blockIdx.z * kTX;
  const int j0 = blockIdx.y * kTY;
  const int k0 = blockIdx.x * kTZ;
  const int64_t plane = (int64_t)nx * ny * nz;

  if (MODE != kZero) {
    const int tid = (threadIdx.z * kTY + threadIdx.y) * kTZ + threadIdx.x;
    // x tiles of every field plus halo; zero outside the lattice
    for (int t = tid; t < NF * SX * SY * SZ; t += kThreads) {
      const int f = t / (SX * SY * SZ);
      int rem = t - f * (SX * SY * SZ);
      const int li = rem / (SY * SZ);
      rem -= li * (SY * SZ);
      const int lj = rem / SZ;
      const int lk = rem - lj * SZ;
      const int gi = i0 + li - R;
      const int gj = j0 + lj - R;
      const int gk = k0 + lk - R;
      float v = 0.0f;
      if (gi >= 0 && gi < nx && gj >= 0 && gj < ny && gk >= 0 && gk < nz) {
        v = x[f * plane + ((int64_t)gi * ny + gj) * nz + gk];
      }
      xs[f][li][lj][lk] = v;
    }
    __syncthreads();
  }

  const int i = i0 + threadIdx.z;
  const int j = j0 + threadIdx.y;
  const int k = k0 + threadIdx.x;
  if (i >= nx || j >= ny || k >= nz) return;
  const int64_t p = ((int64_t)i * ny + j) * nz + k;

  float acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = 0.0f;

  if (MODE != kZero) {
    // rolled over (f2, oi): NF * M * M coefficient loads per trip
#pragma unroll 1
    for (int t = 0; t < NF * M; ++t) {
      const int f2 = t / M;
      const int oi = t - f2 * M;
      const float* Cp = C + ((int64_t)f2 * M3 + oi * M * M) * plane + p;
#pragma unroll
      for (int f1 = 0; f1 < NF; ++f1) {
#pragma unroll
        for (int oj = 0; oj < M; ++oj) {
#pragma unroll
          for (int ok = 0; ok < M; ++ok) {
            const int64_t q = (int64_t)f1 * NF * M3 + oj * M + ok;
            acc[f1] = fmaf(
                __ldg(Cp + q * plane),
                xs[f2][threadIdx.z + oi][threadIdx.y + oj][threadIdx.x + ok],
                acc[f1]);
          }
        }
      }
    }
  }

  if (MODE == kApply) {
#pragma unroll
    for (int f = 0; f < NF; ++f) y[f * plane + p] = acc[f];
    return;
  }
  float res[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) res[f] = b[f * plane + p] - acc[f];
  if (MODE == kResidual) {
#pragma unroll
    for (int f = 0; f < NF; ++f) y[f * plane + p] = res[f];
    return;
  }
#pragma unroll
  for (int f1 = 0; f1 < NF; ++f1) {
    float s = 0.0f;
#pragma unroll
    for (int f2 = 0; f2 < NF; ++f2) {
      s = fmaf(binv[(int64_t)(f1 * NF + f2) * plane + p], res[f2], s);
    }
    const float xc =
        MODE == kZero
            ? 0.0f
            : xs[f1][threadIdx.z + R][threadIdx.y + R][threadIdx.x + R];
    y[f1 * plane + p] = xc + omega * s;
  }
}

template <int R, int NF>
void launch_block_mode(int mode, dim3 grid, dim3 block, cudaStream_t stream,
                       const float* C, const float* x, const float* b,
                       const float* binv, float omega, float* y, int nx,
                       int ny, int nz) {
#define IIFEA_LAUNCH(MODE)                                             \
  stencil3d_block_kernel<R, NF, MODE><<<grid, block, 0, stream>>>(     \
      C, x, b, binv, omega, y, nx, ny, nz)
  switch (mode) {
    case kApply: IIFEA_LAUNCH(kApply); break;
    case kResidual: IIFEA_LAUNCH(kResidual); break;
    case kSweep: IIFEA_LAUNCH(kSweep); break;
    default: IIFEA_LAUNCH(kZero); break;
  }
#undef IIFEA_LAUNCH
}

template <int R>
int launch_block_fields(int n_fields, int mode, dim3 grid, dim3 block,
                        cudaStream_t stream, const float* C, const float* x,
                        const float* b, const float* binv, float omega,
                        float* y, int nx, int ny, int nz) {
  switch (n_fields) {
    case 1:
      launch_block_mode<R, 1>(mode, grid, block, stream, C, x, b, binv,
                              omega, y, nx, ny, nz);
      break;
    case 2:
      launch_block_mode<R, 2>(mode, grid, block, stream, C, x, b, binv,
                              omega, y, nx, ny, nz);
      break;
    case 3:
      launch_block_mode<R, 3>(mode, grid, block, stream, C, x, b, binv,
                              omega, y, nx, ny, nz);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y = A x
int stencil3d_mv(const float* C, const float* x, float* y, int nx, int ny,
                 int nz, int radius, void* stream) {
  return launch<kMv>(C, x, nullptr, nullptr, nullptr, 0.0f, 0.0f, y, nx, ny,
                     nz, radius, (cudaStream_t)stream);
}

// y = x + omega * invd * (b - A x)
int stencil3d_jacobi(const float* C, const float* invd, const float* b,
                     const float* x, float omega, float* y, int nx, int ny,
                     int nz, int radius, void* stream) {
  return launch<kJacobi>(C, x, invd, b, nullptr, omega, 0.0f, y, nx, ny, nz,
                         radius, (cudaStream_t)stream);
}

// d = alpha * invd * (b - A x) + beta * d (in place); y = x + d
int stencil3d_cheb(const float* C, const float* invd, const float* b,
                   const float* x, float* d, float alpha, float beta,
                   float* y, int nx, int ny, int nz, int radius,
                   void* stream) {
  return launch<kCheb>(C, x, invd, b, d, alpha, beta, y, nx, ny, nz, radius,
                       (cudaStream_t)stream);
}

// Block apply (mode 0), residual b - A x (1), point-block sweep
// x + omega * Binv * (b - A x) (2) or the sweep from zero omega * Binv * b
// (3) on n_fields = 1..3 fields in one launch; operands a mode does not read
// may be null. y must not alias x.
int stencil3d_block(const float* C, const float* x, const float* b,
                    const float* binv, float omega, float* y, int nx, int ny,
                    int nz, int radius, int n_fields, int mode,
                    void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || mode < kApply || mode > kZero) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kTZ, kTY, kTX);
  const dim3 grid((nz + kTZ - 1) / kTZ, (ny + kTY - 1) / kTY,
                  (nx + kTX - 1) / kTX);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  if (radius == 1) {
    return launch_block_fields<1>(n_fields, mode, grid, block,
                                  (cudaStream_t)stream, C, x, b, binv, omega,
                                  y, nx, ny, nz);
  }
  if (radius == 2) {
    return launch_block_fields<2>(n_fields, mode, grid, block,
                                  (cudaStream_t)stream, C, x, b, binv, omega,
                                  y, nx, ny, nz);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
