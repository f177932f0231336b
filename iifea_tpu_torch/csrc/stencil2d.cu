// Variable-coefficient 2D stencil apply and fused weighted-Jacobi sweep for
// Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernels iifea_tpu/ops/pallas_stencil.py
// `stencil_mv` (body `_mv_kernel`/`_taps`) and `jacobi_smooth` (body
// `_smooth_kernel`):
//
//   y[i,j] = sum_k C[k,i,j] * x[i+oi, j+oj],   k = (oi+r)*m + (oj+r), m = 2r+1
//   accumulating apply: y += A x               (block operators: y[f1] is
//                                               the sum of nF field applies)
//   jacobi: y = x + omega * invd * (b - A x)   (one pass, A x never stored)
//
// with x zero outside the (nx, ny) lattice. C is stored as m*m contiguous
// logical (nx, ny) planes, node id = i*ny + j; no tile padding.
//
// What bounds it: memory traffic. Every output point reads its m*m
// coefficients once (25 f32 for r=2) plus one x value and writes one y
// value: ~27 loads per 2*25 flops, far below the card's flop/byte balance.
// The design therefore reads each coefficient exactly once, coalesced along
// j (threadIdx.x runs along j), and stages the x tile with its r-wide halo in
// shared memory so the m*m shifted reads of x hit shared memory instead of
// device memory. The halo is zero-filled outside the lattice, which is the
// boundary masking of the zero-padded apply. The jacobi variant reads
// x[i,j] from the same shared tile, so a sweep costs one extra read each of
// invd and b and no round trip of A x through device memory.
//
// Launch contract: PyTorch's current stream, no synchronisation, no
// allocation (the caller allocates y). Each entry returns
// cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 8;   // output rows per block (blockDim.y)
constexpr int kTileY = 32;  // output cols per block (blockDim.x), one warp

template <int R, bool SMOOTH, bool ACC>
__global__ void __launch_bounds__(kTileX * kTileY)
stencil2d_kernel(const float* __restrict__ C, const float* __restrict__ x,
                 const float* __restrict__ invd, const float* __restrict__ b,
                 float omega, float* __restrict__ y, int nx, int ny) {
  constexpr int M = 2 * R + 1;
  constexpr int SX = kTileX + 2 * R;
  constexpr int SY = kTileY + 2 * R;
  __shared__ float xs[SX][SY];

  const int i0 = blockIdx.y * kTileX;
  const int j0 = blockIdx.x * kTileY;
  const int tid = threadIdx.y * kTileY + threadIdx.x;

  // x tile plus halo; zero outside the lattice
  for (int t = tid; t < SX * SY; t += kTileX * kTileY) {
    const int li = t / SY;
    const int lj = t - li * SY;
    const int gi = i0 + li - R;
    const int gj = j0 + lj - R;
    float v = 0.0f;
    if (gi >= 0 && gi < nx && gj >= 0 && gj < ny) {
      v = x[(int64_t)gi * ny + gj];
    }
    xs[li][lj] = v;
  }
  __syncthreads();

  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  if (i >= nx || j >= ny) return;

  const int64_t plane = (int64_t)nx * ny;
  const int64_t p = (int64_t)i * ny + j;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < M * M; ++k) {
    const int oi = k / M;
    const int oj = k - oi * M;
    acc = fmaf(C[k * plane + p], xs[threadIdx.y + oi][threadIdx.x + oj], acc);
  }
  if (SMOOTH) {
    const float xc = xs[threadIdx.y + R][threadIdx.x + R];
    y[p] = xc + omega * invd[p] * (b[p] - acc);
  } else if (ACC) {
    y[p] += acc;
  } else {
    y[p] = acc;
  }
}

template <bool SMOOTH, bool ACC>
int launch(const float* C, const float* x, const float* invd, const float* b,
           float omega, float* y, int nx, int ny, int radius,
           cudaStream_t stream) {
  if (nx <= 0 || ny <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kTileY, kTileX);
  const dim3 grid((ny + kTileY - 1) / kTileY, (nx + kTileX - 1) / kTileX);
  if (radius == 1) {
    stencil2d_kernel<1, SMOOTH, ACC><<<grid, block, 0, stream>>>(
        C, x, invd, b, omega, y, nx, ny);
  } else if (radius == 2) {
    stencil2d_kernel<2, SMOOTH, ACC><<<grid, block, 0, stream>>>(
        C, x, invd, b, omega, y, nx, ny);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y = A x
int stencil2d_mv(const float* C, const float* x, float* y, int nx, int ny,
                 int radius, void* stream) {
  return launch<false, false>(C, x, nullptr, nullptr, 0.0f, y, nx, ny,
                              radius, (cudaStream_t)stream);
}

// y += A x (y must not alias x)
int stencil2d_mv_acc(const float* C, const float* x, float* y, int nx,
                     int ny, int radius, void* stream) {
  return launch<false, true>(C, x, nullptr, nullptr, 0.0f, y, nx, ny,
                             radius, (cudaStream_t)stream);
}

// y = x + omega * invd * (b - A x)
int stencil2d_jacobi(const float* C, const float* invd, const float* b,
                     const float* x, float omega, float* y, int nx, int ny,
                     int radius, void* stream) {
  return launch<true, false>(C, x, invd, b, omega, y, nx, ny, radius,
                             (cudaStream_t)stream);
}

}  // extern "C"
