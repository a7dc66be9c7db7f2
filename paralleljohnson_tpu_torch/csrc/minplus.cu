// Tropical (min-plus) matrix product on CUDA cores:
//
//     out[i, j] = min over k of d[i, k] + a[k, j]      (+inf is the identity)
//
// Replaces: paralleljohnson_tpu/ops/pallas_kernels.py::minplus_pallas
// (pallas_call at :117, body _minplus_kernel). Tensor cores only compute
// sums of products, so, as the MXU could not, they cannot run a min-plus;
// the product stays on the FP32 pipes.
//
// Bound on the H100: operations. I*J*K adds plus I*J*K mins on the FP32
// pipes, two instructions per step that do not fuse the way an FMA does,
// so they issue at half the FMA-counted FP32 FLOP rate. The design raises the work per byte of shared memory read: a
// block of 256 threads owns a 64x64 output tile and sweeps k in 32-wide
// tiles of d and a staged in shared memory; each thread keeps a 4x4
// register micro-tile, so every pair of shared-memory reads (4 of d, 4 of
// a) feeds 16 add+min pairs. Out-of-range loads read +inf, the
// accumulator starts at +inf, and the step is acc = fminf(acc, dv + av),
// so every entry is the exact min of exactly rounded f32 sums and the
// kernel agrees bitwise with the plain PyTorch version for any I, K, J.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTileI = 64;
constexpr int kTileJ = 64;
constexpr int kTileK = 32;
constexpr int kThreads = 256;  // 16 x 16, a 4x4 micro-tile each

__global__ void __launch_bounds__(kThreads)
minplus_kernel(const float* __restrict__ d, const float* __restrict__ a,
               float* __restrict__ out, int64_t I, int64_t K, int64_t J) {
  // d tile stored k-major with one pad column, so the transposing store
  // below hits 32 distinct banks.
  __shared__ float ds[kTileK][kTileI + 1];
  __shared__ __align__(16) float as[kTileK][kTileJ];

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int64_t i0 = (int64_t)blockIdx.y * kTileI;
  const int64_t j0 = (int64_t)blockIdx.x * kTileJ;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = CUDART_INF_F;

  for (int64_t k0 = 0; k0 < K; k0 += kTileK) {
    // 64 x 32 tile of d: consecutive threads read consecutive k of a row.
#pragma unroll
    for (int q = 0; q < (kTileI * kTileK) / kThreads; ++q) {
      const int idx = t + q * kThreads;
      const int r = idx / kTileK;
      const int kk = idx % kTileK;
      const int64_t gi = i0 + r;
      const int64_t gk = k0 + kk;
      ds[kk][r] = (gi < I && gk < K) ? d[gi * K + gk] : CUDART_INF_F;
    }
    // 32 x 64 tile of a: consecutive threads read consecutive j.
#pragma unroll
    for (int q = 0; q < (kTileK * kTileJ) / kThreads; ++q) {
      const int idx = t + q * kThreads;
      const int kk = idx / kTileJ;
      const int c = idx % kTileJ;
      const int64_t gk = k0 + kk;
      const int64_t gj = j0 + c;
      as[kk][c] = (gk < K && gj < J) ? a[gk * J + gj] : CUDART_INF_F;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) {
      float dv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dv[r] = ds[kk][ty * 4 + r];
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][tx * 4]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fminf(acc[r][0], dv[r] + av.x);
        acc[r][1] = fminf(acc[r][1], dv[r] + av.y);
        acc[r][2] = fminf(acc[r][2], dv[r] + av.z);
        acc[r][3] = fminf(acc[r][3], dv[r] + av.w);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t gi = i0 + ty * 4 + r;
    if (gi >= I) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t gj = j0 + tx * 4 + c;
      if (gj < J) out[gi * J + gj] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" int pj_minplus(const float* d, const float* a, float* out,
                          long long I, long long K, long long J,
                          void* stream) {
  if (I > 0 && J > 0) {
    const dim3 grid((unsigned)((J + kTileJ - 1) / kTileJ),
                    (unsigned)((I + kTileI - 1) / kTileI));
    minplus_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        d, a, out, I, K, J);
  }
  return (int)cudaGetLastError();
}
