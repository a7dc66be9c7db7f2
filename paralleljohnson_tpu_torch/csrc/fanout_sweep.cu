// One Jacobi relaxation sweep of the batched Johnson fan-out, pulled over
// destination-sorted in-edges (CSC):
//
//     out[v, c] = min(old[v, c], min over edges u->v of old[u, c] + w)
//
// Replaces: paralleljohnson_tpu/ops/pallas_sweep.py::pallas_fanout_sweep
// (pallas_call at :255). That kernel buckets edges by (dst block, src
// block) so that two [vb, B] blocks sit in the TPU's 16 MB of VMEM. A
// Hopper block has 227 KB of shared memory, so the bucket grid is not
// carried over: each warp owns one destination row and gathers its
// in-neighbours' rows straight from device memory (through L1/L2). The
// result is the same Jacobi sweep: candidates read only `old`, and the
// minimum of exactly rounded f32 sums does not depend on order, so the
// kernel agrees bitwise with the plain PyTorch version.
//
// Bound on the H100: bytes. At least the [V, B] read and the [V, B] write
// plus the CSC edges (4(V+1) + 8E bytes); at most E*B*4 bytes of gathered
// rows when no gathered row hits in cache. The design keeps each gather
// wide: a lane reads 4 contiguous floats (16 bytes), so a warp reads one
// 512-byte row segment per in-edge, and column tiles beyond 128 take the
// y grid dimension. Skewed in-degrees (R-MAT) leave a few warps walking
// 10^4-edge lists while the rest of the card idles at the end of a sweep.
//
// The `improved` flag is set (plain store of 1) when any entry strictly
// drops; the caller zeroes it before the launch and reads it after.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kTileCols = 128;  // columns per warp: 32 lanes x 4

// VEC: B % 4 == 0 and 16-byte aligned rows, so a lane loads one float4.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
fanout_sweep_kernel(const float* __restrict__ old, float* __restrict__ out,
                    const int* __restrict__ indptr,
                    const int* __restrict__ src,
                    const float* __restrict__ w,
                    int* __restrict__ improved, int64_t V, int64_t B) {
  const int64_t v =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= V) return;  // whole warps leave together
  const int64_t col0 = (int64_t)blockIdx.y * kTileCols;
  const int e0 = indptr[v];
  const int e1 = indptr[v + 1];
  bool dropped = false;

  if (VEC) {
    const int64_t c = col0 + 4 * lane;
    if (c < B) {
      const float4 init =
          *reinterpret_cast<const float4*>(old + v * B + c);
      float4 acc = init;
      for (int e = e0; e < e1; ++e) {
        const int64_t u = __ldg(src + e);
        const float we = __ldg(w + e);
        const float4 du =
            __ldg(reinterpret_cast<const float4*>(old + u * B + c));
        acc.x = fminf(acc.x, du.x + we);
        acc.y = fminf(acc.y, du.y + we);
        acc.z = fminf(acc.z, du.z + we);
        acc.w = fminf(acc.w, du.w + we);
      }
      *reinterpret_cast<float4*>(out + v * B + c) = acc;
      dropped = acc.x < init.x || acc.y < init.y || acc.z < init.z ||
                acc.w < init.w;
    }
  } else {
    float init[4], acc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t c = col0 + lane + 32 * k;
      init[k] = c < B ? old[v * B + c] : 0.0f;
      acc[k] = init[k];
    }
    for (int e = e0; e < e1; ++e) {
      const int64_t u = __ldg(src + e);
      const float we = __ldg(w + e);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t c = col0 + lane + 32 * k;
        if (c < B) acc[k] = fminf(acc[k], __ldg(old + u * B + c) + we);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t c = col0 + lane + 32 * k;
      if (c < B) {
        out[v * B + c] = acc[k];
        dropped = dropped || acc[k] < init[k];
      }
    }
  }
  if (__any_sync(0xffffffffu, dropped) && lane == 0) *improved = 1;
}

}  // namespace

extern "C" int pj_fanout_sweep(const float* old, float* out,
                               const int* indptr, const int* src,
                               const float* w, int* improved, long long V,
                               long long B, void* stream) {
  if (V > 0 && B > 0) {
    const dim3 grid((unsigned)((V + kWarpsPerBlock - 1) / kWarpsPerBlock),
                    (unsigned)((B + kTileCols - 1) / kTileCols));
    const bool vec = (B % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(old) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vec) {
      fanout_sweep_kernel<true><<<grid, kThreads, 0, s>>>(
          old, out, indptr, src, w, improved, V, B);
    } else {
      fanout_sweep_kernel<false><<<grid, kThreads, 0, s>>>(
          old, out, indptr, src, w, improved, V, B);
    }
  }
  return (int)cudaGetLastError();
}
