// Kleene closure of one [t, t] diagonal tile of blocked Floyd-Warshall
// (in-tile Floyd-Warshall), on the FP32 pipes of an H100:
//
//     for k = 0 .. t-1:  m[i, j] <- min(m[i, j], m[i, k] + m[k, j])
//
// with row k and column k of each step read from the state BEFORE the
// step. Replaces: paralleljohnson_tpu/ops/fw.py::tile_kleene (:100), an
// XLA fori_loop of t rank-1 min-plus updates (no pallas_call); its body
// reads m before it writes it, and the difference shows when a diagonal
// entry goes negative (a negative cycle inside the tile): then m[i, k]
// and m[k, j] drop during step k itself.
//
// Bound on the H100: at t = 512 one closure is t^3 = 1.3e8 candidates,
// an add and a min each: 8 us of FP32 instructions, against 2 MB of
// bytes read and written once (0.6 us). The t steps are dependent, so
// the closure is bound by t launch latencies (~2 us each), not by
// either: ~1 ms at t = 512. What the design does: nothing clever, on
// purpose. The C entry point loops over the t steps itself (one kernel
// launch per step on the caller's stream, so the host pays one ctypes
// call per closure, not t), alternating two [t, t] scratch buffers so
// that every step reads the state before it and writes the next one
// (read-before-write without a grid barrier). Step 0 reads the caller's
// tile and the last step writes the caller's output, each through its
// own row stride, so a diagonal tile of a larger matrix is closed in
// place without a copy. A thread owns one column j and kRows rows: row
// k's value is one coalesced load per warp, column k's value one
// broadcast load per row. The tile stays in L2 (50 MB) between steps.
//
// The next design (ROADMAP): a thread-block cluster that holds the tile
// in distributed shared memory with one cluster barrier per step.
//
// Exactness: each candidate is one exactly rounded f32 add and fminf is
// exact, and the steps run in the reference's order, so the closure is
// bitwise the plain PyTorch loop's. No recursive sub-blocking inside the
// tile: it would change the association of float path sums. The build
// has no fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32;    // columns per block (one warp wide)
constexpr int kBY = 8;     // thread rows per block
constexpr int kRows = 4;   // rows per thread

__global__ void __launch_bounds__(kBX * kBY)
kleene_step(const float* src, long long ld_src, float* dst, long long ld_dst,
            int t, int k) {
  const int j = blockIdx.x * kBX + threadIdx.x;
  if (j >= t) return;
  const float rk = src[(long long)k * ld_src + j];
  const int i0 = blockIdx.y * (kBY * kRows) + threadIdx.y;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kBY;
    if (i < t) {
      const float cik = src[(long long)i * ld_src + k];
      dst[(long long)i * ld_dst + j] =
          fminf(src[(long long)i * ld_src + j], cik + rk);
    }
  }
}

}  // namespace

// The closure of the [t, t] tile at `in` (row stride ld_in) into `out`
// (row stride ld_out; may be `in` itself: only step 0 reads `in`, only
// step t-1 writes `out`). buf0 and buf1 are [t, t] scratch
// (row stride t): steps alternate between them. Returns
// cudaGetLastError() after the last launch.
extern "C" int pj_fw_kleene(const float* in, long long ld_in, float* out,
                            long long ld_out, float* buf0, float* buf1, int t,
                            void* stream) {
  if (t <= 0) return (int)cudaGetLastError();
  if (ld_in < t || ld_out < t || (t >= 2 && buf0 == nullptr) ||
      (t >= 3 && buf1 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kBX, kBY);
  const dim3 grid((unsigned)((t + kBX - 1) / kBX),
                  (unsigned)((t + kBY * kRows - 1) / (kBY * kRows)));
  float* bufs[2] = {buf0, buf1};
  const float* src = in;
  long long ld = ld_in;
  for (int k = 0; k < t; ++k) {
    float* dst = k == t - 1 ? out : bufs[k & 1];
    const long long ldd = k == t - 1 ? ld_out : (long long)t;
    kleene_step<<<grid, block, 0, s>>>(src, ld, dst, ldd, t, k);
    src = dst;
    ld = ldd;
  }
  return (int)cudaGetLastError();
}
