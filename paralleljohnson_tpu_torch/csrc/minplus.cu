// Tropical (min-plus) matrix product on the FP32 pipes of an H100:
//
//     out[i, j] = min over k of d[i, k] + a[k, j]      (+inf is the identity)
//
// Replaces: paralleljohnson_tpu/ops/pallas_kernels.py::minplus_pallas
// (pallas_call at :117, body _minplus_kernel). Tensor cores only compute
// sums of products, and DPX has no f32 add-min, so the product stays on
// the FP32 pipes, as it stayed off the MXU on the TPU.
//
// Bound on the H100: operations. An add and a min per candidate, two
// FP32 instructions that do not fuse the way an FMA does, so I*J*K
// candidates issue at half the FMA-counted 67 TFLOP/s. The dense route
// only runs at V <= 1024, so its products are small: V^3 (squaring) and
// B x V x V with B < V/2 (the iterate regime). What the design does:
//
// - Math per shared-memory read. A thread owns an 8x8 (TM = 8, 128-row
//   tiles) or 4x8 (TM = 4) register micro-tile: per k it reads its TM
//   rows of d as one or two LDS.128 and its 8 columns of a as two
//   LDS.128, and does 2 * TM * 8 instructions with them. The d stage is
//   stored k-major ([k][BM + 4]), so a thread's rows are contiguous for
//   the float4 read; a warp spans 4 thread rows x 8 thread columns, so
//   both reads are one wavefront.
// - Loads overlap math. A ring of kStages = 2 k-tiles (BK = 16) in
//   dynamic shared memory is filled by cp.async: the d tile element
//   by element (4-byte copies, which also transpose it), the a tile by
//   16-byte copies when J % 4 == 0, else 4-byte ones; tile t + 1 loads
//   while tile t computes. One barrier per k-tile. Out-of-range elements
//   (the ragged edge, k past the split's end) are plain +inf stores into
//   the stage, ordered by the same barrier.
// - Enough blocks for 132 SMs: exact split-K. The host plan
//   (ops/minplus.py, minplus_plan) picks the block's row count BM from I
//   (16, 32 or 128; a narrow source batch gets a narrow tile, not 64
//   rows of padding) and S splits of K, so that the grid fills the card's
//   resident block slots at the dense route's shapes. With S > 1 each
//   split writes its partial [I, J] to scratch and a second, elementwise
//   kernel folds the S partials with fminf.
//
// Exactness: every entry is the min of exactly rounded f32 sums
// (fminf(acc, d + a), accumulators start at +inf), and min is exact,
// associative and commutative, so any tiling, k order or split gives the
// same bits as the plain PyTorch version. The build has no fast-math.
//
// Fixpoint support (ops/minplus.py, minplus_fixpoint): when `improved` is
// given (and K == J) the product also sets it where any out[i, j] <
// d[i, j] -- in the epilogue, or in the fold when S > 1. When `prev` is
// given and holds 0, every kernel returns at entry and writes nothing, so
// the host can launch a group of products and read their flags once.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;     // output columns per block
constexpr int kBK = 16;      // k per stage
// k-tiles in flight: 2 (tile t + 1 loads while tile t computes). 3 and 4
// stages, and BK = 32, timed no faster on the H100 (PERF.md).
constexpr int kStages = 2;
constexpr unsigned kFull = 0xffffffffu;

// Block shape for BM output rows: 16 thread columns (8 output columns
// each: tx * 4 + [0, 4) and 64 + tx * 4 + [0, 4)) by R thread rows (TM
// contiguous output rows each).
template <int BM>
struct Tile {
  static constexpr int TM = BM == 128 ? 8 : 4;
  static constexpr int R = BM / TM;
  static constexpr int kThreads = 16 * R;
  static constexpr int kMinBlocks = BM == 128 ? 2 : BM == 32 ? 4 : 7;
  static constexpr int kDStride = BM + 4;
  static constexpr int kDFloats = kBK * kDStride;
  static constexpr int kStageFloats = kDFloats + kBK * kBN;
  static constexpr int kSmemBytes = kStages * kStageFloats * 4;
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Lane 0 of a warp in which any lane saw a drop sets the flag, only when
// an L1-cached read still shows 0 (as in fanout_sweep.cu: many stores to
// one word serialise on its L2 slice).
__device__ __forceinline__ void raise_flag(bool dropped, int* improved) {
  if (__any_sync(kFull, dropped) && (threadIdx.x & 31) == 0 &&
      __ldca(improved) == 0)
    *improved = 1;
}

// This thread's share of a stage's copies, fixed for the block. d: the
// tile elements (row r0 + q * DR, column kk0), q < BM * BK / threads; a
// (16-byte path): the float4 at (row ka0 + q * AR, column c0). Sources
// point at the split's first k; a stage for k-tile t adds t * BK.
template <int BM>
struct Copies {
  static constexpr int DR = Tile<BM>::kThreads / kBK;
  static constexpr int AR = Tile<BM>::kThreads / (kBN / 4);
  const float* dsrc;
  const float* asrc;
  int d_rows;   // tile rows left in d from row r0 (<= 0: none)
  int kk0, ka0, c0;
  bool col_ok;  // column c0 of the tile lies inside a (16-byte path)
};

// Issue the copies of k-tile t of the split into one stage; elements
// outside [0, I) x [kbeg, kend) or [kbeg, kend) x [0, J) become +inf.
// `k_left` = kend - (kbeg + t * BK).
template <int BM, bool VEC>
__device__ __forceinline__ void load_stage(float* stage, const Copies<BM>& c,
                                           int t, int k_left, int64_t K,
                                           int64_t J, int64_t j0) {
  using T = Tile<BM>;
  using C = Copies<BM>;
  float* ds = stage + c.kk0 * T::kDStride + threadIdx.x / kBK;
  const float* src = c.dsrc + t * kBK;
  const bool k_ok = c.kk0 < k_left;
#pragma unroll
  for (int q = 0; q < BM / C::DR; ++q) {
    if (k_ok && q * C::DR < c.d_rows)
      cp_async4(ds + q * C::DR, src + q * C::DR * K);
    else
      ds[q * C::DR] = CUDART_INF_F;
  }
  float* as = stage + T::kDFloats;
  const float* asrc = c.asrc + (int64_t)t * kBK * J;
  if (VEC) {
#pragma unroll
    for (int q = 0; q < kBK / C::AR; ++q) {
      float* dst = as + (c.ka0 + q * C::AR) * kBN + c.c0;
      if (c.col_ok && c.ka0 + q * C::AR < k_left)
        cp_async16(dst, asrc + q * C::AR * J);
      else
        *reinterpret_cast<float4*>(dst) =
            make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
    }
  } else {
#pragma unroll 1
    for (int idx = threadIdx.x; idx < kBK * kBN; idx += T::kThreads) {
      const int kk = idx / kBN;
      const int cc = idx % kBN;
      if (kk < k_left && j0 + cc < J)
        cp_async4(as + idx, asrc + kk * J + cc);
      else
        as[idx] = CUDART_INF_F;
    }
  }
}

// Block (x, y, z): output columns [128 x, 128 x + 128), rows [BM y, BM y +
// BM), k in split z: [z * k_split, min(K, (z + 1) * k_split)). Writes
// out (S == 1) or partial + z * I * J (S > 1).
template <int BM, bool VEC>
__global__ void __launch_bounds__(Tile<BM>::kThreads, Tile<BM>::kMinBlocks)
minplus_tiles(const float* __restrict__ d, const float* __restrict__ a,
              float* __restrict__ out, int64_t I, int64_t K, int64_t J,
              int64_t k_split, const int* __restrict__ prev,
              int* __restrict__ improved) {
  using T = Tile<BM>;
  constexpr int TM = T::TM;
  if (prev != nullptr && *prev == 0) return;
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int64_t i0 = (int64_t)blockIdx.y * BM;
  const int64_t j0 = (int64_t)blockIdx.x * kBN;
  const int64_t kbeg = (int64_t)blockIdx.z * k_split;
  const int64_t kend = min(K, kbeg + k_split);
  const int nkt = kend > kbeg ? (int)((kend - kbeg + kBK - 1) / kBK) : 0;
  if (gridDim.z > 1) out += (int64_t)blockIdx.z * I * J;

  float acc[TM][8];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = CUDART_INF_F;

  Copies<BM> cp;
  cp.kk0 = threadIdx.x % kBK;
  cp.d_rows = (int)min(I - i0 - (int64_t)(threadIdx.x / kBK), (int64_t)BM);
  cp.dsrc = d + (i0 + threadIdx.x / kBK) * K + kbeg + cp.kk0;
  if (VEC) {
    cp.ka0 = threadIdx.x / (kBN / 4);
    cp.c0 = 4 * (threadIdx.x % (kBN / 4));
    cp.col_ok = j0 + cp.c0 < J;
    cp.asrc = a + (kbeg + cp.ka0) * J + j0 + cp.c0;
  } else {
    cp.ka0 = cp.c0 = 0;
    cp.col_ok = true;
    cp.asrc = a + kbeg * J + j0;
  }
  const int k_span = (int)(kend - kbeg);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt)
      load_stage<BM, VEC>(smem + s * T::kStageFloats, cp, s, k_span - s * kBK,
                          K, J, j0);
    cp_async_commit();
  }
  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // The stage tile t + kStages - 1 goes into was read at step t - 1,
    // which every thread has finished (the barrier above).
    const int tn = t + kStages - 1;
    if (tn < nkt)
      load_stage<BM, VEC>(smem + (tn % kStages) * T::kStageFloats, cp, tn,
                          k_span - tn * kBK, K, J, j0);
    cp_async_commit();

    const float* ds = smem + (t % kStages) * T::kStageFloats + ty * TM;
    const float* as = smem + (t % kStages) * T::kStageFloats + T::kDFloats +
                      tx * 4;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float dv[TM];
#pragma unroll
      for (int m = 0; m < TM; m += 4) {
        const float4 x =
            *reinterpret_cast<const float4*>(ds + kk * T::kDStride + m);
        dv[m] = x.x;
        dv[m + 1] = x.y;
        dv[m + 2] = x.z;
        dv[m + 3] = x.w;
      }
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kBN);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kBN + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = fminf(acc[m][n], dv[m] + av[n]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: rows ty * TM + m, columns tx * 4 + c and 64 + tx * 4 + c.
  bool dropped = false;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int64_t gi = i0 + ty * TM + m;
    if (gi >= I) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gj = j0 + 64 * h + tx * 4;
      float* o = out + gi * J + gj;
      const float* v = &acc[m][4 * h];
      if (VEC) {
        if (gj < J) *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (gj + c < J) o[c] = v[c];
      }
      if (improved != nullptr && gridDim.z == 1) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (gj + c < J) dropped |= v[c] < __ldg(d + gi * K + gj + c);
      }
    }
  }
  if (improved != nullptr && gridDim.z == 1) raise_flag(dropped, improved);
}

// out = fminf over the S partials [S, n]; with `improved`, also the flag
// where out < d (d and out share the flat layout: K == J).
template <bool VEC>
__global__ void __launch_bounds__(256)
fold_splits(const float* __restrict__ partial, int splits, int64_t n,
            const float* __restrict__ d, float* __restrict__ out,
            const int* __restrict__ prev, int* __restrict__ improved) {
  if (prev != nullptr && *prev == 0) return;
  bool dropped = false;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (VEC) {
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n / 4;
         e += stride) {
      float4 v = __ldcs(reinterpret_cast<const float4*>(partial) + e);
      for (int s = 1; s < splits; ++s) {
        const float4 x = __ldcs(reinterpret_cast<const float4*>(partial + s * n) + e);
        v.x = fminf(v.x, x.x);
        v.y = fminf(v.y, x.y);
        v.z = fminf(v.z, x.z);
        v.w = fminf(v.w, x.w);
      }
      reinterpret_cast<float4*>(out)[e] = v;
      if (improved != nullptr) {
        const float4 o = __ldg(reinterpret_cast<const float4*>(d) + e);
        dropped |= v.x < o.x || v.y < o.y || v.z < o.z || v.w < o.w;
      }
    }
  } else {
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += stride) {
      float v = __ldcs(partial + e);
      for (int s = 1; s < splits; ++s) v = fminf(v, __ldcs(partial + s * n + e));
      out[e] = v;
      if (improved != nullptr) dropped |= v < __ldg(d + e);
    }
  }
  if (improved != nullptr) raise_flag(dropped, improved);
}

using TilesFn = void (*)(const float*, const float*, float*, int64_t, int64_t,
                         int64_t, int64_t, const int*, int*);

// The tile kernel for BM rows, with its dynamic shared memory allowed
// (once per kernel: above 48 KB it must be).
template <int BM, bool VEC>
cudaError_t tiles_kernel(TilesFn* fn) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      minplus_tiles<BM, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<BM>::kSmemBytes);
  *fn = minplus_tiles<BM, VEC>;
  return attr;
}

template <int BM>
cudaError_t tiles_fn(bool vec, TilesFn* fn, int* threads, int* smem) {
  *threads = Tile<BM>::kThreads;
  *smem = Tile<BM>::kSmemBytes;
  return vec ? tiles_kernel<BM, true>(fn) : tiles_kernel<BM, false>(fn);
}

cudaError_t pick(int rows, bool vec, TilesFn* fn, int* threads, int* smem) {
  switch (rows) {
    case 16: return tiles_fn<16>(vec, fn, threads, smem);
    case 32: return tiles_fn<32>(vec, fn, threads, smem);
    case 128: return tiles_fn<128>(vec, fn, threads, smem);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One product under a plan (ops/minplus.py, minplus_plan): tiles of
// `rows` x 128 outputs, `splits` splits of K of `k_split` each (a
// multiple of 16); with splits > 1, `partial` holds [splits, I, J] and
// the fold writes out. `prev` and `improved` may be null.
extern "C" int pj_minplus(const float* d, const float* a, float* out,
                          float* partial, long long I, long long K,
                          long long J, int rows, int splits,
                          long long k_split, const int* prev, int* improved,
                          void* stream) {
  if (I <= 0 || J <= 0) return (int)cudaGetLastError();
  if (splits < 1 || splits > 65535 || k_split < 1 || k_split % kBK != 0 ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = J % 4 == 0 && aligned16(a) && aligned16(out) &&
                   (splits == 1 || aligned16(partial));
  TilesFn fn;
  int threads, smem;
  const cudaError_t err = pick(rows, vec, &fn, &threads, &smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid_y = (I + rows - 1) / rows;
  if (grid_y > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((J + kBN - 1) / kBN), (unsigned)grid_y,
                  (unsigned)splits);
  fn<<<grid, threads, smem, s>>>(d, a, splits == 1 ? out : partial, I, K, J,
                                 k_split, prev, improved);
  if (splits > 1) {
    const long long n = I * J;
    const bool fvec = n % 4 == 0 && aligned16(partial) && aligned16(out) &&
                      (improved == nullptr || aligned16(d));
    const long long work = fvec ? n / 4 : n;
    const unsigned blocks =
        (unsigned)(work / 256 + 1 < 132 * 8 ? work / 256 + 1 : 132 * 8);
    if (fvec)
      fold_splits<true><<<blocks, 256, 0, s>>>(partial, splits, n, d, out,
                                               prev, improved);
    else
      fold_splits<false><<<blocks, 256, 0, s>>>(partial, splits, n, d, out,
                                                prev, improved);
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the tile kernel for `rows` (16-byte path).
extern "C" int pj_minplus_occupancy(int rows, int* blocks_per_sm) {
  TilesFn fn;
  int threads, smem;
  const cudaError_t err = pick(rows, true, &fn, &threads, &smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(fn), threads, smem);
}
