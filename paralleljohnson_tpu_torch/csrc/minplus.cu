// Tropical (min-plus) matrix product on the FP32 (or FP64) pipes of an
// H100:
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
// Exactness: every entry is the min of exactly rounded sums (fminf /
// cand_min(acc, d + a), accumulators start at +inf), and min is exact,
// associative and commutative, so any tiling, k order or split gives the
// same bits as the plain PyTorch version. The build has no fast-math.
//
// f64 (`pj_minplus_f64`, precision="f64"): a 4x4 micro-tile of doubles
// over 128 threads (16-row tiles, 4 blocks per SM) or 256 (32-row tiles,
// 2 blocks per SM; RESIDENT_F64 in ops/minplus.py, which never asks f64
// for 128 rows): 16 warps an SM, where the first f64 kernel's 4x8 tile
// (~160 registers a thread) held 8. A thread's 4 columns are two double2
// at tx * 2 + 64 h, so each LDS.128 of a warp still covers 128 contiguous
// bytes; its 4 rows of d are two double2. The d tile goes in by 8-byte
// cp.async copies (its transpose), the a tile by 16-byte ones, and the d
// stage's row pitch is BM + 2 doubles. fmin on doubles is no single
// instruction on sm_90a (cand_min below): the candidate is DADD, DSETP
// and two FSELs, two on the FP64 pipes (64 a clock per SM) and two on the
// FP32 ones, four issue slots of the SM's four a clock: either way 32
// candidates per SM per clock, the FP64 bound.
//
// Fixpoint support (ops/minplus.py, minplus_fixpoint): when `improved` is
// given (and K == J) the product also sets it where any out[i, j] <
// d[i, j] -- in the epilogue, or in the fold when S > 1. When `prev` is
// given and holds 0, every kernel returns at entry and writes nothing, so
// the host can launch a group of products and read their flags once.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "once_per_device.h"

namespace {

constexpr int kBN = 128;     // output columns per block
constexpr int kBK = 16;      // k per stage
// k-tiles in flight: 2 (tile t + 1 loads while tile t computes). 3 and 4
// stages, and BK = 32, timed no faster on the H100 (PERF.md).
constexpr int kStages = 2;
constexpr unsigned kFull = 0xffffffffu;

// A 16-byte vector of K values: float4 at f32, double2 at f64.
template <typename T> struct Lane;
template <> struct Lane<float> {
  using V = float4;
  static constexpr int K = 4;
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
};
template <> struct Lane<double> {
  using V = double2;
  static constexpr int K = 2;
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
};

__device__ __forceinline__ float at(const float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}
__device__ __forceinline__ double at(const double2& f, int i) {
  return i == 0 ? f.x : f.y;
}
__device__ __forceinline__ float& at(float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}
__device__ __forceinline__ double& at(double2& f, int i) {
  return i == 0 ? f.x : f.y;
}

__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }

// A candidate c into its accumulator. f32: fminf, one FMNMX. f64: fmin is
// DSETP.MIN and two selects plus a NaN fix-up and moves on sm_90a, while
// c < acc ? c : acc is DSETP and two FSELs (scripts/fp64_min_probe.cu: 22
// against 13 candidates a clock per SM). They agree wherever c is not
// NaN; a NaN c (an inf - inf sum) loses to acc in both, and acc, from
// +inf, is never NaN. (A tie of -0.0 and +0.0 keeps the earlier one.)
__device__ __forceinline__ float cand_min(float acc, float c) {
  return fminf(acc, c);
}
__device__ __forceinline__ double cand_min(double acc, double c) {
  return c < acc ? c : acc;
}

template <typename T>
__device__ __forceinline__ typename Lane<T>::V inf_vec() {
  typename Lane<T>::V v;
#pragma unroll
  for (int i = 0; i < Lane<T>::K; ++i) at(v, i) = Lane<T>::inf();
  return v;
}

// Block shape for BM output rows: TX = 128 / TN thread columns (TN output
// columns each: tx * K + TX K h + [0, K) for h < TN / K) by R = BM / TM
// thread rows (TM contiguous output rows each). A warp is 8 thread
// columns by 4 thread rows.
template <typename T, int BM>
struct Tile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static_assert(BM == 16 || BM == 32 || (kF32 && BM == 128),
                "f32 takes 16-, 32- and 128-row tiles, f64 16 and 32");
  static constexpr int K = Lane<T>::K;
  static constexpr int TM = BM == 128 ? 8 : 4;
  static constexpr int TN = kF32 ? 8 : 4;
  static constexpr int TX = kBN / TN;
  static constexpr int R = BM / TM;
  static_assert(TX % 8 == 0 && R % 4 == 0, "whole warps of 8 x 4 threads");
  static constexpr int kThreads = TX * R;
  static constexpr int kMinBlocks =
      kF32 ? (BM == 128 ? 2 : BM == 32 ? 4 : 7) : (BM == 32 ? 2 : 4);
  static constexpr int kDStride = BM + K;
  static constexpr int kDElems = kBK * kDStride;
  static constexpr int kStageElems = kDElems + kBK * kBN;
  static constexpr int kSmemBytes = kStages * kStageElems * (int)sizeof(T);
};

// One element's asynchronous copy (4 bytes at f32, 8 at f64).
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
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
// (16-byte path): the vector at (row ka0 + q * AR, column c0). Sources
// point at the split's first k; a stage for k-tile t adds t * BK.
template <typename T, int BM>
struct Copies {
  static constexpr int DR = Tile<T, BM>::kThreads / kBK;
  static constexpr int AR = Tile<T, BM>::kThreads / (kBN / Lane<T>::K);
  const T* dsrc;
  const T* asrc;
  int d_rows;   // tile rows left in d from row r0 (<= 0: none)
  int kk0, ka0, c0;
  bool col_ok;  // column c0 of the tile lies inside a (16-byte path)
};

// Issue the copies of k-tile t of the split into one stage; elements
// outside [0, I) x [kbeg, kend) or [kbeg, kend) x [0, J) become +inf.
// `k_left` = kend - (kbeg + t * BK).
template <typename T, int BM, bool VEC>
__device__ __forceinline__ void load_stage(T* stage, const Copies<T, BM>& c,
                                           int t, int k_left, int64_t K,
                                           int64_t J, int64_t j0) {
  using Tl = Tile<T, BM>;
  using C = Copies<T, BM>;
  T* ds = stage + c.kk0 * Tl::kDStride + threadIdx.x / kBK;
  const T* src = c.dsrc + t * kBK;
  const bool k_ok = c.kk0 < k_left;
#pragma unroll
  for (int q = 0; q < BM / C::DR; ++q) {
    if (k_ok && q * C::DR < c.d_rows)
      cp_async_elem(ds + q * C::DR, src + q * C::DR * K);
    else
      ds[q * C::DR] = Lane<T>::inf();
  }
  T* as = stage + Tl::kDElems;
  const T* asrc = c.asrc + (int64_t)t * kBK * J;
  if (VEC) {
#pragma unroll
    for (int q = 0; q < kBK / C::AR; ++q) {
      T* dst = as + (c.ka0 + q * C::AR) * kBN + c.c0;
      if (c.col_ok && c.ka0 + q * C::AR < k_left)
        cp_async16(dst, asrc + q * C::AR * J);
      else
        *reinterpret_cast<typename Lane<T>::V*>(dst) = inf_vec<T>();
    }
  } else {
#pragma unroll 1
    for (int idx = threadIdx.x; idx < kBK * kBN; idx += Tl::kThreads) {
      const int kk = idx / kBN;
      const int cc = idx % kBN;
      if (kk < k_left && j0 + cc < J)
        cp_async_elem(as + idx, asrc + kk * J + cc);
      else
        as[idx] = Lane<T>::inf();
    }
  }
}

// Block (x, y, z): output columns [128 x, 128 x + 128), rows [BM y, BM y +
// BM), k in split z: [z * k_split, min(K, (z + 1) * k_split)). Writes
// out (S == 1) or partial + z * I * J (S > 1).
template <typename T, int BM, bool VEC>
__global__ void __launch_bounds__(Tile<T, BM>::kThreads,
                                  Tile<T, BM>::kMinBlocks)
minplus_tiles(const T* __restrict__ d, const T* __restrict__ a,
              T* __restrict__ out, int64_t I, int64_t K, int64_t J,
              int64_t k_split, const int* __restrict__ prev,
              int* __restrict__ improved) {
  using Tl = Tile<T, BM>;
  using Vec = typename Lane<T>::V;
  constexpr int TM = Tl::TM;
  constexpr int TN = Tl::TN;
  constexpr int KV = Lane<T>::K;  // values per vector
  constexpr int NH = TN / KV;     // column vectors per thread
  constexpr int WX = Tl::TX / 8;  // warps across the tile's columns
  if (prev != nullptr && *prev == 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tx = (warp % WX) * 8 + (lane & 7);
  const int ty = (warp / WX) * 4 + (lane >> 3);
  const int64_t i0 = (int64_t)blockIdx.y * BM;
  const int64_t j0 = (int64_t)blockIdx.x * kBN;
  const int64_t kbeg = (int64_t)blockIdx.z * k_split;
  const int64_t kend = min(K, kbeg + k_split);
  const int nkt = kend > kbeg ? (int)((kend - kbeg + kBK - 1) / kBK) : 0;
  if (gridDim.z > 1) out += (int64_t)blockIdx.z * I * J;

  T acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = Lane<T>::inf();

  Copies<T, BM> cp;
  cp.kk0 = threadIdx.x % kBK;
  cp.d_rows = (int)min(I - i0 - (int64_t)(threadIdx.x / kBK), (int64_t)BM);
  cp.dsrc = d + (i0 + threadIdx.x / kBK) * K + kbeg + cp.kk0;
  if (VEC) {
    cp.ka0 = threadIdx.x / (kBN / KV);
    cp.c0 = KV * (threadIdx.x % (kBN / KV));
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
      load_stage<T, BM, VEC>(smem + s * Tl::kStageElems, cp, s,
                             k_span - s * kBK, K, J, j0);
    cp_async_commit();
  }
  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // The stage tile t + kStages - 1 goes into was read at step t - 1,
    // which every thread has finished (the barrier above).
    const int tn = t + kStages - 1;
    if (tn < nkt)
      load_stage<T, BM, VEC>(smem + (tn % kStages) * Tl::kStageElems, cp, tn,
                             k_span - tn * kBK, K, J, j0);
    cp_async_commit();

    const T* ds = smem + (t % kStages) * Tl::kStageElems + ty * TM;
    const T* as = smem + (t % kStages) * Tl::kStageElems + Tl::kDElems +
                  tx * KV;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      T dv[TM];
#pragma unroll
      for (int m = 0; m < TM; m += KV) {
        const Vec x = *reinterpret_cast<const Vec*>(ds + kk * Tl::kDStride + m);
#pragma unroll
        for (int i = 0; i < KV; ++i) dv[m + i] = at(x, i);
      }
      T av[TN];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const Vec x =
            *reinterpret_cast<const Vec*>(as + kk * kBN + Tl::TX * KV * h);
#pragma unroll
        for (int i = 0; i < KV; ++i) av[KV * h + i] = at(x, i);
      }
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n)
          acc[m][n] = cand_min(acc[m][n], dv[m] + av[n]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: rows ty * TM + m, columns TX K h + tx * K + c.
  bool dropped = false;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int64_t gi = i0 + ty * TM + m;
    if (gi >= I) continue;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int64_t gj = j0 + Tl::TX * KV * h + tx * KV;
      T* o = out + gi * J + gj;
      const T* v = &acc[m][KV * h];
      if (VEC) {
        if (gj < J) {
          Vec x;
#pragma unroll
          for (int c = 0; c < KV; ++c) at(x, c) = v[c];
          *reinterpret_cast<Vec*>(o) = x;
        }
      } else {
#pragma unroll
        for (int c = 0; c < KV; ++c)
          if (gj + c < J) o[c] = v[c];
      }
      if (improved != nullptr && gridDim.z == 1) {
#pragma unroll
        for (int c = 0; c < KV; ++c)
          if (gj + c < J) dropped |= v[c] < __ldg(d + gi * K + gj + c);
      }
    }
  }
  if (improved != nullptr && gridDim.z == 1) raise_flag(dropped, improved);
}

// out = min over the S partials [S, n]; with `improved`, also the flag
// where out < d (d and out share the flat layout: K == J).
template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
fold_splits(const T* __restrict__ partial, int splits, int64_t n,
            const T* __restrict__ d, T* __restrict__ out,
            const int* __restrict__ prev, int* __restrict__ improved) {
  using Vec = typename Lane<T>::V;
  constexpr int KV = Lane<T>::K;
  if (prev != nullptr && *prev == 0) return;
  bool dropped = false;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (VEC) {
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         e < n / KV; e += stride) {
      Vec v = __ldcs(reinterpret_cast<const Vec*>(partial) + e);
      for (int s = 1; s < splits; ++s) {
        const Vec x = __ldcs(reinterpret_cast<const Vec*>(partial + s * n) + e);
#pragma unroll
        for (int i = 0; i < KV; ++i) at(v, i) = vmin(at(v, i), at(x, i));
      }
      reinterpret_cast<Vec*>(out)[e] = v;
      if (improved != nullptr) {
        const Vec o = __ldg(reinterpret_cast<const Vec*>(d) + e);
#pragma unroll
        for (int i = 0; i < KV; ++i) dropped |= at(v, i) < at(o, i);
      }
    }
  } else {
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += stride) {
      T v = __ldcs(partial + e);
      for (int s = 1; s < splits; ++s) v = vmin(v, __ldcs(partial + s * n + e));
      out[e] = v;
      if (improved != nullptr) dropped |= v < __ldg(d + e);
    }
  }
  if (improved != nullptr) raise_flag(dropped, improved);
}

template <typename T>
using TilesFn = void (*)(const T*, const T*, T*, int64_t, int64_t, int64_t,
                         int64_t, const int*, int*);

// The tile kernel for BM rows, with its dynamic shared memory allowed
// (once per kernel and device: above 48 KB it must be).
template <typename T, int BM, bool VEC>
cudaError_t tiles_kernel(TilesFn<T>* fn) {
  const cudaError_t attr = once_per_device([] {
    return cudaFuncSetAttribute(minplus_tiles<T, BM, VEC>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Tile<T, BM>::kSmemBytes);
  });
  *fn = minplus_tiles<T, BM, VEC>;
  return attr;
}

template <typename T, int BM>
cudaError_t tiles_fn(bool vec, TilesFn<T>* fn, int* threads, int* smem) {
  *threads = Tile<T, BM>::kThreads;
  *smem = Tile<T, BM>::kSmemBytes;
  return vec ? tiles_kernel<T, BM, true>(fn) : tiles_kernel<T, BM, false>(fn);
}

template <typename T>
cudaError_t pick(int rows, bool vec, TilesFn<T>* fn, int* threads, int* smem) {
  switch (rows) {
    case 16: return tiles_fn<T, 16>(vec, fn, threads, smem);
    case 32: return tiles_fn<T, 32>(vec, fn, threads, smem);
    case 128:  // f32 only
      if constexpr (sizeof(T) == 4) return tiles_fn<T, 128>(vec, fn, threads, smem);
      else return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int product(const T* d, const T* a, T* out, T* partial, long long I,
            long long K, long long J, int rows, int splits, long long k_split,
            const int* prev, int* improved, void* stream) {
  constexpr int KV = Lane<T>::K;
  if (I <= 0 || J <= 0) return (int)cudaGetLastError();
  if (splits < 1 || splits > 65535 || k_split < 1 || k_split % kBK != 0 ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = J % KV == 0 && aligned16(a) && aligned16(out) &&
                   (splits == 1 || aligned16(partial));
  TilesFn<T> fn;
  int threads, smem;
  const cudaError_t err = pick<T>(rows, vec, &fn, &threads, &smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid_y = (I + rows - 1) / rows;
  if (grid_y > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((J + kBN - 1) / kBN), (unsigned)grid_y,
                  (unsigned)splits);
  fn<<<grid, threads, smem, s>>>(d, a, splits == 1 ? out : partial, I, K, J,
                                 k_split, prev, improved);
  if (splits > 1) {
    const long long n = I * J;
    const bool fvec = n % KV == 0 && aligned16(partial) && aligned16(out) &&
                      (improved == nullptr || aligned16(d));
    const long long work = fvec ? n / KV : n;
    const unsigned blocks =
        (unsigned)(work / 256 + 1 < 132 * 8 ? work / 256 + 1 : 132 * 8);
    if (fvec)
      fold_splits<T, true><<<blocks, 256, 0, s>>>(partial, splits, n, d, out,
                                                  prev, improved);
    else
      fold_splits<T, false><<<blocks, 256, 0, s>>>(partial, splits, n, d, out,
                                                   prev, improved);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int rows, int* blocks_per_sm) {
  TilesFn<T> fn;
  int threads, smem;
  const cudaError_t err = pick<T>(rows, true, &fn, &threads, &smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(fn), threads, smem);
}

}  // namespace

// One product under a plan (ops/minplus.py, minplus_plan): tiles of
// `rows` x 128 outputs, `splits` splits of K of `k_split` each (a
// multiple of 16); with splits > 1, `partial` holds [splits, I, J] and
// the fold writes out. `prev` and `improved` may be null. `pj_minplus`
// takes f32 values, `pj_minplus_f64` f64 ones.
extern "C" int pj_minplus(const float* d, const float* a, float* out,
                          float* partial, long long I, long long K,
                          long long J, int rows, int splits,
                          long long k_split, const int* prev, int* improved,
                          void* stream) {
  return product<float>(d, a, out, partial, I, K, J, rows, splits, k_split,
                        prev, improved, stream);
}

extern "C" int pj_minplus_f64(const double* d, const double* a, double* out,
                              double* partial, long long I, long long K,
                              long long J, int rows, int splits,
                              long long k_split, const int* prev,
                              int* improved, void* stream) {
  return product<double>(d, a, out, partial, I, K, J, rows, splits, k_split,
                         prev, improved, stream);
}

// Resident blocks per SM of the tile kernel for `rows` (16-byte path).
extern "C" int pj_minplus_occupancy(int rows, int* blocks_per_sm) {
  return occupancy<float>(rows, blocks_per_sm);
}

extern "C" int pj_minplus_occupancy_f64(int rows, int* blocks_per_sm) {
  return occupancy<double>(rows, blocks_per_sm);
}
