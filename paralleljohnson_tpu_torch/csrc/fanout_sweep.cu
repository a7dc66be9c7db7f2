// One Jacobi relaxation sweep of the batched Johnson fan-out, pulled over
// destination-sorted in-edges (CSC):
//
//     out[v, c] = min(old[v, c], min over edges u->v of old[u, c] + w)
//
// Replaces: paralleljohnson_tpu/ops/pallas_sweep.py::pallas_fanout_sweep
// (pallas_call at :255). That kernel buckets edges by (dst block, src
// block) so that two [vb, B] blocks sit in the TPU's 16 MB of VMEM. A
// Hopper block has 227 KB of shared memory, so the bucket grid is not
// carried over: warps gather in-neighbours' rows straight from device
// memory (through L1/L2). Every candidate reads `old` and the minimum of
// exactly rounded sums does not depend on order, so the kernel agrees
// bitwise with the plain PyTorch version however the edges are split.
//
// Two value types, one design: f32 (`pj_fanout_sweep`) and f64
// (`pj_fanout_sweep_f64`, precision="f64"). A lane moves 16 bytes per
// load either way: a float4, or a double2 at f64, so a pass of NV
// vectors per lane covers 32 * 4 NV f32 columns or 32 * 2 NV f64 columns
// in the same registers. The f64 plan takes NV by B on that narrower
// pass (plan below); its partial minima are f64 too.
//
// At f64 the gathered rows are twice the bytes and the sweep reads them
// at about the HBM rate, though the gather is skewed: on R-MAT-20 the 1%
// of sources with the most out-edges are the source of half the edges.
// Their rows, one pass wide, fit in the 50 MB L2, but the 8.6 GB a sweep
// at B = 512 streams through it (own rows, output, cold gathers) flushes
// them under plain LRU. So the f64 kernel takes per-edge hub flags
// (ops/fanout_sweep.py, hub_flags: the sources with the most out-edges,
// whose rows one pass wide fill a fixed share of the L2) and sets each
// access's L2 eviction priority (createpolicy, ld/st .L2::cache_hint;
// sm_80 and later): a gather from a hub is kept (evict_last), every
// other gather, the own-row read and the stores go first (evict_first).
// A graph without hubs (a grid) gets no flags and plain loads: there the
// hinted loads were slower than the read-only path (PERF.md). And the f64
// column passes run on the grid (blockIdx.y is the pass) instead of one
// after the other in each warp, so a hub's footprint at any moment is one
// pass of its row, not the whole row; with hubs a pass is at most 128
// columns (1 KB of a row). The f32 kernel keeps its plain loads and its
// in-warp pass loop.
//
// Bound on the H100: bytes. At least the [V, B] read and the [V, B] write
// plus the CSC (4(V+1) + (4 + s)E bytes, s the value size); at most
// E*B*s bytes of gathered rows when no gathered row hits in cache. What
// the design does about it:
//
// - Edge-balanced work items of at most L in-edges, one warp each, so a
//   skewed in-degree (R-MAT hubs of 10^4 edges) no longer leaves one warp
//   walking a whole row while the card idles. A row of at most L in-edges
//   is one item, found by its row number (warp n_pieces + v), so its own
//   chain of dependent loads stays indptr -> (src, w) -> gathers. A longer
//   row is cut into pieces of L edges, listed once per graph in a table
//   of (row, first edge, end edge) (ops/fanout_sweep.py,
//   build_work_items) and taken first (warps 0 .. n_pieces - 1); piece k
//   writes the partial minimum of its edges to `partial[k, :]`. A second,
//   small kernel folds old[v, :] and the row's partials into out[v, :]
//   and sets the flag there, against old, after every partial is in.
// - One warp covers all B columns of its item: 32 * K * NV columns per
//   pass (NV 16-byte vectors of K values per lane: K = 4 at f32, 2 at
//   f64), and a column loop inside the warp for wider B.
//   Each (src, w) pair is fetched once per edge and pass.
// - Many gathers in flight. A warp reads 32 (src, w) pairs with one
//   coalesced load and hands them out with __shfl_sync, so no lane waits
//   on an index load before a gather, and each lane issues U independent
//   row gathers into registers before folding any of them. (A per-warp
//   cp.async.cg ring of S stages in shared memory was measured beside it
//   on the H100 and was slower at every main-path width; PERF.md. TMA
//   does not fit: it has no row gather, and the rows are not a tile.)
// - One host sync per group of sweeps. Each launch reads the previous
//   sweep's flag (`prev`) and returns at entry when it is 0, so the host
//   can launch K sweeps ahead and read K flags at once; a skipped sweep
//   writes nothing.
//
// The `improved` flag is set when any entry strictly drops; the caller
// zeroes it before the launch. Up to one warp per row finds a drop, and
// ~10^5 stores to one word serialise on the L2 slice that holds it, so a
// warp stores only when an L1-cached read of the flag still shows 0 (a
// stale 0 costs one redundant store, never a lost one: L1 lines are
// invalidated between dependent launches, so a stale 1 from an earlier
// sweep cannot be read). The caller keeps each
// sweep's flag on a 128-byte line of its own, apart from the `prev` flag
// that every warp reads at entry.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// A lane's 16-byte vector of K values: float4 at f32, double2 at f64.
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

template <typename T>
constexpr bool kF64 = sizeof(T) == 8;

__device__ __forceinline__ float& at(float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

__device__ __forceinline__ double& at(double2& f, int i) {
  return i == 0 ? f.x : f.y;
}

__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }

template <typename T>
__device__ __forceinline__ typename Lane<T>::V inf_vec() {
  typename Lane<T>::V v;
#pragma unroll
  for (int i = 0; i < Lane<T>::K; ++i) at(v, i) = Lane<T>::inf();
  return v;
}

// Columns of one pass: 32 * K * NV starting at col0. VEC (B % K == 0,
// 16-byte aligned rows): group q of a lane is the vector at
// col0 + K (lane + 32 q). Scalar: element i of group q is column
// col0 + lane + 32 (K q + i).
template <int K, bool VEC>
__device__ __forceinline__ int64_t col_of(int64_t col0, int lane, int q,
                                          int i) {
  return VEC ? col0 + K * (lane + 32 * q) + i : col0 + lane + 32 * (K * q + i);
}

// L2 eviction policies (the f64 kernel with hubs): made once per thread,
// handed to each load or store. `keep` lines are evicted last, `stream`
// lines first.
__device__ __forceinline__ uint64_t l2_keep() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_stream() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ double2 ld_hint(const double2* p, uint64_t pol) {
  double2 v;
  asm("ld.global.nc.L2::cache_hint.v2.f64 {%0, %1}, [%2], %3;"
      : "=d"(v.x), "=d"(v.y)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ double ld_hint(const double* p, uint64_t pol) {
  double v;
  asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;"
      : "=d"(v)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void st_hint(double2* p, double2 v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v2.f64 [%0], {%1, %2}, %3;"
               ::"l"(p), "d"(v.x), "d"(v.y), "l"(pol)
               : "memory");
}

__device__ __forceinline__ void st_hint(double* p, double v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.f64 [%0], %1, %2;"
               ::"l"(p), "d"(v), "l"(pol)
               : "memory");
}

// A load or store under the L2 policy `pol` (L2), or through the
// read-only path and plainly (the f32 kernel, and the f64 one without
// hubs).
template <bool L2, typename T>
__device__ __forceinline__ T load(const T* p, uint64_t pol) {
  if constexpr (L2) return ld_hint(p, pol);
  else return __ldg(p);
}

template <bool L2, typename T>
__device__ __forceinline__ void store(T* p, T v, uint64_t pol) {
  if constexpr (L2) st_hint(p, v, pol);
  else *p = v;
}

// Lane's columns of `row` (+inf outside [0, B)), under the L2 policy
// `pol` when L2.
template <typename T, int NV, bool VEC, bool L2>
__device__ __forceinline__ void load_row(const T* __restrict__ row,
                                         int64_t col0, int lane, int64_t B,
                                         typename Lane<T>::V (&f)[NV],
                                         uint64_t pol) {
  using L = Lane<T>;
  using Vec = typename L::V;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    if (VEC) {
      const int64_t c = col_of<L::K, true>(col0, lane, q, 0);
      f[q] = c < B ? load<L2>(reinterpret_cast<const Vec*>(row + c), pol)
                   : inf_vec<T>();
    } else {
#pragma unroll
      for (int i = 0; i < L::K; ++i) {
        const int64_t c = col_of<L::K, false>(col0, lane, q, i);
        at(f[q], i) = c < B ? load<L2>(row + c, pol) : L::inf();
      }
    }
  }
}

template <typename T, int NV, bool VEC, bool L2>
__device__ __forceinline__ void store_row(T* __restrict__ row, int64_t col0,
                                          int lane, int64_t B,
                                          typename Lane<T>::V (&f)[NV],
                                          uint64_t pol) {
  using L = Lane<T>;
  using Vec = typename L::V;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    if (VEC) {
      const int64_t c = col_of<L::K, true>(col0, lane, q, 0);
      if (c < B) store<L2>(reinterpret_cast<Vec*>(row + c), f[q], pol);
    } else {
#pragma unroll
      for (int i = 0; i < L::K; ++i) {
        const int64_t c = col_of<L::K, false>(col0, lane, q, i);
        if (c < B) store<L2>(row + c, at(f[q], i), pol);
      }
    }
  }
}

// Whether any in-range column of acc is strictly below init.
template <typename T, int NV, bool VEC>
__device__ __forceinline__ bool any_drop(int64_t col0, int lane, int64_t B,
                                         typename Lane<T>::V (&acc)[NV],
                                         typename Lane<T>::V (&init)[NV]) {
  constexpr int K = Lane<T>::K;
  bool dropped = false;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (col_of<K, VEC>(col0, lane, q, i) < B)
        dropped |= at(acc[q], i) < at(init[q], i);
    }
  }
  return dropped;
}

template <typename T>
__device__ __forceinline__ void fold(typename Lane<T>::V& acc,
                                     typename Lane<T>::V& x, T w) {
#pragma unroll
  for (int i = 0; i < Lane<T>::K; ++i) at(acc, i) = vmin(at(acc, i), at(x, i) + w);
}

// End of a pass: a whole row folds old[v] in last (the min does not
// depend on order) and notes whether any column dropped below it; old is
// read only here, so it holds no registers during the edge loop. Then
// the pass's columns are stored (to out[v], or to partial[slot]); with
// L2 both stream through the L2 (`pol`).
template <typename T, int NV, bool VEC, bool L2>
__device__ __forceinline__ bool finish_pass(const T* __restrict__ own,
                                            T* __restrict__ dst, bool whole,
                                            int64_t col0, int lane, int64_t B,
                                            typename Lane<T>::V (&acc)[NV],
                                            uint64_t pol) {
  bool dropped = false;
  if (whole) {
    typename Lane<T>::V init[NV];
    load_row<T, NV, VEC, L2>(own, col0, lane, B, init, pol);
    dropped = any_drop<T, NV, VEC>(col0, lane, B, acc, init);
#pragma unroll
    for (int q = 0; q < NV; ++q) {
#pragma unroll
      for (int i = 0; i < Lane<T>::K; ++i)
        at(acc[q], i) = vmin(at(init[q], i), at(acc[q], i));
    }
  }
  store_row<T, NV, VEC, L2>(dst, col0, lane, B, acc, pol);
  return dropped;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Lane 0 of a warp in which any lane dropped sets the flag (see the top).
__device__ __forceinline__ void raise_flag(bool dropped, int lane,
                                           int* improved) {
  if (__any_sync(kFull, dropped) && lane == 0 && __ldca(improved) == 0)
    *improved = 1;
}

// The item of warp k. Warps below n_pieces take piece k of a split row
// from the table (row, first edge, end edge) and store partial[k]; warp
// n_pieces + v takes row v whole and stores out[v], unless v has more
// than L in-edges (its pieces cover it). False: nothing to do. A whole
// row's own old[v], columns [c0, c1), is prefetched into L2 first (it is
// folded in last), so the chain of dependent loads is indptr, (src, w),
// the gathers.
struct Item {
  int64_t row;
  int e0, e1;
  bool whole;
};

template <typename T>
__device__ __forceinline__ bool fetch_item(
    const int* __restrict__ indptr, const int* __restrict__ pieces,
    int64_t n_pieces, int64_t V, int L, const T* __restrict__ old, int64_t B,
    int64_t c0, int64_t c1, int lane, int64_t k, Item& it) {
  constexpr int K = Lane<T>::K;
  if (k < n_pieces) {
    it.row = __ldg(pieces + 3 * k);
    it.e0 = __ldg(pieces + 3 * k + 1);
    it.e1 = __ldg(pieces + 3 * k + 2);
    it.whole = false;
    return true;
  }
  const int64_t v = k - n_pieces;
  if (v >= V) return false;
  for (int64_t c = c0 + K * lane; c < c1; c += 32 * K)
    prefetch_l2(old + v * B + c);
  it.row = v;
  it.e0 = __ldg(indptr + v);
  it.e1 = __ldg(indptr + v + 1);
  it.whole = true;
  return it.e1 - it.e0 <= L;
}

// One warp per item: per lane, U row gathers (NV vectors each) issued
// back to back, then folded. The scalar path's column arithmetic needs
// more registers: at NV >= 2 it holds 2 blocks per SM instead of
// spilling. The registers per NV are the same at both value types (a
// vector is 16 bytes either way); f64 weights take two per gather.
//
// At f64 blockIdx.y is the column pass. L2 (f64 with hub flags): bit 31
// of a lane's source id carries the edge's flag (`hub`, one byte per
// edge) to the lane that gathers the row, which it keeps in L2
// (evict_last); every other access streams (evict_first).
template <typename T, int NV, bool VEC, int U, bool L2>
__global__ void __launch_bounds__(kThreads, NV >= 4 || (!VEC && NV >= 2) ? 2 : 3)
sweep_items(const T* __restrict__ old, T* __restrict__ out,
            const int* __restrict__ src, const T* __restrict__ w,
            const unsigned char* __restrict__ hub,
            const int* __restrict__ indptr, const int* __restrict__ pieces,
            int64_t n_pieces, int64_t V, int L, T* __restrict__ partial,
            const int* __restrict__ prev, int* __restrict__ improved,
            int64_t B) {
  using Vec = typename Lane<T>::V;
  constexpr int K = Lane<T>::K;
  constexpr bool kGridPasses = kF64<T>;
  constexpr int64_t kPass = 32 * K * NV;
  if (*prev == 0) return;
  const int lane = threadIdx.x & 31;
  const int64_t k = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t c0 = kGridPasses ? (int64_t)blockIdx.y * kPass : 0;
  const int64_t c1 = kGridPasses ? min(B, c0 + kPass) : B;
  Item it;
  if (!fetch_item<T>(indptr, pieces, n_pieces, V, L, old, B, c0, c1, lane, k,
                     it))
    return;
  uint64_t keep = 0, stream = 0;
  if constexpr (L2) {
    keep = l2_keep();
    stream = l2_stream();
  }
  const bool whole = it.whole;
  T* dst = whole ? out + it.row * B : partial + k * B;
  bool dropped = false;
  for (int64_t col0 = c0; col0 < c1; col0 += kPass) {
    Vec acc[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) acc[q] = inf_vec<T>();
    for (int eb = it.e0; eb < it.e1; eb += 32) {
      const int n = min(32, it.e1 - eb);
      int my_u = lane < n ? __ldg(src + eb + lane) : 0;
      if (L2 && lane < n && __ldg(hub + eb + lane)) my_u |= INT32_MIN;
      const T my_w = lane < n ? __ldg(w + eb + lane) : T(0);
      for (int j = 0; j < n; j += U) {
        Vec g[U][NV];
        T wj[U];
#pragma unroll
        for (int t = 0; t < U; ++t) {
          const int p = __shfl_sync(kFull, my_u, (j + t) & 31);
          const int u = L2 ? p & INT32_MAX : p;
          wj[t] = __shfl_sync(kFull, my_w, (j + t) & 31);
          if (j + t < n)
            load_row<T, NV, VEC, L2>(old + (int64_t)u * B, col0, lane, B,
                                     g[t], p < 0 ? keep : stream);
        }
#pragma unroll
        for (int t = 0; t < U; ++t) {
          if (j + t < n) {
#pragma unroll
            for (int q = 0; q < NV; ++q) fold<T>(acc[q], g[t][q], wj[t]);
          }
        }
      }
    }
    dropped |= finish_pass<T, NV, VEC, L2>(old + it.row * B, dst, whole,
                                           col0, lane, B, acc, stream);
  }
  if (whole) raise_flag(dropped, lane, improved);
}

// Split rows: out[v] = min(old[v], partials of v's pieces); one warp per
// row, every column.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
combine_split_rows(const T* __restrict__ old, T* __restrict__ out,
                   const T* __restrict__ partial,
                   const int* __restrict__ split_rows,
                   const int* __restrict__ split_ptr, int64_t n_rows,
                   const int* __restrict__ prev, int* __restrict__ improved,
                   int64_t B) {
  using Vec = typename Lane<T>::V;
  constexpr int K = Lane<T>::K;
  if (*prev == 0) return;
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t row = __ldg(split_rows + r);
  const int p0 = __ldg(split_ptr + r);
  const int p1 = __ldg(split_ptr + r + 1);
  bool dropped = false;
  if (VEC) {
    for (int64_t c = K * lane; c < B; c += 32 * K) {
      Vec init = __ldg(reinterpret_cast<const Vec*>(old + row * B + c));
      Vec acc = init;
#pragma unroll 4
      for (int p = p0; p < p1; ++p) {
        Vec x = __ldg(reinterpret_cast<const Vec*>(partial + (int64_t)p * B + c));
#pragma unroll
        for (int i = 0; i < K; ++i) at(acc, i) = vmin(at(acc, i), at(x, i));
      }
      *reinterpret_cast<Vec*>(out + row * B + c) = acc;
#pragma unroll
      for (int i = 0; i < K; ++i) dropped |= at(acc, i) < at(init, i);
    }
  } else {
    for (int64_t c = lane; c < B; c += 32) {
      const T init = __ldg(old + row * B + c);
      T acc = init;
#pragma unroll 4
      for (int p = p0; p < p1; ++p)
        acc = vmin(acc, __ldg(partial + (int64_t)p * B + c));
      out[row * B + c] = acc;
      dropped |= acc < init;
    }
  }
  raise_flag(dropped, lane, improved);
}

template <typename T>
using ItemsFn = void (*)(const T*, T*, const int*, const T*,
                         const unsigned char*, const int*, const int*,
                         int64_t, int64_t, int, T*, const int*, int*,
                         int64_t);

template <typename T>
struct Plan {
  ItemsFn<T> fn;
  int depth;  // gathers per batch U
  int pass;   // columns per pass: 32 K NV
};

// Gathers per batch U. At f32, 16 vectors per lane in flight at most:
// U = 8 gathers at NV = 1, then 4, so the schedule stays within the
// launch bounds (3 blocks per SM below NV = 4, 2 at NV = 4 and on the
// scalar path from NV = 2). At f64 each gather's weight takes two
// registers more, and U = 8 at NV = 1 and 4 at NV = 4 spilled on the
// H100 (ptxas): U = 6 and 3 there keep the same bounds without spills.
// The f32 scalar path at NV = 4 (B % 4 != 0 above 256 columns) spilled
// 38 bytes at U = 4 in this templated source: U = 3 there.
template <typename T, int NV, bool VEC> struct Depth {
  static constexpr int U = NV >= 2 ? 4 : 8;
};
template <bool VEC> struct Depth<double, 1, VEC> {
  static constexpr int U = 6;
};
template <bool VEC> struct Depth<double, 4, VEC> {
  static constexpr int U = 3;
};
template <> struct Depth<float, 4, false> { static constexpr int U = 3; };

template <typename T, int NV, bool L2>
Plan<T> plan_nv(bool vec) {
  constexpr int UV = Depth<T, NV, true>::U, US = Depth<T, NV, false>::U;
  constexpr int kPass = 32 * Lane<T>::K * NV;
  if (vec) return {sweep_items<T, NV, true, UV, L2>, UV, kPass};
  return {sweep_items<T, NV, false, US, L2>, US, kPass};
}

// The L2 kernel exists at f64 and NV <= 2 only (plan below).
template <typename T, int NV>
Plan<T> plan_nv(bool vec, bool l2) {
  if constexpr (kF64<T> && NV <= 2) {
    if (l2) return plan_nv<T, NV, true>(vec);
  }
  return plan_nv<T, NV, false>(vec);
}

// NV by B: one pass of 32 K, 64 K or 128 K columns (128, 256, 512 at
// f32; 64, 128, 256 at f64); wider B loops over the widest pass inside
// the warp (f32) or on the grid (f64). With hubs (l2) the f64 passes are
// at most 128 columns wide: a hub's row is 1 KB a pass, so twice the hubs
// fit the same L2 bytes (at R-MAT-20 B = 512: 15.6 ms against 17.9 ms
// with 256-column passes; PERF.md).
template <typename T>
Plan<T> plan(int64_t B, bool vec, bool l2) {
  constexpr int K = Lane<T>::K;
  if (B <= 32 * K) return plan_nv<T, 1>(vec, l2);
  if (B <= 64 * K || (kF64<T> && l2)) return plan_nv<T, 2>(vec, l2);
  return plan_nv<T, 4>(vec, l2);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int sweep(const T* old, T* out, const int* indptr, const int* src, const T* w,
          const unsigned char* hub, const int* pieces, long long n_pieces,
          long long V, int L,
          T* partial, const int* split_rows, const int* split_ptr,
          long long n_split_rows, const int* prev, int* improved, long long B,
          void* stream) {
  if (B > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = B % Lane<T>::K == 0 && aligned16(old) && aligned16(out) &&
                     aligned16(partial);
    const long long n_items = n_pieces + V;
    if (n_items > 0) {
      // At f64 the column passes are the grid's y (pass 0 first).
      const Plan<T> p = plan<T>(B, vec, hub != nullptr);
      const dim3 grid((unsigned)((n_items + kWarps - 1) / kWarps),
                      kF64<T> ? (unsigned)((B + p.pass - 1) / p.pass) : 1u);
      p.fn<<<grid, kThreads, 0, s>>>(old, out, src, w, hub, indptr, pieces,
                                     n_pieces, V, L, partial, prev, improved,
                                     B);
    }
    if (n_split_rows > 0) {
      const unsigned grid = (unsigned)((n_split_rows + kWarps - 1) / kWarps);
      if (vec) {
        combine_split_rows<T, true><<<grid, kThreads, 0, s>>>(
            old, out, partial, split_rows, split_ptr, n_split_rows, prev,
            improved, B);
      } else {
        combine_split_rows<T, false><<<grid, kThreads, 0, s>>>(
            old, out, partial, split_rows, split_ptr, n_split_rows, prev,
            improved, B);
      }
    }
  }
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(long long B, int vec, int hubs, int* blocks_per_sm,
              int* gather_depth) {
  const Plan<T> p = plan<T>(B, vec != 0, hubs != 0);
  *gather_depth = p.depth;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(p.fn), kThreads, 0);
}

}  // namespace

// One sweep over V rows: the items kernel (n_pieces pieces of split rows,
// then every row of at most L in-edges whole), then the split-row
// combine. B % K != 0 or unaligned rows take the scalar lane path.
// `pj_fanout_sweep` takes f32 values (old, out, w, partial), and
// `pj_fanout_sweep_f64` f64 ones and the per-edge hub flags (`hub`, one
// byte per in-edge in CSC order, nonzero: keep the source's row in L2;
// null: no hubs).
extern "C" int pj_fanout_sweep(const float* old, float* out,
                               const int* indptr, const int* src,
                               const float* w, const int* pieces,
                               long long n_pieces, long long V, int L,
                               float* partial, const int* split_rows,
                               const int* split_ptr, long long n_split_rows,
                               const int* prev, int* improved, long long B,
                               void* stream) {
  return sweep<float>(old, out, indptr, src, w, nullptr, pieces, n_pieces, V,
                      L, partial, split_rows, split_ptr, n_split_rows, prev,
                      improved, B, stream);
}

extern "C" int pj_fanout_sweep_f64(const double* old, double* out,
                                   const int* indptr, const int* src,
                                   const double* w, const unsigned char* hub,
                                   const int* pieces,
                                   long long n_pieces, long long V, int L,
                                   double* partial, const int* split_rows,
                                   const int* split_ptr,
                                   long long n_split_rows, const int* prev,
                                   int* improved, long long B, void* stream) {
  return sweep<double>(old, out, indptr, src, w, hub, pieces, n_pieces, V, L,
                       partial, split_rows, split_ptr, n_split_rows, prev,
                       improved, B, stream);
}

// Resident blocks per SM and gather depth (gathers per batch U) of the
// items kernel that a sweep at width B launches, at f32 and at f64 (with
// hub flags or without).
extern "C" int pj_fanout_sweep_occupancy(long long B, int vec,
                                         int* blocks_per_sm,
                                         int* gather_depth) {
  return occupancy<float>(B, vec, 0, blocks_per_sm, gather_depth);
}

extern "C" int pj_fanout_sweep_occupancy_f64(long long B, int vec, int hubs,
                                             int* blocks_per_sm,
                                             int* gather_depth) {
  return occupancy<double>(B, vec, hubs, blocks_per_sm, gather_depth);
}
