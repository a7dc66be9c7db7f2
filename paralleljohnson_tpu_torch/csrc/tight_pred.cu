// Tight-edge predecessor extraction over the fan-out's in-edge CSC, on
// vertex-major converged distances dist[V, B]:
//
//     pred[v, c] = the (dist[u, c], u)-lexicographic minimum over in-edges
//                  (u, v, w) with |dist[u, c] + w - dist[v, c]|
//                  <= 4 eps max(|dist[v, c]|, 1), both sides finite;
//                  -1 where no in-edge is tight.
//
// Replaces: paralleljohnson_tpu/ops/pred.py::tight_pred_pass (:69), an
// XLA function (no pallas_call): per edge chunk it gathers [B, Ec] blocks
// of dist on src and dst, builds a tight mask and runs two unsorted
// segment_mins over B*V flattened segments. Here the pass pulls over the
// same CSC and work items as the fan-out sweep (csrc/fanout_sweep.cu), on
// the sweep's gather schedule, so dst rows need no gather and no segment
// ids exist.
//
// Bound on the H100: bytes, as for the sweep. At least dist read once,
// pred written once, the CSC, and the split rows' partial keys; the
// gathered source rows (E * B * 4 bytes) count as cache hits there.
// What the design does about it:
//
// - One warp per work item (ops/fanout_sweep.py, build_work_items): a
//   row of at most L in-edges whole, a longer row as pieces of L edges
//   taken first, each writing its partial keys to partial[piece, :]; a
//   second kernel folds each split row's pieces. A hub of 10^4 in-edges
//   does not leave one warp walking it alone.
// - One warp covers all B columns of its item in passes of 128 * NV
//   columns (NV float4 per lane: NV = 1 for B <= 128, else 2, looping
//   over 256-column passes inside the warp). Each (src, w) pair is
//   fetched once per edge and pass: 32 at a time with one coalesced
//   load, handed out by __shfl_sync. Each lane issues U row gathers of NV
//   float4 before testing any of them.
// - Registers set the speed: a candidate's test takes ~8 instructions,
//   so the gathers hide behind other warps' tests only with many warps
//   per SM. A lane holds NV * 4 (du, u) pairs and the row's own dv beside
//   its U * NV gathered float4; the tolerance is recomputed from dv once
//   per column and batch, not kept. Plan: U = 2 at 5 blocks per SM
//   (NV = 1), U = 1 at 4 (NV = 2), without spills. Measured on the H100
//   (PERF.md): wider passes as the sweep makes them (NV = 4 at B = 512,
//   16 pairs per lane) spill at 3 blocks per SM and run at 2, and were
//   1.5x slower; deeper U at fewer blocks was slower too.
// - The lexicographic minimum: a lane keeps the least (du, u) as a float
//   and an int, compared as floats (so -0.0 and +0.0 tie, as in the
//   reference's two segment minima, ops/pred.py, tight_pred_pass_plain)
//   and then by id. Pieces of split rows store it as one 64-bit key, an
//   order-keeping int32 image of du (-0.0 made +0.0) in the high half and
//   u in the low half, whose integer minimum is the same pair.
//
// With `sources` (int32[B]) the epilogue also settles the tree check's
// inputs, as ops/pred.py::tree_flags_plain does: it writes -1 at
// (sources[c], c), and raises flags[0] ("uncovered": a non-source entry
// with finite dv has no tight in-edge) and flags[1] ("nondescending": a
// chosen predecessor's du is not < dv). Every walk along a tree with
// neither flag strictly descends in dist, so it reaches a root: the
// caller skips the pointer-doubling check. A warp raises a flag only
// while an L1-cached read of it still shows 0, as the sweep raises
// `improved`; the caller zeroes both words before the launch.
//
// Arithmetic: __fadd_rn / __fsub_rn / __fmul_rn (never contracted into an
// FMA) and no fast-math, so the tight test rounds exactly as the plain
// PyTorch version's f32 ops do, and the result agrees bitwise.
//
// f64 (`pj_tight_pred_f64`, precision="f64"): the same schedule on
// double2 lanes (32 * 2 NV columns a pass: NV = 1 up to B = 64, else 2),
// __dadd_rn / __dsub_rn / __dmul_rn and a tolerance of 4 DBL_EPSILON, as
// the plain version takes finfo(float64).eps. A 64-bit image of a double
// and a 32-bit id do not fit one 64-bit key, so at f64 the least pair is
// compared as a pair in registers everywhere, and pieces of split rows
// write it as two words: du (f64) and u (int32) in two scratch arrays
// (none: +inf and -1; a tight du is finite, so +inf sorts after it). The
// combine takes their lexicographic minimum with the same comparison, as
// doubles, so -0.0 and +0.0 still tie and go to the lower id. Each
// resident block carries more live state than at f32 (a du takes two
// registers), so the f64 plan keeps one block per SM fewer (Tune).
//
// f64 on a skewed graph (the L2 kernel). The pass gathers the f64
// sweep's rows over the same CSC, so the sweep's hub flags apply as they
// are (ops/fanout_sweep.py hub_flags: one byte per in-edge, the sources
// whose rows, one 128-column pass wide, fill 24 MB of the L2). With
// flags (`hub`) and more than one pass (B > 128), the items kernel takes
// the sweep's L2 policies (csrc/fanout_sweep.cu): a hub's row slice is
// loaded evict_last, every other gather and the own row evict_first, the
// flag riding bit 31 of the source id through the shuffle (no dependent
// load); its column passes are the grid's y, pass 0 of every item first,
// so that a hub's footprint is one pass of its row; and each column's
// tolerance is made once per pass, beside dv, not per candidate. Without
// flags, or in one pass, the plain kernel stays as it was (plain loads,
// the in-warp pass loop, the tolerance per candidate): on R-MAT-20 the
// tolerance per pass was slower there (B = 512: 23.6 against 21.8 ms,
// B = 128: 5.10 against 4.67; PERF.md §6), and on the grid hinted
// loads were (the f64 sweep's, PERF.md). max(|dv|, 1) is
// `a > 1 ? a : 1` at f64 (as fast as fmax here; exact where it is used,
// |dv| finite). The test itself
// rounds as the plain version's f64 ops do (__dadd_rn, __dsub_rn,
// __dmul_rn; the written-out lexicographic compare).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNoKey = 0x7fffffffffffffffLL;

// A lane's 16-byte vector of K values (float4 at f32, double2 at f64),
// the int vector of the same K, the tolerance scale TOL_SCALE * eps and
// the correctly rounded arithmetic of the tight test.
template <typename T> struct Lane;
template <> struct Lane<float> {
  using V = float4;
  using IV = int4;
  static constexpr int K = 4;
  // TOL_SCALE * FLT_EPSILON = 4 * 2^-23.
  static constexpr float kTolEps = 4.0f * 1.1920928955078125e-07f;
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
  static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
};
template <> struct Lane<double> {
  using V = double2;
  using IV = int2;
  static constexpr int K = 2;
  // TOL_SCALE * DBL_EPSILON = 4 * 2^-52.
  static constexpr double kTolEps = 4.0 * 2.220446049250313080847e-16;
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
  // a is |dv| and finite wherever the tolerance uses it: exact.
  static __device__ __forceinline__ double max(double a, double b) { return a > b ? a : b; }
};

// Row gathers per batch (U) and resident blocks per SM of the items
// kernel, by value type, pass width NV and L2 policies (f64 with hub
// flags), on the vector and on the scalar lane path (whose column
// arithmetic takes more registers).
template <typename T, int NV, bool L2> struct Tune;
template <> struct Tune<float, 1, false> {
  static constexpr int U = 2, kBlocks = 5, kScalarBlocks = 4;
};
template <> struct Tune<float, 2, false> {
  static constexpr int U = 1, kBlocks = 4, kScalarBlocks = 2;
};
template <> struct Tune<double, 1, false> {
  static constexpr int U = 2, kBlocks = 4, kScalarBlocks = 3;
};
template <bool L2> struct Tune<double, 2, L2> {
  static constexpr int U = 1, kBlocks = 3, kScalarBlocks = 2;
};

// L2 eviction policies and hinted loads (as csrc/fanout_sweep.cu has
// them; sm_80 and later): `keep` lines are evicted last, `stream` lines
// first.
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

// A load under the L2 policy `pol` (L2), or through the read-only path.
template <bool L2, typename T>
__device__ __forceinline__ T load(const T* p, uint64_t pol) {
  if constexpr (L2) return ld_hint(p, pol);
  else return __ldg(p);
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

__device__ __forceinline__ float& at(float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}
__device__ __forceinline__ double& at(double2& f, int i) {
  return i == 0 ? f.x : f.y;
}
__device__ __forceinline__ int& at(int4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}
__device__ __forceinline__ int& at(int2& f, int i) {
  return i == 0 ? f.x : f.y;
}

template <typename V, typename S>
__device__ __forceinline__ V splat(S x) {
  V v;
  constexpr int K = sizeof(V) / sizeof(S);
#pragma unroll
  for (int i = 0; i < K; ++i) at(v, i) = x;
  return v;
}

// Lane's columns of `row` (+inf outside [0, B)), under the L2 policy
// `pol` when L2.
template <typename T, int NV, bool VEC, bool L2 = false>
__device__ __forceinline__ void load_row(const T* __restrict__ row,
                                         int64_t col0, int lane, int64_t B,
                                         typename Lane<T>::V (&f)[NV],
                                         uint64_t pol = 0) {
  using L = Lane<T>;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    if (VEC) {
      const int64_t c = col_of<L::K, true>(col0, lane, q, 0);
      f[q] = c < B ? load<L2>(reinterpret_cast<const typename L::V*>(row + c),
                              pol)
                   : splat<typename L::V>(L::inf());
    } else {
#pragma unroll
      for (int i = 0; i < L::K; ++i) {
        const int64_t c = col_of<L::K, false>(col0, lane, q, i);
        at(f[q], i) = c < B ? load<L2>(row + c, pol) : L::inf();
      }
    }
  }
}

// Order-keeping int32 image of a float (-0.0 made +0.0).
__device__ __forceinline__ int image(float x) {
  int bits = __float_as_int(x);
  if (bits == (int)0x80000000) bits = 0;
  return bits >= 0 ? bits : bits ^ 0x7fffffff;
}

// The f32 key of (du, u) (u < 0: none), ordered lexicographically as a
// signed 64-bit int.
__device__ __forceinline__ long long pack(float du, int u) {
  return u < 0 ? kNoKey
               : (long long)(((unsigned long long)(unsigned)image(du) << 32) |
                             (unsigned)u);
}

// The least (du, u) of a column so far; u < 0 while no in-edge was tight.
template <typename T>
struct Best {
  T du;
  int u;
};

// Whether (du, u) comes before b: du compared as a float (so -0.0 and
// +0.0 tie), then the id. A tight du is finite, so none (+inf, -1) comes
// after every tight pair and two nones tie.
template <typename T>
__device__ __forceinline__ bool before(T du, int u, const Best<T>& b) {
  return du < b.du || (du == b.du && u < b.u);
}

// Tolerance of a row's entry dv; -1 when dv is not finite, so that no
// candidate passes (|cand - dv| >= 0 > -1). Otherwise it is finite, so a
// candidate that is not finite fails too (|cand - dv| is inf or NaN):
// the plain version's isfinite(cand) needs no test of its own.
template <typename T>
__device__ __forceinline__ T tolerance(T dv) {
  using L = Lane<T>;
  return L::abs(dv) < L::inf() ? L::mul(L::kTolEps, L::max(L::abs(dv), T(1)))
                               : T(-1);
}

__device__ __forceinline__ int pred_of(long long key) {
  return key == kNoKey ? -1 : (int)(key & 0xffffffffLL);
}

// The du of a key: the float whose image is the high half.
__device__ __forceinline__ float du_of(long long key) {
  const int image = (int)(key >> 32);
  return __int_as_float(image >= 0 ? image : image ^ 0x7fffffff);
}

// The pred entry of a column of `row` from its least pair (du, u), u < 0
// for none. Without sources (is_source unused), u. With them: -1 at the
// column's source; else -1 noting `uncovered` when dv is finite and no
// in-edge was tight, or u noting `nondescending` when du is not < dv.
template <typename T>
__device__ __forceinline__ int settle(T du, int u, T dv, bool is_source,
                                      bool with_sources, bool& uncovered,
                                      bool& nondescending) {
  if (!with_sources) return u;
  if (is_source) return -1;
  if (u < 0) {
    uncovered |= Lane<T>::abs(dv) < Lane<T>::inf();
    return -1;
  }
  nondescending |= !(du < dv);
  return u;
}

// The source of each of a lane's K columns of group q (one int vector
// load on the VEC path; sources null: none is).
template <typename T, bool VEC>
__device__ __forceinline__ typename Lane<T>::IV source_rows(
    const int* __restrict__ sources, int64_t col0, int lane, int q,
    int64_t B) {
  using L = Lane<T>;
  typename L::IV s = splat<typename L::IV>(-1);
  if (sources == nullptr) return s;
  if (VEC) {
    const int64_t c = col_of<L::K, true>(col0, lane, q, 0);
    if (c < B) s = __ldg(reinterpret_cast<const typename L::IV*>(sources + c));
  } else {
#pragma unroll
    for (int i = 0; i < L::K; ++i) {
      const int64_t c = col_of<L::K, false>(col0, lane, q, i);
      if (c < B) at(s, i) = __ldg(sources + c);
    }
  }
  return s;
}

// Where pieces of split rows leave their least pairs: an int64 key per
// column at f32 (`key`), du and u as two words at f64 (`du`, `u`).
struct Partial {
  long long* key;
  double* du;
  int* u;
};

// Store piece k's least pairs of the K columns of group q.
template <int NV, bool VEC>
__device__ __forceinline__ void store_partial(const Partial& p, int64_t k,
                                              int64_t B, int64_t col0,
                                              int lane, int q,
                                              Best<float> (&best)[NV][4]) {
  long long* out = p.key + k * B;
  long long key[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) key[i] = pack(best[q][i].du, best[q][i].u);
  const int64_t c = col_of<4, VEC>(col0, lane, q, 0);
  if (VEC) {
    if (c < B) {
      reinterpret_cast<longlong2*>(out + c)[0] = make_longlong2(key[0], key[1]);
      reinterpret_cast<longlong2*>(out + c)[1] = make_longlong2(key[2], key[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t ci = col_of<4, false>(col0, lane, q, i);
      if (ci < B) out[ci] = key[i];
    }
  }
}

template <int NV, bool VEC>
__device__ __forceinline__ void store_partial(const Partial& p, int64_t k,
                                              int64_t B, int64_t col0,
                                              int lane, int q,
                                              Best<double> (&best)[NV][2]) {
  double* du = p.du + k * B;
  int* u = p.u + k * B;
  const int64_t c = col_of<2, VEC>(col0, lane, q, 0);
  if (VEC) {
    if (c < B) {
      *reinterpret_cast<double2*>(du + c) =
          make_double2(best[q][0].du, best[q][1].du);
      *reinterpret_cast<int2*>(u + c) = make_int2(best[q][0].u, best[q][1].u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t ci = col_of<2, false>(col0, lane, q, i);
      if (ci < B) {
        du[ci] = best[q][i].du;
        u[ci] = best[q][i].u;
      }
    }
  }
}

// Lane 0 of a warp in which any lane saw `seen` sets *flag (see the top).
__device__ __forceinline__ void raise_flag(bool seen, int lane, int* flag) {
  if (__any_sync(kFull, seen) && lane == 0 && __ldca(flag) == 0) *flag = 1;
}

// One warp per item. Warps below n_pieces take piece k of a split row
// from the table (row, first edge, end edge) and store its partial;
// warp n_pieces + v takes row v whole and stores pred[v], unless v has
// more than L in-edges (its pieces cover it). Per lane, U row gathers
// (NV vectors each) are issued back to back, then tested. L2 (f64 with
// hub flags, B > 128): each column's tolerance is made once per pass,
// blockIdx.y is the column pass, and bit 31 of a lane's source id
// carries the edge's flag to the lane that gathers the row, which keeps
// it in L2 (evict_last); the other gathers and the own row stream
// (evict_first).
template <typename T, int NV, bool VEC, int U, bool L2>
__global__ void __launch_bounds__(kThreads, VEC ? Tune<T, NV, L2>::kBlocks
                                                : Tune<T, NV, L2>::kScalarBlocks)
pred_items(const T* __restrict__ dist, int* __restrict__ pred,
           const int* __restrict__ src, const T* __restrict__ w,
           const unsigned char* __restrict__ hub,
           const int* __restrict__ indptr, const int* __restrict__ pieces,
           int64_t n_pieces, int64_t V, int L, Partial partial,
           const int* __restrict__ sources, int* __restrict__ flags,
           int64_t B) {
  using Ln = Lane<T>;
  using Vec = typename Ln::V;
  constexpr int K = Ln::K;
  constexpr bool kTolPerPass = L2;
  constexpr int64_t kPass = 32 * K * NV;
  const int lane = threadIdx.x & 31;
  const int64_t k = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  int64_t row;
  int e0, e1;
  const bool whole = k >= n_pieces;
  if (!whole) {
    row = __ldg(pieces + 3 * k);
    e0 = __ldg(pieces + 3 * k + 1);
    e1 = __ldg(pieces + 3 * k + 2);
  } else {
    row = k - n_pieces;
    if (row >= V) return;
    e0 = __ldg(indptr + row);
    e1 = __ldg(indptr + row + 1);
    if (e1 - e0 > L) return;
  }
  uint64_t keep = 0, stream = 0;
  if constexpr (L2) {
    keep = l2_keep();
    stream = l2_stream();
  }
  const int64_t c0 = L2 ? (int64_t)blockIdx.y * kPass : 0;
  const int64_t c1 = L2 ? min(B, c0 + kPass) : B;
  bool uncovered = false, nondescending = false;
  for (int64_t col0 = c0; col0 < c1; col0 += kPass) {
    Vec dv[NV];
    load_row<T, NV, VEC, L2>(dist + row * B, col0, lane, B, dv, stream);
    T tols[NV][K];
    if constexpr (kTolPerPass) {
#pragma unroll
      for (int q = 0; q < NV; ++q) {
#pragma unroll
        for (int i = 0; i < K; ++i) tols[q][i] = tolerance(at(dv[q], i));
      }
    }
    Best<T> best[NV][K];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
#pragma unroll
      for (int i = 0; i < K; ++i) best[q][i] = {Ln::inf(), -1};
    }
    for (int eb = e0; eb < e1; eb += 32) {
      const int n = min(32, e1 - eb);
      int my_u = lane < n ? __ldg(src + eb + lane) : 0;
      if (L2 && lane < n && __ldg(hub + eb + lane)) my_u |= INT32_MIN;
      const T my_w = lane < n ? __ldg(w + eb + lane) : T(0);
      for (int j = 0; j < n; j += U) {
        Vec g[U][NV];
        int uj[U];
        T wj[U];
#pragma unroll
        for (int t = 0; t < U; ++t) {
          const int p = __shfl_sync(kFull, my_u, (j + t) & 31);
          uj[t] = L2 ? p & INT32_MAX : p;
          wj[t] = __shfl_sync(kFull, my_w, (j + t) & 31);
          if (j + t < n)
            load_row<T, NV, VEC, L2>(dist + (int64_t)uj[t] * B, col0, lane,
                                     B, g[t], p < 0 ? keep : stream);
        }
#pragma unroll
        for (int q = 0; q < NV; ++q) {
#pragma unroll
          for (int i = 0; i < K; ++i) {
            const T d = at(dv[q], i);
            const T tol = kTolPerPass ? tols[q][i] : tolerance(d);
            Best<T> b = best[q][i];
#pragma unroll
            for (int t = 0; t < U; ++t) {
              if (j + t < n) {
                const T du = at(g[t][q], i);
                const T cand = Ln::add(du, wj[t]);
                // before(), written out: through the helper the f32
                // pass ran 10-20% slower on the H100 (PERF.md, PR 16).
                if (Ln::abs(Ln::sub(cand, d)) <= tol &&
                    (du < b.du || (du == b.du && uj[t] < b.u)))
                  b = {du, uj[t]};
              }
            }
            best[q][i] = b;
          }
        }
      }
    }
    if (whole) {
      int* out = pred + row * B;
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        typename Ln::IV srcs = source_rows<T, VEC>(sources, col0, lane, q, B);
        typename Ln::IV p;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const int64_t c = col_of<K, VEC>(col0, lane, q, i);
          at(p, i) = c < B ? settle(best[q][i].du, best[q][i].u, at(dv[q], i),
                                    at(srcs, i) == row, sources != nullptr,
                                    uncovered, nondescending)
                           : -1;
          if (!VEC && c < B) out[c] = at(p, i);
        }
        const int64_t c = col_of<K, VEC>(col0, lane, q, 0);
        if (VEC && c < B) *reinterpret_cast<typename Ln::IV*>(out + c) = p;
      }
    } else {
#pragma unroll
      for (int q = 0; q < NV; ++q)
        store_partial<NV, VEC>(partial, k, B, col0, lane, q, best);
    }
  }
  if (whole && sources != nullptr) {
    raise_flag(uncovered, lane, flags);
    raise_flag(nondescending, lane, flags + 1);
  }
}

// The least pair of column c of a split row over its pieces p0 .. p1-1.
__device__ __forceinline__ Best<float> least(const Partial& part, int p0,
                                             int p1, int64_t B, int64_t c,
                                             float) {
  long long best = kNoKey;
#pragma unroll 4
  for (int p = p0; p < p1; ++p) {
    const long long key = __ldg(part.key + (int64_t)p * B + c);
    best = key < best ? key : best;
  }
  return {du_of(best), pred_of(best)};
}

__device__ __forceinline__ Best<double> least(const Partial& part, int p0,
                                              int p1, int64_t B, int64_t c,
                                              double) {
  Best<double> best = {CUDART_INF, -1};
#pragma unroll 4
  for (int p = p0; p < p1; ++p) {
    const double du = __ldg(part.du + (int64_t)p * B + c);
    const int u = __ldg(part.u + (int64_t)p * B + c);
    if (before(du, u, best)) best = {du, u};
  }
  return best;
}

// Split rows: pred[v] from the least of v's pieces' pairs, settled as a
// whole row is; one warp per row, every column (four per lane at a time
// on the f32 VEC path, one on the others).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
combine_split_rows(int* __restrict__ pred, Partial partial,
                   const int* __restrict__ split_rows,
                   const int* __restrict__ split_ptr, int64_t n_rows,
                   const T* __restrict__ dist,
                   const int* __restrict__ sources, int* __restrict__ flags,
                   int64_t B) {
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t row = __ldg(split_rows + r);
  const int p0 = __ldg(split_ptr + r);
  const int p1 = __ldg(split_ptr + r + 1);
  bool uncovered = false, nondescending = false;
  if constexpr (VEC && sizeof(T) == 4) {
    for (int64_t c = 4 * lane; c < B; c += 128) {
      long long best[4] = {kNoKey, kNoKey, kNoKey, kNoKey};
#pragma unroll 4
      for (int p = p0; p < p1; ++p) {
        const longlong2* keys =
            reinterpret_cast<const longlong2*>(partial.key + (int64_t)p * B + c);
        const longlong2 a = __ldg(keys), b = __ldg(keys + 1);
        best[0] = a.x < best[0] ? a.x : best[0];
        best[1] = a.y < best[1] ? a.y : best[1];
        best[2] = b.x < best[2] ? b.x : best[2];
        best[3] = b.y < best[3] ? b.y : best[3];
      }
      const float* drow = reinterpret_cast<const float*>(dist) + row * B;
      float4 dv = __ldg(reinterpret_cast<const float4*>(drow + c));
      int4 srcs = source_rows<float, true>(sources, c, 0, 0, B);
      int4 p;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        at(p, i) = settle(du_of(best[i]), pred_of(best[i]), at(dv, i),
                          at(srcs, i) == row, sources != nullptr, uncovered,
                          nondescending);
      *reinterpret_cast<int4*>(pred + row * B + c) = p;
    }
  } else {
    for (int64_t c = lane; c < B; c += 32) {
      const Best<T> best = least(partial, p0, p1, B, c, T(0));
      pred[row * B + c] =
          settle(best.du, best.u, __ldg(dist + row * B + c),
                 sources != nullptr && __ldg(sources + c) == row,
                 sources != nullptr, uncovered, nondescending);
    }
  }
  if (sources != nullptr) {
    raise_flag(uncovered, lane, flags);
    raise_flag(nondescending, lane, flags + 1);
  }
}

template <typename T>
using ItemsFn = void (*)(const T*, int*, const int*, const T*,
                         const unsigned char*, const int*, const int*,
                         int64_t, int64_t, int, Partial, const int*, int*,
                         int64_t);

template <typename T>
struct Plan {
  ItemsFn<T> fn;
  int depth;  // gathers per batch U
  int pass;   // columns per pass: 32 K NV
  bool l2;    // the L2 policies, passes on the grid's y
};

template <typename T, int NV, bool L2>
Plan<T> plan_nv(bool vec) {
  constexpr int U = Tune<T, NV, L2>::U;
  constexpr int kPass = 32 * Lane<T>::K * NV;
  if (vec) return {pred_items<T, NV, true, U, L2>, U, kPass, L2};
  return {pred_items<T, NV, false, U, L2>, U, kPass, L2};
}

// NV by B: one pass of 32 K columns up to B = 32 K (128 at f32, 64 at
// f64), else passes of 64 K columns: in the warp, or, at f64 with hubs
// (l2) and more than one pass, on the grid's y with the L2 policies. One
// 128-column pass with the policies lost to the plain kernel on R-MAT-20
// (B = 128: 5.04 against 4.67 ms; PERF.md §6).
template <typename T>
Plan<T> plan(int64_t B, bool vec, bool l2) {
  constexpr int K = Lane<T>::K;
  if (B <= 32 * K) return plan_nv<T, 1, false>(vec);
  if constexpr (sizeof(T) == 8) {
    if (l2 && B > 64 * K) return plan_nv<T, 2, true>(vec);
  }
  return plan_nv<T, 2, false>(vec);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int pass(const T* dist, int* pred, const int* indptr, const int* src,
         const T* w, const unsigned char* hub, const int* pieces,
         long long n_pieces, long long V, int L, Partial partial,
         const int* split_rows, const int* split_ptr, long long n_split_rows,
         const int* sources, int* flags, long long B, void* stream) {
  if (B > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = B % Lane<T>::K == 0 && aligned16(dist) &&
                     aligned16(pred) && aligned16(partial.key) &&
                     aligned16(partial.du) && aligned16(partial.u) &&
                     aligned16(sources);
    const long long n_items = n_pieces + V;
    if (n_items > 0) {
      const Plan<T> p = plan<T>(B, vec, hub != nullptr);
      const dim3 grid((unsigned)((n_items + kWarps - 1) / kWarps),
                      p.l2 ? (unsigned)((B + p.pass - 1) / p.pass) : 1u);
      p.fn<<<grid, kThreads, 0, s>>>(dist, pred, src, w, hub, indptr, pieces,
                                     n_pieces, V, L, partial, sources, flags,
                                     B);
    }
    if (n_split_rows > 0) {
      const unsigned grid = (unsigned)((n_split_rows + kWarps - 1) / kWarps);
      if (vec) {
        combine_split_rows<T, true><<<grid, kThreads, 0, s>>>(
            pred, partial, split_rows, split_ptr, n_split_rows, dist, sources,
            flags, B);
      } else {
        combine_split_rows<T, false><<<grid, kThreads, 0, s>>>(
            pred, partial, split_rows, split_ptr, n_split_rows, dist, sources,
            flags, B);
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

// One pass over V rows: the items kernel (n_pieces pieces of split rows,
// then every row of at most L in-edges whole), then the split-row
// combine. B % K != 0 or unaligned rows take the scalar lane path.
// `sources` and `flags` are both null (no source mask, no flags) or both
// given (flags zeroed by the caller). f32: `partial` holds the pieces'
// int64 keys [n_pieces, B]; f64 (`pj_tight_pred_f64`): `partial_du`
// (f64) and `partial_u` (int32), each [n_pieces, B], and the per-edge hub
// flags (`hub`, one byte per in-edge in CSC order, nonzero: keep the
// source's row in L2; null: no hubs, plain loads).
extern "C" int pj_tight_pred(const float* dist, int* pred, const int* indptr,
                             const int* src, const float* w, const int* pieces,
                             long long n_pieces, long long V, int L,
                             long long* partial, const int* split_rows,
                             const int* split_ptr, long long n_split_rows,
                             const int* sources, int* flags, long long B,
                             void* stream) {
  return pass<float>(dist, pred, indptr, src, w, nullptr, pieces, n_pieces, V,
                     L, Partial{partial, nullptr, nullptr}, split_rows,
                     split_ptr, n_split_rows, sources, flags, B, stream);
}

extern "C" int pj_tight_pred_f64(const double* dist, int* pred,
                                 const int* indptr, const int* src,
                                 const double* w, const unsigned char* hub,
                                 const int* pieces, long long n_pieces,
                                 long long V, int L, double* partial_du,
                                 int* partial_u, const int* split_rows,
                                 const int* split_ptr, long long n_split_rows,
                                 const int* sources, int* flags, long long B,
                                 void* stream) {
  return pass<double>(dist, pred, indptr, src, w, hub, pieces, n_pieces, V, L,
                      Partial{nullptr, partial_du, partial_u}, split_rows,
                      split_ptr, n_split_rows, sources, flags, B, stream);
}

// Resident blocks per SM and gathers per batch (U) of the items kernel
// that a pass at width B launches, at f32 and at f64 (with hub flags or
// without).
extern "C" int pj_tight_pred_occupancy(long long B, int vec,
                                       int* blocks_per_sm, int* gather_depth) {
  return occupancy<float>(B, vec, 0, blocks_per_sm, gather_depth);
}

extern "C" int pj_tight_pred_occupancy_f64(long long B, int vec, int hubs,
                                           int* blocks_per_sm,
                                           int* gather_depth) {
  return occupancy<double>(B, vec, hubs, blocks_per_sm, gather_depth);
}
