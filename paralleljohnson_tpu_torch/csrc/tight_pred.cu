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

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNoKey = 0x7fffffffffffffffLL;
// TOL_SCALE * FLT_EPSILON = 4 * 2^-23.
constexpr float kTolEps = 4.0f * 1.1920928955078125e-07f;

// Row gathers per batch (U) and resident blocks per SM of the items
// kernel, by pass width NV, on the float4 and on the scalar lane path
// (whose column arithmetic takes more registers).
template <int NV> struct Tune;
template <> struct Tune<1> {
  static constexpr int U = 2, kBlocks = 5, kScalarBlocks = 4;
};
template <> struct Tune<2> {
  static constexpr int U = 1, kBlocks = 4, kScalarBlocks = 2;
};

// Columns of one pass: 128 * NV starting at col0. VEC (B % 4 == 0, 16-byte
// aligned rows): group q of a lane is the float4 at col0 + 4 (lane + 32 q).
// Scalar: element i of group q is column col0 + lane + 32 (4 q + i).
template <bool VEC>
__device__ __forceinline__ int64_t col_of(int64_t col0, int lane, int q,
                                          int i) {
  return VEC ? col0 + 4 * (lane + 32 * q) + i : col0 + lane + 32 * (4 * q + i);
}

__device__ __forceinline__ float4 inf4() {
  return make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
}

__device__ __forceinline__ float& at(float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

__device__ __forceinline__ int& at(int4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

__device__ __forceinline__ int at(const int4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

// Lane's columns of `row` (+inf outside [0, B)).
template <int NV, bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         int64_t col0, int lane, int64_t B,
                                         float4 (&f)[NV]) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    if (VEC) {
      const int64_t c = col_of<true>(col0, lane, q, 0);
      f[q] = c < B ? __ldg(reinterpret_cast<const float4*>(row + c)) : inf4();
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t c = col_of<false>(col0, lane, q, i);
        at(f[q], i) = c < B ? __ldg(row + c) : CUDART_INF_F;
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

// The key of (du, u) (u < 0: none), ordered lexicographically as a
// signed 64-bit int.
__device__ __forceinline__ long long pack(float du, int u) {
  return u < 0 ? kNoKey
               : (long long)(((unsigned long long)(unsigned)image(du) << 32) |
                             (unsigned)u);
}

// The least (du, u) of a column so far; u < 0 while no in-edge was tight.
struct Best {
  float du;
  int u;
};

// Tolerance of a row's entry dv; -1 when dv is not finite, so that no
// candidate passes (|cand - dv| >= 0 > -1). Otherwise it is finite, so a
// candidate that is not finite fails too (|cand - dv| is inf or NaN):
// the plain version's isfinite(cand) needs no test of its own.
__device__ __forceinline__ float tolerance(float dv) {
  return fabsf(dv) < CUDART_INF_F ? __fmul_rn(kTolEps, fmaxf(fabsf(dv), 1.0f))
                                  : -1.0f;
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
__device__ __forceinline__ int settle(float du, int u, float dv,
                                      bool is_source, bool with_sources,
                                      bool& uncovered, bool& nondescending) {
  if (!with_sources) return u;
  if (is_source) return -1;
  if (u < 0) {
    uncovered |= fabsf(dv) < CUDART_INF_F;
    return -1;
  }
  nondescending |= !(du < dv);
  return u;
}

// Whether `row` is the source of each of a lane's four columns of group
// q (one int4 load on the VEC path; sources null: none is).
template <bool VEC>
__device__ __forceinline__ int4 source_rows(const int* __restrict__ sources,
                                            int64_t col0, int lane, int q,
                                            int64_t B) {
  int4 s = make_int4(-1, -1, -1, -1);
  if (sources == nullptr) return s;
  if (VEC) {
    const int64_t c = col_of<true>(col0, lane, q, 0);
    if (c < B) s = __ldg(reinterpret_cast<const int4*>(sources + c));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t c = col_of<false>(col0, lane, q, i);
      if (c < B) at(s, i) = __ldg(sources + c);
    }
  }
  return s;
}

// Lane 0 of a warp in which any lane saw `seen` sets *flag (see the top).
__device__ __forceinline__ void raise_flag(bool seen, int lane, int* flag) {
  if (__any_sync(kFull, seen) && lane == 0 && __ldca(flag) == 0) *flag = 1;
}

// One warp per item. Warps below n_pieces take piece k of a split row
// from the table (row, first edge, end edge) and store partial[k]; warp
// n_pieces + v takes row v whole and stores pred[v], unless v has more
// than L in-edges (its pieces cover it). Per lane, U row gathers (NV
// float4 each) are issued back to back, then tested.
template <int NV, bool VEC, int U>
__global__ void __launch_bounds__(kThreads, VEC ? Tune<NV>::kBlocks
                                                : Tune<NV>::kScalarBlocks)
pred_items(const float* __restrict__ dist, int* __restrict__ pred,
           const int* __restrict__ src, const float* __restrict__ w,
           const int* __restrict__ indptr, const int* __restrict__ pieces,
           int64_t n_pieces, int64_t V, int L, long long* __restrict__ partial,
           const int* __restrict__ sources, int* __restrict__ flags,
           int64_t B) {
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
  bool uncovered = false, nondescending = false;
  for (int64_t col0 = 0; col0 < B; col0 += 128 * NV) {
    float4 dv[NV];
    load_row<NV, VEC>(dist + row * B, col0, lane, B, dv);
    Best best[NV][4];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) best[q][i] = {CUDART_INF_F, -1};
    }
    for (int eb = e0; eb < e1; eb += 32) {
      const int n = min(32, e1 - eb);
      const int my_u = lane < n ? __ldg(src + eb + lane) : 0;
      const float my_w = lane < n ? __ldg(w + eb + lane) : 0.0f;
      for (int j = 0; j < n; j += U) {
        float4 g[U][NV];
        int uj[U];
        float wj[U];
#pragma unroll
        for (int t = 0; t < U; ++t) {
          uj[t] = __shfl_sync(kFull, my_u, (j + t) & 31);
          wj[t] = __shfl_sync(kFull, my_w, (j + t) & 31);
          if (j + t < n)
            load_row<NV, VEC>(dist + (int64_t)uj[t] * B, col0, lane, B, g[t]);
        }
#pragma unroll
        for (int q = 0; q < NV; ++q) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float d = at(dv[q], i);
            const float tol = tolerance(d);
            Best b = best[q][i];
#pragma unroll
            for (int t = 0; t < U; ++t) {
              if (j + t < n) {
                const float du = at(g[t][q], i);
                const float cand = __fadd_rn(du, wj[t]);
                if (fabsf(__fsub_rn(cand, d)) <= tol &&
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
        const int4 srcs = source_rows<VEC>(sources, col0, lane, q, B);
        int4 p;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t c = col_of<VEC>(col0, lane, q, i);
          at(p, i) = c < B ? settle(best[q][i].du, best[q][i].u, at(dv[q], i),
                                    at(srcs, i) == row, sources != nullptr,
                                    uncovered, nondescending)
                           : -1;
          if (!VEC && c < B) out[c] = at(p, i);
        }
        const int64_t c = col_of<VEC>(col0, lane, q, 0);
        if (VEC && c < B) *reinterpret_cast<int4*>(out + c) = p;
      }
    } else {
      long long* out = partial + k * B;
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        long long key[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) key[i] = pack(best[q][i].du, best[q][i].u);
        const int64_t c = col_of<VEC>(col0, lane, q, 0);
        if (VEC) {
          if (c < B) {
            reinterpret_cast<longlong2*>(out + c)[0] =
                make_longlong2(key[0], key[1]);
            reinterpret_cast<longlong2*>(out + c)[1] =
                make_longlong2(key[2], key[3]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int64_t ci = col_of<false>(col0, lane, q, i);
            if (ci < B) out[ci] = key[i];
          }
        }
      }
    }
  }
  if (whole && sources != nullptr) {
    raise_flag(uncovered, lane, flags);
    raise_flag(nondescending, lane, flags + 1);
  }
}

// Split rows: pred[v] from the least of v's pieces' keys, settled as a
// whole row is; one warp per row, every column (four per lane at a time
// on the VEC path).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
combine_split_rows(int* __restrict__ pred,
                   const long long* __restrict__ partial,
                   const int* __restrict__ split_rows,
                   const int* __restrict__ split_ptr, int64_t n_rows,
                   const float* __restrict__ dist,
                   const int* __restrict__ sources, int* __restrict__ flags,
                   int64_t B) {
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t row = __ldg(split_rows + r);
  const int p0 = __ldg(split_ptr + r);
  const int p1 = __ldg(split_ptr + r + 1);
  bool uncovered = false, nondescending = false;
  if (VEC) {
    for (int64_t c = 4 * lane; c < B; c += 128) {
      long long best[4] = {kNoKey, kNoKey, kNoKey, kNoKey};
#pragma unroll 4
      for (int p = p0; p < p1; ++p) {
        const longlong2* keys =
            reinterpret_cast<const longlong2*>(partial + (int64_t)p * B + c);
        const longlong2 a = __ldg(keys), b = __ldg(keys + 1);
        best[0] = a.x < best[0] ? a.x : best[0];
        best[1] = a.y < best[1] ? a.y : best[1];
        best[2] = b.x < best[2] ? b.x : best[2];
        best[3] = b.y < best[3] ? b.y : best[3];
      }
      float4 dv = __ldg(reinterpret_cast<const float4*>(dist + row * B + c));
      const int4 srcs = source_rows<true>(sources, c, 0, 0, B);
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
      long long best = kNoKey;
#pragma unroll 4
      for (int p = p0; p < p1; ++p) {
        const long long key = __ldg(partial + (int64_t)p * B + c);
        best = key < best ? key : best;
      }
      pred[row * B + c] =
          settle(du_of(best), pred_of(best), __ldg(dist + row * B + c),
                 sources != nullptr && __ldg(sources + c) == row,
                 sources != nullptr, uncovered, nondescending);
    }
  }
  if (sources != nullptr) {
    raise_flag(uncovered, lane, flags);
    raise_flag(nondescending, lane, flags + 1);
  }
}

using ItemsFn = void (*)(const float*, int*, const int*, const float*,
                         const int*, const int*, int64_t, int64_t, int,
                         long long*, const int*, int*, int64_t);

struct Plan {
  ItemsFn fn;
  int depth;  // gathers per batch U
};

template <int NV>
Plan plan_nv(bool vec) {
  constexpr int U = Tune<NV>::U;
  if (vec) return {pred_items<NV, true, U>, U};
  return {pred_items<NV, false, U>, U};
}

// NV by B: one 128-column pass up to B = 128, else 256-column passes.
Plan plan(int64_t B, bool vec) {
  return B <= 128 ? plan_nv<1>(vec) : plan_nv<2>(vec);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One pass over V rows: the items kernel (n_pieces pieces of split rows,
// then every row of at most L in-edges whole), then the split-row
// combine. B % 4 != 0 or unaligned rows take the scalar lane path.
// `sources` and `flags` are both null (no source mask, no flags) or both
// given (flags zeroed by the caller).
extern "C" int pj_tight_pred(const float* dist, int* pred, const int* indptr,
                             const int* src, const float* w, const int* pieces,
                             long long n_pieces, long long V, int L,
                             long long* partial, const int* split_rows,
                             const int* split_ptr, long long n_split_rows,
                             const int* sources, int* flags, long long B,
                             void* stream) {
  if (B > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = B % 4 == 0 && aligned16(dist) && aligned16(pred) &&
                     aligned16(partial) && aligned16(sources);
    const long long n_items = n_pieces + V;
    if (n_items > 0) {
      const unsigned grid = (unsigned)((n_items + kWarps - 1) / kWarps);
      plan(B, vec).fn<<<grid, kThreads, 0, s>>>(
          dist, pred, src, w, indptr, pieces, n_pieces, V, L, partial,
          sources, flags, B);
    }
    if (n_split_rows > 0) {
      const unsigned grid = (unsigned)((n_split_rows + kWarps - 1) / kWarps);
      if (vec) {
        combine_split_rows<true><<<grid, kThreads, 0, s>>>(
            pred, partial, split_rows, split_ptr, n_split_rows, dist, sources,
            flags, B);
      } else {
        combine_split_rows<false><<<grid, kThreads, 0, s>>>(
            pred, partial, split_rows, split_ptr, n_split_rows, dist, sources,
            flags, B);
      }
    }
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM and gathers per batch (U) of the items kernel
// that a pass at width B launches.
extern "C" int pj_tight_pred_occupancy(long long B, int vec,
                                       int* blocks_per_sm, int* gather_depth) {
  const Plan p = plan(B, vec != 0);
  *gather_depth = p.depth;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(p.fn), kThreads, 0);
}
