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
// same CSC and work items as the fan-out sweep (csrc/fanout_sweep.cu), so
// dst rows need no gather and no segment ids exist.
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
// - Lanes cover the columns, four per lane per 128-column pass (a float4
//   when B % 4 == 0 and rows are 16-byte aligned), and a column loop
//   inside the warp for wider B. The row's own dist[v] and its tolerance
//   are loaded once per pass; (src, w) come 32 at a time with one
//   coalesced load and go out by __shfl_sync, and each lane issues
//   kDepth row gathers before testing any of them.
// - The lexicographic minimum is one 64-bit integer minimum: the key of
//   (du, u) is an order-keeping int32 image of du in the high half (-0.0
//   first made +0.0: the reference compares du as floats, where the two
//   tie) and u in the low half. Its minimum is the pair the plain
//   version's two segment minima pick (ops/pred.py,
//   tight_pred_pass_plain).
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
constexpr int kDepth = 8;  // row gathers in flight per lane
constexpr long long kNoKey = 0x7fffffffffffffffLL;
// TOL_SCALE * FLT_EPSILON = 4 * 2^-23.
constexpr float kTolEps = 4.0f * 1.1920928955078125e-07f;

// Column of element i of a lane's four in a pass from col0. VEC: four
// neighbouring columns (one float4). Scalar: one column per 32.
template <bool VEC>
__device__ __forceinline__ int64_t col_of(int64_t col0, int lane, int i) {
  return VEC ? col0 + 4 * lane + i : col0 + lane + 32 * i;
}

__device__ __forceinline__ float& at(float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

// The lane's four columns of `row` (+inf outside [0, B)).
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ row,
                                        int64_t col0, int lane, int64_t B) {
  float4 f;
  if (VEC) {
    const int64_t c = col_of<true>(col0, lane, 0);
    if (c < B) return __ldg(reinterpret_cast<const float4*>(row + c));
    f = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t c = col_of<false>(col0, lane, i);
      at(f, i) = c < B ? __ldg(row + c) : CUDART_INF_F;
    }
  }
  return f;
}

// The key of (du, u), ordered lexicographically as a signed 64-bit int.
__device__ __forceinline__ long long pack(float du, int u) {
  int bits = __float_as_int(du);
  if (bits == (int)0x80000000) bits = 0;  // -0.0 -> +0.0
  const int image = bits >= 0 ? bits : bits ^ 0x7fffffff;
  return (long long)(((unsigned long long)(unsigned)image << 32) |
                     (unsigned)u);
}

// Tolerance of a row's entry dv; -1 when dv is not finite, so that no
// candidate passes (|cand - dv| >= 0 > -1).
__device__ __forceinline__ float tolerance(float dv) {
  return fabsf(dv) < CUDART_INF_F ? __fmul_rn(kTolEps, fmaxf(fabsf(dv), 1.0f))
                                  : -1.0f;
}

__device__ __forceinline__ int pred_of(long long key) {
  return key == kNoKey ? -1 : (int)(key & 0xffffffffLL);
}

template <bool VEC>
__device__ __forceinline__ void store_pred(int* __restrict__ row, int64_t col0,
                                           int lane, int64_t B,
                                           const long long (&best)[4]) {
  if (VEC) {
    const int64_t c = col_of<true>(col0, lane, 0);
    if (c < B)
      *reinterpret_cast<int4*>(row + c) =
          make_int4(pred_of(best[0]), pred_of(best[1]), pred_of(best[2]),
                    pred_of(best[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t c = col_of<false>(col0, lane, i);
      if (c < B) row[c] = pred_of(best[i]);
    }
  }
}

// One warp per item. Warps below n_pieces take piece k of a split row
// from the table (row, first edge, end edge) and store partial[k]; warp
// n_pieces + v takes row v whole and stores pred[v], unless v has more
// than L in-edges (its pieces cover it).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
pred_items(const float* __restrict__ dist, int* __restrict__ pred,
           const int* __restrict__ src, const float* __restrict__ w,
           const int* __restrict__ indptr, const int* __restrict__ pieces,
           int64_t n_pieces, int64_t V, int L, long long* __restrict__ partial,
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
  for (int64_t col0 = 0; col0 < B; col0 += 128) {
    float4 dv = load4<VEC>(dist + row * B, col0, lane, B);
    float tol[4];
    long long best[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tol[i] = tolerance(at(dv, i));
      best[i] = kNoKey;
    }
    for (int eb = e0; eb < e1; eb += 32) {
      const int n = min(32, e1 - eb);
      const int my_u = lane < n ? __ldg(src + eb + lane) : 0;
      const float my_w = lane < n ? __ldg(w + eb + lane) : 0.0f;
      for (int j = 0; j < n; j += kDepth) {
        float4 g[kDepth];
        int uj[kDepth];
        float wj[kDepth];
#pragma unroll
        for (int t = 0; t < kDepth; ++t) {
          uj[t] = __shfl_sync(kFull, my_u, (j + t) & 31);
          wj[t] = __shfl_sync(kFull, my_w, (j + t) & 31);
          if (j + t < n) g[t] = load4<VEC>(dist + (int64_t)uj[t] * B, col0, lane, B);
        }
#pragma unroll
        for (int t = 0; t < kDepth; ++t) {
          if (j + t < n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float du = at(g[t], i);
              const float cand = __fadd_rn(du, wj[t]);
              if (fabsf(cand) < CUDART_INF_F &&
                  fabsf(__fsub_rn(cand, at(dv, i))) <= tol[i]) {
                const long long key = pack(du, uj[t]);
                best[i] = key < best[i] ? key : best[i];
              }
            }
          }
        }
      }
    }
    if (whole) {
      store_pred<VEC>(pred + row * B, col0, lane, B, best);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t c = col_of<VEC>(col0, lane, i);
        if (c < B) partial[k * B + c] = best[i];
      }
    }
  }
}

// Split rows: pred[v] from the least of v's pieces' keys; one warp per
// row, every column.
__global__ void __launch_bounds__(kThreads)
combine_split_rows(int* __restrict__ pred,
                   const long long* __restrict__ partial,
                   const int* __restrict__ split_rows,
                   const int* __restrict__ split_ptr, int64_t n_rows,
                   int64_t B) {
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t row = __ldg(split_rows + r);
  const int p0 = __ldg(split_ptr + r);
  const int p1 = __ldg(split_ptr + r + 1);
  for (int64_t c = lane; c < B; c += 32) {
    long long best = kNoKey;
#pragma unroll 4
    for (int p = p0; p < p1; ++p) {
      const long long key = __ldg(partial + (int64_t)p * B + c);
      best = key < best ? key : best;
    }
    pred[row * B + c] = pred_of(best);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One pass over V rows: the items kernel (n_pieces pieces of split rows,
// then every row of at most L in-edges whole), then the split-row
// combine. B % 4 != 0 or unaligned rows take the scalar lane path.
extern "C" int pj_tight_pred(const float* dist, int* pred, const int* indptr,
                             const int* src, const float* w, const int* pieces,
                             long long n_pieces, long long V, int L,
                             long long* partial, const int* split_rows,
                             const int* split_ptr, long long n_split_rows,
                             long long B, void* stream) {
  if (B > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = B % 4 == 0 && aligned16(dist) && aligned16(pred);
    const long long n_items = n_pieces + V;
    if (n_items > 0) {
      const unsigned grid = (unsigned)((n_items + kWarps - 1) / kWarps);
      if (vec) {
        pred_items<true><<<grid, kThreads, 0, s>>>(
            dist, pred, src, w, indptr, pieces, n_pieces, V, L, partial, B);
      } else {
        pred_items<false><<<grid, kThreads, 0, s>>>(
            dist, pred, src, w, indptr, pieces, n_pieces, V, L, partial, B);
      }
    }
    if (n_split_rows > 0) {
      const unsigned grid = (unsigned)((n_split_rows + kWarps - 1) / kWarps);
      combine_split_rows<<<grid, kThreads, 0, s>>>(
          pred, partial, split_rows, split_ptr, n_split_rows, B);
    }
  }
  return (int)cudaGetLastError();
}
