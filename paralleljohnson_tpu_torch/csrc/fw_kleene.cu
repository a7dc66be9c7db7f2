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
// an add and a min each: 8 us of FP32 instructions over the whole card,
// against 2 MB read and written once (0.6 us). But the t steps are
// dependent: what sets the pace is how fast one step hands its row and
// column to the next. One kernel launch per step (the step variant
// below) pays a launch and a drain per step, ~2 us: ~1 ms at t = 512.
//
// The design (kleene_cluster): ONE launch per closure, on one
// thread-block cluster of 4 x 4 CTAs (16 is above the portable 8, so the
// kernel allows non-portable sizes). CTA (x, y) holds
// the block of rows x and columns y of the tile in REGISTERS: thread
// (ty, tx) holds column tx of RR consecutive rows, v[0 .. RR-1]. A step
// is RR adds and RR mins per thread. Its floor is the cluster's: 2 t^3
// FP32 instructions on 16 of the card's 132 SMs (66 us at t = 512), plus
// t hand-overs of row k+1 and column k+1 from one step to the next.
//
// The hand-over is what the design is about. A cluster barrier with
// release / acquire semantics spends most of a step in its release
// fence, and one SM serves its shared memory to the rest of the cluster
// slowly: a 1-D split, each CTA pulling a whole row from its owner after
// a full cluster.sync(), ran 1.8x this design at t = 512 on the H100
// (PERF.md, Findings). So:
//  - the 2-D split cuts what leaves one SM: row k+1 goes to the 4 CTAs
//    of each column block (`cols` floats each) and column k+1 to the 4
//    CTAs of each row block (`rows` floats each): at most 4 KB a step
//    from one SM at t = 512, not 32 KB;
//  - the holders PUSH, before the rest of the step's update: a warp of
//    row k+1's holders sends one 16-byte store per lane (its lane quad's
//    entries, to row block lane % 4); the warp of column k+1's owner
//    makes the column's entries one per lane (the owner stages its
//    entries, each lane applies the step to one) and sends 16 bytes per
//    lane. st.async stores into the consumer's shared memory and counts
//    the bytes on its mbarrier (complete_tx): no fence. The consumer
//    waits on that mbarrier (acquire at cluster scope);
//  - ONE hardware cluster barrier per step (barrier.cluster arrive
//    .relaxed / wait) keeps any CTA from pushing step k+2's entries into
//    a slot another CTA still reads for step k: a thread arrives when
//    its update of step k is done (its reads of the slot are consumed by
//    that arithmetic) and waits just before its next hand-over, so the
//    update overlaps the hand-over's flight.
// Buffers: rowbuf[2][cols], colbuf[2][rows], one mbarrier per slot, and
// the column owners' stage[rows]; step k reads slot k % 2 and fills slot
// (k + 1) % 2. Each CTA loads and stores only its own block, so `out`
// may be `in` itself, and both may be row-strided views of a larger
// matrix.
//
// No register array is ever indexed by a run-time value (it would spill
// to local memory): the k loop runs over groups of RR rows (run time)
// and, unrolled, over the group's rows r (compile time), so the holder's
// row k+1 is v[r + 1] (or v[0] of the next group) with a constant index.
// The code is RR^2 add / min pairs long; RR is a template parameter, one
// instantiation per row count the plan uses (ops/fw.py kleene_plan).
// A tile that is not a multiple of 16 rows is padded to the plan's size
// with +inf rows and columns, which no real entry ever reads.
//
// The step variant (kleene_step, the first version of this kernel)
// closes tiles too large for a cluster's registers: one launch per step
// from one C call, alternating two [t, t] scratch buffers. ops/fw.py
// kleene_plan picks the variant by t; a refused cluster launch raises,
// it does not fall back.
//
// f64 (`pj_fw_kleene_f64`, `pj_fw_kleene_steps_f64`, precision="f64"):
// the cluster in ROUNDS of B = kSteps64 steps per hand-over
// (`kleene_rounds`; the step variant as at f32). At f64 a step's arithmetic
// is ~0.5 us on the cluster and its hand-over ~0.7 us (PERF.md), and the
// first f64 kernel (kleene_cluster on doubles) paid one hand-over and one
// cluster barrier per step. A thread's RR rows take 2 RR registers: at t
// = 512 (RR = 32) the tile is 64 of the 128 a thread has at 512 threads
// per SM, so the rest of the design has ~60 registers to spend. A round
// is steps k0 .. k0+B-1; what an entry (i, j) needs of it is the column
// panel C[i, k] = m[i, k] and the row panel R[k, j] = m[k, j], each as
// the state before step k, for k in the round. Per round, each CTA
//  1. waits for its slot: its rows k0.. raw (as the last round left
//     them, [cols][B]), its columns k0.. raw ([B][rows], step-major, so
//     that 16 bytes are two rows of one step and one load feeds two
//     independent candidates) and the snapshots of the B x B diagonal
//     block: entry (i, c) as it was before step min(i, c), off the
//     diagonal (the panels' values inside the block);
//  2. turns its raw panels into C and R in place, a thread per line: row
//     i of the column panel takes steps k0 .. with the block's row
//     values, column j of the row panel with its column values, in step
//     order (an entry is final once its own step comes); one CTA barrier;
//  3. hands the next round over, ahead of its update: the 4 CTAs of the
//     next columns' block make them from their owners' entries (staged
//     before the barrier), one entry per thread through the round's B
//     steps, and push them to their row block (st.async, complete_tx on
//     the slot's mbarrier); the one of those holding the next diagonal
//     block runs its B steps in its last warp (in shared memory, an
//     entry a lane: shuffles in that branch made the kernel spill at
//     RR = 32) while the rest of the CTA updates, and pushes the
//     snapshots to all 16; the thread row of the next rows updates those
//     rows first and pushes them to its column block;
//  4. updates every register entry with the B candidates C[i, k] +
//     R[k, j], k ascending, and arrives on the cluster barrier, which the
//     next round waits on before it pushes into this slot again.
// So one flight and one cluster barrier per round, not per step. The
// min at f64 is `c < acc ? c : acc` (vmin). Every entry gets the same
// candidates, C[i, k] + R[k, j] with both operands as the reference's
// loop has them before step k, in ascending k; a panel entry or a
// snapshot is such a value made by the same operations in the same
// order; an entry a holder updates ahead is updated once. So the
// rounds are bitwise the one-step closure (tests/test_torch_f64.py holds
// a plain-torch model of this order to both packages' loops). The f32
// plan keeps one step per hand-over (kleene_cluster).
//
// Exactness: each candidate is one exactly rounded add (f32 or f64) and
// the min is exact, and the steps run in the reference's order, so the closure is
// bitwise the plain PyTorch loop's. A hand-over entry is made ahead of
// its holder's own update by the same operation on the same operands,
// and min is idempotent, so making it twice changes no bit. No recursive
// sub-blocking inside the tile: it would change the association of
// float path sums. The build has no fast-math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "once_per_device.h"

namespace cg = cooperative_groups;

namespace {

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

// The candidate min. At f64 a compare and a select (DSETP and two FSEL)
// in place of fmin (DSETP.MIN, selects and a NaN fix-up: 22 against 13
// per clock per SM on the H100, scripts/fp64_min_probe.cu). It is exact:
// `a` is the accumulator, which starts from the input and never holds
// NaN; a NaN candidate (inf + -inf) loses in both forms; on a tie of
// -0.0 and +0.0 the accumulator stays, which torch.equal counts equal.
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) {
  return b < a ? b : a;
}

// ---- cluster variant -------------------------------------------------------

constexpr int kRowBlocks = 4;  // CTAs down the tile: a row goes to 4 CTAs
constexpr int kColBlocks = 4;  // CTAs across: a column goes to 4 CTAs
constexpr int kCluster = kRowBlocks * kColBlocks;

// Threads per CTA a row count RR is built for: at most 16 RR (a 4 x 4
// cluster, 4 thread rows of RR rows over 4 RR columns) and at most 512
// (128 registers a thread at one CTA per SM).
constexpr int max_threads(int rr) { return 16 * rr < 512 ? 16 * rr : 512; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The same shared-memory offset in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned in_cta(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Store 16 bytes into another CTA's shared memory; they count on the
// mbarrier `bar` of that CTA when they have landed.
__device__ __forceinline__ void push_words(unsigned dst, unsigned w0,
                                           unsigned w1, unsigned w2,
                                           unsigned w3, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst), "r"(w0), "r"(w1), "r"(w2),
      "r"(w3), "r"(bar) : "memory");
}

// The 16 bytes at e: four floats in one store.
__device__ __forceinline__ void push16(unsigned dst, const float* e,
                                       unsigned bar) {
  push_words(dst, __float_as_uint(e[0]), __float_as_uint(e[1]),
             __float_as_uint(e[2]), __float_as_uint(e[3]), bar);
}


// This CTA's one arrival on `bar` for the next phase, which then
// completes when `bytes` more bytes have landed.
__device__ __forceinline__ void expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      " .reg .pred done;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      " @!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A warp of row holders hands its 32 entries of a row (lane l: column
// tx = 32 w + l) to the 4 CTAs of its column block y: lane l sends its
// lane quad's 4 entries, one 16-byte store at f32 (two at f64), to row
// block l % 4. `dst` is the quad's offset in the row buffer slot, `bar`
// its mbarrier.
template <typename T>
__device__ __forceinline__ void push_row(T e, unsigned dst, unsigned bar,
                                         int y) {
  constexpr int K = Lane<T>::K;
  const int lane = threadIdx.x & 31, quad = lane & ~3;
  T q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __shfl_sync(0xffffffffu, e, quad + i);
  const int c = (lane & 3) * kColBlocks + y;
  const unsigned d = in_cta(dst, c), b = in_cta(bar, c);
#pragma unroll
  for (int h = 0; h < 4 / K; ++h) push16(d + 16 * h, q + K * h, b);
}

// The warp of column k1's owner thread (lane `owner`) hands the column
// as step k leaves it to the 4 CTAs of its row block x. The owner stages
// its entries before the step in `stage`; lane l < RR makes entry l
// with the step's operation on the same operands the owner's own update
// uses (the column `ck` and the owner's row entry `rk`); then the column
// goes as 16-byte pieces, RR / K to each of the 4 column blocks, one per
// lane (looped where 4 RR / K exceeds a warp: f64 at RR = 32). With
// `step` false (the state before step 0) the staged entries go as they
// are.
template <typename T, int RR>
__device__ __forceinline__ void push_column(const T (&v)[RR], int owner,
                                            bool step, T rk, const T* ck,
                                            T* stage, unsigned dst,
                                            unsigned bar, int x) {
  using Vec = typename Lane<T>::V;
  constexpr int K = Lane<T>::K;
  constexpr int P = RR / K;  // pieces per column block
  const int lane = threadIdx.x & 31;
  if (lane == owner) {
#pragma unroll
    for (int q = 0; q < RR; q += K) {
      Vec e;
      T* ev = reinterpret_cast<T*>(&e);
#pragma unroll
      for (int i = 0; i < K; ++i) ev[i] = v[q + i];
      *reinterpret_cast<Vec*>(stage + q) = e;
    }
  }
  __syncwarp();
  if (step) {
    const T rko = __shfl_sync(0xffffffffu, rk, owner);
    if (lane < RR) stage[lane] = vmin(stage[lane], ck[lane] + rko);
    __syncwarp();
  }
#pragma unroll
  for (int i = lane; i < kColBlocks * P; i += 32) {
    const int c = x * kColBlocks + i / P, q = K * (i % P);
    push16(in_cta(dst + (unsigned)sizeof(T) * q, c), stage + q,
           in_cta(bar, c));
  }
}

// The closure on one cluster of 4 x 4 CTAs, each `rows` x `cols` of the
// (padded) tile, cols threads across and rows / RR down.
template <typename T, int RR>
__global__ void __launch_bounds__(max_threads(RR), 1)
kleene_cluster(const T* in, long long ld_in, T* out, long long ld_out, int t,
               int rows, int cols) {
  static_assert(RR % 4 == 0 && RR <= 32,
                "a column goes as 16-byte pieces, one entry per lane");
  using Vec = typename Lane<T>::V;
  constexpr int K = Lane<T>::K;
  // Dynamic shared memory: two mbarriers, rowbuf[2][cols], colbuf[2][rows]
  // and the column owners' stage[rows].
  extern __shared__ __align__(16) unsigned char smem[];
  T* rowbuf = reinterpret_cast<T*>(smem + 16);
  T* colbuf = rowbuf + 2 * cols;  // 16-byte aligned: cols % 4 == 0
  T* stage = colbuf + 2 * rows;
  const unsigned bar0 = smem_u32(smem);
  const unsigned row0 = smem_u32(rowbuf);
  const unsigned col0 = smem_u32(colbuf);
  constexpr unsigned kSz = sizeof(T);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int x = rank / kColBlocks, y = rank % kColBlocks;  // its blocks
  const int tx = threadIdx.x % cols, ty = threadIdx.x / cols;
  const int groups = rows / RR;           // thread rows per CTA
  const int i0 = x * rows + ty * RR;      // this thread's first tile row
  const int j = y * cols + tx;            // and its column
  const int step_bytes = (int)kSz * (rows + cols);

  T v[RR];
#pragma unroll
  for (int q = 0; q < RR; ++q) {
    v[q] = (j < t && i0 + q < t) ? in[(long long)(i0 + q) * ld_in + j]
                                 : Lane<T>::inf();
  }
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0)
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    expect(bar0, step_bytes);                 // step 0
    if (t > 1) expect(bar0 + 8, step_bytes);  // step 1
  }
  cluster.sync();  // every mbarrier is set up before any CTA pushes

  // The state before step 0: row 0 and column 0 into slot 0.
  if (x == 0 && ty == 0) push_row(v[0], row0 + kSz * (tx & ~3), bar0, y);
  if (y == 0 && tx < 32)
    push_column<T, RR>(v, 0, false, T(0), nullptr, stage + ty * RR,
                       col0 + kSz * ty * RR, bar0, x);

  for (int g = 0; g * RR < t; ++g) {  // tile rows [g RR, g RR + RR)
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      const int k = g * RR + r;
      if (k >= t) break;  // uniform over the cluster
      const int s = k & 1;
      wait_phase(bar0 + 8 * s, (k >> 1) & 1);
      if (threadIdx.x == 0 && k + 2 < t) expect(bar0 + 8 * s, step_bytes);
      const T rk = rowbuf[s * cols + tx];
      const T* ck = colbuf + s * rows + ty * RR;
      // Every thread is done with slot (k + 1) % 2 of step k - 1.
      if (k > 0) cluster_wait();
      const int k1 = k + 1;
      if (k1 < t) {
        // Row k+1 and column k+1 as step k leaves them, first. Both
        // conditions are uniform over a warp.
        const unsigned bar = bar0 + 8 * (s ^ 1);
        const int g1 = r + 1 < RR ? g : g + 1;
        const int r1 = r + 1 < RR ? r + 1 : 0;  // compile-time
        if (x == g1 / groups && ty == g1 % groups)
          push_row(vmin(v[r1], ck[r1] + rk),
                   row0 + kSz * ((s ^ 1) * cols + (tx & ~3)), bar, y);
        const int c1 = k1 % cols;
        if (y == k1 / cols && (tx >> 5) == (c1 >> 5))
          push_column<T, RR>(v, c1 & 31, true, rk, ck, stage + ty * RR,
                             col0 + kSz * ((s ^ 1) * rows + ty * RR), bar, x);
      }
      const Vec* ckv = reinterpret_cast<const Vec*>(ck);
#pragma unroll
      for (int q = 0; q < RR; q += K) {
        const Vec c = ckv[q / K];
#pragma unroll
        for (int i = 0; i < K; ++i) v[q + i] = vmin(v[q + i], at(c, i) + rk);
      }
      __syncwarp();
      cluster_arrive_relaxed();  // this thread is done with slot k % 2
    }
  }
  cluster_wait();
#pragma unroll
  for (int q = 0; q < RR; ++q)
    if (j < t && i0 + q < t) out[(long long)(i0 + q) * ld_out + j] = v[q];
}

template <typename T, int RR>
cudaError_t cluster_config(int threads, int smem, void* stream,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attrs) {
  const cudaError_t attr_err = once_per_device([] {
    return cudaFuncSetAttribute(kleene_cluster<T, RR>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed,
                                1);
  });
  if (attr_err != cudaSuccess) return attr_err;
  if (threads > max_threads(RR)) return cudaErrorInvalidValue;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)kCluster);
  cfg->blockDim = dim3((unsigned)threads);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = (unsigned)kCluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  // One CTA per SM: the cluster's rate is its SMs'.
  attrs[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attrs[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicySpread;
  cfg->attrs = attrs;
  cfg->numAttrs = 2;
  return cudaSuccess;
}

template <typename T, int RR>
cudaError_t launch_cluster(const T* in, long long ld_in, T* out,
                           long long ld_out, int t, int rows, int cols,
                           int threads, int smem, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  cudaError_t err = cluster_config<T, RR>(threads, smem, stream, &cfg, attrs);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kleene_cluster<T, RR>, in, ld_in, out,
                           ld_out, t, rows, cols);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int RR>
cudaError_t occupancy_cluster(int threads, int smem, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  const cudaError_t err = cluster_config<T, RR>(threads, smem, nullptr, &cfg,
                                                attrs);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, kleene_cluster<T, RR>, &cfg);
}

// ---- rounds variant (f64: B steps per hand-over; see the top) -------------

// The rounds kernel's CTAs are KLEENE_THREAD_ROWS (4) thread rows of RR
// rows down and as many columns across: rows = cols = 4 RR, known at
// compile time, which keeps offsets out of registers (the tile takes 64
// of a thread's 128 at RR = 32).
constexpr int kThreadRows = 4;

// Dynamic shared memory of kleene_rounds<T, RR, B> on a CTA of rows x
// cols: two mbarriers; two slots, each the row panel [cols][B] (a
// thread's column: B values in a row), the column panel [B][rows] (a
// step's column: 16 bytes are two rows, as kleene_cluster's colbuf, so
// that one load feeds two independent candidates) and the diagonal
// block's snapshots [B][B]; the column owners' stage [rows][B]; the next
// diagonal block [B][B] (column-major) and its snapshots [B][B], where
// the holder makes them.
template <typename T>
constexpr int rounds_smem(int rows, int cols, int b) {
  return 16 + (int)sizeof(T) * (2 * b * (cols + rows + b) + b * rows
                                + 2 * b * b);
}

// Two doubles, by value, as one 16-byte push (no register array is
// addressed, so none goes to local memory).
__device__ __forceinline__ void push_pair(unsigned dst, double a, double b,
                                          unsigned bar) {
  push_words(dst, (unsigned)__double2loint(a), (unsigned)__double2hiint(a),
             (unsigned)__double2loint(b), (unsigned)__double2hiint(b), bar);
}

// Push a thread's N doubles e as 16-byte pieces to offset `dst` of the 4
// CTAs rank0 + stride * c, counting on their mbarrier `bar`.
template <int N>
__device__ __forceinline__ void push_to4(const double (&e)[N], unsigned dst,
                                         unsigned bar, int rank0,
                                         int stride) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int rank = rank0 + stride * c;
    const unsigned d = in_cta(dst, rank), b = in_cta(bar, rank);
#pragma unroll
    for (int h = 0; h < N / 2; ++h)
      push_pair(d + 16 * h, e[2 * h], e[2 * h + 1], b);
  }
}

// The B steps of a round on its diagonal block `block` ([B][B],
// column-major, as the last round left it, in place), one entry a lane
// of the CTA's last warp, through shared memory: snap[i][c] (row-major)
// gets entry (i, c) as it was before step min(i, c), off the diagonal:
// the row panel's values above it, the column panel's below (what step 2
// needs of the block). (Shuffles, or each entry made straight from the
// raw block, were faster but made the kernel spill at RR = 32; PERF.md.)
template <typename T, int B>
__device__ __forceinline__ void close_diag(T* block, T* snap) {
  static_assert(B * B <= 32, "an entry a lane of one warp");
  const int e = threadIdx.x - ((int)blockDim.x - 32);
  const int i = e % B, c = e / B;
  const bool mine = e < B * B;
  T m = mine ? block[c * B + i] : T(0);
#pragma unroll
  for (int k = 0; k + 1 < B; ++k) {
    if (mine && i != c && k == min(i, c)) snap[i * B + c] = m;
    T cand = T(0);
    if (mine) cand = block[k * B + i] + block[c * B + k];
    __syncwarp();  // every read of step k is done
    if (mine) block[c * B + i] = m = vmin(m, cand);
    __syncwarp();
  }
}

// Step 2, one thread per panel line, in place, its B values `stride`
// apart. A row of the column panel (p[k] = m[i, k0 + k]) takes each
// step k on its entries right of k with the block's row values; a column
// of the row panel (p[k] = m[k0 + k, j]) on its entries below k with the
// block's column values. Entry k is final once step k comes: the state
// before step k.
template <typename T, int B>
__device__ __forceinline__ void panel_line(T* p, int stride, const T* snap,
                                           bool row) {
  T cur[B];
#pragma unroll
  for (int k = 0; k < B; ++k) cur[k] = p[k * stride];
#pragma unroll
  for (int k = 0; k < B - 1; ++k) {
#pragma unroll
    for (int c = k + 1; c < B; ++c)
      cur[c] = row ? vmin(cur[c], cur[k] + snap[k * B + c])
                   : vmin(cur[c], snap[c * B + k] + cur[k]);
  }
#pragma unroll
  for (int k = 1; k < B; ++k) p[k * stride] = cur[k];
}

// Step 3 on the thread's rows: only the block of B rows at `only` (< 0:
// every block), but the block at `skip` (< 0: none). Both fold to
// constants where the round loop is unrolled. Each entry takes the
// candidates C[i, k] + R[k, j] in ascending k: k outside, over 16-byte
// pieces of the thread's column of the row panel (`rcol`, loaded as it
// is used), the rows inside, K of them a 16-byte load of the column
// panel (`ck`: step k's column at ck[k * kRows], this thread's rows).
template <typename T, int RR, int B, int kRows>
__device__ __forceinline__ void apply_round(T (&v)[RR], const T* ck,
                                            const T* rcol, int only,
                                            int skip) {
  using Vec = typename Lane<T>::V;
  constexpr int K = Lane<T>::K;
#pragma unroll
  for (int h = 0; h < B / K; ++h) {
    const Vec rv = reinterpret_cast<const Vec*>(rcol)[h];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const T rk = at(rv, i);
      const Vec* col = reinterpret_cast<const Vec*>(ck + (K * h + i) * kRows);
#pragma unroll
      for (int q = 0; q < RR; q += K) {
        const int block = q / B * B;
        if ((only >= 0 && block != only) || block == skip) continue;
        const Vec c = col[q / K];
#pragma unroll
        for (int e = 0; e < K; ++e) v[q + e] = vmin(v[q + e], at(c, e) + rk);
      }
    }
  }
}

// The next round's columns k1 .. k1+B-1, made by every thread of a CTA
// of their column block from the owners' entries (`stage`: [rows][B],
// the state before this round): B / 4 entries (row, c) per thread, one
// B-step chain each (`round`: this round's column panel `colbuf` and row
// panel `rowbuf`, columns c1 .. of this CTA, in step order), not B^2
// steps in the owners' warp. A lane pair makes the 16 bytes of two rows
// of column c (one shuffle) and the even lane pushes them into the 4
// CTAs of its row block x (`dst`: the step-major column panel of the
// next slot). Where the rows hold the next diagonal block (rows
// diag_row0 .. diag_row0+B-1 of this CTA; < 0: not here) its entries go
// to `block` ([B][B], column-major).
template <typename T, int B, int kRows>
__device__ __forceinline__ void make_columns(
    const T* stage, bool round, const T* colbuf, const T* rowbuf, int c1,
    unsigned dst, unsigned bar, int x, int diag_row0, T* block) {
  static_assert(B % 4 == 0, "every thread takes B / 4 entries");
  constexpr unsigned kSz = sizeof(T);
  constexpr int kTrips = B / 4;
  int c[kTrips], row[kTrips];
  T cur[kTrips];
#pragma unroll
  for (int it = 0; it < kTrips; ++it) {
    const int p = threadIdx.x + it * 4 * kRows;
    c[it] = p / kRows;
    row[it] = p % kRows;
    cur[it] = stage[row[it] * B + c[it]];
  }
  if (round) {
#pragma unroll
    for (int k = 0; k < B; ++k) {
#pragma unroll
      for (int it = 0; it < kTrips; ++it)
        cur[it] = vmin(cur[it], colbuf[k * kRows + row[it]] +
                                    rowbuf[(c1 + c[it]) * B + k]);
    }
  }
#pragma unroll
  for (int it = 0; it < kTrips; ++it) {
    const T other = __shfl_xor_sync(0xffffffffu, cur[it], 1);
    if (!(row[it] & 1)) {
      const T piece[2] = {cur[it], other};
      push_to4<2>(piece, dst + kSz * (c[it] * kRows + row[it]), bar,
                     x * kColBlocks, 1);
    }
    if (diag_row0 >= 0 && row[it] >= diag_row0 && row[it] < diag_row0 + B)
      block[c[it] * B + row[it] - diag_row0] = cur[it];
  }
}

// The holder of the next diagonal block (a CTA of make_columns with
// diag_row0 >= 0), after a barrier: its last warp runs the round's steps
// on the block and pushes the snapshots (`snap`, [B][B]) to all 16 CTAs'
// next slot (`dst`), 16 bytes at a time. It overlaps the rest of the
// CTA's update; every CTA then builds its panels from them.
template <typename T, int B>
__device__ __forceinline__ void push_snapshots(T* block, T* snap,
                                               unsigned dst, unsigned bar) {
  constexpr int K = Lane<T>::K;
  constexpr int kPieces = B * B / K;
  if ((int)threadIdx.x < (int)blockDim.x - 32) return;
  close_diag<T, B>(block, snap);
  __syncwarp();
  for (int q = threadIdx.x & 31; q < kPieces * kCluster; q += 32) {
    const int p = q % kPieces, cta = q / kPieces;
    push_pair(in_cta(dst + 16 * p, cta), snap[K * p], snap[K * p + 1],
              in_cta(bar, cta));
  }
}

// The owners of columns c1 .. c1+B-1 of this CTA (all thread rows) stage
// their entries for make_columns.
template <typename T, int RR, int B>
__device__ __forceinline__ void stage_columns(const T (&v)[RR], T* stage,
                                              int c1, int tx, int ty) {
  if (tx >= c1 && tx < c1 + B) {
#pragma unroll
    for (int r = 0; r < RR; ++r) stage[(ty * RR + r) * B + tx - c1] = v[r];
  }
}

// The closure on one cluster of 4 x 4 CTAs in rounds of B steps: CTAs of
// 4 RR x 4 RR entries, 4 thread rows of 4 RR threads (shared memory
// rounds_smem).
template <typename T, int RR, int B>
__global__ void __launch_bounds__(max_threads(RR), 1)
kleene_rounds(const T* in, long long ld_in, T* out, long long ld_out,
              int t) {
  static_assert(RR % B == 0 && B % 2 == 0 && B <= 32 && RR <= 32,
                "a round is whole 16-byte pieces of a thread's row group");
  constexpr int Q = RR / B;  // rounds per row group
  constexpr int kRows = kThreadRows * RR, kCols = kRows;
  static_assert(Lane<T>::K == 2, "the f64 kernel");
  constexpr int kSlot = B * (kCols + kRows + B);  // rowbuf, colbuf, diag
  constexpr unsigned kSz = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* const slots = reinterpret_cast<T*>(smem + 16);
  T* const stage = slots + 2 * kSlot;  // [kRows][B]
  T* const block = stage + B * kRows;  // the next diagonal block, [B][B]
  T* const snap = block + B * B;       // and its snapshots
  const unsigned bar0 = smem_u32(smem);
  const unsigned slots0 = smem_u32(slots);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int x = rank / kColBlocks, y = rank % kColBlocks;
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const int i0 = x * kRows + ty * RR;
  const int j = y * kCols + tx;

  T v[RR];
#pragma unroll
  for (int q = 0; q < RR; ++q) {
    v[q] = (j < t && i0 + q < t) ? in[(long long)(i0 + q) * ld_in + j]
                                 : Lane<T>::inf();
  }
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0)
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    expect(bar0, (int)kSz * kSlot);                 // round 0
    if (t > B) expect(bar0 + 8, (int)kSz * kSlot);  // round 1
  }
  cluster.sync();  // every mbarrier is set up before any CTA pushes

  // Round 0's panels and block: the input itself, into slot 0.
  {
    constexpr unsigned kColbuf = kSz * B * kCols;
    if (x == 0 && ty == 0) {
      T e[B];
#pragma unroll
      for (int i = 0; i < B; ++i) e[i] = v[i];
      push_to4<B>(e, slots0 + kSz * B * tx, bar0, y, kColBlocks);
    }
    if (y == 0) {  // uniform over the CTA
      stage_columns<T, RR, B>(v, stage, 0, tx, ty);
      __syncthreads();
      make_columns<T, B, kRows>(stage, false, nullptr, nullptr, 0,
                                slots0 + kColbuf, bar0, x, x == 0 ? 0 : -1,
                                block);
      if (x == 0) {
        __syncthreads();
        push_snapshots<T, B>(block, snap, slots0 + kColbuf + kSz * B * kRows,
                             bar0);
      }
    }
  }

  for (int g = 0; g * RR < t; ++g) {  // tile rows [g RR, g RR + RR)
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k0 = g * RR + q * B;
      if (k0 >= t) break;  // uniform over the cluster
      const int n = k0 / B, s = n & 1;
      T* const rowbuf = slots + s * kSlot;
      T* const colbuf = rowbuf + B * kCols;
      wait_phase(bar0 + 8 * s, (n >> 1) & 1);
      if (threadIdx.x == 0 && k0 + 2 * B < t)
        expect(bar0 + 8 * s, (int)kSz * kSlot);
      const T* round_snap = colbuf + B * kRows;
      if (threadIdx.x < kRows)
        panel_line<T, B>(colbuf + threadIdx.x, kRows, round_snap, true);
      else if (threadIdx.x < kRows + kCols)
        panel_line<T, B>(rowbuf + B * (threadIdx.x - kRows), 1, round_snap,
                         false);
      const int k1 = k0 + B;
      const int c1 = k1 % kCols;
      const bool cols_here = k1 < t && y == k1 / kCols;  // CTA-uniform
      if (cols_here) stage_columns<T, RR, B>(v, stage, c1, tx, ty);
      __syncthreads();
      const T* ck = colbuf + ty * RR;
      const T* rcol = rowbuf + B * tx;
      // Every thread is done with slot s ^ 1 of round n - 1.
      if (n > 0) cluster_wait();
      const int r1 = ((q + 1) % Q) * B;  // next round's rows in a group
      int skip = -1;  // the block of rows this thread updated ahead
      const unsigned bar = bar0 + 8 * (s ^ 1);
      const unsigned next = slots0 + kSz * (s ^ 1) * kSlot;
      const int g1 = q + 1 < Q ? g : g + 1;
      // The next round's columns and block, then its rows, as this round
      // leaves them, ahead of the update.
      if (cols_here) {
        const bool block_here = x == g1 / kThreadRows;  // CTA-uniform
        make_columns<T, B, kRows>(
            stage, true, colbuf, rowbuf, c1, next + kSz * B * kCols, bar, x,
            block_here ? (g1 % kThreadRows) * RR + r1 : -1, block);
        if (block_here) {
          __syncthreads();
          push_snapshots<T, B>(block, snap, next + kSz * B * (kCols + kRows),
                               bar);
        }
      }
      if (k1 < t && x * kThreadRows + ty == g1) {  // uniform: a thread row
        apply_round<T, RR, B, kRows>(v, ck, rcol, r1, -1);
        T e[B];
#pragma unroll
        for (int i = 0; i < B; ++i) e[i] = v[r1 + i];
        push_to4<B>(e, next + kSz * B * tx, bar, y, kColBlocks);
        skip = r1;
      }
      apply_round<T, RR, B, kRows>(v, ck, rcol, -1, skip);
      __syncwarp();
      cluster_arrive_relaxed();  // this thread is done with slot s
    }
  }
  cluster_wait();
#pragma unroll
  for (int q = 0; q < RR; ++q)
    if (j < t && i0 + q < t) out[(long long)(i0 + q) * ld_out + j] = v[q];
}

// The launch configuration of kleene_rounds<T, RR, B>: kleene_cluster's.
template <typename T, int RR, int B>
cudaError_t rounds_config(int threads, int smem, void* stream,
                          cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attrs) {
  const cudaError_t attr_err = once_per_device([] {
    return cudaFuncSetAttribute(kleene_rounds<T, RR, B>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed,
                                1);
  });
  if (attr_err != cudaSuccess) return attr_err;
  if (threads > max_threads(RR)) return cudaErrorInvalidValue;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)kCluster);
  cfg->blockDim = dim3((unsigned)threads);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = (unsigned)kCluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attrs[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicySpread;
  cfg->attrs = attrs;
  cfg->numAttrs = 2;
  return cudaSuccess;
}

template <typename T, int RR, int B>
cudaError_t launch_rounds(const T* in, long long ld_in, T* out,
                          long long ld_out, int t, int threads, int smem,
                          void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  cudaError_t err = rounds_config<T, RR, B>(threads, smem, stream, &cfg, attrs);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kleene_rounds<T, RR, B>, in, ld_in, out,
                           ld_out, t);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int RR, int B>
cudaError_t occupancy_rounds(int threads, int smem, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  const cudaError_t err = rounds_config<T, RR, B>(threads, smem, nullptr,
                                                  &cfg, attrs);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, kleene_rounds<T, RR, B>,
                                        &cfg);
}

// The CTAs' shape from the plan (ops/fw.py kleene_plan): 4 x 4 CTAs of
// `rows` x `cols` over a tile padded to 4 rows = 4 cols >= t, `cols` (a
// multiple of 32) threads across and rows / RR down, at most RR = 32;
// `steps` per hand-over (1: kleene_cluster; B > 1: kleene_rounds, 4 thread
// rows, its panel lines one thread each). Returns RR, or 0 when the shape
// is not one the kernel takes.
template <typename T>
int cluster_shape(int t, int rows, int cols, int threads, int smem,
                  int steps) {
  if (rows < 1 || cols < 32 || cols % 32 || threads % cols || steps < 1)
    return 0;
  const int groups = threads / cols, rr = rows / groups;
  if (rows % groups || kRowBlocks * rows != kColBlocks * cols ||
      kRowBlocks * rows < t || kColBlocks * rr > 128)
    return 0;
  const int need = steps == 1
                       ? 16 + (int)sizeof(T) * (2 * cols + 3 * rows)
                       : rounds_smem<T>(rows, cols, steps);
  if (smem < need || smem > 48 * 1024 ||
      (steps > 1 && (rr % steps || groups != kThreadRows)))
    return 0;
  return rr;
}

template <typename T>
int closure(const T* in, long long ld_in, T* out, long long ld_out, int t,
            int rows, int cols, int threads, int smem, void* stream) {
  if (t <= 0) return (int)cudaGetLastError();
  const int rr = cluster_shape<T>(t, rows, cols, threads, smem, 1);
  if (ld_in < t || ld_out < t || rr == 0) return (int)cudaErrorInvalidValue;
  switch (rr) {
    case 8: return (int)launch_cluster<T, 8>(in, ld_in, out, ld_out, t, rows, cols, threads, smem, stream);
    case 16: return (int)launch_cluster<T, 16>(in, ld_in, out, ld_out, t, rows, cols, threads, smem, stream);
    case 24: return (int)launch_cluster<T, 24>(in, ld_in, out, ld_out, t, rows, cols, threads, smem, stream);
    case 32: return (int)launch_cluster<T, 32>(in, ld_in, out, ld_out, t, rows, cols, threads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int cluster_occupancy(int rows, int cols, int threads, int smem,
                      int* clusters) {
  *clusters = 0;
  switch (cluster_shape<T>(0, rows, cols, threads, smem, 1)) {
    case 8: return (int)occupancy_cluster<T, 8>(threads, smem, clusters);
    case 16: return (int)occupancy_cluster<T, 16>(threads, smem, clusters);
    case 24: return (int)occupancy_cluster<T, 24>(threads, smem, clusters);
    case 32: return (int)occupancy_cluster<T, 32>(threads, smem, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The f64 closure and its occupancy, in rounds of kSteps64 steps per
// hand-over: kleene_rounds at each RR. (One step per hand-over,
// kleene_cluster<double, 32> with the compare-and-select min, took 128
// registers and spilled; rounds of 8 spilled at RR = 32 and were slower
// than rounds of 4 in every form tried; PERF.md §6.)
constexpr int kSteps64 = 4;
#define PJ_ROUNDS(F, ...)                                                \
  switch (rr) {                                                          \
    case 8: return (int)F<double, 8, kSteps64>(__VA_ARGS__);             \
    case 16: return (int)F<double, 16, kSteps64>(__VA_ARGS__);           \
    case 24: return (int)F<double, 24, kSteps64>(__VA_ARGS__);           \
    case 32: return (int)F<double, 32, kSteps64>(__VA_ARGS__);           \
    default: return (int)cudaErrorInvalidValue;                          \
  }

int closure_f64(const double* in, long long ld_in, double* out,
                long long ld_out, int t, int rows, int cols, int threads,
                int smem, void* stream) {
  if (t <= 0) return (int)cudaGetLastError();
  const int rr =
      cluster_shape<double>(t, rows, cols, threads, smem, kSteps64);
  if (ld_in < t || ld_out < t || rr == 0) return (int)cudaErrorInvalidValue;
  PJ_ROUNDS(launch_rounds, in, ld_in, out, ld_out, t, threads, smem, stream)
}

int occupancy_f64(int rows, int cols, int threads, int smem,
                  int* clusters) {
  *clusters = 0;
  const int rr =
      cluster_shape<double>(0, rows, cols, threads, smem, kSteps64);
  PJ_ROUNDS(occupancy_rounds, threads, smem, clusters)
}

#undef PJ_ROUNDS

// ---- step variant ----------------------------------------------------------

constexpr int kBX = 32;    // columns per block (one warp wide)
constexpr int kBY = 8;     // thread rows per block
constexpr int kRows = 4;   // rows per thread

template <typename T>
__global__ void __launch_bounds__(kBX * kBY)
kleene_step(const T* src, long long ld_src, T* dst, long long ld_dst, int t,
            int k) {
  const int j = blockIdx.x * kBX + threadIdx.x;
  if (j >= t) return;
  const T rk = src[(long long)k * ld_src + j];
  const int i0 = blockIdx.y * (kBY * kRows) + threadIdx.y;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kBY;
    if (i < t) {
      const T cik = src[(long long)i * ld_src + k];
      dst[(long long)i * ld_dst + j] =
          vmin(src[(long long)i * ld_src + j], cik + rk);
    }
  }
}

template <typename T>
int closure_steps(const T* in, long long ld_in, T* out, long long ld_out,
                  T* buf0, T* buf1, int t, void* stream) {
  if (t <= 0) return (int)cudaGetLastError();
  if (ld_in < t || ld_out < t || (t >= 2 && buf0 == nullptr) ||
      (t >= 3 && buf1 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kBX, kBY);
  const dim3 grid((unsigned)((t + kBX - 1) / kBX),
                  (unsigned)((t + kBY * kRows - 1) / (kBY * kRows)));
  T* bufs[2] = {buf0, buf1};
  const T* src = in;
  long long ld = ld_in;
  for (int k = 0; k < t; ++k) {
    T* dst = k == t - 1 ? out : bufs[k & 1];
    const long long ldd = k == t - 1 ? ld_out : (long long)t;
    kleene_step<T><<<grid, block, 0, s>>>(src, ld, dst, ldd, t, k);
    src = dst;
    ld = ldd;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The closure of the [t, t] tile at `in` (row stride ld_in) into `out`
// (row stride ld_out; may be `in` itself) in one launch of one cluster
// of 16 CTAs of `rows` x `cols` tile entries, `threads` threads and
// `smem` bytes of dynamic shared memory each (ops/fw.py kleene_plan).
// Returns the launch's error, else cudaGetLastError(). The `_f64` entry
// points take doubles; their plan is sized for rounds of kSteps64 steps
// (ops/fw.py KLEENE_STEPS_F64, which a test holds equal to it).
extern "C" int pj_fw_kleene(const float* in, long long ld_in, float* out,
                            long long ld_out, int t, int rows, int cols,
                            int threads, int smem, void* stream) {
  return closure<float>(in, ld_in, out, ld_out, t, rows, cols, threads, smem,
                        stream);
}

extern "C" int pj_fw_kleene_f64(const double* in, long long ld_in,
                                double* out, long long ld_out, int t,
                                int rows, int cols, int threads, int smem,
                                void* stream) {
  return closure_f64(in, ld_in, out, ld_out, t, rows, cols, threads, smem,
                     stream);
}

// Clusters of that shape the card can hold at once, into *clusters
// (cudaOccupancyMaxActiveClusters); 0 means the launch cannot run.
extern "C" int pj_fw_kleene_occupancy(int rows, int cols, int threads,
                                      int smem, int* clusters) {
  return cluster_occupancy<float>(rows, cols, threads, smem, clusters);
}

extern "C" int pj_fw_kleene_occupancy_f64(int rows, int cols, int threads,
                                          int smem, int* clusters) {
  return occupancy_f64(rows, cols, threads, smem, clusters);
}

// The step variant: the closure of `in` into `out` as above in t kernel
// launches on the caller's stream. buf0 and buf1 are [t, t] scratch (row
// stride t): steps alternate between them, so each reads the state
// before it; only step 0 reads `in`, only step t-1 writes `out`.
// Returns cudaGetLastError() after the last launch.
extern "C" int pj_fw_kleene_steps(const float* in, long long ld_in,
                                  float* out, long long ld_out, float* buf0,
                                  float* buf1, int t, void* stream) {
  return closure_steps<float>(in, ld_in, out, ld_out, buf0, buf1, t, stream);
}

extern "C" int pj_fw_kleene_steps_f64(const double* in, long long ld_in,
                                      double* out, long long ld_out,
                                      double* buf0, double* buf1, int t,
                                      void* stream) {
  return closure_steps<double>(in, ld_in, out, ld_out, buf0, buf1, t, stream);
}
