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
// the same design on doubles. A thread's RR rows take 2 RR registers, so
// at t = 512 (RR = 32) the tile is 64 registers of the 128 a thread has
// at 512 threads per SM. A hand-over store still moves 16 bytes, now two
// whole doubles (st.async of four 32-bit words: each double's low and
// high word in the same store, so no double arrives in halves): a lane
// of a row warp sends its quad's 32 bytes as two stores, and a column's
// RR entries go as RR / 2 pieces per CTA, looped over the warp's lanes.
// Twice the bytes per step, 8 (rows + cols).
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

__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }

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

// The 16 bytes at e: four floats, or two doubles (each as its low then
// its high word, its layout in memory) in one store.
__device__ __forceinline__ void push16(unsigned dst, const float* e,
                                       unsigned bar) {
  push_words(dst, __float_as_uint(e[0]), __float_as_uint(e[1]),
             __float_as_uint(e[2]), __float_as_uint(e[3]), bar);
}

__device__ __forceinline__ void push16(unsigned dst, const double* e,
                                       unsigned bar) {
  push_words(dst, (unsigned)__double2loint(e[0]),
             (unsigned)__double2hiint(e[0]), (unsigned)__double2loint(e[1]),
             (unsigned)__double2hiint(e[1]), bar);
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
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kleene_cluster<T, RR>, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
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

// The CTAs' shape from the plan (ops/fw.py kleene_plan): 4 x 4 CTAs of
// `rows` x `cols` over a tile padded to 4 rows = 4 cols >= t, `cols` (a
// multiple of 32) threads across and rows / RR down, at most RR = 32.
// Returns RR, or 0 when the shape is not one the kernel takes.
template <typename T>
int cluster_shape(int t, int rows, int cols, int threads, int smem) {
  if (rows < 1 || cols < 32 || cols % 32 || threads % cols) return 0;
  const int groups = threads / cols, rr = rows / groups;
  if (rows % groups || kRowBlocks * rows != kColBlocks * cols ||
      kRowBlocks * rows < t || kColBlocks * rr > 128 ||
      smem < 16 + (int)sizeof(T) * (2 * cols + 3 * rows) ||
      smem > 48 * 1024)
    return 0;
  return rr;
}

template <typename T>
int closure(const T* in, long long ld_in, T* out, long long ld_out, int t,
            int rows, int cols, int threads, int smem, void* stream) {
  if (t <= 0) return (int)cudaGetLastError();
  const int rr = cluster_shape<T>(t, rows, cols, threads, smem);
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
  switch (cluster_shape<T>(0, rows, cols, threads, smem)) {
    case 8: return (int)occupancy_cluster<T, 8>(threads, smem, clusters);
    case 16: return (int)occupancy_cluster<T, 16>(threads, smem, clusters);
    case 24: return (int)occupancy_cluster<T, 24>(threads, smem, clusters);
    case 32: return (int)occupancy_cluster<T, 32>(threads, smem, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
// points take doubles.
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
  return closure<double>(in, ld_in, out, ld_out, t, rows, cols, threads,
                         smem, stream);
}

// Clusters of that shape the card can hold at once, into *clusters
// (cudaOccupancyMaxActiveClusters); 0 means the launch cannot run.
extern "C" int pj_fw_kleene_occupancy(int rows, int cols, int threads,
                                      int smem, int* clusters) {
  return cluster_occupancy<float>(rows, cols, threads, smem, clusters);
}

extern "C" int pj_fw_kleene_occupancy_f64(int rows, int cols, int threads,
                                          int smem, int* clusters) {
  return cluster_occupancy<double>(rows, cols, threads, smem, clusters);
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
