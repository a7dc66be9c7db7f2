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
// Exactness: each candidate is one exactly rounded f32 add and fminf is
// exact, and the steps run in the reference's order, so the closure is
// bitwise the plain PyTorch loop's. A hand-over entry is made ahead of
// its holder's own update by the same operation on the same operands,
// and min is idempotent, so making it twice changes no bit. No recursive
// sub-blocking inside the tile: it would change the association of
// float path sums. The build has no fast-math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

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
__device__ __forceinline__ void push4(unsigned dst, float v0, float v1,
                                      float v2, float v3, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst), "r"(__float_as_uint(v0)),
      "r"(__float_as_uint(v1)), "r"(__float_as_uint(v2)),
      "r"(__float_as_uint(v3)), "r"(bar) : "memory");
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
// lane quad's 4 entries, one 16-byte store, to row block l % 4. `dst`
// is the quad's offset in the row buffer slot, `bar` its mbarrier.
__device__ __forceinline__ void push_row(float e, unsigned dst, unsigned bar,
                                         int y) {
  const int lane = threadIdx.x & 31, quad = lane & ~3;
  const float e0 = __shfl_sync(0xffffffffu, e, quad);
  const float e1 = __shfl_sync(0xffffffffu, e, quad + 1);
  const float e2 = __shfl_sync(0xffffffffu, e, quad + 2);
  const float e3 = __shfl_sync(0xffffffffu, e, quad + 3);
  const int c = (lane & 3) * kColBlocks + y;
  push4(in_cta(dst, c), e0, e1, e2, e3, in_cta(bar, c));
}

// The warp of column k1's owner thread (lane `owner`) hands the column
// as step k leaves it to the 4 CTAs of its row block x. The owner stages
// its entries before the step in `stage`; lane l < RR makes entry l
// with the step's operation on the same operands the owner's own update
// uses (the column `ck` and the owner's row entry `rk`); then lane l
// sends 16 bytes, one store, to column block l / (RR / 4). With
// `step` false (the state before step 0) the staged entries go as they
// are.
template <int RR>
__device__ __forceinline__ void push_column(const float (&v)[RR], int owner,
                                            bool step, float rk,
                                            const float* ck, float* stage,
                                            unsigned dst, unsigned bar, int x) {
  const int lane = threadIdx.x & 31;
  if (lane == owner) {
#pragma unroll
    for (int q = 0; q < RR; q += 4)
      *reinterpret_cast<float4*>(stage + q) =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  }
  __syncwarp();
  if (step) {
    const float rko = __shfl_sync(0xffffffffu, rk, owner);
    if (lane < RR) stage[lane] = fminf(stage[lane], ck[lane] + rko);
    __syncwarp();
  }
  if (lane < kColBlocks * (RR / 4)) {
    const int c = x * kColBlocks + lane / (RR / 4), q = 4 * (lane % (RR / 4));
    const float4 e = *reinterpret_cast<const float4*>(stage + q);
    push4(in_cta(dst + 4 * q, c), e.x, e.y, e.z, e.w, in_cta(bar, c));
  }
}

// The closure on one cluster of 4 x 4 CTAs, each `rows` x `cols` of the
// (padded) tile, cols threads across and rows / RR down.
template <int RR>
__global__ void __launch_bounds__(max_threads(RR), 1)
kleene_cluster(const float* in, long long ld_in, float* out, long long ld_out,
               int t, int rows, int cols) {
  static_assert(RR % 4 == 0 && RR <= 32,
                "a column goes as float4 pieces, one entry per lane");
  // Dynamic shared memory: two mbarriers, rowbuf[2][cols], colbuf[2][rows]
  // and the column owners' stage[rows].
  extern __shared__ __align__(16) unsigned char smem[];
  float* rowbuf = reinterpret_cast<float*>(smem + 16);
  float* colbuf = rowbuf + 2 * cols;  // 16-byte aligned: cols % 4 == 0
  float* stage = colbuf + 2 * rows;
  const unsigned bar0 = smem_u32(smem);
  const unsigned row0 = smem_u32(rowbuf);
  const unsigned col0 = smem_u32(colbuf);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int x = rank / kColBlocks, y = rank % kColBlocks;  // its blocks
  const int tx = threadIdx.x % cols, ty = threadIdx.x / cols;
  const int groups = rows / RR;           // thread rows per CTA
  const int i0 = x * rows + ty * RR;      // this thread's first tile row
  const int j = y * cols + tx;            // and its column
  const int step_bytes = 4 * (rows + cols);

  float v[RR];
#pragma unroll
  for (int q = 0; q < RR; ++q) {
    v[q] = (j < t && i0 + q < t) ? in[(long long)(i0 + q) * ld_in + j]
                                 : __int_as_float(0x7f800000);
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
  if (x == 0 && ty == 0) push_row(v[0], row0 + 4 * (tx & ~3), bar0, y);
  if (y == 0 && tx < 32)
    push_column(v, 0, false, 0.f, nullptr, stage + ty * RR, col0 + 4 * ty * RR,
                bar0, x);

  for (int g = 0; g * RR < t; ++g) {  // tile rows [g RR, g RR + RR)
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      const int k = g * RR + r;
      if (k >= t) break;  // uniform over the cluster
      const int s = k & 1;
      wait_phase(bar0 + 8 * s, (k >> 1) & 1);
      if (threadIdx.x == 0 && k + 2 < t) expect(bar0 + 8 * s, step_bytes);
      const float rk = rowbuf[s * cols + tx];
      const float* ck = colbuf + s * rows + ty * RR;
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
          push_row(fminf(v[r1], ck[r1] + rk),
                   row0 + 4 * ((s ^ 1) * cols + (tx & ~3)), bar, y);
        const int c1 = k1 % cols;
        if (y == k1 / cols && (tx >> 5) == (c1 >> 5))
          push_column(v, c1 & 31, true, rk, ck, stage + ty * RR,
                      col0 + 4 * ((s ^ 1) * rows + ty * RR), bar, x);
      }
      const float4* ck4 = reinterpret_cast<const float4*>(ck);
#pragma unroll
      for (int q = 0; q < RR; q += 4) {
        const float4 c = ck4[q / 4];
        v[q] = fminf(v[q], c.x + rk);
        v[q + 1] = fminf(v[q + 1], c.y + rk);
        v[q + 2] = fminf(v[q + 2], c.z + rk);
        v[q + 3] = fminf(v[q + 3], c.w + rk);
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

template <int RR>
cudaError_t cluster_config(int threads, int smem, void* stream,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attrs) {
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kleene_cluster<RR>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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

template <int RR>
cudaError_t launch_cluster(const float* in, long long ld_in, float* out,
                           long long ld_out, int t, int rows, int cols,
                           int threads, int smem, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  cudaError_t err = cluster_config<RR>(threads, smem, stream, &cfg, attrs);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kleene_cluster<RR>, in, ld_in, out, ld_out,
                           t, rows, cols);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int RR>
cudaError_t occupancy_cluster(int threads, int smem, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  const cudaError_t err = cluster_config<RR>(threads, smem, nullptr, &cfg,
                                             attrs);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, kleene_cluster<RR>, &cfg);
}

// The CTAs' shape from the plan (ops/fw.py kleene_plan): 4 x 4 CTAs of
// `rows` x `cols` over a tile padded to 4 rows = 4 cols >= t, `cols` (a
// multiple of 32) threads across and rows / RR down, the 4 (RR / 4)
// 16-byte pieces of a column at most one per lane. Returns RR, or 0 when
// the shape is not one the kernel takes.
int cluster_shape(int t, int rows, int cols, int threads, int smem) {
  if (rows < 1 || cols < 32 || cols % 32 || threads % cols) return 0;
  const int groups = threads / cols, rr = rows / groups;
  if (rows % groups || kRowBlocks * rows != kColBlocks * cols ||
      kRowBlocks * rows < t || kColBlocks * rr > 128 ||
      smem < 16 + (int)sizeof(float) * (2 * cols + 3 * rows) ||
      smem > 48 * 1024)
    return 0;
  return rr;
}

// ---- step variant ----------------------------------------------------------

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
// (row stride ld_out; may be `in` itself) in one launch of one cluster
// of 16 CTAs of `rows` x `cols` tile entries, `threads` threads and
// `smem` bytes of dynamic shared memory each (ops/fw.py kleene_plan).
// Returns the launch's error, else cudaGetLastError().
extern "C" int pj_fw_kleene(const float* in, long long ld_in, float* out,
                            long long ld_out, int t, int rows, int cols,
                            int threads, int smem, void* stream) {
  if (t <= 0) return (int)cudaGetLastError();
  const int rr = cluster_shape(t, rows, cols, threads, smem);
  if (ld_in < t || ld_out < t || rr == 0) return (int)cudaErrorInvalidValue;
  switch (rr) {
    case 8: return (int)launch_cluster<8>(in, ld_in, out, ld_out, t, rows, cols, threads, smem, stream);
    case 16: return (int)launch_cluster<16>(in, ld_in, out, ld_out, t, rows, cols, threads, smem, stream);
    case 24: return (int)launch_cluster<24>(in, ld_in, out, ld_out, t, rows, cols, threads, smem, stream);
    case 32: return (int)launch_cluster<32>(in, ld_in, out, ld_out, t, rows, cols, threads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Clusters of that shape the card can hold at once, into *clusters
// (cudaOccupancyMaxActiveClusters); 0 means the launch cannot run.
extern "C" int pj_fw_kleene_occupancy(int rows, int cols, int threads,
                                      int smem, int* clusters) {
  *clusters = 0;
  switch (cluster_shape(0, rows, cols, threads, smem)) {
    case 8: return (int)occupancy_cluster<8>(threads, smem, clusters);
    case 16: return (int)occupancy_cluster<16>(threads, smem, clusters);
    case 24: return (int)occupancy_cluster<24>(threads, smem, clusters);
    case 32: return (int)occupancy_cluster<32>(threads, smem, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The step variant: the closure of `in` into `out` as above in t kernel
// launches on the caller's stream. buf0 and buf1 are [t, t] scratch (row
// stride t): steps alternate between them, so each reads the state
// before it; only step 0 reads `in`, only step t-1 writes `out`.
// Returns cudaGetLastError() after the last launch.
extern "C" int pj_fw_kleene_steps(const float* in, long long ld_in,
                                  float* out, long long ld_out, float* buf0,
                                  float* buf1, int t, void* stream) {
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
