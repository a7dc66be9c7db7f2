// Native CPU/OpenMP kernels — the rebuild of the reference's attested
// native component (SURVEY.md §2 #6: "C/C++ + OpenMP shared-memory parallel
// kernels: parallel-for over edges (Bellman-Ford iterations) and over
// sources (Dijkstra fan-out)", BASELINE.json:5 "CPU/OpenMP path").
//
// This is the comparison baseline the TPU backend's >=10x target is
// measured against, not a stand-in: edge relaxation is a lock-free
// atomic-min sweep parallel over edges, and the fan-out is heap Dijkstra
// parallel over sources. Both count edge relaxations for the attested
// edges-relaxed/sec/chip metric (BASELINE.json:2).
//
// Memory-model notes (the part TSan cares about):
//   - dist[] updates go through __atomic_compare_exchange with relaxed
//     ordering. Distances only ever decrease, and the fixpoint of a
//     monotone min-relaxation is unique, so a stale read can only delay
//     convergence by a sweep, never corrupt the result.
//   - The per-sweep "improved" flag is an OpenMP || reduction.
//   - Dijkstra threads share nothing but read-only CSR arrays and disjoint
//     output rows.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

template <typename T>
inline bool atomic_fetch_min(T *addr, T val) {
  // Lock-free min via CAS on the value's object representation. Returns
  // true iff this call lowered *addr. NaN never occurs (weights are
  // finite or +inf and +inf + finite stays +inf).
  T cur;
  __atomic_load(addr, &cur, __ATOMIC_RELAXED);
  while (val < cur) {
    if (__atomic_compare_exchange(addr, &cur, &val, /*weak=*/true,
                                  __ATOMIC_RELAXED, __ATOMIC_RELAXED))
      return true;
  }
  return false;
}

// One Bellman-Ford relaxation sweep over the COO edge list, parallel over
// edges. Returns whether any distance improved.
template <typename T>
bool relax_sweep(int64_t num_edges, const int32_t *src, const int32_t *dst,
                 const T *w, T *dist) {
  bool improved = false;
#pragma omp parallel for schedule(static) reduction(|| : improved)
  for (int64_t i = 0; i < num_edges; ++i) {
    T du;
    __atomic_load(&dist[src[i]], &du, __ATOMIC_RELAXED);
    if (!std::isfinite(du)) continue;  // inf + w never relaxes anything
    const T cand = du + w[i];
    T dv;
    __atomic_load(&dist[dst[i]], &dv, __ATOMIC_RELAXED);
    if (cand < dv) improved |= atomic_fetch_min(&dist[dst[i]], cand);
  }
  return improved;
}

// Binary-heap Dijkstra from one source on non-negative CSR weights.
// Writes the full distance row (and the predecessor row when `pred` is
// non-null; -1 = source/unreachable); returns edges scanned (the
// edges-relaxed count convention for heap Dijkstra: out-edges of settled
// vertices).
template <typename T>
int64_t dijkstra_row(int32_t num_nodes, const int32_t *indptr,
                     const int32_t *indices, const T *w, int32_t source,
                     T *dist, int32_t *pred = nullptr) {
  const T inf = std::numeric_limits<T>::infinity();
  for (int32_t v = 0; v < num_nodes; ++v) dist[v] = inf;
  dist[source] = T(0);
  if (pred)
    for (int32_t v = 0; v < num_nodes; ++v) pred[v] = -1;

  using Item = std::pair<T, int32_t>;  // (distance, vertex), min-heap
  std::priority_queue<Item, std::vector<Item>, std::greater<Item>> heap;
  heap.emplace(T(0), source);
  int64_t scanned = 0;
  while (!heap.empty()) {
    const auto [d, u] = heap.top();
    heap.pop();
    if (d > dist[u]) continue;  // lazy deletion: stale entry
    for (int32_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      ++scanned;
      const T nd = d + w[e];
      const int32_t v = indices[e];
      if (nd < dist[v]) {
        dist[v] = nd;
        if (pred) pred[v] = u;
        heap.emplace(nd, v);
      }
    }
  }
  return scanned;
}

// Post-fixpoint predecessor extraction for Bellman-Ford: BFS from the
// source over "tight" edges (dist[u] + w == dist[v] — exact: dist[v] was
// stored as that very sum for its winning edge). Every shortest path
// consists of tight edges, so the BFS reaches every finite-distance vertex,
// and first-discovery assignment makes the result a proper tree — a
// parallel per-edge equality scan could instead pick edges of a zero-weight
// cycle and loop path reconstruction. Runs AFTER the sweeps, so it needs no
// racy paired atomics on (dist, pred); CSR order makes it deterministic.
// O(V + E) sequential — noise next to the O(V * E) sweep phase.
template <typename T>
void extract_predecessors(int32_t num_nodes, const int32_t *indptr,
                          const int32_t *indices, const T *w, const T *dist,
                          int32_t source, int32_t *pred) {
  for (int32_t v = 0; v < num_nodes; ++v) pred[v] = -1;
  std::vector<int32_t> queue;
  std::vector<uint8_t> seen(num_nodes, 0);
  queue.reserve(num_nodes);
  queue.push_back(source);
  seen[source] = 1;
  for (size_t qi = 0; qi < queue.size(); ++qi) {
    const int32_t u = queue[qi];
    const T du = dist[u];
    for (int32_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      const int32_t v = indices[e];
      if (seen[v]) continue;
      if (du + w[e] == dist[v]) {
        pred[v] = u;
        seen[v] = 1;
        queue.push_back(v);
      }
    }
  }
}

template <typename T>
int32_t bellman_ford_impl(int32_t num_nodes, int64_t num_edges,
                          const int32_t *src, const int32_t *dst, const T *w,
                          T *dist, int32_t max_iter, int32_t *iterations,
                          int64_t *edges_relaxed) {
  int32_t iters = 0;
  bool improving = num_nodes > 0;
  while (improving && iters < max_iter) {
    improving = relax_sweep(num_edges, src, dst, w, dist);
    ++iters;
  }
  *iterations = iters;
  // Sweep convention (matches every other backend): each sweep scans all E.
  *edges_relaxed = static_cast<int64_t>(iters) * num_edges;
  return improving ? 1 : 0;  // still improving at cap = caller's flag
}

template <typename T>
void dijkstra_fanout_impl(int32_t num_nodes, const int32_t *indptr,
                          const int32_t *indices, const T *w,
                          int32_t num_sources, const int32_t *sources,
                          T *dist_out, int64_t *edges_relaxed,
                          int32_t *pred_out = nullptr) {
  int64_t total = 0;
#pragma omp parallel for schedule(dynamic, 1) reduction(+ : total)
  for (int32_t b = 0; b < num_sources; ++b) {
    const int64_t off = static_cast<int64_t>(b) * num_nodes;
    total += dijkstra_row(num_nodes, indptr, indices, w, sources[b],
                          dist_out + off,
                          pred_out ? pred_out + off : nullptr);
  }
  *edges_relaxed = total;
}

// One graph of the many-small-graphs batch (SURVEY.md §3.4): full Johnson —
// virtual-source Bellman-Ford -> reweight -> per-source heap Dijkstra ->
// un-reweight. Runs serially; the batch loop parallelizes across graphs
// (the reference-shaped thread-pool decomposition: graphs are independent).
// Edges are COO (CSR-ordered by src) with +inf padding; indptr is rebuilt
// locally. Returns 1 on a negative cycle (dist rows left +inf).
template <typename T>
int32_t johnson_one_graph(int32_t v, int64_t e_pad, const int32_t *src,
                          const int32_t *dst, const T *w, int32_t v_max,
                          T *dist_rows, int64_t *edges_relaxed) {
  const T inf = std::numeric_limits<T>::infinity();
  // Trim +inf padding (stacked graphs pad the edge tail).
  int64_t e = e_pad;
  while (e > 0 && !std::isfinite(w[e - 1])) --e;

  // Phase 1: virtual-source Bellman-Ford (dist0 = 0 everywhere).
  std::vector<T> h(v, T(0));
  int32_t iters = 0;
  bool improving = v > 0;
  while (improving && iters < v) {  // v sweeps max: v-1 suffice cycle-free
    improving = false;
    for (int64_t i = 0; i < e; ++i) {
      const T du = h[src[i]];
      if (!std::isfinite(du)) continue;
      const T cand = du + w[i];
      if (cand < h[dst[i]]) {
        h[dst[i]] = cand;
        improving = true;
      }
    }
    ++iters;
  }
  *edges_relaxed += static_cast<int64_t>(iters) * e;
  if (improving) {  // v-th sweep still improved: negative cycle
    for (int64_t i = 0; i < static_cast<int64_t>(v_max) * v_max; ++i)
      dist_rows[i] = inf;  // honor the contract: rows are +inf, not garbage
    return 1;
  }

  // Reweight + rebuild CSR structure (COO is already src-sorted).
  std::vector<T> wp(e);
  std::vector<int32_t> indptr(v + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    T x = w[i] + h[src[i]] - h[dst[i]];
    wp[i] = x < T(0) ? T(0) : x;  // clamp float residue
    ++indptr[src[i] + 1];
  }
  for (int32_t u = 0; u < v; ++u) indptr[u + 1] += indptr[u];

  // Phase 2+3: per-source Dijkstra on w', un-reweighted in place.
  for (int32_t s = 0; s < v; ++s) {
    T *row = dist_rows + static_cast<int64_t>(s) * v_max;
    *edges_relaxed +=
        dijkstra_row(v, indptr.data(), dst, wp.data(), s, row);
    for (int32_t t = 0; t < v; ++t)
      if (std::isfinite(row[t])) row[t] += h[t] - h[s];
    for (int32_t t = v; t < v_max; ++t) row[t] = inf;
  }
  // Padded source rows: unreachable except the 0 diagonal (mirrors the
  // vmapped jax batch kernel; callers slice to the true V anyway).
  for (int32_t s = v; s < v_max; ++s) {
    T *row = dist_rows + static_cast<int64_t>(s) * v_max;
    for (int32_t t = 0; t < v_max; ++t) row[t] = (t == s) ? T(0) : inf;
  }
  return 0;
}

}  // namespace

extern "C" {

int32_t pj_version() { return 1; }

int32_t pj_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// Bellman-Ford over a COO edge list. `dist` is in-out: the caller seeds it
// (all-zero for the Johnson virtual source, +inf except source otherwise).
// Returns 1 if a sweep at the iteration cap was still improving (negative
// cycle when max_iter >= V), else 0.
int32_t pj_bellman_ford_f32(int32_t num_nodes, int64_t num_edges,
                            const int32_t *src, const int32_t *dst,
                            const float *w, float *dist, int32_t max_iter,
                            int32_t *iterations, int64_t *edges_relaxed) {
  return bellman_ford_impl(num_nodes, num_edges, src, dst, w, dist, max_iter,
                           iterations, edges_relaxed);
}

int32_t pj_bellman_ford_f64(int32_t num_nodes, int64_t num_edges,
                            const int32_t *src, const int32_t *dst,
                            const double *w, double *dist, int32_t max_iter,
                            int32_t *iterations, int64_t *edges_relaxed) {
  return bellman_ford_impl(num_nodes, num_edges, src, dst, w, dist, max_iter,
                           iterations, edges_relaxed);
}

// N-source heap-Dijkstra fan-out on non-negative CSR weights, parallel over
// sources. dist_out is [num_sources, num_nodes] row-major.
void pj_dijkstra_fanout_f32(int32_t num_nodes, const int32_t *indptr,
                            const int32_t *indices, const float *w,
                            int32_t num_sources, const int32_t *sources,
                            float *dist_out, int64_t *edges_relaxed) {
  dijkstra_fanout_impl(num_nodes, indptr, indices, w, num_sources, sources,
                       dist_out, edges_relaxed);
}

void pj_dijkstra_fanout_f64(int32_t num_nodes, const int32_t *indptr,
                            const int32_t *indices, const double *w,
                            int32_t num_sources, const int32_t *sources,
                            double *dist_out, int64_t *edges_relaxed) {
  dijkstra_fanout_impl(num_nodes, indptr, indices, w, num_sources, sources,
                       dist_out, edges_relaxed);
}

// Predecessor-tracking fan-out: pred_out is [num_sources, num_nodes]
// row-major, -1 = source/unreachable.
void pj_dijkstra_fanout_pred_f32(int32_t num_nodes, const int32_t *indptr,
                                 const int32_t *indices, const float *w,
                                 int32_t num_sources, const int32_t *sources,
                                 float *dist_out, int32_t *pred_out,
                                 int64_t *edges_relaxed) {
  dijkstra_fanout_impl(num_nodes, indptr, indices, w, num_sources, sources,
                       dist_out, edges_relaxed, pred_out);
}

void pj_dijkstra_fanout_pred_f64(int32_t num_nodes, const int32_t *indptr,
                                 const int32_t *indices, const double *w,
                                 int32_t num_sources, const int32_t *sources,
                                 double *dist_out, int32_t *pred_out,
                                 int64_t *edges_relaxed) {
  dijkstra_fanout_impl(num_nodes, indptr, indices, w, num_sources, sources,
                       dist_out, edges_relaxed, pred_out);
}

// Shortest-path-tree extraction after a converged Bellman-Ford: BFS over
// tight edges of the CSR graph (see extract_predecessors).
void pj_extract_predecessors_f32(int32_t num_nodes, const int32_t *indptr,
                                 const int32_t *indices, const float *w,
                                 const float *dist, int32_t source,
                                 int32_t *pred) {
  extract_predecessors(num_nodes, indptr, indices, w, dist, source, pred);
}

void pj_extract_predecessors_f64(int32_t num_nodes, const int32_t *indptr,
                                 const int32_t *indices, const double *w,
                                 const double *dist, int32_t source,
                                 int32_t *pred) {
  extract_predecessors(num_nodes, indptr, indices, w, dist, source, pred);
}

// Many-small-graphs batch Johnson APSP (BASELINE.json:11), parallel over
// graphs. Inputs are the stacked COO arrays [num_graphs, e_pad] with +inf
// edge padding; dist_out is [num_graphs, v_max, v_max]; num_nodes[g] is the
// true vertex count of graph g; neg_out[g] is set to 1 on a negative cycle.
// Returns total edges relaxed across the batch.
#define PJ_BATCH_JOHNSON(SUFFIX, T)                                          \
  int64_t pj_batch_johnson_##SUFFIX(                                         \
      int32_t num_graphs, int64_t e_pad, const int32_t *num_nodes,           \
      int32_t v_max, const int32_t *src, const int32_t *dst, const T *w,     \
      T *dist_out, int32_t *neg_out) {                                       \
    int64_t total = 0;                                                       \
    _Pragma("omp parallel for schedule(dynamic, 1) reduction(+ : total)")    \
    for (int32_t g = 0; g < num_graphs; ++g) {                               \
      int64_t relaxed = 0;                                                   \
      neg_out[g] = johnson_one_graph(                                        \
          num_nodes[g], e_pad, src + g * e_pad, dst + g * e_pad,             \
          w + g * e_pad,                                                     \
          v_max, dist_out + static_cast<int64_t>(g) * v_max * v_max,         \
          &relaxed);                                                         \
      total += relaxed;                                                      \
    }                                                                        \
    return total;                                                            \
  }

PJ_BATCH_JOHNSON(f32, float)
PJ_BATCH_JOHNSON(f64, double)
#undef PJ_BATCH_JOHNSON

}  // extern "C"
