"""``CppBackend`` — the native CPU/OpenMP execution engine.

The comparison baseline of the card's backend (BASELINE.json:5, the
CPU/OpenMP path): Bellman-Ford as a lock-free atomic-min edge sweep
(parallel over edges) and the fan-out as heap Dijkstra (parallel over
sources), implemented in ``native/pj_native.cpp`` and called through
ctypes. The library is built by ``g++`` the first time a backend is
constructed (``native.load_library``); a failed build raises there with
the compiler's stderr.
"""

from __future__ import annotations

import ctypes

import numpy as np

from paralleljohnson_tpu_torch.backends.base import Backend, KernelResult, register_backend
from paralleljohnson_tpu_torch.graphs import CSRGraph
from paralleljohnson_tpu_torch.native import load_library


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class CppBackend(Backend):
    """Native C++/OpenMP backend (host shared-memory parallelism)."""

    name = "cpp"

    def __init__(self, config=None, device=None) -> None:
        super().__init__(config, device=device)
        self._lib = load_library()

    @property
    def _dtype(self):
        return np.float64 if self.config.precision == "f64" else np.float32

    @property
    def _suffix(self) -> str:
        return "f64" if self.config.precision == "f64" else "f32"

    @property
    def _ctype(self):
        return ctypes.c_double if self.config.precision == "f64" else ctypes.c_float

    def upload(self, graph: CSRGraph) -> CSRGraph:
        # Host backend: "upload" = ensure contiguous arrays of the configured
        # dtype (and materialize the COO src column once, outside the timed
        # kernels). Padding is unnecessary on CPU — use real edges only.
        g = graph.astype(self._dtype)
        g.src  # noqa: B018 — warm the cached COO source column
        return g

    def download_graph(self, dgraph: CSRGraph) -> CSRGraph:
        return dgraph

    def num_threads(self) -> int:
        return int(self._lib.pj_num_threads())

    def bellman_ford(self, dgraph: CSRGraph, source: int | None) -> KernelResult:
        g = dgraph
        v, e = g.num_nodes, g.num_real_edges
        if source is None:
            dist = np.zeros(v, self._dtype)
        else:
            dist = np.full(v, np.inf, self._dtype)
            dist[source] = 0.0
        max_iter = self.config.max_iterations or v
        iters = ctypes.c_int32(0)
        relaxed = ctypes.c_int64(0)
        fn = getattr(self._lib, f"pj_bellman_ford_{self._suffix}")
        improving = fn(
            np.int32(v),
            np.int64(e),
            _ptr(g.src[:e], ctypes.c_int32),
            _ptr(g.indices[:e], ctypes.c_int32),
            _ptr(g.weights[:e], self._ctype),
            _ptr(dist, self._ctype),
            np.int32(max_iter),
            ctypes.byref(iters),
            ctypes.byref(relaxed),
        )
        improving = bool(improving)
        return KernelResult(
            dist=dist,
            negative_cycle=improving and max_iter >= v,
            converged=not improving,
            iterations=int(iters.value),
            edges_relaxed=int(relaxed.value),
        )

    def multi_source(self, dgraph: CSRGraph, sources: np.ndarray) -> KernelResult:
        return self._multi_source(dgraph, sources, with_pred=False)

    def multi_source_pred(self, dgraph: CSRGraph, sources: np.ndarray) -> KernelResult:
        return self._multi_source(dgraph, sources, with_pred=True)

    def _multi_source(
        self, dgraph: CSRGraph, sources: np.ndarray, *, with_pred: bool
    ) -> KernelResult:
        g = dgraph
        if g.has_negative_weights:
            raise ValueError("multi_source requires non-negative weights")
        v = g.num_nodes
        srcs = np.ascontiguousarray(sources, np.int32)
        b = len(srcs)
        dist = np.empty((b, v), self._dtype)
        relaxed = ctypes.c_int64(0)
        if with_pred:
            pred = np.empty((b, v), np.int32)
            fn = getattr(self._lib, f"pj_dijkstra_fanout_pred_{self._suffix}")
            fn(
                np.int32(v),
                _ptr(g.indptr, ctypes.c_int32),
                _ptr(g.indices, ctypes.c_int32),
                _ptr(g.weights, self._ctype),
                np.int32(b),
                _ptr(srcs, ctypes.c_int32),
                _ptr(dist, self._ctype),
                _ptr(pred, ctypes.c_int32),
                ctypes.byref(relaxed),
            )
            return KernelResult(dist=dist, pred=pred,
                                edges_relaxed=int(relaxed.value))
        fn = getattr(self._lib, f"pj_dijkstra_fanout_{self._suffix}")
        fn(
            np.int32(v),
            _ptr(g.indptr, ctypes.c_int32),
            _ptr(g.indices, ctypes.c_int32),
            _ptr(g.weights, self._ctype),
            np.int32(b),
            _ptr(srcs, ctypes.c_int32),
            _ptr(dist, self._ctype),
            ctypes.byref(relaxed),
        )
        return KernelResult(dist=dist, edges_relaxed=int(relaxed.value))

    def batch_apsp(self, batch: dict[str, np.ndarray]) -> KernelResult:
        """Native many-small-graphs Johnson (BASELINE.json:11): OpenMP
        parallel over graphs, serial Johnson per graph (the shared-memory
        thread-pool decomposition — graphs are independent)."""
        src = np.ascontiguousarray(batch["src"], np.int32)
        dst = np.ascontiguousarray(batch["dst"], np.int32)
        w = np.ascontiguousarray(batch["weights"], self._dtype)
        sizes = np.ascontiguousarray(batch["num_nodes"], np.int32)
        g, e_pad = src.shape
        v_max = int(batch["v_max"])
        dist = np.empty((g, v_max, v_max), self._dtype)
        neg = np.zeros(g, np.int32)
        fn = getattr(self._lib, f"pj_batch_johnson_{self._suffix}")
        relaxed = fn(
            np.int32(g),
            np.int64(e_pad),
            _ptr(sizes, ctypes.c_int32),
            np.int32(v_max),
            _ptr(src, ctypes.c_int32),
            _ptr(dst, ctypes.c_int32),
            _ptr(w, self._ctype),
            _ptr(dist, self._ctype),
            _ptr(neg, ctypes.c_int32),
        )
        return KernelResult(
            dist=dist,
            negative_cycle=bool(neg.any()),
            edges_relaxed=int(relaxed),
        )

    def bellman_ford_pred(self, dgraph: CSRGraph, source: int | None) -> KernelResult:
        """SSSP with the shortest-path tree: the converged Bellman-Ford
        distances plus a native tight-edge BFS extraction pass."""
        if source is None:
            raise NotImplementedError(
                "virtual-source Bellman-Ford has no predecessor tree"
            )
        res = self.bellman_ford(dgraph, source)
        if res.negative_cycle or not res.converged:
            return res
        g = dgraph
        pred = np.empty(g.num_nodes, np.int32)
        dist = np.ascontiguousarray(res.dist, self._dtype)
        fn = getattr(self._lib, f"pj_extract_predecessors_{self._suffix}")
        fn(
            np.int32(g.num_nodes),
            _ptr(g.indptr, ctypes.c_int32),
            _ptr(g.indices, ctypes.c_int32),
            _ptr(g.weights, self._ctype),
            _ptr(dist, self._ctype),
            np.int32(source),
            _ptr(pred, ctypes.c_int32),
        )
        res.pred = pred
        return res


register_backend("cpp", CppBackend)
