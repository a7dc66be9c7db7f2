"""Benchmark harness of the PyTorch port: the JAX package's bench
configs whose modules are ported (BASELINE.json:6-12 and the companion
rows), run through ``paralleljohnson_tpu_torch`` on the card.

Each config is a callable returning a :class:`BenchRecord`; the harness
times the solve, folds in the edges-relaxed counters
(BASELINE.json:2 "edges-relaxed/sec/chip"), and emits one JSON line per
run (``scripts/torch_bench.py`` prints them). ``update_baseline_md``
rewrites the measured-numbers table of a BASELINE.md.

Every timed window ends where the solve reads the host: the sanity
guard reads each fan-out batch's rows, ``solve_reduced`` downloads its
checksums, and ``batch_small``, whose [count, V, V] block stays on the
card, ends in ``torch.cuda.synchronize()``.

Dataset stand-ins (the public files are not in the repository): the
DIMACS-NY road graph -> a ``grid2d`` lattice with matching node
count/diameter profile and safe negative weights; SNAP ego-Facebook ->
an R-MAT scale-12 power-law graph with matching node/edge counts. Swap
in the real files via ``dimacs:<path>`` / ``snap:<path>`` specs when
present.

Presets scale every config: ``smoke`` (CI, seconds), ``mini``
(single-card sanity), ``full`` (the attested benchmark sizes). Rows
report the platform of the backend that solved (``cuda`` or ``cpu``) and,
on ``cuda``, the card's name and power limit. ``serve_fleet``'s replicas
are ``python -m paralleljohnson_tpu_torch serve`` processes.
"""

from __future__ import annotations

import contextvars
import dataclasses
import json
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from paralleljohnson_tpu_torch.observe import card_info, current_platform
from paralleljohnson_tpu_torch.solver.johnson import to_numpy as _host
from paralleljohnson_tpu_torch.utils.reductions import finite_frac as _finite_frac

# Per-config telemetry for a bench pass (``run(..., telemetry_dir=...)``):
# a contextvar because the config callables build their own solvers via
# ``_solver`` — the pass sets it around each config so every solver the
# config constructs records into that config's flight file.
_BENCH_TELEMETRY: contextvars.ContextVar = contextvars.ContextVar(
    "pj_bench_telemetry", default=None
)

# Profile store for a bench pass (``run(..., profile_dir=...)``): same
# contextvar pattern — every solver a config builds appends its profile
# records there, so a bench pass leaves the calibration behind.
_BENCH_PROFILE: contextvars.ContextVar = contextvars.ContextVar(
    "pj_bench_profile", default=None
)

# The device every torch solver of a bench pass runs on.
_BENCH_DEVICE: contextvars.ContextVar = contextvars.ContextVar(
    "pj_bench_device", default="cuda"
)


@dataclasses.dataclass
class BenchRecord:
    config: str
    backend: str
    preset: str
    wall_s: float
    edges_relaxed: int
    edges_relaxed_per_sec: float
    n_chips: int
    detail: dict

    def as_json_line(self) -> str:
        d = dataclasses.asdict(self)
        d["edges_relaxed_per_sec_per_chip"] = (
            self.edges_relaxed_per_sec / max(self.n_chips, 1)
        )
        return json.dumps(d)


# -- sizing tables -----------------------------------------------------------

_PRESETS = ("smoke", "mini", "full")

# The JAX package's sizes, unchanged.
_SIZES = {
    #                 smoke            mini              full (attested)
    "er1k_apsp":     dict(n=64,        mini_n=256,       full_n=1000),
    "dimacs_ny_bf":  dict(rows=24,     mini_rows=96,     full_rows=515),
    "dimacs_ny_scrambled": dict(rows=24, mini_rows=96,   full_rows=515),
    "dimacs_ny_scrambled_pred": dict(rows=24, mini_rows=96, full_rows=515),
    "ego_fb_nsource": dict(scale=8,    mini_scale=10,    full_scale=12,
                          sources=16,  mini_sources=64,  full_sources=512),
    "rmat_apsp":     dict(scale=8,     mini_scale=12,    full_scale=20,
                          sources=8,   mini_sources=32,  full_sources=128),
    "rmat_apsp_pipelined": dict(scale=8, mini_scale=12,  full_scale=20,
                          sources=32,  mini_sources=64,  full_sources=128),
    "batch_small":   dict(count=32,    mini_count=512,   full_count=10000),
    "dense_apsp_fw": dict(n=96,        mini_n=384,       full_n=2048),
    "dirty_window": dict(rows=24,      mini_rows=48,     full_rows=96,
                          sources=2,   mini_sources=4,   full_sources=4,
                          rscale=8,    mini_rscale=9,    full_rscale=12),
    "planner_dispatch": dict(rows=16,  mini_rows=32,     full_rows=96,
                          rscale=7,    mini_rscale=9,    full_rscale=12,
                          dense_n=64,  mini_dense_n=128, full_dense_n=256,
                          sources=4,   mini_sources=4,   full_sources=8),
    # mini/full sit past the 512 seed tile so the pad-to-V challenger
    # wins a single-block FW pass vs the seed's 2x2 blocked sweep;
    # smoke stays below it and demonstrates the no-promotion-within-band
    # rule instead.
    "planner_tuning": dict(n=256,      mini_n=576,       full_n=640,
                          probe_s=30.0, mini_probe_s=45.0,
                          full_probe_s=90.0,
                          bucket_s=120.0, mini_bucket_s=180.0,
                          full_bucket_s=360.0),
    "distributed_fleet": dict(n=96,    mini_n=1024,      full_n=4096,
                          workers=2,   mini_workers=3,   full_workers=4),
    "serve_queries": dict(n=256,       mini_n=1024,      full_n=4096,
                          queries=200, mini_queries=2000, full_queries=20000,
                          clients=16,  mini_clients=16,  full_clients=32),
    "serve_overload": dict(rows=12,    mini_rows=20,     full_rows=40,
                          clients=4,   mini_clients=6,   full_clients=8,
                          overload_s=2.5, mini_overload_s=4.0,
                          full_overload_s=6.0,
                          cooldown_s=3.5, mini_cooldown_s=5.0,
                          full_cooldown_s=6.0),
    "serve_fleet":   dict(rows=10,     mini_rows=14,     full_rows=24,
                          clients=3,   mini_clients=4,   full_clients=6,
                          duration_s=2.5, mini_duration_s=4.0,
                          full_duration_s=8.0),
    "distributed_fleet": dict(n=96,    mini_n=1024,      full_n=4096,
                          workers=2,   mini_workers=3,   full_workers=4),
    "incremental_update": dict(n=96,   mini_n=1024,      full_n=4096,
                          k=2,         mini_k=6,         full_k=12),
    "approx_apsp":   dict(n=256,       mini_n=4096,      full_n=16384,
                          sources=32,  mini_sources=128, full_sources=256),
}

def _sz(config: str, key: str, preset: str):
    table = _SIZES[config]
    if preset == "smoke":
        return table[key]
    return table[f"{preset}_{key}"]


def _n_chips() -> int:
    """Devices one solve of the port uses: one card (or the host)."""
    return 1


def _platform(backend: str) -> str:
    """``cuda`` or ``cpu``: where the backend that solved ran."""
    return current_platform(_BENCH_DEVICE.get()) if backend == "torch" else "cpu"


def _solver(backend: str, **cfg_overrides):
    from paralleljohnson_tpu_torch.config import SolverConfig
    from paralleljohnson_tpu_torch.solver import ParallelJohnsonSolver

    cfg_overrides.setdefault("telemetry", _BENCH_TELEMETRY.get())
    cfg_overrides.setdefault("profile_store", _BENCH_PROFILE.get())
    return ParallelJohnsonSolver(SolverConfig(backend=backend, **cfg_overrides),
                                 device=_BENCH_DEVICE.get())


def _routes(res) -> dict:
    """Compact resolved-kernel-route tag for a bench row's detail (e.g.
    ``"bellman_ford:frontier,fanout:pallas-vm"``) — keeps before/after
    kernel comparisons reconstructable across measurement runs. Empty
    for backends that don't report routes.
    Also folds in the resilience counters when any recovery actually
    fired (retries / OOM batch degradations / watchdog abandons), so a
    row measured through a degraded path is identifiable as such — a
    clean-looking wall-clock from a solve that silently halved its batch
    twice is NOT a measurement of the intended configuration."""
    out = {}
    routes = getattr(res.stats, "routes_by_phase", None)
    if routes:
        out["route"] = ",".join(f"{k}:{v}" for k, v in sorted(routes.items()))
    s = res.stats
    if getattr(s, "retries", 0):
        out["retries"] = s.retries
    if getattr(s, "oom_degradations", 0):
        out["oom_degradations"] = s.oom_degradations
        out["final_batch"] = s.final_batch
    if getattr(s, "abandoned_stages", None):
        out["abandoned_stages"] = list(s.abandoned_stages)
    # Pipeline overlap accounting: a row that claims a wall-
    # clock win must be attributable to overlap (overlap_saved_s > 0
    # with the download/ckpt costs it hid), not to noise.
    for key in ("download_s", "ckpt_wait_s", "overlap_saved_s"):
        val = float(getattr(s, key, 0.0) or 0.0)
        if val:
            out[key] = round(val, 4)
    # The roofline bound and the analytic totals ride in the row detail,
    # so a regression flag on this row arrives pre-attributed
    # (bench_regress reads exactly these keys).
    roof = getattr(s, "roofline", None)
    if roof and roof.get("bound") and roof["bound"] != "unknown":
        out["roofline_bound"] = roof["bound"]
    cost = getattr(s, "analytic_cost", None)
    if cost and cost.get("captures"):
        out["analytic_flops"] = round(float(cost["flops"]), 1)
        out["analytic_bytes"] = round(float(cost["bytes_accessed"]), 1)
    if getattr(s, "predicted_s", None) is not None:
        out["predicted_s"] = round(float(s.predicted_s), 6)
    # Convergence summary: total iterations ride
    # at top level — bench_regress grades them like walls (a route
    # silently converging slower is a perf bug even when wall noise
    # hides it) — with the trajectory shape numbers beside them.
    conv = getattr(s, "convergence", None)
    if conv:
        out["iterations"] = sum(
            int(c.get("iterations", 0)) for c in conv.values()
        )
        out["convergence"] = {
            phase: {
                "iterations": c.get("iterations"),
                "frontier_half_life": c.get("frontier_half_life"),
                "tail_fraction": round(
                    float(c.get("tail_fraction", 0.0)), 4
                ),
                "jfr_skippable_edge_frac": round(
                    float(c.get("jfr_skippable_edge_frac", 0.0)), 4
                ),
            }
            for phase, c in conv.items()
        }
    return out


# -- the five configs --------------------------------------------------------


def bench_er1k_apsp(backend: str, preset: str) -> BenchRecord:
    """Config 1 (BASELINE.json:7): Johnson APSP on an ER graph
    (full: 1k nodes, p=0.01) — the correctness-scale reference config."""
    from paralleljohnson_tpu_torch.graphs import erdos_renyi

    n = _sz("er1k_apsp", "n", preset)
    g = erdos_renyi(n, 0.01 if n >= 256 else 0.1, seed=42)
    solver = _solver(backend)
    solver.solve(g)  # warm compile caches
    t0 = time.perf_counter()
    res = solver.solve(g)
    wall = time.perf_counter() - t0
    return BenchRecord(
        "er1k_apsp", backend, preset, wall,
        res.stats.edges_relaxed, res.stats.edges_relaxed / wall, _n_chips(),
        {"nodes": g.num_nodes, "edges": g.num_real_edges,
         "finite_frac": _finite_frac(res.dist), **_routes(res)},
    )


def bench_dimacs_ny_bf(backend: str, preset: str) -> BenchRecord:
    """Config 2 (BASELINE.json:8): standalone Bellman-Ford SSSP on a
    negative-weight road graph (high-diameter sweep stress). Stand-in:
    ``grid2d`` lattice (see module docstring)."""
    from paralleljohnson_tpu_torch.graphs import grid2d

    rows = _sz("dimacs_ny_bf", "rows", preset)
    g = grid2d(rows, rows, negative_fraction=0.2, seed=7)
    solver = _solver(backend)
    solver.sssp(g, 0)  # warm
    t0 = time.perf_counter()
    res = solver.sssp(g, 0)
    wall = time.perf_counter() - t0
    return BenchRecord(
        "dimacs_ny_bf", backend, preset, wall,
        res.stats.edges_relaxed, res.stats.edges_relaxed / wall, _n_chips(),
        {"nodes": g.num_nodes, "edges": g.num_real_edges,
         "sweeps": res.stats.iterations_by_phase.get("bellman_ford", 0),
         "reached_frac": _finite_frac(res.dist), **_routes(res)},
    )


def bench_dimacs_ny_scrambled(backend: str, preset: str) -> BenchRecord:
    """Config 2b: the SAME road-graph SSSP as
    ``dimacs_ny_bf`` but with the vertex labels uniformly permuted —
    the honest proxy for the real DIMACS file, whose labeling is not a
    lattice order. The natural row-major grid labeling qualifies the
    DIA stencil route; a real file's does not, so THIS row is what the
    attested config would actually measure: auto must decline DIA here
    and serve the solve through the irregular-labeling routes
    (``frontier`` in the port on every device)."""
    from paralleljohnson_tpu_torch.graphs import grid2d, permute_labels

    rows = _sz("dimacs_ny_scrambled", "rows", preset)
    g = permute_labels(
        grid2d(rows, rows, negative_fraction=0.2, seed=7), seed=11
    )
    solver = _solver(backend)
    solver.sssp(g, 0)  # warm
    t0 = time.perf_counter()
    res = solver.sssp(g, 0)
    wall = time.perf_counter() - t0
    return BenchRecord(
        "dimacs_ny_scrambled", backend, preset, wall,
        res.stats.edges_relaxed, res.stats.edges_relaxed / wall, _n_chips(),
        {"nodes": g.num_nodes, "edges": g.num_real_edges,
         "sweeps": res.stats.iterations_by_phase.get("bellman_ford", 0),
         "reached_frac": _finite_frac(res.dist), **_routes(res)},
    )


def bench_dimacs_ny_scrambled_pred(backend: str, preset: str) -> BenchRecord:
    """Config 2c: the scrambled road-graph SSSP with ``--predecessors``.
    Times the tight-edge extraction route (the ``tight_pred`` kernel on
    the card) AND (torch only) the legacy argmin sweep on the same graph,
    so BENCH/BASELINE record the pred-route speedup and the exact
    edges-examined ratio (extraction adds one O(E) pass; the sweep pays
    iterations x E)."""
    from paralleljohnson_tpu_torch.graphs import grid2d, permute_labels

    rows = _sz("dimacs_ny_scrambled_pred", "rows", preset)
    g = permute_labels(
        grid2d(rows, rows, negative_fraction=0.2, seed=7), seed=11
    )
    solver = _solver(backend)
    solver.sssp(g, 0, predecessors=True)  # warm
    t0 = time.perf_counter()
    res = solver.sssp(g, 0, predecessors=True)
    wall = time.perf_counter() - t0
    detail = {
        "nodes": g.num_nodes, "edges": g.num_real_edges,
        "reached_frac": _finite_frac(res.dist), **_routes(res),
    }
    if backend == "torch":
        legacy = _solver(backend, pred_extraction=False)
        legacy.sssp(g, 0, predecessors=True)  # warm
        t0 = time.perf_counter()
        lres = legacy.sssp(g, 0, predecessors=True)
        detail["legacy_sweep_wall_s"] = round(time.perf_counter() - t0, 6)
        detail["legacy_sweep_edges_relaxed"] = lres.stats.edges_relaxed
        detail["pred_route_speedup"] = round(
            detail["legacy_sweep_wall_s"] / max(wall, 1e-9), 3
        )
    return BenchRecord(
        "dimacs_ny_scrambled_pred", backend, preset, wall,
        res.stats.edges_relaxed, res.stats.edges_relaxed / wall, _n_chips(),
        detail,
    )


def bench_ego_fb_nsource(backend: str, preset: str) -> BenchRecord:
    """Config 3 (BASELINE.json:9): batched N-source fan-out on a
    non-negative power-law graph (ego-Facebook profile). Stand-in: R-MAT
    (see module docstring)."""
    from paralleljohnson_tpu_torch.graphs import rmat

    scale = _sz("ego_fb_nsource", "scale", preset)
    n_sources = _sz("ego_fb_nsource", "sources", preset)
    g = rmat(scale, 16, seed=3)
    rng = np.random.default_rng(0)
    sources = np.sort(rng.choice(g.num_nodes, size=min(n_sources, g.num_nodes),
                                 replace=False))
    solver = _solver(backend)
    solver.multi_source(g, sources)  # warm
    t0 = time.perf_counter()
    res = solver.multi_source(g, sources)
    wall = time.perf_counter() - t0
    return BenchRecord(
        "ego_fb_nsource", backend, preset, wall,
        res.stats.edges_relaxed, res.stats.edges_relaxed / wall, _n_chips(),
        {"nodes": g.num_nodes, "edges": g.num_real_edges,
         "sources": len(sources), **_routes(res)},
    )


def bench_rmat_apsp(backend: str, preset: str) -> BenchRecord:
    """Config 4 (BASELINE.json:10): Johnson APSP on R-MAT (full: scale 20;
    scale 22 via PJ_BENCH_RMAT_SCALE). The full distance matrix is not
    materializable at scale 22 (~70 TB, SURVEY.md §7); per the attested
    metric the harness solves a source subset and reduces rows to a
    checksum — rows stream through, never accumulate."""
    import os

    from paralleljohnson_tpu_torch.graphs import rmat

    default_scale = _sz("rmat_apsp", "scale", preset)
    scale = int(os.environ.get("PJ_BENCH_RMAT_SCALE", 0)) or default_scale
    # A non-default scale gets its own row name so e.g. the RMAT-22 run
    # never overwrites the scale-20 row in BASELINE.md (rows merge by
    # (config, backend, preset)).
    name = "rmat_apsp" if scale == default_scale else f"rmat_apsp_s{scale}"
    n_sources = _sz("rmat_apsp", "sources", preset)
    g = rmat(scale, 16, seed=42)
    rng = np.random.default_rng(1)
    sources = np.sort(rng.choice(g.num_nodes, size=n_sources, replace=False))
    solver = _solver(backend)
    small = sources[: max(2, n_sources // 8)]
    solver.solve_reduced(g, sources=small, reduce_rows="checksum")  # warm
    t0 = time.perf_counter()
    res = solver.solve_reduced(g, sources=sources, reduce_rows="checksum")
    wall = time.perf_counter() - t0
    checksum = float(sum(res.values))
    return BenchRecord(
        name, backend, preset, wall,
        res.stats.edges_relaxed, res.stats.edges_relaxed / wall, _n_chips(),
        {"scale": scale, "nodes": g.num_nodes, "edges": g.num_real_edges,
         "sources": n_sources, "rows_checksum": checksum, **_routes(res)},
    )


def bench_rmat_apsp_pipelined(backend: str, preset: str) -> BenchRecord:
    """Config 4b: the rmat fan-out as a MULTI-batch
    checkpointed solve, measured serial (``pipeline_depth=1``) vs
    double-buffered (``pipeline_depth=2``) on the same graph — so
    BENCH/BASELINE can attribute any s22-class improvement to
    compute/transfer/IO overlap rather than noise. The timed row is the
    pipelined run; the detail column records the serial wall, the
    speedup, and the overlap accounting (``overlap_saved_s`` > 0 is the
    proof the win came from the pipeline). Rows are cross-checked
    bitwise between the two runs — a pipelined result that drifted is a
    bug, not a measurement."""
    import tempfile

    from paralleljohnson_tpu_torch.graphs import rmat

    scale = _sz("rmat_apsp_pipelined", "scale", preset)
    n_sources = _sz("rmat_apsp_pipelined", "sources", preset)
    g = rmat(scale, 16, seed=42)
    rng = np.random.default_rng(1)
    sources = np.sort(
        rng.choice(g.num_nodes, size=min(n_sources, g.num_nodes),
                   replace=False)
    )
    bs = max(1, len(sources) // 4)  # >= 4 batches: the window needs work
    # Warm WITHOUT a checkpoint dir: a warmed checkpoint would let the
    # timed runs resume instead of computing.
    _solver(backend, source_batch_size=bs).multi_source(g, sources)
    with tempfile.TemporaryDirectory() as d_serial, \
            tempfile.TemporaryDirectory() as d_pipe:
        serial = _solver(backend, source_batch_size=bs, pipeline_depth=1,
                         checkpoint_dir=d_serial)
        t0 = time.perf_counter()
        sres = serial.multi_source(g, sources)
        serial_wall = time.perf_counter() - t0
        pipe = _solver(backend, source_batch_size=bs, pipeline_depth=2,
                       checkpoint_dir=d_pipe)
        t0 = time.perf_counter()
        res = pipe.multi_source(g, sources)
        wall = time.perf_counter() - t0
    detail = {
        "scale": scale, "nodes": g.num_nodes, "edges": g.num_real_edges,
        "sources": len(sources), "source_batch": bs,
        "serial_wall_s": round(serial_wall, 6),
        "pipeline_speedup": round(serial_wall / max(wall, 1e-9), 3),
        **_routes(res),
    }
    if not np.array_equal(_host(sres.dist), _host(res.dist)):
        detail["failed"] = "pipelined rows != serial rows"
    return BenchRecord(
        "rmat_apsp_pipelined", backend, preset, wall,
        res.stats.edges_relaxed, res.stats.edges_relaxed / wall, _n_chips(),
        detail,
    )


def bench_batch_small(backend: str, preset: str) -> BenchRecord:
    """Config 5 (BASELINE.json:11): many-small-graphs APSP (full: 10k
    random 256-node graphs; the torch backend's ``batch_apsp``, one
    fan-out over the batch's disjoint union)."""
    from paralleljohnson_tpu_torch.graphs import random_graph_batch

    count = _sz("batch_small", "count", preset)
    nodes = 64 if preset == "smoke" else 256
    graphs = random_graph_batch(count, nodes, 8.0 / nodes, seed=0)
    solver = _solver(backend)
    try:
        # Time the batch kernel itself, with results left where the
        # backend computed them (the [count, V, V] block is ~2.6 GB at
        # the full preset — downloading it is not part of the solve).
        # The block stays on the card, so the window ends in a
        # synchronize.
        from paralleljohnson_tpu_torch.graphs import stack_graphs

        batch = stack_graphs(graphs)
        if backend == "torch":
            # Full-shape warm: the first call builds the kernels and
            # grows the caching allocator to the full block. Host
            # backends have nothing to warm — a full warm would just
            # double the (minutes-long at the full preset) run.
            solver.backend.batch_apsp(batch)
        else:
            solver.backend.batch_apsp(stack_graphs(graphs[: max(2, count // 16)]))
        t0 = time.perf_counter()
        res = solver.backend.batch_apsp(batch)
        if isinstance(res.dist, torch.Tensor) and res.dist.is_cuda:
            torch.cuda.synchronize(res.dist.device)
        wall = time.perf_counter() - t0
        edges = res.edges_relaxed
    except NotImplementedError:
        # Backends without a vectorized path: time the per-graph fallback.
        solver.solve_batch(graphs[: max(2, count // 16)])  # warm
        t0 = time.perf_counter()
        results = solver.solve_batch(graphs)
        wall = time.perf_counter() - t0
        # The per-graph fallback gives each result its own stats object;
        # sum over distinct objects to report the whole batch.
        edges = sum(
            s.edges_relaxed
            for s in {id(r.stats): r.stats for r in results}.values()
        )
    return BenchRecord(
        "batch_small", backend, preset, wall,
        edges, edges / wall, _n_chips(),
        {"graphs": count, "nodes_each": nodes},
    )


def bench_dense_apsp_fw(backend: str, preset: str) -> BenchRecord:
    """Config 7: dense full APSP via the blocked
    min-plus Floyd-Warshall route (``ops.fw``, route ``fw``/``fw-tile``)
    vs the min-plus squaring route on the SAME graph — the B=V workload
    the repo is named for, on the min-plus and Kleene kernels. The
    graph's weights are small integers so every f32 path sum is exact:
    the two routes are checked BITWISE, not allclose — a blocked
    schedule that dropped a k-phase would be caught, not tolerated. The
    timed row is the FW run; detail records the squaring wall, the
    speedup, and the exact tropical-MAC ratio (~log2 V by construction,
    both counters on the same padded scale), plus the roofline bound
    and analytic FLOPs via the shared ``_routes`` folding."""
    from paralleljohnson_tpu_torch.graphs import erdos_renyi

    n = _sz("dense_apsp_fw", "n", preset)
    g = erdos_renyi(n, 0.1, seed=21)
    rng = np.random.default_rng(22)
    g = g.with_weights(
        rng.integers(1, 10, g.num_real_edges).astype(np.float32)
    )
    fw_solver = _solver(backend, fw=True, mesh_shape=(1,))
    fw_solver.solve(g)  # warm compile caches
    t0 = time.perf_counter()
    res = fw_solver.solve(g)
    wall = time.perf_counter() - t0
    sq_solver = _solver(backend, fw=False, dense_threshold=n,
                        dense_min_density=0, mesh_shape=(1,))
    sq_solver.solve(g)  # warm
    t0 = time.perf_counter()
    sres = sq_solver.solve(g)
    sq_wall = time.perf_counter() - t0
    detail = {
        "nodes": g.num_nodes, "edges": g.num_real_edges,
        "squaring_wall_s": round(sq_wall, 6),
        "fw_speedup": round(sq_wall / max(wall, 1e-9), 3),
        "squaring_edges_relaxed": sres.stats.edges_relaxed,
        "work_ratio_sq_over_fw": round(
            sres.stats.edges_relaxed / max(res.stats.edges_relaxed, 1), 3
        ),
        **_routes(res),
    }
    if not np.array_equal(res.matrix, sres.matrix):
        detail["failed"] = "blocked-FW rows != squaring rows (bitwise)"
    return BenchRecord(
        "dense_apsp_fw", backend, preset, wall,
        res.stats.edges_relaxed, res.stats.edges_relaxed / wall, _n_chips(),
        detail,
    )


def bench_planner_dispatch(backend: str, preset: str) -> BenchRecord:
    """Config 13: does the priced planner pick the
    measured-fastest qualified route? Three contrasting graphs —
    scrambled road grid (irregular low-degree sweep territory), R-MAT
    power-law (hub-heavy sweep territory), and a dense small-V graph
    (dense/FW territory). Per graph:

    1. every candidate plan is FORCED via its registry
       ``force_overrides`` and measured on the same sources, its solve
       + plan records landing in a fresh throwaway profile store (the
       calibration the planner will price from);
    2. the auto planner then dispatches the same solve; the row's
       detail records the pick, the measured-fastest auto-qualified
       plan, whether the pick is the fastest or within the planner's
       noise band of it (the acceptance criterion), and that the
       planner solve's distances are BITWISE-identical to the forced
       run of the same plan (registry dispatch never changes a
       route's arithmetic).

    On the torch backend the sparse graphs also force-measure
    ``pallas-vm``, the port's default sparse route (the hand sweep), so
    the auto pick is graded against a measured run of itself. Host
    backends have no planner registry; their row records the plain
    solve with an explicit marker."""
    import tempfile

    from paralleljohnson_tpu_torch.graphs import (
        erdos_renyi,
        grid2d,
        permute_labels,
        rmat,
    )

    rows = _sz("planner_dispatch", "rows", preset)
    rscale = _sz("planner_dispatch", "rscale", preset)
    dense_n = _sz("planner_dispatch", "dense_n", preset)
    n_sources = _sz("planner_dispatch", "sources", preset)

    grid = permute_labels(
        grid2d(rows, rows, negative_fraction=0.0, seed=7), seed=11
    )
    power = rmat(rscale, edge_factor=8, seed=5)
    dense = erdos_renyi(dense_n, 0.5, seed=3)
    # smoke keeps the candidate sets lean (every forced plan pays its
    # compiles — the CI suite-budget); mini/full measure the full
    # contrast set including the dw and GS schedules.
    grid_plans = (
        ["vm", "sweep-sm"] if preset == "smoke"
        else ["vm", "sweep-sm", "vm-blocked+dw", "gs"]
    )
    workloads = [
        # (name, graph, batch, candidate plan names to force-measure)
        ("scrambled_grid", grid, n_sources, grid_plans),
        ("rmat", power, n_sources, ["vm", "sweep-sm"]),
        ("dense_small_v", dense, dense.num_nodes, ["dense", "fw"]),
    ]

    if backend == "torch":
        workloads = [
            (name, g, b, ["pallas-vm", *plans] if name != "dense_small_v"
             else plans)
            for name, g, b, plans in workloads
        ]
    else:
        t0 = time.perf_counter()
        res = _solver(backend).multi_source(
            grid, np.arange(n_sources, dtype=np.int64)
        )
        wall = time.perf_counter() - t0
        return BenchRecord(
            "planner_dispatch", backend, preset, wall,
            res.stats.edges_relaxed, res.stats.edges_relaxed / wall,
            _n_chips(),
            {"skipped": "planner registry is torch-only; plain solve "
                        "recorded", **_routes(res)},
        )

    from paralleljohnson_tpu_torch.backends.torch_backend import FANOUT_PLANS
    from paralleljohnson_tpu_torch.planner import PLANNER_NOISE_BAND

    plan_by_name = {p.name: p for p in FANOUT_PLANS}
    per_graph = {}
    total_wall = 0.0
    total_edges = 0
    headline_res = None
    for name, g, b, candidates in workloads:
        store = tempfile.mkdtemp(prefix=f"pj_planner_{name}_")
        sources = np.arange(min(b, g.num_nodes), dtype=np.int64)
        measured, dists, skipped = {}, {}, {}
        for plan_name in candidates:
            plan = plan_by_name[plan_name]
            overrides = dict(plan.force_overrides)
            try:
                forced = _solver(
                    backend, profile_store=store, planner=False,
                    **overrides,
                )
                forced.multi_source(g, sources)  # warm compiles
                t0 = time.perf_counter()
                fres = forced.multi_source(g, sources)
                dt = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 — a declined plan is data
                skipped[plan_name] = f"{type(e).__name__}: {e}"
                continue
            measured[plan_name] = {
                "route": fres.stats.routes_by_phase.get("fanout"),
                "wall_ms": round(dt * 1e3, 3),
                "wall_s": dt,
            }
            dists[plan_name] = _host(fres.dist)
        # All plans solve the same problem: any pairwise disagreement
        # beyond float-order noise is a dispatch bug, not noise.
        names = sorted(dists)
        agree = all(
            np.allclose(dists[names[0]], dists[m],
                        rtol=1e-5, atol=1e-5, equal_nan=True)
            for m in names[1:]
        )
        auto = _solver(backend, profile_store=store)
        auto.multi_source(g, sources)  # warm (also lands records)
        t0 = time.perf_counter()
        res = auto.multi_source(g, sources)
        dt = time.perf_counter() - t0
        plan_info = (res.stats.plans_by_phase.get("fanout")
                     or res.stats.plan or {})
        pick = plan_info.get("built") or plan_info.get("chosen")
        qualified = [
            c["plan"] for c in plan_info.get("candidates", [])
            if c.get("qualified")
        ]
        contest = {
            k: v["wall_s"] for k, v in measured.items() if k in qualified
        }
        fastest = min(contest, key=contest.get) if contest else None
        within = (
            contest[pick] <= contest[fastest] * (1.0 + PLANNER_NOISE_BAND)
            if pick in contest and fastest is not None else None
        )
        bitwise = (
            bool(np.array_equal(_host(res.dist), dists[pick],
                                equal_nan=True))
            if pick in dists else None
        )
        per_graph[name] = {
            "nodes": g.num_nodes,
            "edges": g.num_real_edges,
            "batch": int(len(sources)),
            "measured": {
                k: {kk: vv for kk, vv in v.items() if kk != "wall_s"}
                for k, v in measured.items()
            },
            "skipped": skipped,
            "pick": pick,
            "reason": plan_info.get("reason"),
            "qualified": qualified,
            "fastest_qualified": fastest,
            "pick_within_band": within,
            "pick_bitwise_vs_forced": bitwise,
            "routes_agree": bool(agree),
            "planner_wall_ms": round(dt * 1e3, 3),
        }
        total_wall += dt
        total_edges += res.stats.edges_relaxed
        headline_res = res
    verdict = {
        "all_within_band": all(
            v["pick_within_band"] in (True, None)
            for v in per_graph.values()
        ),
        "all_bitwise": all(
            v["pick_bitwise_vs_forced"] in (True, None)
            for v in per_graph.values()
        ),
        "all_routes_agree": all(
            v["routes_agree"] for v in per_graph.values()
        ),
    }
    return BenchRecord(
        "planner_dispatch", backend, preset, total_wall,
        total_edges, total_edges / max(total_wall, 1e-9), _n_chips(),
        {"noise_band": PLANNER_NOISE_BAND, **verdict,
         "graphs": per_graph, **_routes(headline_res)},
    )


def bench_planner_tuning(backend: str, preset: str) -> BenchRecord:
    """Config 17: the self-proposing planner's
    propose → probe-under-budget → promote → dispatch loop, measured on
    one dense graph (FW territory) with the ``fw_tile`` knob. Two
    phases, graded in-bench (violations land in ``detail.failed``):

    - **zero budget**: ``tune_bucket`` with ``bucket_budget_s=0`` must
      touch nothing — the store stays empty and the auto dispatch is
      BITWISE-identical to today's store-less dispatch (the acceptance
      criterion that a disabled tuner changes no behavior);
    - **budgeted**: the tuner probes the hand-tuned seed tile against
      the pad-to-V tile under a hard per-probe wall cap, promotes the
      winner only past the planner's 25% noise band, and the next auto
      dispatch resolves the promoted value — verified bitwise against
      a run with that tile forced, with ``provenance_table`` reporting
      the knob as tuner-backed.

    Host backends have no tuner registry; their row records the plain
    solve with an explicit marker."""
    import tempfile

    from paralleljohnson_tpu_torch.graphs import erdos_renyi

    n = _sz("planner_tuning", "n", preset)
    probe_s = _sz("planner_tuning", "probe_s", preset)
    bucket_s = _sz("planner_tuning", "bucket_s", preset)
    g = erdos_renyi(n, 0.3, seed=3)

    if backend != "torch":
        t0 = time.perf_counter()
        res = _solver(backend).solve(g)
        wall = time.perf_counter() - t0
        return BenchRecord(
            "planner_tuning", backend, preset, wall,
            res.stats.edges_relaxed, res.stats.edges_relaxed / wall,
            _n_chips(),
            {"skipped": "tuner registry is torch-only; plain solve "
                        "recorded", **_routes(res)},
        )

    from paralleljohnson_tpu_torch.config import SolverConfig
    from paralleljohnson_tpu_torch.observe.tuning import (
        DEFAULT_FW_TILE,
        TUNE_NOISE_BAND,
        resolve_param,
    )
    from paralleljohnson_tpu_torch.tuner import provenance_table, tune_bucket

    device = _BENCH_DEVICE.get()
    pad = ((n + 127) // 128) * 128
    candidates = {"fw_tile": sorted({DEFAULT_FW_TILE, pad})}
    failed = []
    fw_cfg = dict(fw=True, mesh_shape=(1,))

    # Phase A — zero tuning budget must be a perfect no-op.
    store_a = tempfile.mkdtemp(prefix="pj_tune_zero_")
    summary_a = tune_bucket(
        g, store_dir=store_a, config=SolverConfig(backend=backend),
        knobs=["fw_tile"], candidates=candidates,
        probe_budget_s=probe_s, bucket_budget_s=0.0, device=device,
    )
    store_untouched = not (Path(store_a) / "profiles.jsonl").exists()
    if summary_a.get("probes", -1) != 0 or not store_untouched:
        failed.append("zero-budget tuner touched the store")
    plain = _solver(backend, profile_store=None, **fw_cfg).solve(g)
    with_store = _solver(backend, profile_store=store_a, **fw_cfg).solve(g)
    zero_bitwise = bool(np.array_equal(
        _host(plain.dist), _host(with_store.dist),
        equal_nan=True,
    ))
    if not zero_bitwise:
        failed.append("zero-budget dispatch diverged from store-less")

    # Phase B — budgeted probes, band-gated promotion, auto dispatch.
    store_b = tempfile.mkdtemp(prefix="pj_tune_probe_")
    t0 = time.perf_counter()
    summary_b = tune_bucket(
        g, store_dir=store_b,
        config=SolverConfig(backend=backend, profile_store=store_b),
        knobs=["fw_tile"], candidates=candidates,
        probe_budget_s=probe_s, bucket_budget_s=bucket_s, device=device,
    )
    tune_wall = time.perf_counter() - t0
    knob = summary_b["knobs"].get("fw_tile", {})
    eff_tile, eff_source = resolve_param(
        "fw_tile", None, DEFAULT_FW_TILE,
        config=SolverConfig(backend=backend, profile_store=store_b),
        platform=_platform(backend), num_nodes=g.num_nodes,
        num_edges=g.num_real_edges,
        validate=lambda t: isinstance(t, int) and t >= 128 and t % 128 == 0,
    )
    if knob.get("promoted") and eff_tile != knob.get("winner"):
        failed.append(
            f"dispatch resolved tile {eff_tile}, tuner promoted "
            f"{knob.get('winner')}"
        )
    prov = {
        row["knob"]: row for row in provenance_table(
            store_dir=store_b, num_nodes=g.num_nodes,
            num_edges=g.num_real_edges,
            config=SolverConfig(backend=backend, profile_store=store_b),
            device=device,
        )
    }.get("fw_tile", {})
    if knob.get("promoted") and prov.get("source") != "tuner-promoted":
        failed.append(
            f"provenance says {prov.get('source')!r} for a promoted knob"
        )

    auto = _solver(backend, profile_store=store_b, **fw_cfg)
    auto.solve(g)  # warm compiles on the resolved tile
    t0 = time.perf_counter()
    res = auto.solve(g)
    dispatch_wall = time.perf_counter() - t0
    forced = _solver(
        backend, profile_store=None, fw_tile=int(eff_tile), **fw_cfg
    ).solve(g)
    dispatch_bitwise = bool(np.array_equal(
        _host(res.dist), _host(forced.dist), equal_nan=True,
    ))
    if not dispatch_bitwise:
        failed.append("auto dispatch diverged from forced tuned tile")

    total_wall = tune_wall + dispatch_wall
    detail = {
        "noise_band": TUNE_NOISE_BAND,
        "zero_budget": {
            "summary": summary_a, "store_untouched": store_untouched,
            "bitwise_vs_storeless": zero_bitwise,
        },
        "tuning": {
            "probes": summary_b.get("probes"),
            "censored": summary_b.get("censored"),
            "probe_budget_s": probe_s,
            "bucket_budget_s": bucket_s,
            "tune_wall_s": round(tune_wall, 4),
            "fw_tile": knob,
        },
        "provenance": prov,
        "dispatch": {
            "tile": int(eff_tile), "source": eff_source,
            "bitwise_vs_forced": dispatch_bitwise,
            "wall_ms": round(dispatch_wall * 1e3, 3),
        },
        **_routes(res),
    }
    if failed:
        detail["failed"] = "; ".join(failed)
    return BenchRecord(
        "planner_tuning", backend, preset, total_wall,
        res.stats.edges_relaxed,
        res.stats.edges_relaxed / max(total_wall, 1e-9), _n_chips(),
        detail,
    )


def bench_dirty_window(backend: str, preset: str) -> BenchRecord:
    """Config 10: dirty-window compacted relaxation
    vs the plain batched route on the SAME graphs — the bench that
    converts the convergence observatory's measured skippable fraction
    into recorded wall-clock. Two workloads:

    - the scrambled road grid (the convergence-evidence shape) at batch
      width: the dw route (forced) vs the plain dispatch (dw disabled),
      BITWISE-checked, with the exact examined/skipped edge counters
      (examined from the kernel's split counter; skipped = the plain
      run's exact examined total minus dw's) and the speedup;
    - the rmat power-law preset: the same comparison where the
      trajectory is flat-ish — the workload the dispatch must DECLINE.

    The detail also records the trajectory-driven dispatch loop end to
    end: an instrumented plain solve writes its trajectory into a
    throwaway profile store, and ``dw_decision`` over that store must
    engage for the grid and decline for rmat — the "never blindly"
    acceptance, exercised on real records."""
    import tempfile

    from paralleljohnson_tpu_torch.graphs import grid2d, permute_labels, rmat

    rows = _sz("dirty_window", "rows", preset)
    n_sources = _sz("dirty_window", "sources", preset)
    rscale = _sz("dirty_window", "rscale", preset)
    g = permute_labels(
        grid2d(rows, rows, negative_fraction=0.0, seed=7), seed=11
    )
    rng = np.random.default_rng(0)
    sources = np.sort(
        rng.choice(g.num_nodes, size=min(n_sources, g.num_nodes),
                   replace=False)
    )

    def timed(graph, srcs, **cfg):
        solver = _solver(backend, mesh_shape=(1,), **cfg)
        solver.multi_source(graph, srcs)  # warm compile caches
        t0 = time.perf_counter()
        res = solver.multi_source(graph, srcs)
        return res, time.perf_counter() - t0

    res, wall = timed(g, sources, dirty_window=True)
    pres, plain_wall = timed(g, sources, dirty_window=False)
    examined = res.stats.edges_relaxed
    plain_examined = pres.stats.edges_relaxed
    detail = {
        "nodes": g.num_nodes, "edges": g.num_real_edges,
        "sources": len(sources),
        "plain_wall_s": round(plain_wall, 6),
        "dw_speedup": round(plain_wall / max(wall, 1e-9), 3),
        "examined_edges": int(examined),
        "plain_examined_edges": int(plain_examined),
        "skipped_edges": int(plain_examined - examined),
        "skip_frac": round(
            1.0 - examined / max(plain_examined, 1), 4
        ),
        **_routes(res),
    }
    if not np.array_equal(_host(res.dist), _host(pres.dist)):
        detail["failed"] = "dw rows != plain rows (bitwise)"

    # R-MAT companion: the workload whose trajectory must DECLINE dw.
    gr = rmat(rscale, 16, seed=3)
    rsources = np.sort(
        rng.choice(gr.num_nodes, size=min(n_sources, gr.num_nodes),
                   replace=False)
    )
    rres, rwall = timed(gr, rsources, dirty_window=True)
    rpres, rplain_wall = timed(gr, rsources, dirty_window=False)
    detail["rmat"] = {
        "nodes": gr.num_nodes, "edges": gr.num_real_edges,
        "dw_wall_s": round(rwall, 6),
        "plain_wall_s": round(rplain_wall, 6),
        "dw_speedup": round(rplain_wall / max(rwall, 1e-9), 3),
        "skip_frac": round(
            1.0 - rres.stats.edges_relaxed
            / max(rpres.stats.edges_relaxed, 1), 4
        ),
    }
    if not np.array_equal(_host(rres.dist), _host(rpres.dist)):
        detail["failed"] = "rmat dw rows != plain rows (bitwise)"

    # Trajectory-driven dispatch, end to end on real records (torch
    # only: host backends record no trajectories).
    if backend == "torch":
        from paralleljohnson_tpu_torch.backends import get_backend
        from paralleljohnson_tpu_torch.config import SolverConfig

        with tempfile.TemporaryDirectory() as d:
            # The hand sweep records no trajectory, so the evidence solves
            # take the instrumented plain-torch route (use_pallas=False).
            for graph, srcs in ((g, sources), (gr, rsources)):
                _solver(
                    backend, dirty_window=False, convergence=True,
                    use_pallas=False, profile_store=d, mesh_shape=(1,),
                ).multi_source(graph, srcs)
            be = get_backend("torch", SolverConfig(
                profile_store=d, mesh_shape=(1,)
            ), device=_BENCH_DEVICE.get())
            detail["dispatch"] = {
                "grid": be._dw_decision(be.upload(g), len(sources)),
                "rmat": be._dw_decision(be.upload(gr), len(rsources)),
            }
    return BenchRecord(
        "dirty_window", backend, preset, wall,
        res.stats.edges_relaxed,
        res.stats.edges_relaxed / max(wall, 1e-9), _n_chips(),
        detail,
    )


def bench_serve_fleet(backend: str, preset: str) -> BenchRecord:
    """Config 17: the REPLICATED serve fleet under a
    kill-one-replica chaos drill, through real TCP sockets and real
    subprocesses — the failover contract under test, not throughput:

    - three ``serve`` replica processes register into a shared
      fleet directory via heartbeated membership records and all serve
      the same pre-solved checkpoint;
    - a consistent-hash :class:`FleetRouter` forwards every client line
      to the owning replica; mid-traffic one replica is SIGKILLed and
      the router must re-publish the routing table minus the corpse and
      re-route the dead replica's sources within one heartbeat lapse
      (``reroute_lapse_s`` is the graded axis — a slower failover flags
      the regression gate);
    - zero hung clients (every request gets exactly one response line or
      an explicit admission error), zero unflagged approximations, and
      every non-shed answer is verified BITWISE against the direct
      solve's matrix — a misrouted query is only colder, never wrong;
    - the per-replica latency histograms merge into one service-level
      SLO verdict (:func:`observe.top.gather_ops` fleet view) which must
      be in-SLO for the row to pass;
    - request tracing end to end: router + every replica run
      with flight recorders, the kill-survivor probe's answer must
      assemble (``observe.trace.assemble``) into ONE single-rooted
      timeline spanning router and replica, at least one trace must show
      the retry hop (a ``forward`` span with ``attempt >= 2``) across
      the kill, and a post-drill query for the one deliberately
      unsolved source must carry the scheduled ``serve_solve`` in its
      assembled trace.

    The replicas are ``python -m paralleljohnson_tpu_torch serve``
    processes on the bench device: on the card all three share it (one
    CUDA context each), and the post-drill probe's scheduled solve runs
    ``fanout_sweep`` inside the replica that owns the unsolved source.

    Violations land in ``detail["failed"]`` (the row is the assertion)."""
    import os as _os
    import signal as _signal
    import socket as _socket
    import subprocess as _subprocess
    import sys as _sys
    import tempfile
    import threading

    from paralleljohnson_tpu_torch.config import SolverConfig
    from paralleljohnson_tpu_torch.graphs import grid2d
    from paralleljohnson_tpu_torch.observe.top import gather_ops
    from paralleljohnson_tpu_torch.serve import (
        FleetRouter,
        QueryEngine,
        TileStore,
        read_routing,
    )

    rows = _sz("serve_fleet", "rows", preset)
    n_clients = _sz("serve_fleet", "clients", preset)
    duration_s = float(_sz("serve_fleet", "duration_s", preset))
    n_replicas = 3
    heartbeat_s = 0.25
    stale_after_s = 1.5
    lapse_budget_s = stale_after_s + 2.0
    # The registry loader for "grid:rows=R,cols=R" is
    # grid2d(R, R, negative_fraction=0.0, seed=0) — the oracle MUST be
    # digest-identical to what the replica subprocesses load.
    graph_name = f"grid:rows={rows},cols={rows}"
    g = grid2d(rows, rows, negative_fraction=0.0, seed=0)
    n = g.num_nodes
    cfg = SolverConfig(backend=backend, telemetry=_BENCH_TELEMETRY.get(),
                       profile_store=_BENCH_PROFILE.get())
    from paralleljohnson_tpu_torch.solver import ParallelJohnsonSolver

    dev = _BENCH_DEVICE.get()
    exact = _host(ParallelJohnsonSolver(
        SolverConfig(backend=backend), device=dev).solve(g).matrix)

    failures: list[str] = []
    procs: list[_subprocess.Popen] = []
    with tempfile.TemporaryDirectory() as td:
        fleet_dir = Path(td) / "fleet"
        store_dir = Path(td) / "store"
        trace_root = Path(td) / "trace"
        # Pre-solve the checkpoint once; every replica serves it
        # cold/warm so non-shed answers are bitwise-reproducible. Source
        # n-1 is deliberately left UNSOLVED (clients never query it):
        # the post-drill solve probe queries it so its assembled trace
        # must contain the scheduled serve_solve hop.
        seed_store = TileStore(str(store_dir), g, hot_rows=max(8, n // 8),
                               warm_rows=n)
        seed_engine = QueryEngine(g, seed_store, config=cfg,
                                  stats_interval_s=0, device=dev)
        seed_engine.warm(np.arange(n - 1))
        seed_engine.close()

        env = dict(_os.environ)
        repo_root = str(Path(__file__).resolve().parents[1])
        env["PYTHONPATH"] = _os.pathsep.join(
            p for p in (repo_root, env.get("PYTHONPATH")) if p)

        def spawn_replica(i: int) -> tuple[_subprocess.Popen, dict]:
            p = _subprocess.Popen(
                [_sys.executable, "-m", "paralleljohnson_tpu_torch",
                 "serve", graph_name,
                 "--listen", "127.0.0.1:0",
                 "--store-dir", str(store_dir),
                 "--backend", backend,
                 "--device", str(dev),
                 "--fleet-dir", str(fleet_dir),
                 "--replica-id", f"replica-{i}",
                 "--replica-heartbeat", str(heartbeat_s),
                 "--slo-p99-ms", "2000",
                 "--stats-interval", "0.5",
                 "--trace-dir", str(trace_root / f"replica-{i}")],
                env=env, stdout=_subprocess.PIPE,
                stderr=_subprocess.DEVNULL, text=True)
            line = p.stdout.readline()
            try:
                ann = json.loads(line)
            except (json.JSONDecodeError, ValueError):
                p.kill()
                raise RuntimeError(
                    f"replica {i} printed no announce line: {line!r}")
            return p, ann

        router = None
        router_tel = None
        t0 = time.perf_counter()
        try:
            anns = []
            for i in range(n_replicas):
                p, ann = spawn_replica(i)
                procs.append(p)
                anns.append(ann)
            from paralleljohnson_tpu_torch.utils.telemetry import Telemetry

            router_tel = Telemetry.create(
                trace_dir=trace_root / "router", label="router")
            router = FleetRouter(
                str(fleet_dir), stale_after_s=stale_after_s,
                refresh_interval_s=heartbeat_s / 2,
                retry_after_ms=25,
                telemetry=router_tel,
            ).start()
            host, port = router.address()
            table = router.table
            epoch_before = table.epoch if table is not None else 0
            if table is None or len(
                    {table.owner(str(s)) for s in range(n)}) < 2:
                failures.append(
                    "routing table did not spread ownership across "
                    "replicas")

            # The victim owns the probe source — after the SIGKILL the
            # probe measures how long its traffic stays dark.
            probe_src = 0
            victim_rid = table.owner(str(probe_src)) if table else None
            victim_i = int(victim_rid.rsplit("-", 1)[1]) if victim_rid \
                else 0

            results: list[tuple[int, int, dict]] = []
            res_lock = threading.Lock()
            client_errors: list[BaseException] = []
            kill_at_s = duration_s * 0.4
            lapse_box: dict = {}

            def client(k: int) -> None:
                # Closed-loop paced through the ROUTER: one response
                # line per request, in order — a missing line hangs the
                # socket timeout and fails the bench.
                try:
                    sock = _socket.create_connection((host, port),
                                                     timeout=30)
                    sock.settimeout(30)
                    f = sock.makefile("rw", encoding="utf-8",
                                      newline="\n")
                    json.loads(f.readline())  # router header
                    crng = np.random.default_rng(2000 + k)
                    local = []
                    sent = 0
                    rate = 40.0  # per client, well below capacity
                    start = time.perf_counter()
                    while True:
                        elapsed = time.perf_counter() - start
                        if elapsed >= duration_s:
                            break
                        delay = sent / rate - elapsed
                        if delay > 0:
                            time.sleep(delay)
                        # n-1 is the reserved never-solved source — the
                        # solve probe's, not client traffic's.
                        src = int(crng.integers(n - 1))
                        dst = int(crng.integers(n))
                        f.write(json.dumps(
                            {"id": sent, "source": src, "dst": dst,
                             "client_id": f"bench-{k}"}) + "\n")
                        f.flush()
                        local.append((src, dst, json.loads(f.readline())))
                        sent += 1
                    f.close()
                    sock.close()
                    with res_lock:
                        results.extend(local)
                except BaseException as e:  # noqa: BLE001 — surface it
                    client_errors.append(e)

            def killer() -> None:
                # SIGKILL the probe source's owner mid-traffic, then
                # probe that source through the router until it answers
                # exactly again: kill -> first good answer is the
                # re-route lapse.
                time.sleep(kill_at_s)
                procs[victim_i].send_signal(_signal.SIGKILL)
                procs[victim_i].wait()
                t_kill = time.perf_counter()
                deadline = t_kill + max(10.0, 3 * lapse_budget_s)
                while time.perf_counter() < deadline:
                    try:
                        sock = _socket.create_connection((host, port),
                                                         timeout=5)
                        sock.settimeout(5)
                        f = sock.makefile("rw", encoding="utf-8",
                                          newline="\n")
                        json.loads(f.readline())
                        f.write(json.dumps(
                            {"id": 0, "source": probe_src,
                             "dst": 1}) + "\n")
                        f.flush()
                        resp = json.loads(f.readline())
                        sock.close()
                        if resp.get("error") is None:
                            lapse_box["lapse_s"] = (
                                time.perf_counter() - t_kill)
                            lapse_box["resp"] = resp
                            return
                    except (OSError, json.JSONDecodeError):
                        pass
                    time.sleep(0.05)

            threads = [threading.Thread(target=client, args=(k,),
                                        name=f"fleet-client-{k}")
                       for k in range(n_clients)]
            kt = threading.Thread(target=killer, name="fleet-killer")
            for t in threads:
                t.start()
            kt.start()
            for t in threads:
                t.join()
            kt.join()
            wall = time.perf_counter() - t0
            if client_errors:
                raise client_errors[0]

            # -- grade --------------------------------------------------
            reroute_lapse_s = lapse_box.get("lapse_s")
            if reroute_lapse_s is None:
                failures.append(
                    "dead replica's sources never answered again — "
                    "the fleet lost them for good")
            elif reroute_lapse_s > lapse_budget_s:
                failures.append(
                    f"re-route took {reroute_lapse_s:.2f}s — over the "
                    f"{lapse_budget_s:.2f}s heartbeat-lapse budget")
            probe_resp = lapse_box.get("resp")
            if probe_resp is not None and not probe_resp.get("shed"):
                want = float(exact[probe_src, 1])
                if float(probe_resp["distance"]) != want:
                    failures.append(
                        f"re-routed probe answer not bitwise: "
                        f"{probe_resp['distance']} != {want}")

            table_after = read_routing(str(fleet_dir))
            epoch_after = (table_after.epoch if table_after is not None
                           else 0)
            if epoch_after <= epoch_before:
                failures.append(
                    f"routing epoch did not advance after the kill "
                    f"({epoch_before} -> {epoch_after})")
            if table_after is not None and victim_rid in {
                    table_after.owner(str(s)) for s in range(n)}:
                failures.append(
                    "dead replica still owns sources in the "
                    "re-published routing table")

            answered = rejected = shed_n = 0
            for src, dst, r in results:
                if "error" in r:
                    if r["error"] in ("overloaded", "deadline",
                                      "draining", "unavailable"):
                        rejected += 1
                    else:
                        failures.append(f"unexpected error answer: {r}")
                    continue
                if r.get("shed"):
                    shed_n += 1
                    if r.get("exact") is not False or "max_error" not in r:
                        failures.append(f"shed answer not flagged: {r}")
                    continue
                if r.get("exact") is not True:
                    failures.append(f"unflagged approximate answer: {r}")
                    continue
                answered += 1
                want = float(exact[src, dst])
                if float(r["distance"]) != want:
                    failures.append(
                        f"non-shed answer not bitwise: s={src} t={dst} "
                        f"{r['distance']} != {want}")
            if answered == 0:
                failures.append("no exact answers at all — dead fleet")

            # -- the scheduled-solve probe ------------------------------
            # Source n-1 was never pre-solved and no client queried it:
            # this one query forces the owning replica to schedule a
            # solve, whose serve_solve span must land in the assembled
            # trace below.
            solve_probe_trace = None
            try:
                sock = _socket.create_connection((host, port), timeout=15)
                sock.settimeout(15)
                f = sock.makefile("rw", encoding="utf-8", newline="\n")
                json.loads(f.readline())
                f.write(json.dumps({"id": "solve-probe",
                                    "source": n - 1, "dst": 0}) + "\n")
                f.flush()
                resp = json.loads(f.readline())
                f.close()
                sock.close()
                solve_probe_trace = resp.get("trace_id")
                if resp.get("error") is not None:
                    failures.append(f"solve probe errored: {resp}")
                elif not resp.get("shed"):
                    want = float(exact[n - 1, 0])
                    if float(resp["distance"]) != want:
                        failures.append(
                            f"solve-probe answer not bitwise: "
                            f"{resp['distance']} != {want}")
            except (OSError, ValueError) as e:
                failures.append(
                    f"solve probe failed: {type(e).__name__}: {e}")

            # -- merged fleet verdict (the top/slo_report view) ---------
            time.sleep(2 * heartbeat_s)  # let final heartbeats land
            doc = gather_ops(serve_fleet=fleet_dir,
                             stale_after_s=stale_after_s)
            sf = doc.get("serve_fleet") or {}
            merged = sf.get("merged") or {}
            if merged.get("histogram_merge_error"):
                failures.append(
                    f"fleet histogram merge degraded: "
                    f"{merged['histogram_merge_error']}")
            if merged.get("verdict") not in ("ok",):
                failures.append(
                    f"merged fleet SLO verdict "
                    f"{merged.get('verdict')!r} — expected in-SLO 'ok'")
            if len(sf.get("replicas") or {}) < n_replicas - 1:
                failures.append(
                    "fleet view lost surviving replicas: "
                    f"{sorted(sf.get('replicas') or {})}")
        finally:
            if router is not None:
                router.drain()
            if router_tel is not None:
                router_tel.close()
            for p in procs:
                if p.poll() is None:
                    p.send_signal(_signal.SIGTERM)
            for p in procs:
                try:
                    p.wait(timeout=20)
                except _subprocess.TimeoutExpired:
                    p.kill()

        # -- assembled request traces ------------------------------------
        # Every process on the request path flushed its own flight
        # JSONL (the SIGKILLed victim's may end in a torn line — the
        # loader tolerates exactly that); the join must reconstruct
        # end-to-end causality: the kill-survivor probe as ONE
        # single-rooted timeline spanning router + replica, a visible
        # retry hop, and the solve probe's scheduled serve_solve.
        from paralleljohnson_tpu_torch.observe.trace import assemble

        try:
            asm = assemble([trace_root])
        except (OSError, ValueError) as e:
            failures.append(f"trace assembly failed: {e}")
            asm = {"processes": [], "traces": {}}
        traces = asm["traces"]
        probe_tid = (lapse_box.get("resp") or {}).get("trace_id")
        ptr = traces.get(probe_tid) if probe_tid else None
        if ptr is None:
            failures.append(
                "kill-survivor probe answer carried no assemblable "
                f"trace (trace_id={probe_tid!r})")
        else:
            if not ptr["single_rooted"]:
                failures.append(
                    f"probe trace {probe_tid} not single-rooted: "
                    f"roots={ptr['roots']} "
                    f"unresolved={ptr['unresolved']}")
            if ("router" not in ptr["processes"]
                    or len(ptr["processes"]) < 2):
                failures.append(
                    "probe trace does not span router + replica: "
                    f"{ptr['processes']}")
        retry_tids = [
            tid for tid, t in traces.items()
            if any(s["name"] == "forward"
                   and (s["attrs"].get("attempt") or 1) >= 2
                   for s in t["spans"])
        ]
        if not retry_tids:
            failures.append(
                "no assembled trace shows the retry hop (a forward "
                "span with attempt >= 2) across the kill")
        elif not any(traces[tid]["single_rooted"] for tid in retry_tids):
            failures.append(
                "no retried request reconstructed into a single "
                "parented trace")
        stp = traces.get(solve_probe_trace) if solve_probe_trace else None
        if stp is None:
            failures.append(
                "solve probe carried no assemblable trace "
                f"(trace_id={solve_probe_trace!r})")
        elif not any(s["name"] == "serve_solve" for s in stp["spans"]):
            failures.append(
                "solve-probe trace missing the scheduled serve_solve "
                f"span: {[s['name'] for s in stp['spans']]}")

        # The drill's tempdir dies with this function; PJ_FLEET_TRACE_OUT
        # preserves the raw flight dirs for the offline assembler.
        keep = _os.environ.get("PJ_FLEET_TRACE_OUT")
        if keep:
            import shutil as _shutil

            _shutil.rmtree(keep, ignore_errors=True)
            try:
                _shutil.copytree(trace_root, keep)
            except OSError:
                pass

        detail = {
            "nodes": n, "edges": g.num_real_edges,
            "replicas": n_replicas,
            "clients": n_clients,
            "duration_s": duration_s,
            "heartbeat_s": heartbeat_s,
            "stale_after_s": stale_after_s,
            "reroute_lapse_s": (round(reroute_lapse_s, 4)
                                if reroute_lapse_s is not None else None),
            "reroute_budget_s": lapse_budget_s,
            "epoch_before": epoch_before,
            "epoch_after": epoch_after,
            "answered": answered,
            "rejected": rejected,
            "shed_answers": shed_n,
            "exact_bitwise_checked": answered,
            "p50_ms": merged.get("p50_ms"),
            "p99_ms": merged.get("p99_ms"),
            "p99_err_ms": merged.get("p99_err_ms"),
            "slo": merged.get("slo"),
            "verdict": merged.get("verdict"),
            "router": dict(router.stats),
            "traces_assembled": len(traces),
            "traces_single_rooted": sum(
                1 for t in traces.values() if t["single_rooted"]),
            "retry_traces": len(retry_tids),
            "probe_trace": probe_tid,
            "solve_probe_trace": solve_probe_trace,
        }
        if failures:
            detail["failed"] = failures[:10]
    return BenchRecord(
        "serve_fleet", backend, preset, wall, 0, 0.0, _n_chips(), detail,
    )


def bench_distributed_fleet(backend: str, preset: str) -> BenchRecord:
    """Config 8: the distributed solve fleet — N local worker processes
    vs 1 on the SAME graph, every worker on the bench device (several
    processes share one card). Both runs go through the full coordinator
    machinery (lease claims over the flock'd log, per-worker checkpoint
    shards, heartbeats, shard-manifest union), so the speedup number
    prices exactly what a pod deployment pays: coordination + per-
    worker process overhead vs parallel source ranges. Rows are checked
    BITWISE between the two fleets through ``fleet_rows`` (the merged
    manifests) — the graph is sparse (below the dense-density gate) and
    the source batch is pinned, so every worker resolves the same
    batch-invariant route and a drifted row is a bug, not rounding.
    The smoke preset runs the workers in-process (same machinery minus
    subprocess spawn — what tier-1 exercises); mini/full spawn real
    subprocesses. Detail records the requeue/extension counters: a
    clean run must show 0 requeues; the host-loss drill is not here.
    Subprocess workers' kernel launches are not counted in this process;
    each worker's ``kernel_build_s`` (its build or load of the kernels
    before its first claim) is in ``worker_kernel_build_s``."""
    import tempfile

    from paralleljohnson_tpu_torch.distributed import (
        fleet_rows,
        launch_local_fleet,
        plan_fleet,
    )
    from paralleljohnson_tpu_torch.distributed.launch import run_in_process_fleet

    n = _sz("distributed_fleet", "n", preset)
    n_workers = _sz("distributed_fleet", "workers", preset)
    # Average degree ~4: below the dense-density gate at every preset
    # size, so every lease resolves the batch-invariant sparse fan-out.
    graph_spec = f"er:n={n},p={round(4.0 / n, 6)},seed=13"
    # Pinned: a batch sized from the free memory each worker sees would
    # overcommit a card that several workers share.
    config = {"source_batch_size": max(16, n // 16)}
    in_process = preset == "smoke"
    device = _BENCH_DEVICE.get()

    def run_fleet(workers: int, d: str):
        coord = plan_fleet(
            d, graph_spec, n_workers=workers, backend=backend,
            config=config,
        )
        t0 = time.perf_counter()
        if in_process:
            report = run_in_process_fleet(coord, workers, device=device)
        else:
            report = launch_local_fleet(
                coord, workers, telemetry=_BENCH_TELEMETRY.get(),
                device=device,
            )
        wall = time.perf_counter() - t0
        if not report.ok:
            raise RuntimeError(
                f"fleet incomplete: {report.leases_committed}/"
                f"{report.leases_total} leases committed "
                f"(worker rcs {report.worker_rcs})"
            )
        return coord, report, wall

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as dn:
        coord1, rep1, wall1 = run_fleet(1, d1 + "/coord")
        coordn, repn, wall = run_fleet(n_workers, dn + "/coord")
        rows1 = fleet_rows(coord1.dir)
        rowsn = fleet_rows(coordn.dir)
        detail = {
            "nodes": n, "graph_spec": graph_spec,
            "workers": n_workers,
            "worker_mode": "in-process" if in_process else "subprocess",
            "leases": repn.leases_total,
            "requeues": repn.requeues,
            "extensions": repn.extensions,
            "single_worker_wall_s": round(wall1, 6),
            "fleet_speedup": round(wall1 / max(wall, 1e-9), 3),
            "committed_by": repn.status["committed_by"],
            "worker_kernel_build_s": {
                wid: json.loads(coordn.worker_summary_path(wid).read_text(
                    encoding="utf-8")).get("kernel_build_s")
                for wid in repn.worker_rcs
            },
        }
        if sorted(rows1) != sorted(rowsn):
            detail["failed"] = "fleet manifests cover different sources"
        elif not all(
            np.array_equal(rows1[s], rowsn[s]) for s in rows1
        ):
            detail["failed"] = (
                f"{n_workers}-worker rows != 1-worker rows (bitwise)"
            )
    return BenchRecord(
        "distributed_fleet", backend, preset, wall,
        repn.edges_relaxed,
        repn.edges_relaxed / max(wall, 1e-9), _n_chips(),
        detail,
    )


def bench_incremental_update(backend: str, preset: str) -> BenchRecord:
    """Config 9: full re-solve vs dirty-part repair on the SAME k-edge
    update, closures and the fresh solve on the bench device. A graph
    is solved into a checkpoint and its incremental state attached;
    then a k-edge update batch confined to ONE partition is applied two
    ways — a fresh full solve of the updated graph, and
    ``repair_checkpoint`` (re-close the one dirty part + the boundary
    core, re-expand affected rows). Rows are checked BITWISE (integer
    weights, so every route agrees exactly); detail records the
    speedup, the exact dirty-part counter (must stay below the part
    total — the dependency tracking is the product being measured), and
    the repair's row-action split. The one-time state build is timed
    separately (``attach_s``): it amortizes over every future update."""
    import tempfile

    from paralleljohnson_tpu_torch.graphs import grid2d
    from paralleljohnson_tpu_torch.incremental import repair_checkpoint
    from paralleljohnson_tpu_torch.incremental.state import IncrementalState
    from paralleljohnson_tpu_torch.utils.checkpoint import (
        BatchCheckpointer,
        graph_digest,
    )

    side = max(4, int(np.sqrt(_sz("incremental_update", "n", preset))))
    k_updates = _sz("incremental_update", "k", preset)
    # A lattice, not ER: the dynamic-graph workload this subsystem
    # opens is road networks (traffic updates, link failures), whose
    # small separators are what make partitioned repair cheap — an ER
    # graph's boundary core is most of the graph and would honestly
    # show repair ~ resolve. Integer weights: the bitwise
    # repair-vs-resolve check needs every route to agree exactly.
    g = grid2d(side, side, seed=17)
    n = g.num_nodes
    g = g.with_weights(np.maximum(1.0, np.rint(g.weights)).astype(np.float32))
    batch = max(16, n // 16)

    with tempfile.TemporaryDirectory() as d:
        solver = _solver(backend, checkpoint_dir=d, source_batch_size=batch)
        solver.solve(g)
        t0 = time.perf_counter()
        state = IncrementalState.build(g, config=solver.config,
                                       device=_BENCH_DEVICE.get())
        state.save(
            BatchCheckpointer(d, graph_key=graph_digest(g)).dir
        )
        attach_s = time.perf_counter() - t0

        # k updates confined to the most-populated part: the honest
        # "traffic update" shape — local change, small dirty set.
        target = int(np.bincount(state.labels).argmax())
        e = g.num_real_edges
        within = np.flatnonzero(
            (state.labels[g.src[:e]] == target)
            & (state.labels[g.indices[:e]] == target)
        )
        rng = np.random.default_rng(5)
        idx = rng.choice(within, size=min(k_updates, within.size),
                         replace=False)
        updates = [
            (int(g.src[i]), int(g.indices[i]),
             1.0 if j % 2 == 0 else float(g.weights[i]) + 3.0)
            for j, i in enumerate(idx)
        ]
        new_graph, _report = g.apply_edge_updates(updates)

        fresh_solver = _solver(backend, source_batch_size=batch)
        t0 = time.perf_counter()
        fresh = fresh_solver.solve(new_graph)
        full_wall = time.perf_counter() - t0

        t0 = time.perf_counter()
        result = repair_checkpoint(
            d, g, updates, config=solver.config, state=state,
            device=_BENCH_DEVICE.get(),
        )
        wall = time.perf_counter() - t0

        ck = BatchCheckpointer(d, graph_key=graph_digest(new_graph))
        manifest = ck.manifest()
        fresh_rows = np.asarray(fresh.matrix)
        detail = {
            "nodes": n, "edges": int(g.num_real_edges),
            "k_updates": len(updates),
            "dirty_parts": result.dirty_parts_closed,
            "parts_total": result.parts_total,
            "core_recomputed": result.core_recomputed,
            "affected_rows": result.affected_rows,
            "rows_recomputed": result.rows_recomputed,
            "rows_patched": result.rows_patched,
            "rows_copied": result.rows_copied,
            "attach_s": round(attach_s, 6),
            "full_resolve_wall_s": round(full_wall, 6),
            "repair_speedup": round(full_wall / max(wall, 1e-9), 3),
            "repair_walls": {
                "closures_s": round(result.closures_s, 6),
                "expand_s": round(result.expand_s, 6),
                "io_s": round(result.io_s, 6),
            },
        }
        if result.dirty_parts_closed >= result.parts_total:
            detail["failed"] = (
                "dirty-part counter reached the part total — the "
                "update was supposed to stay local"
            )
        elif len(manifest) != n:
            detail["failed"] = (
                f"repaired checkpoint covers {len(manifest)} of {n} "
                "sources"
            )
        else:
            seen = {}
            for fn in sorted({f for _b, f in manifest.values()}):
                srcs = ck.batch_sources(fn)
                loaded = ck.load(int(manifest[int(srcs[0])][0]), srcs)
                if loaded is None:
                    detail["failed"] = f"unreadable repaired batch {fn}"
                    break
                for i, s in enumerate(srcs):
                    seen[int(s)] = loaded[0][i]
            if "failed" not in detail and not all(
                np.array_equal(seen[s], fresh_rows[s]) for s in seen
            ):
                detail["failed"] = (
                    "repaired rows != fresh full solve (bitwise)"
                )
    return BenchRecord(
        "incremental_update", backend, preset, wall,
        result.expand_macs,
        result.expand_macs / max(wall, 1e-9), _n_chips(), detail,
    )


def bench_serve_queries(backend: str, preset: str) -> BenchRecord:
    """Config 6: the query-serving layer measured as a TRAFFIC-BEARING SERVICE — K >= 4
    client threads offering a sustained request rate, not one thread
    replaying as fast as it can. A checkpoint-backed store is warmed
    with a quarter of the sources (one scheduled exact batch), a
    landmark index covers the rest, then a seeded 85/15 hit/approx mix
    is split across K paced client threads against ONE shared engine
    (the thread-safety contract under test is the deployment shape).
    The offered rate is calibrated from a short closed-loop probe
    (~70% of measured serial capacity — sustained load, not overload),
    each client sleeps to its own send schedule, and the detail column
    reports the STREAMING histogram p50/p99 with their one-bucket error
    bounds plus the SLO burn verdict.

    The row also carries a ``lookup`` contrast block:
    the SAME request mix replayed closed-loop by K >= 16 concurrent
    clients through a shared :class:`MicroBatcher`, once with the host
    tier walk forced and once with the device megabatch path forced.
    The two response sets must be BITWISE identical (the planner's
    bit-for-bit promise, asserted here, not assumed), and the block
    records both walls, the speedup, and the auto planner's why-line
    for this platform."""
    import json as _json
    import tempfile
    import threading

    from paralleljohnson_tpu_torch.graphs import erdos_renyi
    from paralleljohnson_tpu_torch.observe.live import SLO
    from paralleljohnson_tpu_torch.serve import (
        LandmarkIndex,
        MicroBatcher,
        QueryEngine,
        TileStore,
    )

    dev = _BENCH_DEVICE.get()
    n = _sz("serve_queries", "n", preset)
    n_queries = _sz("serve_queries", "queries", preset)
    n_clients = _sz("serve_queries", "clients", preset)
    g = erdos_renyi(n, 8.0 / n, seed=13)
    cfg_kwargs = dict(telemetry=_BENCH_TELEMETRY.get(),
                      profile_store=_BENCH_PROFILE.get())
    from paralleljohnson_tpu_torch.config import SolverConfig

    cfg = SolverConfig(backend=backend, **cfg_kwargs)
    slo = SLO(name="serve", latency_ms=250.0, availability=0.999,
              rules=((60.0, 15.0, 14.4), (300.0, 60.0, 6.0)))
    rng = np.random.default_rng(17)
    warm_sources = np.sort(rng.choice(n, size=max(8, n // 4), replace=False))
    with tempfile.TemporaryDirectory() as d:
        store = TileStore(d, g, hot_rows=max(8, n // 8), warm_rows=n)
        landmarks = LandmarkIndex.build(g, k=8, config=cfg, seed=0,
                                        device=dev)
        # Every engine is closed before the store's directory goes: an
        # open engine's stats thread holds it alive past the config.
        warm_engine = QueryEngine(g, store, landmarks=landmarks, config=cfg,
                                  miss_policy="landmark", device=dev)
        warm_engine.warm(warm_sources)
        warm_engine.close()
        # Separate calibration engine over the same store, then a fresh
        # engine for the timed loop: neither the warm batch's nor the
        # closed-loop probe's latencies may pollute the measurement.
        probe_engine = QueryEngine(g, store, landmarks=landmarks,
                                   config=cfg, miss_policy="landmark",
                                   device=dev)
        engine = QueryEngine(g, store, landmarks=landmarks, config=cfg,
                             miss_policy="landmark", slo=slo, device=dev)
        warm_set = set(int(s) for s in warm_sources)
        cold_pool = np.array(sorted(set(range(n)) - warm_set), np.int64)
        hit = rng.random(n_queries) < 0.85
        srcs = np.where(
            hit,
            rng.choice(warm_sources, size=n_queries),
            rng.choice(cold_pool, size=n_queries),
        )
        dsts = rng.integers(0, n, size=n_queries)
        requests = [
            {"id": i, "source": int(srcs[i]), "dst": int(dsts[i])}
            for i in range(n_queries)
        ]
        probe = requests[: min(64, n_queries)]
        batch_size = 16  # per-client aggregation batch
        t0 = time.perf_counter()
        for i in range(0, len(probe), batch_size):  # closed-loop probe
            probe_engine.query_batch(probe[i : i + batch_size])
        serial_qps = len(probe) / max(time.perf_counter() - t0, 1e-9)
        probe_engine.close()
        offered_qps = max(50.0, 0.7 * serial_qps)

        # Split the mix round-robin across K clients; each paces its
        # batches to the shared offered rate (open-loop per client: a
        # slow server makes latency grow, it does not slow the offers).
        per_client = offered_qps / n_clients
        slices = [requests[k::n_clients] for k in range(n_clients)]
        barrier = threading.Barrier(n_clients + 1)
        errors: list[BaseException] = []

        def client(k: int) -> None:
            try:
                mine = slices[k]
                barrier.wait()
                start = time.perf_counter()
                sent = 0
                for i in range(0, len(mine), batch_size):
                    due = start + sent / per_client
                    delay = due - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    batch = mine[i : i + batch_size]
                    engine.query_batch(batch)
                    sent += len(batch)
            except BaseException as e:  # noqa: BLE001 — surface, don't hang
                errors.append(e)

        threads = [threading.Thread(target=client, args=(k,),
                                    name=f"bench-client-{k}")
                   for k in range(n_clients)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        pcts = engine.stats.percentiles()
        verdict = engine.metrics.slo(slo).evaluate()
        latency = verdict.get("latency") or {}
        detail = {
            "nodes": g.num_nodes, "edges": g.num_real_edges,
            "queries": n_queries, "landmarks": landmarks.k,
            "warm_sources": len(warm_sources),
            "clients": n_clients,
            "offered_per_s": round(offered_qps, 2),
            "queries_per_s": round(n_queries / max(wall, 1e-9), 2),
            # Streaming-histogram estimates with their one-bucket error
            # bounds (never an unflagged approximation).
            "p50_ms": round(pcts["p50_ms"], 4),
            "p50_err_ms": round(pcts["p50_err_ms"], 4),
            "p99_ms": round(pcts["p99_ms"], 4),
            "p99_err_ms": round(pcts["p99_err_ms"], 4),
            "slo": {
                "p99_target_ms": slo.latency_ms,
                "availability": slo.availability,
                "verdict": "burn" if verdict["burning"] else "ok",
                "burn_rate": verdict["burn_rate"],
                "p99_met": latency.get("met"),
            },
            "hit_rate": round(engine.store.hit_rate(), 4),
            "approx_frac": round(
                engine.stats.approx_answers
                / max(1, engine.stats.queries_total), 4,
            ),
        }
        # -- host vs device lookup contrast -------------------------------
        # Same store, same mix, closed loop: K clients hammer a shared
        # MicroBatcher so the engine sees device-width batches, once
        # per forced path. Wall times compare the LOOKUP paths alone.
        def _lookup_phase(mode: str) -> tuple[float, list, "QueryEngine"]:
            eng = QueryEngine(g, store, landmarks=landmarks, config=cfg,
                              miss_policy="landmark", device_lookup=mode,
                              device=dev)
            mb = MicroBatcher(eng, max_width=max(16, n_clients))
            out: list = [None] * len(requests)
            gate = threading.Barrier(n_clients + 1)
            errs: list[BaseException] = []

            def worker(k: int) -> None:
                try:
                    gate.wait()
                    for req in requests[k::n_clients]:
                        out[req["id"]] = mb.submit(req)
                except BaseException as e:  # noqa: BLE001
                    errs.append(e)

            ts = [threading.Thread(target=worker, args=(k,),
                                   name=f"lookup-{mode}-{k}")
                  for k in range(n_clients)]
            for t in ts:
                t.start()
            gate.wait()
            t1 = time.perf_counter()
            for t in ts:
                t.join()
            dt = time.perf_counter() - t1
            if errs:
                raise errs[0]
            return dt, out, eng

        wall_host, host_out, host_eng = _lookup_phase("off")
        wall_dev, dev_out, dev_eng = _lookup_phase("on")
        bitwise = (_json.dumps(host_out, sort_keys=True)
                   == _json.dumps(dev_out, sort_keys=True))
        # What would AUTO pick here? One batch through an auto engine
        # records the planner's decision + why-line for this platform.
        auto_eng = QueryEngine(g, store, landmarks=landmarks, config=cfg,
                               miss_policy="landmark", device=dev)
        auto_eng.query_batch(requests[: max(16, n_clients)])
        detail["lookup"] = {
            "clients": n_clients,
            "wall_host_s": round(wall_host, 4),
            "wall_device_s": round(wall_dev, 4),
            "speedup": round(wall_host / max(wall_dev, 1e-9), 3),
            "bitwise_identical": bitwise,
            "device_lookups": dev_eng.stats.device_lookups,
            "host_lookups": host_eng.stats.host_lookups,
            "auto_decision": auto_eng.last_lookup_decision,
        }
        for e in (host_eng, dev_eng, auto_eng):
            e.close()
        if not bitwise:
            # A parity break is a wrong-answer bug, not a slow bench.
            detail["failed"] = "host/device lookup answers diverged"

        # Leave the live snapshot beside the flight recorder when the
        # pass runs with telemetry (the slo report reads it offline).
        tel = _BENCH_TELEMETRY.get()
        if tel is not None and getattr(tel, "trace_dir", None):
            engine.metrics.write_snapshot(
                Path(tel.trace_dir) / "serve_live.json"
            )
        engine.close()
    # The serving row's headline is queries/sec, not edges/sec — the
    # edges columns stay zero rather than conflating warm-solve compute
    # with the request loop being measured.
    return BenchRecord(
        "serve_queries", backend, preset, wall, 0, 0.0, _n_chips(), detail,
    )

def bench_serve_overload(backend: str, preset: str) -> BenchRecord:
    """Config 13: the traffic FRONT END measured at
    ~2x its own calibrated capacity, through real TCP sockets — the
    designed-overload contract under test, not throughput:

    - accepted traffic stays in SLO (the latency target is calibrated
      from a closed-loop mixed probe; admission bounds the queue, so
      accepted p99 cannot grow without bound);
    - overload produces explicit ``overloaded`` rejections (never an
      unbounded queue), which burn the availability budget and trip the
      multi-window burn alert;
    - the burn alert engages CERTIFIED shedding: a nonzero-but-bounded
      fraction of answers comes back ``{shed: true, exact: false,
      max_error: <finite>}`` and every one is verified against the
      direct solve's matrix (|answer - exact| <= max_error);
    - every non-shed answer is verified BITWISE against the same matrix;
    - when offered load drops back below capacity (the cooldown phase),
      shedding disengages — zero shed answers in the late cooldown.

    Violations land in ``detail["failed"]`` (the row is the assertion).
    The graph is a strongly connected 2-D lattice so every landmark
    bound is finite — a shed answer with an infinite bound would be
    honest but useless, and this bench demands useful degradation."""
    import socket as _socket
    import tempfile
    import threading

    from paralleljohnson_tpu_torch.config import SolverConfig
    from paralleljohnson_tpu_torch.graphs import grid2d
    from paralleljohnson_tpu_torch.observe.live import SLO
    from paralleljohnson_tpu_torch.serve import (
        LandmarkIndex,
        QueryEngine,
        ServeFrontend,
        TileStore,
    )
    from paralleljohnson_tpu_torch.solver import ParallelJohnsonSolver

    rows = _sz("serve_overload", "rows", preset)
    n_clients = _sz("serve_overload", "clients", preset)
    overload_s = float(_sz("serve_overload", "overload_s", preset))
    cooldown_s = float(_sz("serve_overload", "cooldown_s", preset))
    g = grid2d(rows, rows, seed=41)
    n = g.num_nodes
    cfg = SolverConfig(backend=backend, telemetry=_BENCH_TELEMETRY.get(),
                       profile_store=_BENCH_PROFILE.get())
    dev = _BENCH_DEVICE.get()
    # The oracle every answer is graded against (f32 rows, losslessly
    # widened — the same values the engine serves).
    exact = _host(ParallelJohnsonSolver(
        SolverConfig(backend=backend), device=dev).solve(g).matrix)

    rng = np.random.default_rng(43)
    warm = np.sort(rng.choice(n, size=max(8, n // 4), replace=False))
    rest = np.array(sorted(set(range(n)) - set(map(int, warm))), np.int64)
    probe_cold = rest[: max(1, len(rest) // 3)]
    phase_cold = rest[max(1, len(rest) // 3):]

    with tempfile.TemporaryDirectory() as d:
        store = TileStore(d, g, hot_rows=max(8, n // 8), warm_rows=n)
        landmarks = LandmarkIndex.build(g, k=8, config=cfg, seed=0,
                                        device=dev)
        warm_engine = QueryEngine(g, store, landmarks=landmarks, config=cfg,
                                  device=dev)
        warm_engine.warm(warm)
        warm_engine.close()

        # Capacity + latency calibration: a mixed (80% warm hit / 20%
        # cold miss -> scheduled solve) closed loop through a throwaway
        # engine over the same store. The SLO latency target is 10x the
        # probe's p99 — generous enough that bounded-queue accepted
        # traffic holds it, tight enough that an unbounded queue would
        # not.
        probe_engine = QueryEngine(g, store, landmarks=landmarks,
                                   config=cfg, stats_interval_s=0,
                                   device=dev)
        probe_n = 64
        t0 = time.perf_counter()
        for i in range(probe_n):
            src = (int(probe_cold[i % len(probe_cold)]) if i % 5 == 4
                   else int(rng.choice(warm)))
            probe_engine.query_batch(
                [{"source": src, "dst": int(rng.integers(n))}])
        capacity_qps = probe_n / max(time.perf_counter() - t0, 1e-9)
        probe_p99 = probe_engine.stats.percentiles()["p99_ms"]
        probe_engine.close()
        latency_target_ms = max(50.0, 10.0 * probe_p99)

        slo = SLO(name="serve", latency_ms=latency_target_ms,
                  latency_pct=99.0, availability=0.9,
                  rules=((20.0, 1.5, 2.0),))
        engine = QueryEngine(g, store, landmarks=landmarks, config=cfg,
                             miss_policy="solve", slo=slo,
                             stats_interval_s=0, device=dev)
        frontend = ServeFrontend(
            engine, max_connections=2 * n_clients, max_inflight=2,
            shed_policy="landmark", retry_after_ms=25,
        ).start()
        host, port = frontend.address

        results: dict[str, list] = {"overload": [], "cooldown": []}
        res_lock = threading.Lock()
        client_errors: list[BaseException] = []

        def client(k: int, phase: str, rate: float, duration_s: float,
                   barrier) -> None:
            # Closed-loop paced: wait until the next send is due, send,
            # read the one response line (every request gets exactly
            # one — a missing line is a hung connection and fails the
            # bench via the socket timeout). Client k's schedule is
            # offset by k / n_clients of its period, so the phase's
            # sends are spread evenly: schedules that all start at the
            # barrier arrive in bursts of n_clients against
            # max_inflight = 2 slots, which rejects most of a burst at
            # any average rate.
            try:
                sock = _socket.create_connection((host, port), timeout=30)
                sock.settimeout(30)
                f = sock.makefile("rw", encoding="utf-8", newline="\n")
                json.loads(f.readline())  # protocol header
                crng = np.random.default_rng(1000 * (1 + k) + len(phase))
                local = []
                sent = 0
                barrier.wait()
                start = time.perf_counter()
                while True:
                    elapsed = time.perf_counter() - start
                    if elapsed >= duration_s:
                        break
                    delay = (sent + k / n_clients) / rate - elapsed
                    if delay > 0:
                        time.sleep(delay)
                    src = (int(crng.choice(warm)) if crng.random() < 0.7
                           else int(phase_cold[crng.integers(
                               len(phase_cold))]))
                    dst = int(crng.integers(n))
                    f.write(json.dumps(
                        {"id": sent, "source": src, "dst": dst}) + "\n")
                    f.flush()
                    resp = json.loads(f.readline())
                    local.append((src, dst, resp,
                                  time.perf_counter() - start))
                    sent += 1
                f.close()
                sock.close()
                with res_lock:
                    results[phase].extend(local)
            except BaseException as e:  # noqa: BLE001 — surface, don't hang
                client_errors.append(e)

        def run_phase(phase: str, total_rate: float,
                      duration_s: float) -> None:
            barrier = threading.Barrier(n_clients)
            threads = [
                threading.Thread(
                    target=client,
                    args=(k, phase, total_rate / n_clients, duration_s,
                          barrier),
                    name=f"overload-client-{phase}-{k}")
                for k in range(n_clients)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        t0 = time.perf_counter()
        run_phase("overload", 2.0 * capacity_qps, overload_s)
        shed_after_overload = engine.stats.shed_answers
        rejected_after_overload = engine.stats.rejected
        run_phase("cooldown", 0.3 * capacity_qps, cooldown_s)
        wall = time.perf_counter() - t0
        if client_errors:
            frontend.drain()
            raise client_errors[0]

        # -- grade every response against the oracle ----------------------
        failures: list[str] = []
        all_resps = results["overload"] + results["cooldown"]
        shed_n = rejected_n = exact_n = 0
        for src, dst, r, _ in all_resps:
            if "error" in r:
                if r["error"] in ("overloaded", "deadline", "draining"):
                    rejected_n += 1
                else:
                    failures.append(f"unexpected error answer: {r}")
                continue
            want = float(exact[src, dst])
            if r.get("shed"):
                shed_n += 1
                if r.get("exact") is not False or "max_error" not in r:
                    failures.append(f"shed answer not flagged: {r}")
                    continue
                err = float(r["max_error"])
                if not np.isfinite(err):
                    failures.append(
                        f"shed answer with non-finite max_error: {r}")
                elif abs(float(r["distance"]) - want) > err + 1e-9:
                    failures.append(
                        f"shed answer outside certified bound: "
                        f"|{r['distance']} - {want}| > {err}")
            elif r.get("exact") is True:
                exact_n += 1
                if float(r["distance"]) != want:
                    failures.append(
                        f"non-shed answer not bitwise: s={src} t={dst} "
                        f"{r['distance']} != {want}")
            else:
                failures.append(f"unflagged approximate answer: {r}")

        accepted = shed_n + exact_n
        shed_frac = shed_n / max(1, accepted)
        if shed_after_overload == 0:
            failures.append(
                "overload phase shed nothing — the burn alert never "
                "engaged at 2x capacity")
        if rejected_after_overload == 0:
            failures.append(
                "overload phase rejected nothing — admission control "
                "never bit at 2x capacity")
        if shed_frac >= 0.5:
            failures.append(
                f"shed fraction {shed_frac:.3f} unbounded — most "
                "answers degraded (shedding should be a tail, not the "
                "service)")
        # Disengagement: zero shed answers in the late cooldown (the
        # short burn window has drained by then).
        shed_late = sum(
            1 for _, _, r, t in results["cooldown"]
            if r.get("shed") and t >= cooldown_s / 2
        )
        if shed_late:
            failures.append(
                f"{shed_late} shed answers in the late cooldown — "
                "shedding failed to disengage below capacity")
        # The cooldown second by second: [answers, rejected, shed] each.
        timeline = [[0, 0, 0] for _ in range(int(np.ceil(cooldown_s)))]
        for _, _, r, t in results["cooldown"]:
            slot = timeline[min(int(t), len(timeline) - 1)]
            slot[0] += 1
            slot[1] += "error" in r
            slot[2] += bool(r.get("shed"))
        verdict = engine.slo_tracker().evaluate()
        latency = verdict.get("latency") or {}
        if latency.get("met") is False:
            failures.append(
                f"accepted-traffic p{latency.get('pct')} "
                f"{latency.get('observed_ms')} ms missed the "
                f"{latency.get('target_ms')} ms target")

        pcts = engine.stats.percentiles()
        stats = engine.stats
        detail = {
            "nodes": n, "edges": g.num_real_edges,
            "clients": n_clients,
            "capacity_per_s": round(capacity_qps, 2),
            "offered_x": 2.0,
            "overload_s": overload_s, "cooldown_s": cooldown_s,
            "accepted": accepted,
            "rejected": rejected_n,
            "deadline_drops": stats.deadline_drops,
            "shed_answers": shed_n,
            "shed_frac": round(shed_frac, 4),
            "shed_late_cooldown": shed_late,
            "cooldown_timeline": timeline,
            "exact_bitwise_checked": exact_n,
            "p50_ms": round(pcts["p50_ms"], 4),
            "p50_err_ms": round(pcts["p50_err_ms"], 4),
            "p99_ms": round(pcts["p99_ms"], 4),
            "p99_err_ms": round(pcts["p99_err_ms"], 4),
            "slo": {
                "p99_target_ms": round(latency_target_ms, 3),
                "availability": slo.availability,
                "verdict": "burn" if verdict["burning"] else "ok",
                "burn_rate": verdict["burn_rate"],
                "p99_met": latency.get("met"),
            },
        }
        if failures:
            detail["failed"] = failures[:10]
        tel = _BENCH_TELEMETRY.get()
        if tel is not None and getattr(tel, "trace_dir", None):
            engine.metrics.write_snapshot(
                Path(tel.trace_dir) / "serve_overload_live.json"
            )
        frontend.drain()  # flushes snapshots + closes the engine
    return BenchRecord(
        "serve_overload", backend, preset, wall, 0, 0.0, _n_chips(),
        detail,
    )

def bench_approx_apsp(backend: str, preset: str) -> BenchRecord:
    """Config 16: exact vs certified ``hopset+bf``
    on the SAME graph and source set, at ε ∈ {0.1, 0.5}. A corridor
    lattice (aspect 16), not ER: large diameter is the regime the
    hopset tier exists for — the exact routes sweep to the diameter
    (~4x a square grid's at equal V/E) while the approximate route
    pays β hops past the relay seed. Per ε the detail records construction wall,
    query wall, hopset edge count, the measured max observed error vs
    the exact matrix, and the certified bound it must sit under — a
    single entry whose measured error exceeds its certificate lands in
    ``detail.failed`` and flunks ``bench_regress`` as a contract
    failure (the certificate is the product; a violation is a bug, not
    a slow day). ``speedup`` = exact wall / (construction + query):
    the honest end-to-end ratio, construction un-amortized."""
    from paralleljohnson_tpu_torch.graphs import grid2d
    from paralleljohnson_tpu_torch.solver.approx import approx_apsp

    short = max(2, int(np.sqrt(_sz("approx_apsp", "n", preset) / 16)))
    g = grid2d(16 * short, short, seed=23)
    n = g.num_nodes
    n_sources = min(_sz("approx_apsp", "sources", preset), n)
    rng = np.random.default_rng(11)
    sources = np.sort(rng.choice(n, size=n_sources, replace=False))

    solver = _solver(backend)
    solver.solve(g, sources)  # warm (compile) — same discipline as er1k
    t0 = time.perf_counter()
    exact_res = solver.solve(g, sources)
    exact_wall = time.perf_counter() - t0
    exact_rows = np.asarray(exact_res.matrix, np.float64)  # host rows

    detail = {
        "nodes": n, "edges": int(g.num_real_edges),
        "n_sources": int(n_sources),
        "exact_wall_s": round(exact_wall, 6),
        "exact": _routes(exact_res),
    }
    wall = exact_wall
    examined = int(exact_res.stats.edges_relaxed)
    for eps in (0.1, 0.5):
        dev = _BENCH_DEVICE.get()
        approx_apsp(g, sources, config=solver.config, epsilon=eps,
                    device=dev)  # warm
        t0 = time.perf_counter()
        res = approx_apsp(
            g, sources, config=solver.config, epsilon=eps, device=dev
        )
        approx_wall = time.perf_counter() - t0
        est = np.asarray(res.dist, np.float64)
        err = np.asarray(res.max_error, np.float64)
        # The certification contract, checked entrywise against the
        # exact matrix: wherever the certificate is finite the measured
        # error must sit under it, and a finite exact distance must
        # never be answered with an uncertified +inf.
        certified = np.isfinite(err)
        measured = np.where(
            np.isfinite(exact_rows) & np.isfinite(est),
            np.abs(est - exact_rows), 0.0,
        )
        violations = int(np.sum(certified & (measured > err)))
        wrong_inf = int(np.sum(
            certified & (np.isfinite(exact_rows) != np.isfinite(est))
        ))
        key = f"eps_{eps:g}"
        detail[key] = {
            "construction_s": round(res.stats["construction_s"], 6),
            "query_s": round(res.stats["query_s"], 6),
            "beta": res.stats["beta"],
            "hopset_edges": res.stats["hopset_edges"],
            "hopset_converged": res.stats["hopset_converged"],
            "query_converged": res.stats["query_converged"],
            "measured_max_error": round(float(measured.max()), 6),
            "certified_max_bound": (
                round(float(err[certified].max()), 6)
                if certified.any() else None
            ),
            "certified_frac": round(float(certified.mean()), 6),
            "speedup": round(exact_wall / max(approx_wall, 1e-9), 3),
        }
        if violations or wrong_inf:
            detail["failed"] = (
                f"eps={eps:g}: {violations} entries exceed their "
                f"certified bound, {wrong_inf} reachability "
                "mismatches under a finite certificate"
            )
        if eps == 0.5:
            wall = approx_wall
            examined = int(res.stats["edges_examined"])
    return BenchRecord(
        "approx_apsp", backend, preset, wall, examined,
        examined / max(wall, 1e-9), _n_chips(), detail,
    )


CONFIGS: dict[str, Callable[[str, str], BenchRecord]] = {
    "er1k_apsp": bench_er1k_apsp,
    "dimacs_ny_bf": bench_dimacs_ny_bf,
    "dimacs_ny_scrambled": bench_dimacs_ny_scrambled,
    "dimacs_ny_scrambled_pred": bench_dimacs_ny_scrambled_pred,
    "ego_fb_nsource": bench_ego_fb_nsource,
    "rmat_apsp": bench_rmat_apsp,
    "rmat_apsp_pipelined": bench_rmat_apsp_pipelined,
    "batch_small": bench_batch_small,
    "dense_apsp_fw": bench_dense_apsp_fw,
    "dirty_window": bench_dirty_window,
    "planner_dispatch": bench_planner_dispatch,
    "planner_tuning": bench_planner_tuning,
    "serve_queries": bench_serve_queries,
    "serve_overload": bench_serve_overload,
    "serve_fleet": bench_serve_fleet,
    "distributed_fleet": bench_distributed_fleet,
    "incremental_update": bench_incremental_update,
    "approx_apsp": bench_approx_apsp,
}


def run(
    names: list[str] | None = None,
    *,
    backend: str = "torch",
    preset: str = "mini",
    telemetry_dir: str | None = None,
    profile_dir: str | None = None,
    device="cuda",
) -> list[BenchRecord]:
    """Run the named configs on ``device`` (the card by default; ``"cpu"``
    runs the torch backend's plain versions). ``telemetry_dir`` turns on
    the flight recorder per config: each config's solvers record
    spans/events into ``<dir>/flight-<config>.jsonl`` (plus a Chrome
    trace ``trace-<config>.json`` and a shared ``heartbeat.json``), a
    succeeding row folds the telemetry summary into its detail, and a
    FAILED row's detail points at the flight-recorder path.

    ``profile_dir`` turns on the profile store per config: every solver
    appends its profile records there, rows carry their roofline bound
    in ``detail``, and each finished row is appended to the
    bench-regression history (``bench_history.jsonl``) so
    ``scripts/bench_regress.py`` can grade the next pass against it.

    Every row's detail carries ``platform`` (``cuda`` / ``cpu``: where
    its backend solved) and, on ``cuda``, ``device``: the card's name and
    power limit."""
    if preset not in _PRESETS:
        raise ValueError(f"preset must be one of {_PRESETS}, got {preset!r}")
    names = names or list(CONFIGS)
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        raise ValueError(
            f"unknown config(s) {unknown}; available: {sorted(CONFIGS)}"
        )
    records = []
    profile_token = (
        _BENCH_PROFILE.set(profile_dir) if profile_dir is not None else None
    )
    device_token = _BENCH_DEVICE.set(device)
    for name in names:
        tel = None
        token = None
        if telemetry_dir is not None:
            from paralleljohnson_tpu_torch.utils.telemetry import Telemetry

            tel = Telemetry.create(
                trace_dir=telemetry_dir,
                heartbeat_file=Path(telemetry_dir) / "heartbeat.json",
                label=name,
            )
            tel.progress(config=name, preset=preset, backend=backend)
            token = _BENCH_TELEMETRY.set(tel)
        t0 = time.perf_counter()
        try:
            rec = CONFIGS[name](backend, preset)
            if tel is not None:
                rec.detail["telemetry"] = tel.summary()
        except Exception as e:  # noqa: BLE001 — survive per-config death
            # A failed config writes a PARTIAL row tagged with the reason
            # instead of aborting the whole pass: every on-chip window
            # that died mid-pass so far lost the rows of the configs that
            # had already run or would have run after the crash. The
            # invariant: one row per requested config, always.
            rec = BenchRecord(
                name, backend, preset,
                time.perf_counter() - t0, 0, 0.0, 1,
                {"failed": f"{type(e).__name__}: {e}"},
            )
            if tel is not None:
                tel.event("config_failed", config=name,
                          error=type(e).__name__)
                if tel.tracer.flight_path is not None:
                    # The row is partial; the flight record has the story.
                    rec.detail["flight_recorder"] = str(
                        tel.tracer.flight_path
                    )
        finally:
            if token is not None:
                _BENCH_TELEMETRY.reset(token)
            if tel is not None:
                tel.close()
        try:
            rec.detail["platform"] = _platform(backend)
            if rec.detail["platform"] == "cuda":
                rec.detail["device"] = card_info(torch.device(device))
        except Exception:  # noqa: BLE001 — a dead device must not kill the row
            rec.detail.setdefault("platform", "unknown")
        records.append(rec)
    _BENCH_DEVICE.reset(device_token)
    if profile_token is not None:
        _BENCH_PROFILE.reset(profile_token)
    if profile_dir is not None:
        # Append each finished row to the bench-regression history next
        # to the profile store — the trajectory bench_regress grades the
        # next pass against. Failed rows are skipped by the normalizer
        # (a crash is not a measurement).
        try:
            from paralleljohnson_tpu_torch.observe.regress import (
                BenchHistory,
                normalize_record,
            )

            hist = BenchHistory(profile_dir)
            for rec in records:
                for row in normalize_record(
                    json.loads(rec.as_json_line()), source="pjtpu-bench"
                ):
                    hist.append(row)
        except Exception as e:  # noqa: BLE001 — history is never fatal
            import sys

            print(f"warning: bench history append failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
    return records


# -- BASELINE.md maintenance -------------------------------------------------

_MARKER_BEGIN = "<!-- bench:begin -->"
_MARKER_END = "<!-- bench:end -->"


def _parse_bench_rows(text: str) -> dict[tuple[str, str, str], str]:
    """Existing bench-block rows keyed by (config, backend, preset)."""
    rows: dict[tuple[str, str, str], str] = {}
    if _MARKER_BEGIN not in text or _MARKER_END not in text:
        return rows
    block = text.split(_MARKER_BEGIN, 1)[1].split(_MARKER_END, 1)[0]
    for line in block.strip().splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) >= 3 and cells[0] not in ("config", "---"):
            rows[(cells[0], cells[1], cells[2])] = line.rstrip()
    return rows


def update_baseline_md(records: list[BenchRecord], path: str) -> None:
    """Rewrite the measured-numbers block (between the bench markers) of
    BASELINE.md, merging with existing rows: newest run wins per
    (config, backend, preset), other rows are preserved."""
    from pathlib import Path

    p = Path(path)
    text = p.read_text() if p.exists() else "# BASELINE\n"
    rows = _parse_bench_rows(text)
    for r in records:
        if "failed" in r.detail and (r.config, r.backend, r.preset) in rows:
            # A failure marker must never clobber a real measurement —
            # the JSON stream records the failure; the baseline table
            # keeps the last good number.
            continue
        per_chip = r.edges_relaxed_per_sec / max(r.n_chips, 1)
        rows[(r.config, r.backend, r.preset)] = (
            f"| {r.config} | {r.backend} | {r.preset} | {r.wall_s:.3f} "
            f"| {r.edges_relaxed:,} | {per_chip:,.0f} "
            f"| {json.dumps(r.detail, sort_keys=True)} |"
        )
    lines = [
        "| config | backend | preset | wall s | edges relaxed | edges/s/chip | detail |",
        "|---|---|---|---|---|---|---|",
        *(rows[k] for k in sorted(rows)),
    ]
    block = f"{_MARKER_BEGIN}\n" + "\n".join(lines) + f"\n{_MARKER_END}"
    if _MARKER_BEGIN in text and _MARKER_END in text:
        head, rest = text.split(_MARKER_BEGIN, 1)
        _, tail = rest.split(_MARKER_END, 1)
        text = head + block + tail
    else:
        text = text.rstrip() + "\n\n## Measured results (ours)\n\n" + block + "\n"
    p.write_text(text)
