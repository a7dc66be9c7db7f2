"""One run of one cell: set-up, the measured window, the check, the
metrics.

The steps, in order: build the cell's graph from the seed on the device
(only its CSR arrays come to the host, the form the program's API
takes); load the program's kernels from a fixed directory in the
checkout; warm the solver the window uses with one request of the
cell's traffic (its own sources, so the program's memory rule picks the
batch the window will see); drive requests back to back from one client
for ``seconds``, the program in its default configuration on the
cell's cards; then free the program's state, recompute a sample of what
the window delivered with the plain reference, and read the metrics.
The window closes at the first delivery at or after ``seconds``: a rate
is the rows delivered up to that delivery over the time to it, so no
run loses or gains part of a request to where the clock happened to
stop.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

from pjbench import check, manifest

# Top-level module names a run may not load (compared whole: the
# program's own name begins with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "paralleljohnson_tpu")


def cache_dir(root: Path) -> Path:
    """Where every build and kernel cache of a run lives: a fixed
    directory inside the checkout."""
    return Path(root) / "pjbench" / ".cache"


def forbidden_loaded() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Request:
    """What one request's solve reported."""

    phase_seconds: dict
    fanout_iterations: int
    fanout_row_sweeps: float
    routes: dict
    batch: int | None


@dataclasses.dataclass
class Retained:
    """A row the window delivered, kept to be checked."""

    t: float
    source: int
    row: np.ndarray


class Run:
    """The record of one run that the entry fills and the metric readers
    read."""

    def __init__(self, cell, seed: int, seconds: float, device) -> None:
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = device
        self.chips = cell.chips
        self.setup_s = None
        self.t0 = None
        self.t0_ns = None
        self.t_close = None
        self.t_close_ns = None
        self.deliveries: list[tuple[float, int]] = []
        self.requests: list[Request] = []
        self.retained: list[Retained] = []
        self.potentials: list[tuple[float, np.ndarray]] = []
        self.host_table_s = None
        self.collective_s = None
        self.mesh = None
        self.mesh_size = 1
        self._collective0 = 0.0
        self.attempted = 0
        self.failed = 0
        self.errors: list[str] = []
        self.trace = None
        self.num_nodes = 0
        self.num_edges = 0

    # -- the window ----------------------------------------------------------

    def open_window(self) -> None:
        self.t0_ns = time.time_ns()
        self.t0 = time.perf_counter()
        if self.mesh is not None:
            self._collective0 = self.mesh.collective_s

    @property
    def closed(self) -> bool:
        return self.t_close is not None

    def deliver(self, rows: int) -> float:
        """Record ``rows`` delivered now; the first delivery at or after
        the window's length closes it. Returns the time."""
        t = time.perf_counter()
        if self.t_close is None:
            self.deliveries.append((t, int(rows)))
            if t - self.t0 >= self.seconds:
                self.t_close, self.t_close_ns = t, time.time_ns()
                if self.mesh is not None:
                    self.collective_s = self.mesh.collective_s - self._collective0
        return t

    def request_failed(self, e: BaseException) -> None:
        """Count a request that raised; past the window's length the
        failure closes it (nothing more can be delivered in time)."""
        self.failed += 1
        self.errors.append(f"{type(e).__name__}: {e}"[:500])
        if time.perf_counter() - self.t0 >= self.seconds:
            self.deliver(0)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t0

    def in_window(self, t: float) -> bool:
        return self.t_close is not None and t <= self.t_close

    def record_request(self, stats) -> None:
        e = max(self.num_edges, 1)
        self.requests.append(Request(
            phase_seconds=dict(stats.phase_seconds),
            fanout_iterations=int(stats.iterations_by_phase.get("fanout", 0)),
            fanout_row_sweeps=stats.edges_relaxed_by_phase.get("fanout", 0) / e,
            routes=dict(stats.routes_by_phase),
            batch=stats.final_batch,
        ))

    def sources(self, k: int) -> np.ndarray:
        """Request ``k``'s sources: distinct, drawn from the seed."""
        t = self.cell.traffic
        rng = np.random.default_rng([self.seed, 1, k])
        pick = rng.choice(self.pool.shape[0], int(t["sources_per_request"]),
                          replace=False)
        return self.pool[pick].astype(np.int64)

    def keep_at(self, k: int, batch_idx: int, n: int, count: int) -> np.ndarray:
        """Positions, drawn from the seed, of the rows of request ``k``'s
        batch ``batch_idx`` (of ``n`` rows) kept to be checked."""
        rng = np.random.default_rng([self.seed, 2, k, batch_idx])
        return np.sort(rng.choice(n, min(count, n), replace=False))


def _source_pool(csr: dict, kind: str) -> np.ndarray:
    if kind == "all":
        return np.arange(len(csr["indptr"]) - 1, dtype=np.int64)
    if kind == "non_isolated":
        return np.flatnonzero(np.diff(csr["indptr"]) > 0).astype(np.int64)
    raise ValueError(f"unknown source pool {kind!r}")


def _mesh_shape(traffic: dict, chips: int, device):
    import torch

    mesh = traffic.get("mesh", "one_card")
    if mesh == "one_card":
        return (1,)
    if mesh == "every_card":
        if device.type == "cuda" and torch.cuda.device_count() > chips:
            return (chips,)
        return None
    raise ValueError(f"unknown mesh {mesh!r}")


def _devices(run: Run):
    import torch

    if run.device.type != "cuda":
        return []
    return list(range(min(run.chips, torch.cuda.device_count())))


def _free_device_memory() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             log=print) -> dict:
    """One run of ``workload``; returns the result line's object (the
    check's numbers last). ``t_start`` is when the process started (the
    set-up's origin)."""
    import torch

    import paralleljohnson_tpu_torch as pjt

    t_start = time.perf_counter() if t_start is None else t_start
    root = Path(root)
    cell = manifest.cell(root, workload)
    device = torch.device(device)
    run = Run(cell, seed, seconds, device)
    conf, traffic = cell.config, cell.traffic
    entry = manifest.entry(root, traffic["entry"])

    log(f"imports {time.perf_counter() - t_start:.3f} s")
    # Set-up: the graph, from the seed, on the device.
    gen = manifest.generator(root, conf["generator"])
    csr = gen.build(conf, seed, device)
    _free_device_memory()
    graph = pjt.CSRGraph(csr["indptr"], csr["indices"], csr["weights"])
    log(f"graph {time.perf_counter() - t_start:.3f} s")
    run.num_nodes, run.num_edges = graph.num_nodes, graph.num_real_edges
    run.pool = _source_pool(csr, traffic.get("source_pool", "all"))

    for d in _devices(run):
        torch.cuda.reset_peak_memory_stats(d)

    base = pjt.SolverConfig(
        precision=conf.get("precision", "f32"),
        mesh_shape=_mesh_shape(traffic, cell.chips, device),
        compilation_cache_dir=str(cache_dir(root) / "kernels"),
    )
    solver = pjt.ParallelJohnsonSolver(base, device=device)
    mesh = solver.backend._mesh()
    run.mesh_size = mesh.size
    run.mesh = mesh if mesh.size > 1 else None

    # Warm-up: one request of the cell's traffic, through the same solver.
    try:
        entry.warm(run, solver, graph, run.sources(0))
    except Exception as e:  # noqa: BLE001 — counted; the window tries again
        run.attempted += 1
        run.failed += 1
        run.errors.append(f"warm-up: {type(e).__name__}: {e}"[:500])
    if device.type == "cuda":
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up {run.setup_s:.3f} s: V={run.num_nodes} E={run.num_edges} "
        f"mesh={base.mesh_shape}")

    # The window.
    prof = None
    if trace:
        from pjbench.trace import Profile

        prof = run.trace = Profile()
    with prof or contextlib.nullcontext():
        run.open_window()
        entry.drive(run, solver, graph)
    peak = max((torch.cuda.max_memory_allocated(d) for d in _devices(run)),
               default=0)
    routes = run.requests[-1].routes if run.requests else {}
    log(f"window {run.window_s:.3f} s: {len(run.deliveries)} deliveries, "
        f"{len(run.requests)} requests, routes {routes}, peak {peak}")
    for i, r in enumerate(run.requests):
        log(f"request {i + 1}: batch {r.batch} sweeps {r.fanout_iterations} "
            f"row-sweeps {r.fanout_row_sweeps:.0f} phases "
            + " ".join(f"{k}={v:.3f}" for k, v in r.phase_seconds.items()))

    # The program's state goes before the reference runs.
    solver.close()
    del solver, entry
    run.mesh = None
    _free_device_memory()
    t_check = time.perf_counter()
    numbers, checked = check.check_run(run, csr, conf)
    log(f"checked {checked} in {time.perf_counter() - t_check:.3f} s")

    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        value = manifest.metric_reader(root, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(0) if device.type == "cuda"
                    else device.type),
           "count": len(_devices(run)) or 1,
           "memory_peak_bytes": int(peak)}
    out = {
        "correct": (run.failed == 0 and checked["rows"] > 0
                    and check.passed(numbers)),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace:
        from pjbench import trace as tr

        runs = cache_dir(root).parent / ".runs"
        runs.mkdir(parents=True, exist_ok=True)
        (runs / f"{workload}.{seed}.trace.json").write_text(json.dumps(
            {"ops": tr.summary(prof.ops), "host_events": len(prof.host),
             "device_events": len(prof.ops)}, indent=1))
        lo, hi = run.t0_ns, run.t_close_ns
        devs = _devices(run) or [0]
        busy = [tr.busy_ns(prof.ops, d, lo, hi) for d in devs]
        dev["busy_s"] = sum(busy) / len(busy) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        out["breakdown"] = {
            "device_ops": tr.op_seconds(prof.ops, lo, hi),
            "idle_gaps": tr.idle_gaps(prof.ops, prof.host, devs[0], lo, hi),
        }
    if run.errors:
        out["errors"] = run.errors[:5]
    out["check"] = numbers
    return out
