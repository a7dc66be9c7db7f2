"""The persisted profile store + the calibrated cost model.

``ProfileStore`` is an append-only JSONL (``profiles.jsonl``) of
per-solve records: ``{key, analytic costs, measured wall, exact
counters, SolverStats phases, roofline}``. One record per completed
solve (the solver appends when ``SolverConfig.profile_store`` /
``PJ_PROFILE_DIR`` is set), plus whatever the off-chip validation
scripts and bench passes append. Append-only + flushed per record for
the same reason the flight recorder is: a killed pass keeps every
record it earned.

``CostModel`` is the calibration ROADMAP item 7's dispatch registry
consumes: per ``(route, platform)`` it fits *measured seconds per unit
of analytic work* — per byte accessed, per FLOP, and per edge-row
(``batch x edges``, the unit every sweep route's work scales with) —
and ``predict(route, graph, B)`` prices a prospective solve from it.
Records whose capture was unavailable still calibrate the edge-row
term (the honest fallback), so a CPU store with no ``cost_analysis``
still predicts.

Standard library only: offline readers load this module without
importing torch or numpy. The JSONL schema is the JAX package's, byte for
byte, so each package reads the other's store.
"""

from __future__ import annotations

import json
import statistics
import time
from pathlib import Path

PROFILE_FILENAME = "profiles.jsonl"


class ProfileStore:
    """Append-only JSONL profile store rooted at a directory."""

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self.path = self.root / PROFILE_FILENAME

    def append(self, record: dict) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")
            f.flush()

    def records(self) -> list[dict]:
        """All records; [] when the store has never been written. A torn
        TRAILING line (killed mid-append) is tolerated like the flight
        recorder's; anything torn earlier raises — that is corruption,
        not kill damage."""
        if not self.path.exists():
            return []
        lines = self.path.read_text(encoding="utf-8").splitlines()
        out: list[dict] = []
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    continue
                raise ValueError(
                    f"{self.path}: corrupt record at line {i + 1} "
                    "(not the last line — this is not kill damage)"
                )
        return out

    def __len__(self) -> int:
        return len(self.records())


def solve_record(
    stats,
    *,
    label: str,
    platform: str,
    route: str | None,
    num_nodes: int,
    num_edges: int,
    batch: int,
) -> dict:
    """The canonical per-solve profile record (what the solver appends).

    ``stats`` is a SolverStats; everything is read via getattr so
    stats-shaped objects from offline scripts work too."""
    g = lambda k, d=None: getattr(stats, k, d)  # noqa: E731
    phase_seconds = dict(g("phase_seconds", {}) or {})
    compute_s = sum(
        s for k, s in phase_seconds.items()
        if k in ("bellman_ford", "fanout", "batch_apsp")
    )
    cost = g("analytic_cost")
    if not cost:
        cost = {
            "cost_analysis_unavailable":
                "no compiled-cost capture ran for this solve "
                "(host backend, or capture disabled)"
        }
    return {
        "ts": time.time(),
        "kind": "solve",
        "label": label,
        "route": route,
        "platform": platform,
        "nodes": int(num_nodes),
        "edges": int(num_edges),
        "batch": int(batch),
        "routes_by_phase": dict(g("routes_by_phase", {}) or {}),
        "measured": {
            "wall_s": float(sum(phase_seconds.values())),
            "compute_s": float(compute_s),
            "phase_seconds": phase_seconds,
            "download_s": float(g("download_s", 0.0) or 0.0),
            "ckpt_wait_s": float(g("ckpt_wait_s", 0.0) or 0.0),
            "overlap_saved_s": float(g("overlap_saved_s", 0.0) or 0.0),
        },
        "edges_relaxed": int(g("edges_relaxed", 0) or 0),
        # Iterations-to-converge across the compute phases:
        # the input the CostModel's per-iteration calibration fits, so
        # high-diameter graphs price by how long they actually iterate
        # instead of a single solve-level wall.
        "iterations": int(
            sum((g("iterations_by_phase", {}) or {}).values())
        ),
        "convergence": g("convergence"),
        "cost": cost,
        "roofline": g("roofline"),
        "predicted_s": g("predicted_s"),
    }


def _median(xs: list[float]) -> float | None:
    return statistics.median(xs) if xs else None


class CostModel:
    """Per-(route, platform) calibration fitted from a profile store.

    Entry fields:
      s_per_edge_row — measured compute seconds per (batch x edges)
        unit; always available (the fallback calibration).
      s_per_byte / s_per_flop — measured seconds per analytic byte /
        FLOP, only from records whose capture succeeded.
      bytes_per_edge_row / flops_per_edge_row — analytic density
        (median), used to extrapolate analytic costs to a prospective
        shape.
      s_per_edge_row_iter / median_iterations — the ITERATIONS term:
        seconds per (batch x edges x iteration) unit, fitted
        from records that carry ``iterations`` (solve records written
        with the convergence observatory on; ``kind: "trajectory"``
        records contribute iteration samples). An iterative route's
        wall scales with iterations-to-converge — pure edge-row pricing
        silently assumed every graph converges like the calibration
        graph, which lies on high-diameter inputs. ``predict`` prefers
        this basis whenever it is fitted.

    The per-unit seconds are the MINIMUM over the key's samples, not
    the median: timing noise is one-sided (compile time in a key's
    first record, scheduler contention) and only ever inflates, so the
    min is the steady-state cost — the same reason ``bench.py`` reports
    min-of-repeats. Densities are shape ratios, not timings, so they
    take the median (iterations too — a count, not a timing)."""

    def __init__(self, entries: dict) -> None:
        self.entries = entries

    @classmethod
    def fit(cls, source) -> "CostModel":
        """``source`` is a ProfileStore or a record list."""
        records = source.records() if hasattr(source, "records") else source
        samples: dict[tuple, dict] = {}

        def bucket(route, platform):
            return samples.setdefault(
                (route, platform),
                {"s_edge_row": [], "s_byte": [], "s_flop": [],
                 "bytes_er": [], "flops_er": [], "compute": [],
                 "s_er_iter": [], "iterations": []},
            )

        for r in records:
            route = r.get("route")
            platform = r.get("platform")
            if r.get("kind") == "trajectory":
                # Per-iteration trajectory records carry no measured
                # wall of their own — they contribute iteration
                # samples to the key's median_iterations only.
                iters = (r.get("summary") or {}).get("iterations")
                if route and platform and iters:
                    bucket(route, platform)["iterations"].append(
                        int(iters)
                    )
                continue
            if r.get("kind") not in (None, "solve", "bench", "offchip",
                                     "repair"):
                # "repair" records calibrate like solves:
                # route "incremental-repair" lands in the same priced
                # table, so dispatch can compare repair-vs-resolve.
                continue
            measured = r.get("measured") or {}
            compute = measured.get("compute_s") or measured.get("wall_s")
            edges = r.get("edges") or 0
            batch = r.get("batch") or 1
            if not route or not platform or not compute or compute <= 0:
                continue
            edge_rows = float(batch) * float(edges)
            if edge_rows <= 0:
                continue
            s = bucket(route, platform)
            s["s_edge_row"].append(compute / edge_rows)
            s["compute"].append(compute)
            iters = r.get("iterations")
            if iters and iters > 0:
                s["iterations"].append(int(iters))
                s["s_er_iter"].append(compute / (edge_rows * iters))
            cost = r.get("cost") or {}
            by = cost.get("bytes_accessed")
            fl = cost.get("flops")
            if by and by > 0:
                s["s_byte"].append(compute / by)
                s["bytes_er"].append(by / edge_rows)
            if fl and fl > 0:
                s["s_flop"].append(compute / fl)
                s["flops_er"].append(fl / edge_rows)
        entries = {}
        for key, s in samples.items():
            if not s["s_edge_row"]:
                continue  # iteration-only samples cannot price a route
            entries[key] = {
                "route": key[0],
                "platform": key[1],
                "n": len(s["s_edge_row"]),
                "s_per_edge_row": min(s["s_edge_row"]),
                "s_per_byte": min(s["s_byte"]) if s["s_byte"] else None,
                "s_per_flop": min(s["s_flop"]) if s["s_flop"] else None,
                "bytes_per_edge_row": _median(s["bytes_er"]),
                "flops_per_edge_row": _median(s["flops_er"]),
                "median_compute_s": _median(s["compute"]),
                "s_per_edge_row_iter": (
                    min(s["s_er_iter"]) if s["s_er_iter"] else None
                ),
                "median_iterations": _median(s["iterations"]),
            }
        return cls(entries)

    def _entry(self, route: str, platform: str | None):
        if platform is not None:
            return self.entries.get((route, platform))
        matches = [e for (r, _), e in self.entries.items() if r == route]
        return matches[0] if len(matches) == 1 else None

    def predict(
        self,
        route: str,
        graph=None,
        batch: int = 1,
        *,
        num_edges: int | None = None,
        platform: str | None = None,
        iterations: int | None = None,
    ) -> dict | None:
        """Price a prospective ``(route, graph, B)`` solve from the
        calibration. ``graph`` may be a CSRGraph (its
        ``num_real_edges`` is used) or omitted in favor of
        ``num_edges``. None when the model has no data for the key —
        an unpriced route must read as unpriced, not free.

        ``iterations``: expected iterations-to-converge (a diameter
        estimate, or a measured trajectory's count). When the key has a
        fitted per-iteration calibration the prediction becomes
        ``s_per_edge_row_iter x edge_rows x iterations`` (basis
        ``"s_per_edge_row_iter"``) — with ``iterations=None`` the key's
        observed ``median_iterations`` stands in, so iterative routes
        are priced by how long they iterate, not by one solve-level
        wall (keeps the dispatch registry honest on
        high-diameter graphs)."""
        if num_edges is None and graph is not None:
            num_edges = int(
                getattr(graph, "num_real_edges", 0)
                or getattr(graph, "num_edges", 0)
            )
        if not num_edges or num_edges <= 0:
            return None
        e = self._entry(route, platform)
        if e is None or not e.get("s_per_edge_row"):
            return None
        edge_rows = float(batch) * float(num_edges)
        predicted = e["s_per_edge_row"] * edge_rows
        basis = "s_per_edge_row"
        iters = (
            iterations if iterations is not None
            else e.get("median_iterations")
        )
        if e.get("s_per_edge_row_iter") and iters:
            predicted = e["s_per_edge_row_iter"] * edge_rows * float(iters)
            basis = "s_per_edge_row_iter"
        # Analytic pricing when the key's capture succeeded: extrapolate
        # bytes by density, then apply the measured seconds-per-byte —
        # the same number by construction on in-sample shapes, but it
        # carries the bytes/FLOPs breakdown the roofline preview wants.
        analytic = {}
        if e.get("bytes_per_edge_row") and e.get("s_per_byte"):
            analytic["bytes_accessed"] = e["bytes_per_edge_row"] * edge_rows
            analytic["hbm_s"] = analytic["bytes_accessed"] * e["s_per_byte"]
        if e.get("flops_per_edge_row") and e.get("s_per_flop"):
            analytic["flops"] = e["flops_per_edge_row"] * edge_rows
            analytic["flop_s"] = analytic["flops"] * e["s_per_flop"]
        out = {
            "route": route,
            "platform": e["platform"],
            "predicted_s": predicted,
            "basis": basis,
            "n": e["n"],
            **analytic,
        }
        if basis == "s_per_edge_row_iter":
            out["iterations"] = float(iters)
        return out

    def table(self) -> list[dict]:
        """The priced route table (``cli info`` / cost_report): one row
        per (route, platform) with the fitted calibration."""
        return [
            self.entries[k] for k in sorted(self.entries)
        ]
