#!/usr/bin/env python3
"""Run chip_smoke's phase 24 (the mesh: ``parallel.mesh`` on ranks that
share one CUDA card) on its own.

    python3 scripts/torch_mesh.py
    python3 scripts/torch_mesh.py --processes 4

Builds the hand kernels (as chip_smoke's phase 1 does), solves what
phase 24 is held against on the single card (phase 3's R-MAT-20 rows over
512 sources on ``pallas-vm``; phase 13's rows of the negative 512x512 grid
over phase 4's 256 sources with trees), then runs ``chip_smoke.drive_mesh``.
Prints the card's name and power limit, each step's JSON line and the
launch counts by path; exits 1 if the phase failed.

``--processes N`` runs only phase 24's multi-process path
(``chip_smoke.mesh_processes``) with N processes in place of two: a
process per card where there are N cards, so NCCL; gloo where they
share. Its rows are held bitwise to a single-card solve.

``--cards`` (two cards or more, e.g. four) drives and times
the default mesh over every card (``mesh_shape=None``, a rank per card,
the in-process exchange copying between the cards) against one card
(``mesh_shape=(1,)``) in the same process, each
row held bitwise to the one card's, in this order: R-MAT-20 over phase
3's 512 sources at f64, without and with trees, then at f32 with and
without trees (the wall, the solve's phase seconds, the collectives,
and a split of the fan-out into each rank's copy of the in-edge CSC,
its fixpoint, and the assembly on the caller's card); chip_smoke's
phase 27 (``drive_every_card``) on those one-card rows; the negative
integer R-MAT-20's phase 1 (``edge-sharded`` against one card's route)
at f32 and f64; ``sharded-2d+pred`` on a 2 x 2 mesh over 64 sources; an
in-process fleet and a two-worker local fleet under the default config;
a serving miss (a fresh engine on every card against one on one card);
an incremental repair of the 80 x 80 lattice (every card against one
card, each on its own copy of the checkpoint); ``--first-use``'s
in-process rows (a fresh solver, a fresh engine). Every row carries a
``brief`` beside one card's: the wall, upload, fan-out, collective and
assembly seconds where the row has them. Trees are checked with
``validate_pred_tree``. Prints ``nvidia-smi topo -m`` and, first, the
``--links`` line, then one JSON line per row; exits 1 if a check fails.

``--links`` (two cards or more) prints, for each ordered pair of cards,
whether it has peer access (``Mesh.peer_access``, which makes the pair's
first copy) and one timed copy of 256 MiB from one card to the other
(after an untimed one; host clock around the copy and a synchronize of
both cards): its seconds and GB/s.

``--first-use`` (two cards or more) times what a caller pays whose solve
builds the default mesh afresh, against ``mesh_shape=(1,)``, in turns
(one card, then every card, ``--repeats`` times): a command-line solve
(``python -m paralleljohnson_tpu_torch solve``, the process's wall from
start to exit), a fresh solver's solve of a small graph (R-MAT-12, 64
sources: upload, mesh, the exchange's first run and the mesh's close
included), and a fresh serving engine's first miss on the same graph;
each row bitwise one card's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=None)
    ap.add_argument("--cards", action="store_true")
    ap.add_argument("--first-use", action="store_true")
    ap.add_argument("--links", action="store_true")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_mesh: no CUDA card", file=sys.stderr)
        return 2

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.ops import _cuda
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _cuda.build_all()
    chip_smoke.emit({"build_s": time.perf_counter() - t0})
    if args.links:
        try:
            links()
        except Exception:  # noqa: BLE001 — report and exit non-zero
            traceback.print_exc()
            return 1
        return 0
    if args.cards or args.first_use:
        try:
            (every_card if args.cards else first_use)(dev, args.repeats)
        except Exception:  # noqa: BLE001 — report and exit non-zero
            traceback.print_exc()
            return 1
        return 0
    if args.processes:
        try:
            chip_smoke.emit(chip_smoke.mesh_processes(args.processes, dev))
        except Exception:  # noqa: BLE001 — report and exit non-zero
            traceback.print_exc()
            return 1
        return 0
    t0 = time.perf_counter()
    rmat = pjt.load_graph(chip_smoke.RMAT_SPEC)
    rmat_sources = np.sort(np.random.default_rng(1).choice(
        rmat.num_nodes, 512, replace=False))
    rmat_rows = to_numpy(chip_smoke.solver_on(dev).solve(
        rmat, rmat_sources).dist)
    grid = pjt.load_graph(chip_smoke.GRID_SPEC)
    gsrc = np.sort(np.random.default_rng(2).choice(
        grid.num_nodes, 256, replace=False))
    grid_pred_rows = to_numpy(chip_smoke.solver_on(dev).solve(
        grid, gsrc, predecessors=True).dist)
    chip_smoke.emit({"single_card_rows_s": time.perf_counter() - t0})
    try:
        launches = chip_smoke.drive_mesh(dev, rmat, rmat_sources, rmat_rows,
                                         grid, gsrc, grid_pred_rows)
    except Exception:  # noqa: BLE001 — report and exit non-zero
        traceback.print_exc()
        return 1
    chip_smoke.emit({"launches_by_path": launches, "power_limit": smi})
    return 0


NEG_SEED = 5  # the negative R-MAT-20's potentials
LINK_BYTES = 256 << 20  # --links: one copy's size
FIRST_SPEC = "rmat:scale=12,ef=8,seed=4"  # --first-use's small graph
FIRST_SOURCES = 64
FLEET_SOURCES = 256
FLEET_LEASE = 64
MISS_SOURCES = 8


def _negative(g, seed=NEG_SEED):
    """``g``'s weights x8 rounded, plus a random integer potential
    difference p(u) - p(v): negative weights, no negative cycle (a
    cycle's sum is unchanged), integer sums on every route."""
    import numpy as np

    p = np.random.default_rng(seed).integers(0, 24, g.num_nodes)
    w = np.round(g.weights * 8) + p[g.src] - p[g.indices]
    return g.with_weights(w.astype(np.float32))


class _Split:
    """Wraps the mesh module's placement, fixpoint and assembly with a
    synchronize after each, timing them by thread (the placement runs in
    the caller's thread before the ranks start, the fixpoints in the rank
    threads): what a split run spends where (the syncs cost the run its
    overlap, so the wall is taken from runs without it)."""

    def __init__(self, mesh_mod):
        import threading

        import torch

        self.mod, self.torch = mesh_mod, torch
        self.lock = threading.Lock()
        self.seconds: dict = {}
        self.saved = {}

    def _add(self, key, secs):
        import threading

        name = threading.current_thread().name
        with self.lock:
            per = self.seconds.setdefault(key, {})
            per[name] = per.get(name, 0.0) + secs

    def _wrap(self, fn, key, dev_of):
        torch = self.torch

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize(dev_of(args, kw, out))
            self._add(key, time.perf_counter() - t0)
            return out
        return timed

    def __enter__(self):
        mod = self.mod
        self.saved = {"place": mod._Placer.__call__,
                      "fixpoint": mod.fanout_fixpoint,
                      "assemble": mod._assemble}
        place = self._wrap(self.saved["place"], "copy_to_rank_s",
                           lambda a, kw, out: a[2])
        mod._Placer.__call__ = lambda slf, obj, dev, key: place(
            slf, obj, dev, key)
        mod.fanout_fixpoint = self._wrap(
            self.saved["fixpoint"], "fixpoint_s",
            lambda a, kw, out: out[0].device)
        mod._assemble = self._wrap(self.saved["assemble"], "assembly_s",
                                   lambda a, kw, out: a[1])
        return self

    def __exit__(self, *exc):
        self.mod._Placer.__call__ = self.saved["place"]
        self.mod.fanout_fixpoint = self.saved["fixpoint"]
        self.mod._assemble = self.saved["assemble"]


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def brief(wall_s, phases=None, *, collective_s=None, assembly_s=None):
    """A row's headline numbers for one side: the median wall of the
    timed runs, the last run's upload, phase-1 and fan-out seconds, the
    collectives' host seconds per run (0 on one card, which has none)
    and the assembly of the ranks' rows on the caller's card (None where
    nothing is assembled)."""
    phases = phases or {}
    walls = wall_s if isinstance(wall_s, list) else [wall_s]
    return {"wall_s": _median(walls), "upload_s": phases.get("upload"),
            "bellman_ford_s": phases.get("bellman_ford"),
            "fanout_s": phases.get("fanout"), "collective_s": collective_s,
            "assembly_s": assembly_s}


def every_card(dev, repeats: int) -> None:
    """``--cards``: see the module docstring. Raises on a failed check."""
    import shutil
    import subprocess
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch import distributed
    from paralleljohnson_tpu_torch.distributed.launch import (
        run_in_process_fleet,
    )
    from paralleljohnson_tpu_torch.graphs import grid2d
    from paralleljohnson_tpu_torch.incremental import (
        IncrementalState, repair_checkpoint,
    )
    from paralleljohnson_tpu_torch.parallel import mesh as mesh_mod
    from paralleljohnson_tpu_torch.serve import QueryEngine, TileStore
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy
    from paralleljohnson_tpu_torch.utils.checkpoint import (
        BatchCheckpointer, graph_digest,
    )
    from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

    cards = torch.cuda.device_count()
    if cards < 2:
        raise AssertionError(f"--cards needs two cards or more; {cards} "
                             "visible")
    os.environ.pop(mesh_mod.MESH_DEVICES_ENV, None)
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60).stdout
    links()
    chip_smoke.emit({"cards": cards, "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "topo": [ln.rstrip() for ln in topo.splitlines() if ln.strip()]})
    sync = chip_smoke.sync_time

    def one(**kw):
        return chip_smoke.solver_on(dev, **kw)

    def every(**kw):
        return pjt.ParallelJohnsonSolver(pjt.SolverConfig(**kw), device=dev)

    def walls(solver, *args, **kw):
        """(the last result, host seconds of each of ``repeats`` solves
        after a warm-up, the last solve's phase seconds)."""
        solver.solve(*args, **kw)
        secs = []
        for _ in range(repeats):
            res, s = sync(lambda: solver.solve(*args, **kw))
            secs.append(s)
        return res, secs, dict(res.stats.phase_seconds)

    def same(got, want, label):
        if not np.array_equal(got, want):
            bad = np.argwhere(got != want)[:4].tolist()
            raise AssertionError(f"{label}: rows differ from one card's at "
                                 f"{bad}")

    def trees_valid(g, rows, pred, srcs, every_nth=1):
        check = np.arange(0, len(srcs), every_nth)
        validate_pred_tree(g, rows[check], pred[check],
                           np.asarray(srcs)[check])
        return len(check)

    failed = []

    @contextlib.contextmanager
    def row(name):
        """One row: a failed check is printed and recorded, and the next
        rows still run (``every_card`` raises at the end)."""
        t0 = time.perf_counter()
        try:
            yield
        except Exception:  # noqa: BLE001 — the failure is the row's result
            traceback.print_exc()
            failed.append(name)
            chip_smoke.emit({"path": name, "failed": True,
                             "seconds": time.perf_counter() - t0})
        finally:
            torch.cuda.empty_cache()

    rmat = pjt.load_graph(chip_smoke.RMAT_SPEC)
    sources = np.sort(np.random.default_rng(1).choice(
        rmat.num_nodes, 512, replace=False))
    # -- R-MAT-20, 512 sources: f64 then f32, without and with trees ----------
    ones = {}
    for label, kw, trees in (("f64", {"precision": "f64"}, False),
                             ("f64_trees", {"precision": "f64"}, True),
                             ("f32_trees", {}, True), ("f32", {}, False)):
        with row(f"rmat20_{label}"):
            with one(**kw) as s1:
                r1, w1, p1 = walls(s1, rmat, sources, predecessors=trees)
            want, want_pred = to_numpy(r1.dist), None
            if trees:
                want_pred = to_numpy(r1.predecessors)
            else:
                ones[label] = want
            route1 = dict(r1.stats.routes_by_phase)
            del r1
            with every(**kw) as sn:
                rn, wn, pn = walls(sn, rmat, sources, predecessors=trees)
                mesh = sn.backend._mesh()
                coll = mesh.collective_s
                with _Split(mesh_mod) as split:
                    c0 = mesh.collective_s
                    _, split_s = sync(lambda: sn.solve(rmat, sources,
                                                       predecessors=trees))
                    split_coll = mesh.collective_s - c0
                describe, backends = mesh.describe(), mesh.backends()
            routes = dict(rn.stats.routes_by_phase)
            want_route = "sharded-1d+pred" if trees else "sharded-1d"
            if mesh.size != cards or backends != ["threads"] or routes != {
                    "fanout": want_route}:
                raise AssertionError(
                    f"{label}: {describe} {backends} {routes}")
            same(to_numpy(rn.dist), want, f"R-MAT-20 {label}")
            extra = {}
            if trees:
                pred = to_numpy(rn.predecessors)
                extra["pred_bitwise_one_card"] = bool(
                    np.array_equal(pred, want_pred))
                extra["trees_checked"] = trees_valid(
                    rmat, to_numpy(rn.dist), pred, sources, 37)
            chip_smoke.emit({
                "path": f"rmat20_{label}", "sources": len(sources),
                "brief": {"one_card": brief(w1, p1, collective_s=0.0),
                          "every_card": brief(
                              wn, pn, collective_s=coll / (repeats + 1),
                              assembly_s=sum(split.seconds.get(
                                  "assembly_s", {}).values()))},
                "one_card": {"route": route1, "wall_s": w1, "phases": p1},
                "every_card": {"route": routes, "mesh": describe,
                               "wall_s": wn, "phases": pn,
                               "collective_s_per_solve":
                                   coll / (repeats + 1)},
                "split_run": {"wall_s": split_s, "collective_s": split_coll,
                              **split.seconds},
                "rows_bitwise_one_card": True, **extra})
            del rn, want, want_pred
    # -- chip_smoke's phase 27 on the one-card rows ---------------------------
    with row("phase27"):
        every32, every64 = chip_smoke.drive_every_card(
            dev, rmat, sources, ones["f32"], ones["f64"])
        chip_smoke.emit({"path": "phase27_launches", **every32, **every64})
    del ones
    # -- the negative integer R-MAT-20: phase 1, f32 and f64 ------------------
    neg = _negative(rmat)
    src64 = sources[:64]
    for label, kw in (("f32", {}), ("f64", {"precision": "f64"})):
        with row(f"rmat20_negative_phase1_{label}"):
            with one(**kw) as s1:
                r1, w1, p1 = walls(s1, neg, src64)
            with every(**kw) as sn:
                rn, wn, pn = walls(sn, neg, src64)
                emesh, fmesh = sn.backend._edge_mesh(), sn.backend._mesh()
                ecoll = emesh.collective_s / (repeats + 1)
                fcoll = fmesh.collective_s / (repeats + 1)
                edescribe = emesh.describe()
            phase1 = rn.stats.routes_by_phase.get("bellman_ford")
            if phase1 != "edge-sharded":
                raise AssertionError(f"negative R-MAT-20 {label}: "
                                     f"{rn.stats.routes_by_phase}")
            same(to_numpy(rn.dist), to_numpy(r1.dist),
                 f"negative R-MAT-20 {label}")
            same(to_numpy(rn.potentials), to_numpy(r1.potentials),
                 f"negative R-MAT-20 {label} potentials")
            chip_smoke.emit({
                "path": f"rmat20_negative_phase1_{label}",
                "sources": len(src64),
                "brief": {"one_card": brief(w1, p1, collective_s=0.0),
                          "every_card": brief(wn, pn,
                                              collective_s=ecoll + fcoll)},
                "one_card": {"routes": dict(r1.stats.routes_by_phase),
                             "iterations": dict(r1.stats.iterations_by_phase),
                             "wall_s": w1, "phases": p1},
                "every_card": {"routes": dict(rn.stats.routes_by_phase),
                               "iterations":
                                   dict(rn.stats.iterations_by_phase),
                               "wall_s": wn, "phases": pn,
                               "edge_mesh": edescribe,
                               "phase1_collective_s": ecoll,
                               "fanout_collective_s": fcoll},
                "rows_bitwise_one_card": True})
            del r1, rn
    del neg
    # -- sharded-2d+pred on a 2 x 2 mesh --------------------------------------
    if cards >= 4:
        with row("rmat20_sharded_2d_pred"):
            with one() as s1:
                r1, w1, p1 = walls(s1, rmat, src64, predecessors=True)
            with every(mesh_shape=(2, 2)) as sn:
                rn, wn, pn = walls(sn, rmat, src64, predecessors=True)
                m2 = sn.backend._mesh()
                coll2 = m2.collective_s / (repeats + 1)
                d2 = m2.describe()
            if rn.stats.routes_by_phase != {"fanout": "sharded-2d+pred"}:
                raise AssertionError(f"2-D: {rn.stats.routes_by_phase}")
            same(to_numpy(rn.dist), to_numpy(r1.dist), "2-D R-MAT-20")
            checked = trees_valid(rmat, to_numpy(rn.dist),
                                  to_numpy(rn.predecessors), src64)
            chip_smoke.emit({
                "path": "rmat20_sharded_2d_pred", "sources": len(src64),
                "brief": {"one_card": brief(w1, p1, collective_s=0.0),
                          "every_card": brief(wn, pn, collective_s=coll2)},
                "one_card": {"routes": dict(r1.stats.routes_by_phase),
                             "wall_s": w1, "phases": p1},
                "every_card": {"routes": dict(rn.stats.routes_by_phase),
                               "mesh": d2, "wall_s": wn, "phases": pn,
                               "collective_s_per_solve": coll2},
                "rows_bitwise_one_card": True, "trees_checked": checked})
            del r1, rn
    # -- the fleet under the default config ----------------------------------
    grid = pjt.load_graph(chip_smoke.GRID_SPEC)
    fsrc = np.arange(FLEET_SOURCES)
    with one() as s1:
        r1, w1 = sync(lambda: s1.solve(grid, fsrc))
    want = r1.matrix
    root = Path(tempfile.mkdtemp(prefix="pj-cards-"))
    try:
        with row("fleet_default_config"):
            out = {}
            for label, workers in (("in_process", 2), ("local_fleet", 2)):
                coord = distributed.plan_fleet(
                    root / label, chip_smoke.GRID_SPEC, n_workers=workers,
                    num_sources=FLEET_SOURCES, lease_sources=FLEET_LEASE)
                if label == "in_process":
                    report, secs = sync(lambda: run_in_process_fleet(
                        coord, workers, device=dev))
                else:
                    report, secs = sync(
                        lambda: distributed.launch_local_fleet(
                            coord, workers, poll_s=0.25, timeout_s=300,
                            device=dev))
                if not report.ok or set(report.worker_rcs.values()) != {0}:
                    raise AssertionError(f"{label}: {report.as_dict()}")
                rows = distributed.fleet_rows(coord.dir)
                for s in fsrc:
                    same(rows[int(s)], want[s], f"{label} source {s}")
                devices = sorted(
                    {json.loads(coord.worker_summary_path(w).read_text())
                     .get("device", "?") for w in report.worker_rcs})
                out[label] = {"wall_s": secs, "workers": workers,
                              "leases": report.leases_total,
                              "worker_devices": devices}
            chip_smoke.emit({"path": "fleet_default_config",
                             "spec": chip_smoke.GRID_SPEC,
                             "sources": FLEET_SOURCES,
                             "brief": {
                                 "one_card": brief(w1, r1.stats.phase_seconds,
                                                   collective_s=0.0),
                                 **{k: brief(v["wall_s"])
                                    for k, v in out.items()}},
                             **out, "rows_bitwise_one_card": True})
            del r1, want
        # -- a serving miss: a fresh engine on one card, then every card ------
        with row("serve_miss"):
            miss = grid.num_nodes // 2 + np.arange(MISS_SOURCES)
            serve = {}
            answers = {}
            for label, shape in (("one_card", (1,)), ("every_card", None)):
                engine = QueryEngine(
                    grid, TileStore(None, grid), stats_interval_s=0,
                    config=pjt.SolverConfig(mesh_shape=shape), device=dev)
                try:
                    first, first_s = sync(
                        lambda: engine.query(int(miss[0])))
                    batch, batch_s = sync(lambda: engine.query_batch(
                        [{"source": int(s)} for s in miss[1:]]))
                    mesh = engine.solver.backend._mesh()
                    serve[label] = {"mesh": mesh.describe(),
                                    "one_miss_s": first_s,
                                    "batch_s": batch_s,
                                    "collective_s": mesh.collective_s}
                finally:
                    engine.close()
                answers[label] = [np.asarray(a["distances"], np.float32)
                                  for a in [first, *batch]]
            for i, (got, want) in enumerate(zip(answers["every_card"],
                                                answers["one_card"])):
                same(got, want, f"serving miss {i}")
            chip_smoke.emit({"path": "serve_miss",
                             "spec": chip_smoke.GRID_SPEC,
                             "batch_of_misses": len(miss) - 1,
                             "brief": {
                                 k: brief(v["one_miss_s"],
                                          collective_s=v["collective_s"])
                                 for k, v in serve.items()},
                             **serve, "rows_bitwise_one_card": True})
        # -- an incremental repair: one card, then every card -----------------
        with row("repair_default_config"):
            side = chip_smoke.REPAIR_SIDE
            g = grid2d(side, side, seed=17)
            g = g.with_weights(np.maximum(1.0, np.rint(g.weights)).astype(
                np.float32))
            repair, repaired, updates = {}, {}, None
            for label, shape in (("one_card", (1,)), ("every_card", None)):
                ck = root / f"repair_{label}"
                cfg = pjt.SolverConfig(checkpoint_dir=str(ck),
                                       mesh_shape=shape)
                with pjt.ParallelJohnsonSolver(cfg, device=dev) as s:
                    _, solve_s = sync(lambda: s.solve(g))

                def attach():
                    st = IncrementalState.build(g, config=cfg, device=dev)
                    st.save(BatchCheckpointer(
                        ck, graph_key=graph_digest(g)).dir)
                    return st

                state, attach_s = sync(attach)
                if updates is None:
                    target = int(np.bincount(state.labels).argmax())
                    e = g.num_real_edges
                    within = np.flatnonzero(
                        (state.labels[g.src[:e]] == target)
                        & (state.labels[g.indices[:e]] == target))
                    idx = np.random.default_rng(5).choice(
                        within, size=min(chip_smoke.REPAIR_K, within.size),
                        replace=False)
                    updates = [(int(g.src[i]), int(g.indices[i]),
                                1.0 if j % 2 == 0
                                else float(g.weights[i]) + 3.0)
                               for j, i in enumerate(idx)]
                result, repair_s = sync(lambda: repair_checkpoint(
                    ck, g, updates, config=cfg, state=state, device=dev))
                new_g, _ = g.apply_edge_updates(updates)
                ckp = BatchCheckpointer(ck, graph_key=graph_digest(new_g))
                man = ckp.manifest()
                rows = {}
                for fn in sorted({f for _b, f in man.values()}):
                    srcs = ckp.batch_sources(fn)
                    loaded = ckp.load(int(man[int(srcs[0])][0]), srcs)
                    for k, src in enumerate(srcs):
                        rows[int(src)] = loaded[0][k]
                repaired[label] = rows
                repair[label] = {"solve_s": solve_s, "attach_s": attach_s,
                                 "repair_s": repair_s,
                                 "closures_s": result.closures_s,
                                 "parts_closed": result.dirty_parts_closed}
            if repaired["every_card"].keys() != repaired["one_card"].keys():
                raise AssertionError("repair: the checkpoints hold other "
                                     "sources")
            for src, got in repaired["one_card"].items():
                same(repaired["every_card"][src], got, f"repaired row {src}")
            with one() as s1:
                fresh = s1.solve(new_g).matrix
            for src, got in repaired["one_card"].items():
                same(got, fresh[src], f"repaired row {src}, fresh solve")
            chip_smoke.emit({"path": "repair_default_config",
                             "V": g.num_nodes, "k_updates": len(updates),
                             "brief": {k: brief(v["repair_s"])
                                       for k, v in repair.items()},
                             **repair, "rows_bitwise_one_card": True})
            del repaired, fresh
        # -- --first-use's in-process rows ------------------------------------
        with row("first_use_in_process"):
            _first_use_in_process(dev, repeats)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if failed:
        raise AssertionError(f"--cards rows failed: {failed}")


def links() -> None:
    """``--links``: see the module docstring. Raises below two cards."""
    import torch

    from paralleljohnson_tpu_torch.parallel import mesh as mesh_mod

    cards = torch.cuda.device_count()
    if cards < 2:
        raise AssertionError(f"--links needs two cards or more; {cards} "
                             "visible")
    mesh = mesh_mod.Mesh([torch.device("cuda", i) for i in range(cards)],
                         ("sources",), (cards,))
    rows = []
    for (a, b), peer in sorted(mesh.peer_access().items()):
        src = torch.ones(LINK_BYTES, dtype=torch.uint8,
                         device=torch.device("cuda", a))
        dst = torch.empty(LINK_BYTES, dtype=torch.uint8,
                          device=torch.device("cuda", b))
        dst.copy_(src)  # untimed
        torch.cuda.synchronize(a)
        torch.cuda.synchronize(b)
        dst.zero_()
        torch.cuda.synchronize(b)
        t0 = time.perf_counter()
        dst.copy_(src)
        torch.cuda.synchronize(a)
        torch.cuda.synchronize(b)
        secs = time.perf_counter() - t0
        if not bool((dst == 1).all()):
            raise AssertionError(f"--links: the copy {a} -> {b} differs")
        rows.append({"src": a, "dst": b, "peer_access": peer,
                     "bytes": LINK_BYTES, "seconds": secs,
                     "gb_s": LINK_BYTES / secs / 1e9})
        del src, dst
    chip_smoke.emit({"links": rows})


def first_use(dev, repeats: int) -> None:
    """``--first-use``: see the module docstring. Raises on a failed
    check."""
    import torch

    from paralleljohnson_tpu_torch.parallel import mesh as mesh_mod

    cards = torch.cuda.device_count()
    if cards < 2:
        raise AssertionError(f"--first-use needs two cards or more; {cards} "
                             "visible")
    os.environ.pop(mesh_mod.MESH_DEVICES_ENV, None)
    _first_use_cli(repeats)
    _first_use_in_process(dev, repeats)


FIRST_SHAPES = {"one_card": (1,), "every_card": None}


def _same_as_one_card(rows, label):
    import numpy as np

    if not np.array_equal(rows["every_card"], rows["one_card"]):
        raise AssertionError(f"{label}: rows differ from one card's")


def _first_use_cli(repeats: int) -> None:
    """A command-line solve's process, start to exit, on one card and on
    every card in turns."""
    import shutil
    import tempfile

    import numpy as np

    root = Path(tempfile.mkdtemp(prefix="pj-first-use-"))
    try:
        walls = {k: [] for k in FIRST_SHAPES}
        routes, rows = {}, {}
        for _ in range(repeats):
            for label, shape in FIRST_SHAPES.items():
                out = root / f"{label}.npz"
                cmd = [sys.executable, "-m", "paralleljohnson_tpu_torch",
                       "solve", FIRST_SPEC, "--num-sources",
                       str(FIRST_SOURCES), "--output", str(out), "--json"]
                if shape is not None:
                    cmd += ["--mesh-shape", "1"]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300, cwd=ROOT)
                walls[label].append(time.perf_counter() - t0)
                if proc.returncode != 0:
                    raise AssertionError(f"CLI {label}: rc {proc.returncode}"
                                         f": {proc.stderr[-2000:]}")
                routes[label] = json.loads(
                    proc.stdout.strip().splitlines()[-1])["routes_by_phase"]
                rows[label] = np.load(out)["dist"]
        _same_as_one_card(rows, "CLI")
        if routes["every_card"].get("fanout") != "sharded-1d":
            raise AssertionError(f"CLI default: {routes}")
        chip_smoke.emit({"path": "first_use_cli", "spec": FIRST_SPEC,
                         "sources": FIRST_SOURCES, "routes": routes,
                         "process_wall_s": walls,
                         "brief": {k: brief(v) for k, v in walls.items()},
                         "rows_bitwise_one_card": True})
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _first_use_in_process(dev, repeats: int) -> None:
    """A fresh solver's solve of a small graph and a fresh serving
    engine's first miss, on one card and on every card in turns."""
    import numpy as np

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.serve import QueryEngine, TileStore

    sync = chip_smoke.sync_time
    g = pjt.load_graph(FIRST_SPEC)
    src = np.arange(FIRST_SOURCES)
    secs = {k: [] for k in FIRST_SHAPES}
    rows, meshes = {}, {}
    for _ in range(repeats):
        for label, shape in FIRST_SHAPES.items():
            def solve():
                with pjt.ParallelJohnsonSolver(
                        pjt.SolverConfig(mesh_shape=shape),
                        device=dev) as solver:
                    res = solver.solve(g, src)
                    return res, solver.backend._mesh().describe()
            (res, meshes[label]), t = sync(solve)
            secs[label].append(t)
            rows[label] = res.matrix
    _same_as_one_card(rows, "small graph")
    chip_smoke.emit({"path": "first_use_small_graph", "spec": FIRST_SPEC,
                     "sources": FIRST_SOURCES, "mesh": meshes,
                     "fresh_solver_s": secs,
                     "brief": {k: brief(v) for k, v in secs.items()},
                     "rows_bitwise_one_card": True})
    miss = g.num_nodes // 2
    secs = {k: [] for k in FIRST_SHAPES}
    rows = {}
    for _ in range(repeats):
        for label, shape in FIRST_SHAPES.items():
            engine = QueryEngine(
                g, TileStore(None, g), stats_interval_s=0,
                config=pjt.SolverConfig(mesh_shape=shape), device=dev)
            try:
                ans, t = sync(lambda: engine.query(miss))
                meshes[label] = engine.solver.backend._mesh().describe()
            finally:
                engine.close()
            secs[label].append(t)
            rows[label] = np.asarray(ans["distances"], np.float32)
    _same_as_one_card(rows, "serving miss")
    chip_smoke.emit({"path": "first_use_serve_miss", "spec": FIRST_SPEC,
                     "mesh": meshes, "first_miss_s": secs,
                     "brief": {k: brief(v) for k, v in secs.items()},
                     "rows_bitwise_one_card": True})

if __name__ == "__main__":
    sys.exit(main())
