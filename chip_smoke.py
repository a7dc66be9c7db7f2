#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of paralleljohnson on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

  1. the card (``nvidia-smi`` name and power limit), then the build of
     every hand kernel from ``paralleljohnson_tpu_torch/csrc`` (``ptxas``
     registers, stack frames and spills, by function, none allowed;
     ``tight_pred``'s by template:
     pass width NV, float4 or scalar lanes, gathers per batch U) and each
     kernel's resident blocks per SM;
  2. each kernel against its plain PyTorch version on the card
     (``torch.equal``, same flag): the fan-out sweep at RMAT-20 with
     B = 128 and B = 512 and on a hub graph (one row of 5 L + 3
     in-edges, rows of L and L + 1, an empty row, +inf weights) at
     B = 1, 5, 128, 200, 512, so the split rows' partial minima and
     their combine run; the min-plus product at I x 1024 x 1024 for I =
     1, 16, 100, 128, 511, 1024 (every tile and split-K branch of
     ``minplus_plan``), 1000x777x513, 300x400x200 with all-+inf rows,
     negative finite entries, and ``d is a`` as in squaring; the
     tight-edge pass ``tight_pred`` (int32 trees, ``torch.equal``
     against ``tight_pred_pass_plain``; with the sources, its source
     mask and tree flags against ``tree_flags_plain``) on R-MAT-20's
     converged fan-out at B = 128 and 512, split hub rows included,
     where weights in [1, 10) raise neither flag;
  3. ``solve()`` on ``rmat:scale=20,ef=16,seed=0`` over 512 sources
     (route ``pallas-vm``), 2 rows checked against scipy Dijkstra;
  4. ``solve()`` on ``grid:rows=512,cols=512,neg=0.2,seed=0`` over 256
     sources (phase 1 on ``frontier``, the reference's default route on
     this low-degree graph; reweight, un-reweight): the potentials checked
     feasible on every edge, 2 rows against scipy Dijkstra on the graph
     reweighted with them;
  5. ``solve()`` on ``er:n=1024,p=0.1,seed=0`` with ``fw=False`` (the
     default takes ``fw-tile`` there: phase 16) for all sources (route
     ``dense-squaring-pallas``), the whole matrix against scipy; then for
     128 sources (route ``dense-iterate-pallas``, ``minplus_fixpoint``:
     at most ceil(iterations / 16) + 1 host reads), rows against scipy;
  6. the fan-out sweep against its plain version (``torch.equal`` and
     the same flag, every sweep) on the grid solve's own inputs: the
     reweighted in-edge layout the solve ran on, B = 256, from the
     sources to the fixpoint, which must take the solve's sweep count
     and un-reweight to the solve's rows bitwise; ``tight_pred`` against
     its plain version on that fixpoint (zero-weight ties throughout: it
     must raise the nondescending flag);
  7. a 4-edge negative cycle raises ``NegativeCycleError`` on the card;
  8. CUDA-event times of each kernel and its plain version at the main
     path's shapes, with the bound the card could reach: the sweep at
     L = ``ITEM_EDGES`` (RMAT-20, B = 128 and 512; grid, B = 256, also
     at its fixpoint, where no row drops), the grid fixpoint's host
     clock per sweep at ``SWEEPS_PER_SYNC`` sweeps per host read, and the
     min-plus product at I x 1024 x 1024 for I = 16, 128, 511, 1024 (the
     dense route's iterate and squaring shapes) and at 4096^3, both as
     the wrapper called back to back (``ms``, as the main path pays it)
     and as the card's time alone from CUDA-graph replays (``card_ms``);
     the 128-source ER-1024 fixpoint on the host clock; ``tight_pred``
     with the sources (as the pred solves call it) at R-MAT-20's fixpoint
     (B = 512, 128) and the grid's (B = 256), each with its template's
     registers and spills; the tree check (``certify_pred``) on those
     trees with the kernel's flags beside the check without them (source
     mask, coverage, pointer doubling): R-MAT-20 at B = 512 must certify
     with no walk, the grid must walk and pass;
  9. the pipelined batch driver: ``solve()`` on R-MAT-20 over phase 3's
     512 sources and 512 more, in 4 batches of 256 (1 GiB of rows each),
     at ``pipeline_depth`` 1, 2, 2, 1: rows equal bitwise across runs and
     to phase 3's, 2 rows against scipy; each run's fan-out seconds,
     download / wait / overlap seconds, ``clear_caches`` count, sweep
     launches and host reads; the time of one layout rebuild;
 10. ``solve_reduced`` on the same sources with each built-in reducer,
     against phase 9's rows reduced in numpy (``checksum`` to rtol 1e-6),
     with no call of ``_download_rows``;
 11. checkpoint/resume on the grid (256 sources, batches of 128, depth
     2): 2 batches written, both resumed, an injected OOM in batch 1
     that collapses the window, and an uncheckpointed solve, all
     bitwise equal;
 12. ``sssp`` on the grid (``frontier``) against phase 4's row (rtol
     1e-5, atol 1e-3)
     and on phase 7's negative cycle; ``multi_source`` on R-MAT-20 over
     phase 3's sources (bitwise, rows still on the card); ``solve_batch``
     of 4 ``er:n=256,p=0.1`` graphs (``batch-vmapped``) against their
     ``solve()``s on ``pallas-vm`` bitwise;
 13. ``predecessors=True`` solves (``validate_pred_tree`` on their
     trees): R-MAT-20 over phase 3's sources and the grid over phase 4's
     (``pallas-vm+pred``, rows bitwise equal to theirs), ``sssp`` on the
     grid (``frontier+pred``), the zero-weight tight cycle (``pred-sweep``
     after a warning), a 2-batch checkpointed solve resumed, ER-1024
     (``dense-squaring-pallas+pred``, ``fw=False``);
 14. the XLA routes in plain PyTorch beside the hand routes, rows
     bitwise equal: ``use_pallas=False`` (``vm-blocked``) on R-MAT-20
     at B = 128 and on the grid at B = 64, ``sweep-sm`` on R-MAT-16,
     XLA ``dense-squaring`` on ER-1024 (both with ``fw=False``); fan-out
     seconds per sweep of each route and of its hand route;
 15. the B=1 routes on the grid, in plain PyTorch: ``sssp`` from phase
     4's first source on ``sweep`` (``frontier=False``), ``frontier``
     (the default config), ``dia``, ``gs`` and ``bucket`` (forced), rows
     bitwise equal to ``sweep``'s, each with its seconds (the first call
     and a second ``bellman_ford`` on the same device graph), rounds,
     ``edges_relaxed`` and host reads; ``frontier+pred`` and ``dia+pred``
     (``validate_pred_tree``, a ``tight_pred`` launch); phase 7's
     negative cycle raised on each forced route; the default solve's
     tags (``frontier``, ``pallas-vm``) and its phase-1 seconds beside a
     ``frontier=False`` solve's (both warm, rows bitwise equal); the
     forced ``dia`` and ``gs`` fan-outs at B = 64 (rows bitwise equal to
     ``pallas-vm``'s) with seconds per round; a ``convergence=True``
     ``use_pallas=False`` solve's trajectory summary (``vm-blocked``);
 16. dense APSP: the ``fw_kleene`` kernel against ``tile_kleene`` at t =
     128, 256, 384, 512 (one cluster launch per closure) and 1024 (the
     step variant, t launches), each also on a tile whose diagonal goes
     negative, bitwise; ``kleene_plan(512)`` and the clusters the card
     holds; each variant's times (t = 512 and 1024) and, last in the
     phase, the kernels the card ran for one closure of each
     (``torch.profiler``: 1 and t);
     ``er:n=2048,p=0.1,seed=21`` with the reference's integer weights,
     all sources, default config
     (``fw-tile``), twice in turns with a forced ``dense-squaring-pallas``
     and ``pallas-vm`` solve, rows bitwise equal, with the products' card
     time per k-step at its shapes; phase 5's ER-1024 at default config
     (``fw-tile``) against scipy and within rtol 1e-6 of phase 5's
     squaring matrix, then ``fw-tile+pred``; the condensed route forced
     (``partitioned=True``) on ``grid:rows=64,cols=64,neg=0.2,seed=3``,
     all 4096 sources, against the default solve (rtol 1e-6, atol 1e-4;
     bitwise with the weights rounded), its stage split, and a negative
     cycle across parts that raises; ``solve_batch`` of
     ``random_graph_batch(10000, 256, 8/256, seed=0)`` (``batch-vmapped``),
     64 sampled graphs against scipy Johnson (rtol 1e-6) and bitwise
     against their own ``solve()``, beside a 100-graph ``solve()`` loop.
 17. the dirty window and the priced planner (``drive_dirty_window``) on
     the reference's dirty-window grid at card scale
     (``permute_labels(grid2d(512, 512, negative_fraction=0.0, seed=7),
     seed=11)``), 256 sources, with a fresh profile store: the default
     (``pallas-vm``), ``dirty_window=True`` (``vm-blocked+dw``) and
     ``use_pallas=False`` (``vm-blocked``), exact tags, rows bitwise
     equal, walls, examined edges and the dirty window's overflow
     rounds; the evidence loop (instrumented ``use_pallas=False`` solves
     write ``cuda`` trajectory records, ``_dw_decision`` engages on the
     grid and declines on R-MAT-20) with each graph's default decision;
     the store's prices of the three routes beside their walls and the
     priced walk's decision (the translated veto keeps ``pallas-vm``
     while the store prices it cheaper than the dirty window).
 18. the bench harness (``drive_bench``): ``benchmarks.run`` over the
     port's configs at the full preset on the card (all but the three
     phases 21-22 drive themselves: fourteen; ``rmat_apsp`` and
     ``rmat_apsp_pipelined`` at the mini preset, R-MAT-12, since phases 3
     and 9 drive R-MAT-20), with the
     flight recorder and a fresh profile store under
     ``chiprun_out/chip_smoke_bench/`` (the full rows in its
     ``rows.jsonl``), one line per config (wall, edges/s, route,
     platform, the card); no row may carry ``failed`` (FW bitwise
     against squaring, pipelined rows against serial, the tuner's
     checks), ``planner_dispatch``'s pick must be bitwise its forced run
     with every forced plan agreeing and none declined, the dirty
     window's evidence must engage on the grid and decline on R-MAT,
     ``distributed_fleet`` must run its workers as subprocesses on the
     card with no requeue (its rows bitwise between 1 and 4 workers,
     ``incremental_update``'s repair bitwise a fresh solve: the
     harness's own checks), every config's Chrome trace must validate and
     the heartbeat must show CUDA bytes in use; then the ``cpp``
     backend (C++/OpenMP) on ``er1k_apsp`` and ``ego_fb_nsource`` at the
     full preset, the CPU baseline, with its wall over the card's.
 19. the distributed fleet (``drive_fleet``) over the grid's first 256
     sources in 8 leases of 32 (the batch pinned): 4 in-process workers
     (they must launch ``fanout_sweep``), rows bitwise equal to one
     ``solve()`` of the same sources; then 3 worker subprocesses on the
     card, ``w0`` SIGKILLed after its first claim: its lease requeued
     (at least one requeue), every lease committed, rc -9 and 0, 0, rows
     bitwise equal again; each worker's summary (kernel build seconds:
     ~0, phase 1 built them);
 20. incremental repair (``drive_repair``) on ``grid2d(80, 80,
     seed=17)`` with integer weights: a checkpointed solve, the
     incremental state attached, a 12-edge update inside the most
     populated part repaired (``fanout_sweep`` on the part closures;
     ``minplus`` / ``fw_kleene`` as they fall on the boundary core),
     rows bitwise equal to a fresh ``solve()``, fewer dirty parts than
     parts; then a negative cycle through the repaired graph's chained
     state raises ``NegativeCycleError``.
 21. the serving tier (``drive_serve``) at the bench's ``serve_queries``
     full size: ER-4096 at average degree 8, a quarter of the sources
     solved into a checkpointed ``TileStore``, a ``LandmarkIndex`` of 8
     pivots, 20,000 queries (85% store hits, the misses answered by
     landmark bounds) from 32 clients through one ``MicroBatcher``, with
     the host walk forced and then the device path forced: the two
     response sets bitwise equal, the store's warm rows, the landmark
     rows, the card's ``solve()`` and every exact answer bitwise the
     plain sweep in torch ops, every landmark interval holding the exact
     distance,
     the ``auto`` planner choosing ``device_lookup`` on ``cuda`` with the
     landmark sub-path on the device (f64 probe true); each path's wall,
     tile rebuilds and streaming p50 / p99; then ``serve_overload`` at
     full through real sockets: no hung client, every answer exact
     bitwise or flagged inside its certificate, shedding and admission
     engaged at twice capacity, a bounded shed fraction, the SLO's p99
     met (only the late-cooldown verdict, ``OVERLOAD_PRINTED``, is
     printed and not held);
 22. the approximate tier (``drive_approx``) at the bench's
     ``approx_apsp`` full size: ``grid2d(512, 32, seed=23)``, 256
     sources, ``solve_with_budget`` with ``hopset=True`` forced at
     epsilon 0.1 and 0.5 beside the exact ``solve()``: each hopset's
     forward and reverse beta-hop rows and the query rows bitwise (with
     iterations and convergence) the plain chunked sweep in torch ops
     (``plain_rows``), every interval holding the exact row; walls
     and speedup; then a hopset of 4 pivots and 8 hops on R-MAT-20 (16
     edge chunks, one launch each per sweep), bitwise its plain chunked
     sweep.
 23. the command line (``drive_cli``): ``python -m
     paralleljohnson_tpu_torch`` subprocesses on the card with no
     ``--device`` (the default), each one's exit code checked and wall
     printed: ``info --json`` (the card's ``nvidia-smi`` line, phase 1's
     four libraries built); ``solve`` on R-MAT-20 over phase 3's first
     64 sources (``pallas-vm``, rows bitwise phase 3's), on the grid over
     phase 4's first 128 sources with ``--predecessors`` (``pallas-vm+pred``,
     rows bitwise phase 13's, trees validated) and on ER-1024 at the
     default config (``fw-tile``, bitwise phase 16's matrix), each with
     ``--output`` and ``--log-stats``, whose ``kernel_launches`` show the
     process launched its kernels; ``sssp`` on the grid (exit 0) and
     phase 7's cycle as a ``.gr`` file (exit 2, "negative"); ``bench
     serve_fleet --preset full`` (three replica processes on the card,
     no ``failed``); a replica on the card registered in a fleet
     directory answering one query bitwise ``solve()``, ``top --once
     --json --fleet-dir`` over it, and its SIGTERM drain (exit 0).
 24. the mesh (``drive_mesh``, ``parallel.mesh``) on 4 ranks that share
     the card (``PJ_MESH_DEVICES=cuda:0*4``; the in-process exchange
     between them, device copies on the card, no process group):
     ``solve()`` on R-MAT-20 over
     phase 3's 512 sources with ``mesh_shape=(4,)`` (``sharded-1d``: the
     hand sweep on each rank), rows bitwise phase 3's; the grid over
     phase 4's sources with ``edge_shard=True`` and trees (phase 1
     ``edge-sharded``, one MIN all-reduce a sweep; ``sharded-1d+pred``,
     ``tight_pred`` on each rank), rows bitwise phase 13's, trees
     validated; ``mesh_shape=(2, 2)`` on R-MAT-20 over 64 sources
     (``sharded-2d``), bitwise; ``sharded_fanout(replicate=True)`` called
     directly, each rank's copy equal; ``gs-sharded`` and ``dia-sharded``
     on a 64x64 lattice, bitwise ``pallas-vm``; and two processes under
     ``python -m torch.distributed.run`` (``chip_smoke.py --mesh-child``:
     ``multihost.initialize()``, ``global_mesh()``, ``sharded_fanout``),
     rows bitwise the single-card solve (gloo between the processes).
     Each route, the exchange,
     the rank devices and the phase's seconds are printed; a route that
     ends in ``+1dev-fallback`` fails.
 25. ``precision="f64"`` on the card (``drive_f64``), on phases 2-5's
     graphs: each kernel's f64 version against its plain f64 version
     (``torch.equal``, the same flags): the sweep on R-MAT-20 at B = 128
     and 512 with the main path's hub flags (the sources whose rows the
     f64 kernel keeps in L2), on the grid at B = 256 (no hubs) and on
     the hub graph at B = 1, 5, 128, 200, 512, the
     min-plus product at phase 2's shapes, ``tight_pred`` on R-MAT-20's
     converged f64 fan-out with the sweep's hub flags and without (flags
     [0, 0]), the Kleene closure at t = 40-512 (one cluster launch, in
     rounds of 4 steps per hand-over; at t = 41 and 509 the last round
     runs past t) and 1024 (the step variant), with
     and without a negative diagonal, and with -inf entries (equal
     wherever the plain closure has no NaN); every f64 instantiation's ptxas
     registers (phase 1: no spill, no stack frame) and resident blocks;
     the f64 kernels' times beside their plain versions and bounds (8
     bytes a value, FP64 instructions at 17e12/s; the sweep's at those
     three widths, each beside its hub set's size, bytes and edge
     share); then, each path
     counted from 0, ``solve()`` at f64 on R-MAT-20 over phase 3's 512
     sources (``pallas-vm``) and the grid over phase 4's 256
     (``frontier``, ``pallas-vm``), 2 rows each against scipy in f64
     (rtol 1e-12; 1e-9 through the grid's potentials), ER-1024 on
     ``fw-tile`` and ``dense-squaring-pallas`` against scipy, R-MAT-20
     with trees over phase 3's sources in one batch (``pallas-vm+pred``,
     the pass with hub flags: trees and flags those of ``tight_pred_pass_plain``
     and ``tree_flags_plain`` on the solve's rows, no walk), the grid
     with trees over 64 sources (``pallas-vm+pred``, validated), and
     ``cli.main(["solve", ER_SPEC, "--precision", "f64", ...])`` in
     process, bitwise the ``fw-tile`` solve. Its launches are the
     ``_f64`` rows of the ``kernels`` line, not the f32 rows'.
 26. ``precision="f64"`` above the solver (``drive_f64_layers``), each
     path held bitwise to phase 25's single-card f64 rows (or a
     single-card f64 solve of its own sources) and printed with its
     wall and launches: the mesh on 4 ranks sharing the card (no process
     group built; R-MAT-20
     over phase 3's sources on ``sharded-1d``, each rank's f64 hub set on
     a quarter of the L2 budget beside the whole budget's; its first 64
     with trees on the 2 x 2 mesh, ``sharded-2d+pred``; the grid with
     ``edge_shard=True`` and trees over phase 25's 64 tree sources),
     trees validated; ``gs-sharded`` and ``dia-sharded`` on phase 24's
     64 x 64 float-weight lattice over 64 sources, within rtol 1e-12 of
     the single-card f64 rows and scipy's; the fleet (2 in-process
     workers over the grid's first 32 sources, the plan's config at
     f64); an f64 checkpoint of a
     40 x 40 integer lattice repaired (10 parts: the boundary core closes
     on the f64 min-plus); a store from an f64 solve's checkpoint of
     phase 21's ER graph served host-forced and device-forced (cold
     hits, scheduled misses, then hot hits); ``approx_apsp`` on R-MAT-20
     in f64 with a hopset of 4 pivots and 8 hops (every certified
     interval holding the f64 row) and ``solve_with_budget`` at error
     budget 0 (the exact plan). Its launches count in the ``_f64`` rows.
 27. the default mesh over every card (``drive_every_card``): with two
     cards or more, ``solve()`` on R-MAT-20 over phase 3's sources under
     a default ``SolverConfig`` (``mesh_shape=None`` takes every card, a
     rank per card, device copies between them, no process group):
     ``sharded-1d``, rows bitwise phase 3's; then
     under a default ``SolverConfig(precision="f64")`` with trees:
     ``sharded-1d+pred`` on every card, rows bitwise phase 25's f64 rows,
     sampled trees valid (path ``every_card_f64``, in the ``_f64`` rows).
     With one card it prints one line saying that it did not run and
     why.

Each solving path is driven with the kernels' launch counters (and the
fixpoints' host reads) set to 0 just before and read just after:
phases 3-5 together, then each path of phases 9-22 and 24-27 on its own (a
worker subprocess's launches are not seen: phase 19 counts the
in-process fleet; phase 24's paths are summed under ``mesh``, its two
processes print their own), and phase 23's solves each in a process of
its own, whose counters start at 0 and are read from its
``--log-stats`` line; a path whose kernel was never launched fails (the
plain-torch routes of phases 15, 17 and 24's ``gs-sharded`` /
``dia-sharded`` need none). The last two lines are the
``kernels`` summary (launches summed over the paths, and by path) and
``{"ok": true, "device": {...}}``, after a line with the whole run's
seconds (``smoke_s``).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP32 (non-tensor)
# operations/s. The data sheet counts an FMA as two operations; both
# kernels' inner step is an add and a min, two instructions that do not
# fuse, so they issue at half that rate. The bound of a kernel is the
# larger of its bytes and its FP32 instructions over these.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_F32_INSTR_S = PEAK_F32_OPS_S / 2
# FP64 outside the tensor cores (phase 25's f64 kernels): 34 TFLOP/s with
# an FMA counted as two, so an add or a min issues at 17e12/s.
PEAK_F64_OPS_S = 34e12
PEAK_F64_INSTR_S = PEAK_F64_OPS_S / 2

RMAT_SPEC = "rmat:scale=20,ef=16,seed=0"
GRID_SPEC = "grid:rows=512,cols=512,neg=0.2,seed=0"
ER_SPEC = "er:n=1024,p=0.1,seed=0"
BATCH_SPEC = "er:n=256,p=0.1"  # phase 12's solve_batch, seeds 0-3
PRED_CKPT_SPEC = "grid:rows=64,cols=64,neg=0.2,seed=3"  # phases 13, 16
# Phase 16: the reference's dense FW benchmark graph (its weights are
# redrawn as integers from default_rng(22)) and the many-small-graphs
# config (BASELINE.json: 10k random 256-node graphs).
FW_SPEC = "er:n=2048,p=0.1,seed=21"
BATCH_APSP_GRAPHS = 10000
SWEEP_SM_SPEC = "rmat:scale=16,ef=8,seed=2"  # phase 14
# Phase 9: phase 3's 512 R-MAT-20 sources and this many more, in batches
# of MULTI_BATCH (a [256, 2^20] f32 block is 1 GiB). Phase 11: the grid,
# CKPT_SOURCES sources in batches of CKPT_BATCH.
MULTI_EXTRA_SOURCES = 512
MULTI_BATCH = 256
CKPT_SOURCES = 256
CKPT_BATCH = 128
# Min-plus shapes timed in phase 8 (I, K, J): B x V x V for B = 16, 128,
# 511 sources (the iterate regime) and V^3 (squaring) at V = 1024; and
# 4096^3, off the main path, for information.
MINPLUS_SHAPES = ((16, 1024, 1024), (128, 1024, 1024), (511, 1024, 1024),
                  (1024, 1024, 1024), (4096, 4096, 4096))
# Phase 16: the tile the Kleene kernel's step variant is checked and
# timed at (off every default path: config.fw_tile above 512).
KLEENE_STEP_T = 1024
# Phase 17: the JAX package's dirty-window graph at card scale (its
# bench_dirty_window: the grid with scrambled labels, no negative weight),
# DW_SOURCES sources for the three routes. The instrumented solves of the
# evidence loop run DW_RMAT_SOURCES sources on R-MAT-20 and each width of
# DW_EVIDENCE_WIDTHS on the grid, each into its own store; the first must
# engage. The recorded skippable fraction falls as the batch's frontiers
# overlap, and faster on vm-blocked, whose chunk-level Gauss-Seidel widens
# each sweep's frontier (this port on the CPU, scrambled 128x128 grid in 4
# blocks: 0.85 at B = 1, 0.81 at B = 2, 0.61 at B = 4 against 0.93 on vm at
# B = 4); the reference's bench runs 4 sources at 96 rows, on vm.
DW_ROWS = 512
DW_SOURCES = 256
DW_EVIDENCE_WIDTHS = (1, 4)
DW_RMAT_SOURCES = 64
# Phase 18: the bench harness's configs at the full preset, their flight
# recorder and profile store under BENCH_DIR (gitignored, emptied first),
# and the configs the C++/OpenMP backend runs as the CPU baseline.
BENCH_DIR = "chiprun_out/chip_smoke_bench"
BENCH_PRESET = "full"
# Run at the mini preset (R-MAT-12): their full size is R-MAT-20, which
# phases 3 and 9 already drive through the same routes, and its two
# generations and checkpointed solves cost ~60-80 s of the time limit.
BENCH_MINI_CONFIGS = ("rmat_apsp", "rmat_apsp_pipelined")
BENCH_CPP_CONFIGS = ("er1k_apsp", "ego_fb_nsource")
# Phase 19: the fleet on the card, over GRID_SPEC's first FLEET_SOURCES
# sources in leases of FLEET_LEASE (the batch pinned to the lease: several
# worker processes share the card); FLEET_WORKERS in-process workers, then
# FLEET_PROC_WORKERS subprocess workers, "w0" killed after its first claim,
# its lease requeued once FLEET_DEADLINE_S lapsed and its heartbeat is
# FLEET_STALE_S old.
FLEET_SOURCES = 256
FLEET_LEASE = 32
FLEET_WORKERS = 4
FLEET_PROC_WORKERS = 3
FLEET_DEADLINE_S = 4.0
FLEET_STALE_S = 3.0
# Phase 20: incremental repair on the JAX package's incremental_update
# lattice at card scale (its full preset is 64 x 64): REPAIR_SIDE^2
# vertices, integer weights, a REPAIR_K-edge update inside the most
# populated part (the bench's draw), then a negative cycle. 96 x 96 took
# 91 s on the H100, 31 s of it the checkpointed solve's zlib writes and
# 52 s the repair (31 s rewriting every batch, 16 s of host expansion):
# the rows are quadratic in the side, so the phase runs 80 x 80.
REPAIR_SIDE = 80
REPAIR_K = 12
# Phase 21: the bench's serve_queries at full (ER-SERVE_N at average
# degree 8, SERVE_QUERIES queries from SERVE_CLIENTS clients,
# SERVE_LANDMARKS landmarks), then its serve_overload config at full.
SERVE_N = 4096
SERVE_QUERIES = 20000
SERVE_CLIENTS = 32
SERVE_LANDMARKS = 8
# Phase 22: the bench's approx_apsp at full (the corridor lattice
# grid2d(16 * APPROX_SHORT, APPROX_SHORT, seed=23), APPROX_SOURCES
# sources, each epsilon of APPROX_EPS), then a small hopset on R-MAT-20
# (RMAT_HOP_K pivots, RMAT_HOP_BETA hops): 16.7M edges sweep in 16 chunks
# of the reference's 2^20, the chunk-level Gauss-Seidel order held.
APPROX_SHORT = 32
APPROX_SOURCES = 256
APPROX_EPS = (0.1, 0.5)
RMAT_HOP_K = 4
RMAT_HOP_BETA = 8
# The one serve_overload verdict printed and not held: shed answers in
# the late cooldown (PERF.md, Open questions). Every other verdict fails
# the phase.
OVERLOAD_PRINTED = ("late cooldown",)
# Phase 23: the R-MAT-20 and the grid commands' sources (phase 3's and
# phase 4's first ones): their --output rows go through zlib at ~20
# MB/s, 4 MiB a source on R-MAT-20, 2 MiB and its trees on the grid.
CLI_RMAT_SOURCES = 64
CLI_GRID_SOURCES = 128
# Phase 24: the mesh's ranks, all on the card (the in-process exchange); the
# 2-D mesh and its sources; the sources of the direct replicated call;
# the grid side of the gs-sharded / dia-sharded fan-outs and their
# sources; the graph and sources of the two-process run.
MESH_RANKS = 4
MESH_2D = (2, 2)
MESH_2D_SOURCES = 64
MESH_REPLICATE_SOURCES = 64
MESH_GRID_SIDE = 64
MESH_GRID_SOURCES = 64
MESH_CHILD_SPEC = "rmat:scale=16,ef=16,seed=0"
MESH_CHILD_SOURCES = 64
# Phase 26: precision="f64" above the solver, on earlier phases' graphs.
# The mesh: R-MAT-20 over phase 3's sources on MESH_RANKS ranks, its first
# F64_MESH_2D_SOURCES with trees on MESH_2D, the grid with edge_shard and
# trees over phase 25's 64 tree sources, gs-sharded and dia-sharded on
# phase 24's lattice and sources. The fleet: F64_FLEET_WORKERS
# in-process workers over the grid's first F64_FLEET_SOURCES sources in
# leases of F64_FLEET_LEASE. The repair: phase 20's lattice generator cut
# to F64_REPAIR_SIDE (its f64 checkpoint writes at 80 x 80 would take
# ~50 s) in F64_REPAIR_PARTS parts, so that the boundary core (384
# vertices) closes on dense-iterate-pallas, the f64 min-plus. Serving:
# phase 21's ER graph, F64_SERVE_STORED sources in the store,
# F64_SERVE_QUERIES requests twice (cold and scheduled, then hot). Approx:
# phase 22's R-MAT-20 hopset shape over F64_APPROX_SOURCES sources.
F64_MESH_2D_SOURCES = 64
F64_FLEET_SOURCES = 32
F64_FLEET_LEASE = 16
F64_FLEET_WORKERS = 2
F64_REPAIR_SIDE = 40
F64_REPAIR_PARTS = 10
F64_REPAIR_K = 12
F64_SERVE_STORED = 256
F64_SERVE_QUERIES = 256
F64_APPROX_SOURCES = 16
# Phase 18 leaves the configs phases 21-23 drive themselves.
BENCH_OWN_PHASE = ("serve_queries", "serve_overload", "approx_apsp",
                   "serve_fleet")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(bytes_moved: float, instructions: float, *,
          instr_s: float = PEAK_F32_INSTR_S) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes over the HBM rate
    and the instructions over ``instr_s`` (FP32 unless given)."""
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = instructions / instr_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def minplus_bound(i: int, k: int, j: int, *, itemsize: int = 4,
                  instr_s: float = PEAK_F32_INSTR_S) -> tuple[float, str]:
    """The bound of an [i, k] x [k, j] min-plus product: both operands
    read and the result written once; an add and a min per candidate."""
    return bound(itemsize * (i * k + k * j + i * j), 2 * i * k * j,
                 instr_s=instr_s)


def max_abs_err(got, want) -> float:
    """Largest |got - want| over the finite entries; NaN when the +inf
    entries differ."""
    import torch

    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        return float("nan")
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0
    return float((got[fin] - want[fin]).abs().max())


def event_ms(fn, reps: int, warmup: int = 1) -> float:
    """Milliseconds per call of ``fn``, called back to back from the host
    between two CUDA events: what a loop of calls pays, host time
    included when a call takes the host longer than the card."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn, name: str) -> int:
    """Kernels whose name holds ``name`` that the card ran in one call of
    ``fn``, from ``torch.profiler``'s CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and name in e.name)


def graph_ms(fn, reps: int) -> float:
    """The card's milliseconds per call of ``fn``: ``reps`` calls captured
    in a CUDA graph and replayed between two CUDA events, so that no host
    time is in it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sync_time(fn):
    """(fn(), host seconds), between two ``torch.cuda.synchronize()``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def ptxas_functions(log: str) -> list[dict]:
    """Registers, stack frame and spill bytes of each kernel function in a
    build's ``-Xptxas -v`` output."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = {"function": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            (cur["stack_frame"], cur["spill_stores"],
             cur["spill_loads"]) = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def tight_pred_templates(log: str) -> dict:
    """``tight_pred``'s items kernels by template (``NV{nv}_{vec|scalar}
    _U{u}``, ``_l2`` for the f64 kernel with hub flags) and its combine
    kernels (``combine_{vec|scalar}``), the f64 ones prefixed ``f64_``:
    registers and spill bytes, from the build log."""
    out = {}
    for f in ptxas_functions(log):
        m = re.search(r"pred_itemsI([fd])Li(\d+)ELb([01])ELi(\d+)ELb([01])E",
                      f["function"])
        c = re.search(r"combine_split_rowsI([fd])Lb([01])E", f["function"])
        if m:
            name = (f"{'f64_' if m.group(1) == 'd' else ''}NV{m.group(2)}_"
                    f"{'vec' if m.group(3) == '1' else 'scalar'}_U{m.group(4)}"
                    f"{'_l2' if m.group(5) == '1' else ''}")
        elif c:
            name = (f"{'f64_' if c.group(1) == 'd' else ''}combine_"
                    f"{'vec' if c.group(2) == '1' else 'scalar'}")
        else:
            continue
        out[name] = {k: f.get(k) for k in ("registers", "spill_stores",
                                           "spill_loads")}
    return out


def pred_template(b: int, vec: bool = True) -> str:
    """The ``tight_pred_templates`` key prefix of the items kernel a pass
    at width ``b`` runs (NV by B, as ``csrc/tight_pred.cu`` picks it)."""
    return f"NV{1 if b <= 128 else 2}_{'vec' if vec else 'scalar'}_U"


def counter(launches: dict):
    """``counted(path, fn, needs=())``: ``fn()`` on the host clock with
    every kernel's launch count (and the fixpoints' host reads) set to 0
    just before and read just after into ``launches[path]``; raises if a
    kernel named in ``needs`` was launched no time. Returns (fn(), s)."""
    from paralleljohnson_tpu_torch.ops import bucket as bucket_mod
    from paralleljohnson_tpu_torch.ops import fanout_sweep as fs
    from paralleljohnson_tpu_torch.ops import fw as fw_mod
    from paralleljohnson_tpu_torch.ops import gauss_seidel as gs_mod
    from paralleljohnson_tpu_torch.ops import minplus as mp_mod
    from paralleljohnson_tpu_torch.ops import pred as pred_mod
    from paralleljohnson_tpu_torch.ops import relax

    # The host loops of the plain-torch routes, by the counter's name.
    loops = {"fanout_host_reads": fs.fanout_fixpoint,
             "sweep_host_reads": relax._sweeps_to_fixpoint,
             "frontier_host_reads": relax.bellman_ford_frontier,
             "dw_host_reads": relax.bellman_ford_sweeps_dw,
             "gs_host_reads": gs_mod._gs_engine,
             "bucket_host_reads": bucket_mod.bellman_ford_bucketed}

    def counted(path, fn, needs=()):
        fs.fanout_sweep.launches = 0
        mp_mod.minplus_kernel.launches = 0
        pred_mod.tight_pred_pass.launches = 0
        fw_mod.fw_kleene.launches = 0
        for loop in loops.values():
            loop.host_reads = 0
        try:
            out = sync_time(fn)
        finally:  # a path that raises on purpose is counted too
            launches[path] = {
                "fanout_sweep": fs.fanout_sweep.launches,
                "minplus": mp_mod.minplus_kernel.launches,
                "tight_pred": pred_mod.tight_pred_pass.launches,
                "fw_kleene": fw_mod.fw_kleene.launches,
                **{k: f.host_reads for k, f in loops.items()}}
        for name in needs:
            if launches[path][name] == 0:
                raise AssertionError(f"{path} launched no {name} kernel")
        return out

    return counted


def solver_on(dev, backend_cls=None, **kw):
    """A solver on ``dev`` over ``backend_cls`` (the torch backend by
    default) with ``SolverConfig(**kw)``, on one rank unless ``kw`` gives
    a ``mesh_shape``."""
    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend

    kw.setdefault("mesh_shape", (1,))  # one rank, whatever the host has
    backend = (backend_cls or TorchBackend)(pjt.SolverConfig(**kw),
                                            device=dev)
    return pjt.ParallelJohnsonSolver(backend.config, backend=backend)


def drive_entry_points(dev, rmat, rmat_sources, rmat_rows, grid, grid_source,
                       grid_row, cycle_graph) -> dict:
    """Phases 9-12: the solver's batch driver and its other entry points
    on ``dev`` (the card). ``rmat_rows`` are phase 3's host rows over
    ``rmat_sources``; ``grid_row`` is phase 4's row of ``grid_source``.
    Each path runs with the kernels' launch counts set to 0 just before
    and read just after; returns those counts by path."""
    import tempfile

    import numpy as np
    import scipy.sparse.csgraph as csgraph
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend
    from paralleljohnson_tpu_torch.solver.johnson import _ROW_REDUCERS, to_numpy
    from paralleljohnson_tpu_torch.utils.checkpoint import BatchCheckpointer

    class CountingBackend(TorchBackend):
        """The torch backend, counting ``clear_caches`` calls."""

        clears = 0

        def clear_caches(self, dgraph):
            self.clears += 1
            super().clear_caches(dgraph)

    launches = {}
    counted = counter(launches)

    def solver_with(backend_cls=TorchBackend, **kw):
        return solver_on(dev, backend_cls, **kw)

    # -- phase 9: multi-batch solve() on R-MAT-20, depth 1 and 2 in turns ----
    v = rmat.num_nodes
    extra = np.random.default_rng(9).choice(
        np.setdiff1d(np.arange(v), rmat_sources), MULTI_EXTRA_SOURCES,
        replace=False)
    sources = np.sort(np.concatenate([rmat_sources, extra]))
    at_phase3 = np.searchsorted(sources, rmat_sources)
    check = [int(np.searchsorted(sources, extra.min())),
             int(np.searchsorted(sources, extra.max()))]
    # What suggested_source_batch (the OOM degrader's re-consult) returns
    # before the runs and after each, on one device graph at depth 2:
    # mem_get_info counts the caching allocator's cached blocks as used.
    probe = TorchBackend(pjt.SolverConfig(), device=dev)
    dg = probe.upload(rmat)
    suggested_before = probe.suggested_source_batch(dg)
    free_before = torch.cuda.mem_get_info(dev)[0]
    rows = None
    runs = []
    for run, depth in enumerate((1, 2, 2, 1)):
        solver = solver_with(CountingBackend, source_batch_size=MULTI_BATCH,
                             pipeline_depth=depth)
        res, secs = counted(f"multi_batch_depth{depth}_run{run}",
                            lambda: solver.solve(rmat, sources),
                            needs=("fanout_sweep",))
        st = res.stats
        if (not isinstance(res.dist, np.ndarray)
                or res.dist.shape != (len(sources), v)):
            raise AssertionError(f"multi-batch rows: {type(res.dist)}")
        if st.final_pipeline_depth != depth or st.final_batch != MULTI_BATCH:
            raise AssertionError(f"depth {st.final_pipeline_depth}, batch "
                                 f"{st.final_batch}")
        if rows is None:
            rows = res.dist
            if not np.array_equal(rows[at_phase3], rmat_rows):
                raise AssertionError("multi-batch rows differ from phase 3's")
            oracle = csgraph.dijkstra(rmat.to_scipy().astype(np.float64),
                                      directed=True, indices=sources[check])
            np.testing.assert_array_equal(np.isinf(rows[check]),
                                          np.isinf(oracle))
            np.testing.assert_allclose(rows[check], oracle, rtol=1e-5)
        elif not np.array_equal(res.dist, rows):
            raise AssertionError(f"run {run} (depth {depth}) rows differ "
                                 "from run 0 (depth 1)")
        runs.append({
            "run": run, "depth": depth, "seconds": secs,
            "fanout_s": st.phase_seconds["fanout"],
            "upload_s": st.phase_seconds["upload"],
            "download_s": st.download_s, "ckpt_wait_s": st.ckpt_wait_s,
            "overlap_saved_s": st.overlap_saved_s,
            "final_pipeline_depth": st.final_pipeline_depth,
            "clear_caches": solver.backend.clears,
            "suggested_batch_after": probe.suggested_source_batch(dg),
            "free_GB_after": torch.cuda.mem_get_info(dev)[0] / 1e9,
            "reserved_GB_after": torch.cuda.memory_reserved(dev) / 1e9,
            "sweeps": st.iterations_by_phase["fanout"],
            "launches": launches[f"multi_batch_depth{depth}_run{run}"]})
        del res
    # One layout rebuild (what each batch pays after the download's clear).
    rebuild_s = []
    for _ in range(3):
        probe.clear_caches(dg)
        rebuild_s.append(sync_time(dg.fanout_layout)[1])
    del dg
    row_bytes = 4 * v * len(sources)
    emit({"phase": "multi_batch_rmat20", "spec": RMAT_SPEC,
          "sources": len(sources), "source_batch_size": MULTI_BATCH,
          "row_GB": row_bytes / 1e9, "runs": runs,
          "rows_equal_across_runs": True, "rows_equal_phase3": True,
          "checked_rows": check, "layout_rebuild_s": rebuild_s,
          "suggested_batch_before": suggested_before,
          "free_GB_before": free_before / 1e9,
          "depth1_download_GB_s": [row_bytes / r["download_s"] / 1e9
                                   for r in runs if r["depth"] == 1]})

    # -- phase 10: solve_reduced, no [B, V] block reaches the host -----------
    reduced = {}
    for name in ("reach_count", "eccentricity", "checksum"):
        solver = solver_with(source_batch_size=MULTI_BATCH)
        downloads = []
        download_rows = solver._download_rows

        def counting_download(*args, _inner=download_rows):
            downloads.append(1)
            return _inner(*args)

        solver._download_rows = counting_download
        red, secs = counted(
            f"solve_reduced_{name}",
            lambda: solver.solve_reduced(rmat, sources, reduce_rows=name),
            needs=("fanout_sweep",))
        if downloads:
            raise AssertionError(f"solve_reduced({name}) downloaded rows")
        fn = _ROW_REDUCERS[name]
        want = [fn(rows[k:k + MULTI_BATCH], None)
                for k in range(0, len(sources), MULTI_BATCH)]
        if len(red.values) != len(want):
            raise AssertionError(f"{name}: {len(red.values)} values")
        for got, exp in zip(red.values, want):
            if name == "checksum":
                np.testing.assert_allclose(got, exp, rtol=1e-6)
            elif not np.array_equal(np.asarray(got), exp):
                raise AssertionError(f"solve_reduced({name}) disagrees with "
                                     "phase 9's rows")
        reduced[name] = {"seconds": secs,
                         "fanout_s": red.stats.phase_seconds["fanout"],
                         "download_rows_calls": len(downloads),
                         "launches": launches[f"solve_reduced_{name}"]}
    emit({"phase": "solve_reduced_rmat20", "sources": len(sources),
          "reducers": reduced, "checksum_rtol": 1e-6})
    del rows

    # -- phase 11: checkpoint / resume / injected OOM on the grid ------------
    gsrc = np.sort(np.random.default_rng(11).choice(
        grid.num_nodes, CKPT_SOURCES, replace=False))
    n_batches = -(-CKPT_SOURCES // CKPT_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        first_dir, fault_dir = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        kw = dict(source_batch_size=CKPT_BATCH, pipeline_depth=2)
        first, s_first = counted(
            "checkpoint_write",
            lambda: solver_with(checkpoint_dir=first_dir, **kw).solve(
                grid, gsrc), needs=("fanout_sweep",))
        done = BatchCheckpointer(first_dir, graph_key=grid).completed_batches()
        if done != list(range(n_batches)) or first.stats.batches_resumed:
            raise AssertionError(f"first checkpointed run wrote {done}")
        again, s_again = counted(
            "checkpoint_resume",
            lambda: solver_with(checkpoint_dir=first_dir, **kw).solve(
                grid, gsrc))
        if again.stats.batches_resumed != n_batches:
            raise AssertionError(f"resumed {again.stats.batches_resumed} of "
                                 f"{n_batches} batches")
        plan = pjt.FaultPlan([pjt.Fault(stage="fanout", kind="oom", batch=1)])
        faulted, s_fault = counted(
            "checkpoint_injected_oom",
            lambda: solver_with(checkpoint_dir=fault_dir, fault_plan=plan,
                                **kw).solve(grid, gsrc),
            needs=("fanout_sweep",))
        if faulted.stats.final_pipeline_depth != 1:
            raise AssertionError("the injected OOM did not collapse the "
                                 "window")
        plain, _ = counted("checkpoint_plain_solve",
                           lambda: solver_with(**kw).solve(grid, gsrc),
                           needs=("fanout_sweep",))
        for label, other in (("resumed", again), ("injected OOM", faulted),
                             ("uncheckpointed", plain)):
            if not np.array_equal(to_numpy(other.dist), first.dist):
                raise AssertionError(f"the {label} run's rows differ")
        emit({"phase": "checkpoint_grid512", "spec": GRID_SPEC,
              "sources": CKPT_SOURCES, "source_batch_size": CKPT_BATCH,
              "batches_written": len(done),
              "batches_resumed": again.stats.batches_resumed,
              "seconds": {"write": s_first, "resume": s_again,
                          "injected_oom": s_fault},
              "write_run": {"fanout_s": first.stats.phase_seconds["fanout"],
                            "download_s": first.stats.download_s,
                            "ckpt_wait_s": first.stats.ckpt_wait_s,
                            "overlap_saved_s": first.stats.overlap_saved_s},
              "injected_oom": {"fired": [list(f) for f in plan.fired],
                               "final_pipeline_depth":
                                   faulted.stats.final_pipeline_depth,
                               "oom_degradations":
                                   faulted.stats.oom_degradations},
              "rows_equal": True})
        del first, again, faulted, plain

    # -- phase 12: sssp, multi_source, solve_batch ---------------------------
    solver = solver_with()
    res, s_sssp = counted("sssp_grid", lambda: solver.sssp(grid, grid_source))
    got = to_numpy(res.dist)[0]
    np.testing.assert_array_equal(np.isinf(got), np.isinf(grid_row))
    np.testing.assert_allclose(got, grid_row, rtol=1e-5, atol=1e-3)
    sssp_err = float(np.abs(np.where(np.isfinite(got), got - grid_row, 0)).max())
    try:
        solver.sssp(cycle_graph, 0)
    except pjt.NegativeCycleError:
        pass
    else:
        raise AssertionError("sssp missed the negative cycle")
    res, s_ms = counted("multi_source_rmat20",
                        lambda: solver.multi_source(rmat, rmat_sources),
                        needs=("fanout_sweep",))
    if (not isinstance(res.dist, torch.Tensor)
            or res.dist.device.type != dev.type):
        raise AssertionError("multi_source's single batch left the card")
    if not np.array_equal(to_numpy(res.dist), rmat_rows):
        raise AssertionError("multi_source rows differ from phase 3's")
    del res
    graphs = [pjt.load_graph(f"{BATCH_SPEC},seed={seed}") for seed in range(4)]
    batch, s_batch = counted("solve_batch_er256",
                             lambda: solver.solve_batch(graphs),
                             needs=("fanout_sweep",))
    # The same Jacobi sweeps one graph at a time: pallas-vm (these dense
    # graphs would take fw, which associates path sums differently).
    sparse = solver_on(dev, fw=False, dense_threshold=0)
    routes = []
    for g, r in zip(graphs, batch):
        single = sparse.solve(g)
        routes.append(r.stats.routes_by_phase["batch_apsp"])
        if routes[-1] != "batch-vmapped":
            raise AssertionError(f"solve_batch took route {routes[-1]}")
        if single.stats.routes_by_phase["fanout"] != "pallas-vm":
            raise AssertionError("the per-graph solve left pallas-vm")
        if not np.array_equal(to_numpy(r.dist), to_numpy(single.dist)):
            raise AssertionError("solve_batch differs from solve()")
    emit({"phase": "entry_points", "sssp": {
              "spec": GRID_SPEC, "source": int(grid_source),
              "seconds": s_sssp, "max_abs_err_vs_phase4": sssp_err,
              "rtol": 1e-5, "atol": 1e-3,
              "negative_cycle": "NegativeCycleError"},
          "multi_source": {"spec": RMAT_SPEC, "sources": len(rmat_sources),
                           "seconds": s_ms, "rows_equal_phase3": True},
          "solve_batch": {"spec": BATCH_SPEC, "graphs": len(graphs),
                          "seconds": s_batch, "routes": routes,
                          "equal_to_solve": True},
          "launches": {k: launches[k] for k in ("sssp_grid",
                                                "multi_source_rmat20",
                                                "solve_batch_er256")}})
    return launches


def drive_pred_paths(dev, rmat, rmat_sources, rmat_rows, grid, gsrc,
                     grid_rows, er, er_matrix) -> tuple[dict, object]:
    """Phase 13: ``predecessors=True`` solves on ``dev``, each path counted
    from 0 (returns the counts by path, and the grid solve's rows for
    phase 23): R-MAT-20 over phase 3's sources
    and the grid over phase 4's (rows bitwise equal to theirs), ``sssp``
    on the grid, the zero-weight tight cycle (``pred-sweep`` with a
    warning), a checkpointed 2-batch solve resumed, and ER-1024 (dense).
    Every tree passes ``validate_pred_tree`` (sampled rows on the large
    graphs)."""
    import tempfile
    import warnings

    import numpy as np

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy
    from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

    launches = {}
    counted = counter(launches)
    report = {}

    def check(label, graph, res, route, rows=None, want_rows=None):
        """Route, rows against ``want_rows`` (bitwise), and the trees of
        ``rows`` (all when None) validated against their own rows."""
        got_route = res.stats.routes_by_phase[
            "fanout" if "fanout" in res.stats.routes_by_phase
            else "bellman_ford"]
        # (A multi-batch solve lists its route once per batch: the
        # stats join distinct "+"-parts only.)
        if set(got_route.split("+")) != set(route.split("+")):
            raise AssertionError(f"{label} took route {got_route}")
        dist, pred = to_numpy(res.dist), to_numpy(res.predecessors)
        if want_rows is not None and not np.array_equal(
                dist[:len(want_rows)], want_rows):
            raise AssertionError(f"{label}: rows differ from the plain solve")
        sel = slice(None) if rows is None else rows
        validate_pred_tree(graph, dist[sel], pred[sel], res.sources[sel])
        report[label] = {
            "route": got_route, "rows": int(dist.shape[0]),
            "validated_rows": "all" if rows is None else list(rows),
            "fanout_s": res.stats.phase_seconds.get("fanout"),
            "iterations": dict(res.stats.iterations_by_phase),
            "launches": launches[label]}

    pred_kernels = ("fanout_sweep", "tight_pred")
    res, s_rmat = counted("pred_rmat20", lambda: solver_on(dev).solve(
        rmat, rmat_sources, predecessors=True), needs=pred_kernels)
    check("pred_rmat20", rmat, res, "pallas-vm+pred", [0, 255, 511],
          rmat_rows)
    report["pred_rmat20"]["seconds"] = s_rmat
    del res
    res, _ = counted("pred_grid512", lambda: solver_on(dev).solve(
        grid, gsrc, predecessors=True), needs=pred_kernels)
    check("pred_grid512", grid, res, "pallas-vm+pred", [0, 255], grid_rows)
    grid_pred_rows = to_numpy(res.dist)
    del res
    res, _ = counted("pred_sssp_grid512", lambda: solver_on(dev).sssp(
        grid, gsrc[0], predecessors=True), needs=("tight_pred",))
    check("pred_sssp_grid512", grid, res, "frontier+pred")
    zero = pjt.CSRGraph.from_edges([0, 3, 1, 2], [3, 1, 2, 1],
                                   [1.0, 0.0, 0.0, 0.0], 4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res, _ = counted("pred_zero_cycle", lambda: solver_on(dev).multi_source(
            zero, [0], predecessors=True), needs=("tight_pred",))
    if not any("fell back" in str(w.message) for w in caught):
        raise AssertionError("the zero-weight tight cycle did not warn")
    check("pred_zero_cycle", zero, res, "pred-sweep")
    small = pjt.load_graph(PRED_CKPT_SPEC)
    ssrc = np.arange(0, small.num_nodes, small.num_nodes // 256)[:256]
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(source_batch_size=128, checkpoint_dir=tmp)
        first, _ = counted("pred_checkpoint_write", lambda: solver_on(
            dev, **kw).solve(small, ssrc, predecessors=True),
            needs=pred_kernels)
        again, _ = counted("pred_checkpoint_resume", lambda: solver_on(
            dev, **kw).solve(small, ssrc, predecessors=True))
    if (first.stats.batches_resumed, again.stats.batches_resumed) != (0, 2):
        raise AssertionError("the checkpointed pred solve did not resume")
    for name in ("dist", "predecessors"):
        if not np.array_equal(getattr(first, name), getattr(again, name)):
            raise AssertionError(f"resumed {name} differ")
    check("pred_checkpoint_write", small, first, "pallas-vm+pred")
    report["pred_checkpoint_write"]["batches_resumed_after"] = 2
    res, _ = counted("pred_er1024", lambda: solver_on(dev, fw=False).solve(
        er, predecessors=True), needs=("minplus", "tight_pred"))
    check("pred_er1024", er, res, "dense-squaring-pallas+pred", None,
          er_matrix)
    del res
    emit({"phase": "pred_solves", "paths": report,
          "zero_cycle_warning": True})
    return launches, grid_pred_rows


def drive_xla_routes(dev, rmat, rmat_sources, rmat_rows, grid, gsrc,
                     grid_rows, er, er_matrix) -> dict:
    """Phase 14: the JAX package's XLA routes in plain PyTorch on ``dev``,
    each beside the hand route on the same sources, rows bitwise equal:
    ``vm-blocked`` on R-MAT-20 (B = 128) and on the grid (B = 64),
    ``sweep-sm`` on R-MAT-16, XLA ``dense-squaring`` on ER-1024. Prints
    each route's fan-out seconds and seconds per sweep."""
    import numpy as np

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy

    launches = {}
    counted = counter(launches)
    routes = {}

    def both(label, graph, sources, kw, want_route, want_rows=None,
             pin=None):
        """The hand route and the XLA route (``kw``), each with ``pin``."""
        pin = pin or {}
        hand, s_hand = counted(f"{label}_hand", lambda: solver_on(
            dev, **pin).solve(graph, sources))
        xla, s_xla = counted(label, lambda: solver_on(dev, **kw, **pin).solve(
            graph, sources))
        got = xla.stats.routes_by_phase["fanout"]
        if got != want_route:
            raise AssertionError(f"{label} took route {got}")
        rows = to_numpy(xla.dist)
        if not np.array_equal(rows, to_numpy(hand.dist)):
            raise AssertionError(f"{label}: rows differ from the hand route")
        if want_rows is not None and not np.array_equal(rows, want_rows):
            raise AssertionError(f"{label}: rows differ from the main path")
        entry = {"route": got, "hand_route": hand.stats.routes_by_phase[
            "fanout"], "sources": len(rows), "seconds": s_xla,
                 "hand_seconds": s_hand}
        for name, r in (("", xla), ("hand_", hand)):
            fan = r.stats.phase_seconds["fanout"]
            sweeps = r.stats.iterations_by_phase["fanout"]
            entry[f"{name}fanout_s"] = fan
            entry[f"{name}sweeps"] = sweeps
            entry[f"{name}s_per_sweep"] = fan / max(sweeps, 1)
        routes[label] = entry

    both("xla_vm_blocked_rmat20", rmat, rmat_sources[:128],
         {"use_pallas": False}, "vm-blocked", rmat_rows[:128])
    both("xla_vm_blocked_grid512", grid, gsrc[:64], {"use_pallas": False},
         "vm-blocked", grid_rows)
    sm = pjt.load_graph(SWEEP_SM_SPEC)
    both("xla_sweep_sm_rmat16", sm, np.arange(0, sm.num_nodes, 1024),
         {"fanout_layout": "source_major"}, "sweep-sm")
    both("xla_dense_er1024", er, np.arange(er.num_nodes),
         {"use_pallas": False}, "dense-squaring", er_matrix, {"fw": False})
    emit({"phase": "xla_routes", "routes": routes})
    return launches


def drive_b1_routes(dev, grid, gsrc, grid_rows, grid_solve_stats,
                    cycle_graph) -> dict:
    """Phase 15: the B=1 routes on ``dev`` (the card), each path counted
    from 0 (returns the counts by path). ``grid_rows`` are the default
    grid solve's first 64 rows over ``gsrc[:64]`` and ``grid_solve_stats``
    its stats (phase 4).

    ``sssp`` from ``gsrc[0]`` on ``sweep`` (``frontier=False``),
    ``frontier`` (the default config), ``dia``, ``gs`` and ``bucket``
    (forced): rows bitwise equal to ``sweep``'s; the first call (upload
    and layouts included) and a second ``bellman_ford`` on the same
    device graph, each on the host clock; ``frontier+pred`` and
    ``dia+pred`` trees validated; the negative cycle raised on each
    forced route; the default solve's phase-1 seconds (phase 4's, and a
    warm rerun) beside a ``frontier=False`` solve's; the ``dia`` and
    ``gs`` fan-outs at
    B = 64 beside ``pallas-vm``'s rows; a ``convergence=True``
    ``use_pallas=False`` solve's trajectory summary."""
    import numpy as np

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy
    from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

    launches = {}
    counted = counter(launches)
    src = int(gsrc[0])
    routes = {"sweep": {"frontier": False}, "frontier": {},
              "dia": {"dia": True}, "gs": {"gauss_seidel": True},
              "bucket": {"bucket": True}}
    report, sweep_row = {}, None
    for name, kw in routes.items():
        res, first_s = counted(f"sssp_{name}", lambda: solver_on(
            dev, **kw).sssp(grid, src))
        tag = res.stats.routes_by_phase["bellman_ford"]
        if tag != name:
            raise AssertionError(f"sssp with {kw} took route {tag}")
        row = to_numpy(res.dist)[0]
        if sweep_row is None:
            sweep_row = row
        elif not np.array_equal(row, sweep_row):
            raise AssertionError(f"sssp on {name}: row differs from sweep's")
        backend = solver_on(dev, **kw).backend
        dgraph = backend.upload(grid)
        backend.bellman_ford(dgraph, src)  # builds the route's layouts
        again, bf_s = counted(f"sssp_{name}_again",
                              lambda: backend.bellman_ford(dgraph, src))
        if not np.array_equal(to_numpy(again.dist), sweep_row):
            raise AssertionError(f"{name}: second run differs")
        reads = {k: v for k, v in launches[f"sssp_{name}_again"].items()
                 if k.endswith("host_reads") and v}
        report[name] = {
            "first_s": first_s, "bf_s": bf_s,
            "iterations": again.iterations,
            "edges_relaxed": again.edges_relaxed,
            "host_reads": reads,
            "s_per_iteration": bf_s / max(again.iterations, 1)}
        del backend, dgraph, again
    pred = {}
    for name in ("frontier", "dia"):
        res, secs = counted(f"sssp_{name}_pred", lambda: solver_on(
            dev, **routes[name]).sssp(grid, src, predecessors=True),
            needs=("tight_pred",))
        tag = res.stats.routes_by_phase["bellman_ford"]
        if tag != f"{name}+pred":
            raise AssertionError(f"pred sssp took route {tag}")
        dist = to_numpy(res.dist)
        if not np.array_equal(dist[0], sweep_row):
            raise AssertionError(f"{name}+pred: row differs from sweep's")
        validate_pred_tree(grid, dist, to_numpy(res.predecessors),
                           res.sources)
        pred[name] = {"route": tag, "seconds": secs, "validated": True,
                      "tight_pred": launches[f"sssp_{name}_pred"][
                          "tight_pred"]}
    cycle = {}
    for name in ("frontier", "dia", "gs", "bucket"):
        try:
            solver_on(dev, **{**routes[name], "frontier": name == "frontier"}
                      ).sssp(cycle_graph, 0)
        except pjt.NegativeCycleError:
            cycle[name] = "NegativeCycleError"
        else:
            raise AssertionError(f"{name} missed the negative cycle")
    # The default grid solve (phase 4) against the same on sweep.
    tags = dict(grid_solve_stats.routes_by_phase)
    if tags != {"bellman_ford": "frontier", "fanout": "pallas-vm"}:
        raise AssertionError(f"default grid solve took {tags}")
    default = {"routes": tags, "phase4_bellman_ford_s":
               grid_solve_stats.phase_seconds["bellman_ford"]}
    # Warm, in turns: the default (frontier) solve, then frontier=False.
    for name, kw in (("frontier", {}), ("sweep", {"frontier": False})):
        res, secs = counted(f"solve_grid512_{name}", lambda: solver_on(
            dev, **kw).solve(grid, gsrc), needs=("fanout_sweep",))
        if res.stats.routes_by_phase != {"bellman_ford": name,
                                         "fanout": "pallas-vm"}:
            raise AssertionError(f"grid solve with {kw} took "
                                 f"{res.stats.routes_by_phase}")
        if not np.array_equal(to_numpy(res.dist)[:64], grid_rows):
            raise AssertionError(f"grid solve with {kw}: rows differ")
        default[name] = {
            "solve_s": secs,
            "bellman_ford_s": res.stats.phase_seconds["bellman_ford"],
            "bellman_ford_iterations":
                res.stats.iterations_by_phase["bellman_ford"],
            "fanout_s": res.stats.phase_seconds["fanout"]}
        del res
    fanout = {}
    for name in ("dia", "gs"):
        res, secs = counted(f"fanout_{name}_grid512", lambda: solver_on(
            dev, **routes[name]).solve(grid, gsrc[:64]))
        if res.stats.routes_by_phase != {"bellman_ford": name,
                                         "fanout": name}:
            raise AssertionError(f"{name} solve took "
                                 f"{res.stats.routes_by_phase}")
        if not np.array_equal(to_numpy(res.dist), grid_rows):
            raise AssertionError(f"{name} fan-out rows differ from "
                                 "pallas-vm's")
        fan = res.stats.phase_seconds["fanout"]
        sweeps = res.stats.iterations_by_phase["fanout"]
        fanout[name] = {"sources": 64, "seconds": secs, "fanout_s": fan,
                        "iterations": sweeps,
                        "s_per_iteration": fan / max(sweeps, 1),
                        "bellman_ford_s": res.stats.phase_seconds[
                            "bellman_ford"],
                        "host_reads": {k: v for k, v in launches[
                            f"fanout_{name}_grid512"].items()
                            if k.endswith("host_reads") and v}}
        del res
    res, secs = counted("trajectory_grid512", lambda: solver_on(
        dev, use_pallas=False, convergence=True).solve(grid, gsrc[:4]))
    conv = res.stats.convergence or {}
    if set(conv) != {"fanout"} or (
            conv["fanout"]["iterations"]
            != res.stats.iterations_by_phase["fanout"]):
        raise AssertionError(f"trajectory: {sorted(conv)}")
    if not np.array_equal(to_numpy(res.dist), grid_rows[:4]):
        raise AssertionError("trajectory solve rows differ")
    trajectory = {"routes": dict(res.stats.routes_by_phase), "seconds": secs,
                  "keys": sorted(conv),
                  "fanout": {k: conv["fanout"][k] for k in (
                      "iterations", "frontier_peak", "frontier_half_life",
                      "tail_iterations", "jfr_skippable_edge_frac",
                      "relaxations_total")}}
    emit({"phase": "b1_routes", "spec": GRID_SPEC, "source": src,
          "sssp": report, "pred": pred, "negative_cycle": cycle,
          "default_solve": default, "fanout_B64": fanout,
          "trajectory": trajectory})
    return launches


def drive_dense_apsp(dev, er, er_matrix) -> tuple[dict, dict, object]:
    """Phase 16: dense APSP on ``dev``, each path counted from 0. Returns
    (launches by path, the ``fw_kleene`` kernel's row data, the default
    ER-1024 matrix for phase 23)."""
    import numpy as np
    import scipy.sparse.csgraph as csgraph
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.graphs import random_graph_batch
    from paralleljohnson_tpu_torch.ops import fw
    from paralleljohnson_tpu_torch.ops.minplus import minplus_kernel
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy
    from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree
    from test_torch_cuda import fw_tile_matrix

    launches = {}
    counted = counter(launches)
    out = {}
    t_phase = time.perf_counter()

    # The Kleene kernel against tile_kleene, bitwise, on the variant
    # kleene_plan names: one cluster launch up to t = 512, the step kernel
    # at KLEENE_STEP_T. Each tile also with a diagonal that goes negative
    # in its last two steps, where row and column k change during step k
    # (read-before-write).
    checks, errs = [], []
    for t in (128, 256, 384, 512, KLEENE_STEP_T):
        for neg in (False, True):
            m = torch.as_tensor(fw_tile_matrix(t, t, negative_diagonal=neg)
                                ).to(dev)
            got, want = fw.fw_kleene(m), fw.tile_kleene(m)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            checks.append({"t": t, "variant": fw.kleene_plan(t).variant,
                           "negative_diagonal": neg,
                           "equal": torch.equal(got, want),
                           "max_abs_err": err})
            if not checks[-1]["equal"]:
                raise AssertionError(f"fw_kleene disagrees with plain: "
                                     f"{checks[-1]}")
            errs.append(err)
    plan = fw.kleene_plan(fw.DEFAULT_FW_TILE)
    occupancy = fw.cluster_occupancy(plan, torch.cuda.current_device())
    emit({"phase": "fw_kleene_plan", "t": fw.DEFAULT_FW_TILE,
          "plan": plan._asdict(), "clusters_on_card": occupancy})
    if occupancy < 1:
        raise AssertionError(f"the card holds no Kleene cluster: {plan}")
    # Times of each variant at its t, with the scratch its plan asks for
    # (none on the cluster variant: the path the solve takes).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    variants = {}
    for t in (fw.DEFAULT_FW_TILE, KLEENE_STEP_T):
        plan = fw.kleene_plan(t)
        m = torch.as_tensor(fw_tile_matrix(t, t)).to(dev)
        dst = torch.empty((t, t), device=dev)
        scratch = (torch.empty((2, t, t), device=dev)
                   if plan.variant == "step" else None)
        kleene = lambda: fw.fw_kleene(m, out=dst, scratch=scratch)
        bms, by = bound(8 * t * t, 2 * t ** 3)
        variants[plan.variant] = {
            "t": t, "ms": event_ms(kleene, reps=20),
            "card_ms": graph_ms(kleene, reps=5),
            "plain_ms": event_ms(lambda: fw.tile_kleene(m), reps=2),
            "bound_ms": bms, "bound_by": by, "plan": plan._asdict()}
        if plan.variant == "cluster":
            # The cluster's own floor: 2 t^3 FP32 instructions on its
            # share of the card's SMs.
            variants[plan.variant]["cluster_floor_ms"] = (
                2 * t ** 3 / (PEAK_F32_INSTR_S * plan.cluster / sms) * 1e3)
            variants[plan.variant]["sms"] = sms
        del m, dst, scratch
    timing = variants["cluster"]

    # 16a: dense FW at the reference's full width, in turns with the
    # squaring and pallas-vm routes on the same graph.
    g = pjt.load_graph(FW_SPEC)
    g = g.with_weights(np.random.default_rng(22).integers(
        1, 10, g.num_real_edges).astype(np.float32))
    v = g.num_nodes
    runs = {"fw": ({}, "fw-tile", ("minplus", "fw_kleene")),
            "squaring": ({"fw": False, "dense_threshold": v,
                          "dense_min_density": 0}, "dense-squaring-pallas",
                         ("minplus",)),
            "pallas_vm": ({"fw": False}, "pallas-vm", ("fanout_sweep",))}
    walls = {name: [] for name in runs}
    rows, counts = {}, {}
    for rep in range(2):
        for name, (kw, want_route, needs) in runs.items():
            res, secs = counted(f"fw_er2048_{name}", lambda: solver_on(
                dev, **kw).solve(g), needs=needs)
            route = res.stats.routes_by_phase["fanout"]
            if route != want_route:
                raise AssertionError(f"er2048 {name} took route {route}")
            walls[name].append(secs)
            rows[name] = to_numpy(res.dist)
            counts[name] = {"route": route,
                            "iterations": res.stats.iterations_by_phase[
                                "fanout"],
                            "edges_relaxed": res.stats.edges_relaxed}
        for name in ("squaring", "pallas_vm"):
            if not np.array_equal(rows[name], rows["fw"]):
                raise AssertionError(f"er2048: fw rows differ from {name}'s")
    tile = fw.effective_tile(v, fw.DEFAULT_FW_TILE)
    vp = fw.pad_tiles(v, tile)
    shapes = {"row_panel": (tile, tile, vp), "col_panel": (vp, tile, tile),
              "trailing": (vp, tile, vp)}
    products = {}
    rng = np.random.default_rng(5)
    for name, (i, k, j) in shapes.items():
        dm = torch.as_tensor(rng.random((i, k), dtype=np.float32)).to(dev)
        am = torch.as_tensor(rng.random((k, j), dtype=np.float32)).to(dev)
        pms, pby = minplus_bound(i, k, j)
        products[name] = {"shape": [i, k, j],
                          "card_ms": graph_ms(lambda: minplus_kernel(dm, am),
                                              reps=10),
                          "bound_ms": pms, "bound_by": pby}
    a = fw.pad_dense(torch.full((v, v), float("inf"), device=dev), tile)
    a.fill_diagonal_(0.0)
    closure_ms = event_ms(lambda: fw.fw_closure(a, tile=tile), reps=3)
    kstep_card_ms = sum(p["card_ms"] for p in products.values())
    out["fw_er2048"] = {
        "spec": FW_SPEC, "V": v, "E": g.num_real_edges, "sources": v,
        "walls_s": walls, "routes": counts, "rows_bitwise_equal": True,
        "tile": tile,
        "ksteps": vp // tile, "fw_macs": fw.fw_mac_count(vp, tile),
        "closure_ms": closure_ms,
        "kleene_card_ms_per_closure": timing["card_ms"],
        "products_card_ms_per_kstep": kstep_card_ms,
        "products_bound_ms_per_kstep": sum(p["bound_ms"]
                                           for p in products.values()),
        "products": products,
        "launches": {name: launches[f"fw_er2048_{name}"] for name in runs}}
    emit({"phase": "dense_fw_er2048", **out["fw_er2048"]})
    del rows, a

    # 16b: the Queue 3 graph at default config, then with predecessors.
    res, secs = counted("fw_er1024", lambda: solver_on(dev).solve(er),
                        needs=("minplus", "fw_kleene"))
    if res.stats.routes_by_phase["fanout"] != "fw-tile":
        raise AssertionError(f"er1024 default took {res.stats.routes_by_phase}")
    oracle = csgraph.dijkstra(er.to_scipy().astype(np.float64), directed=True)
    np.testing.assert_allclose(res.matrix, oracle, rtol=1e-5)
    got = to_numpy(res.dist)
    np.testing.assert_allclose(got, er_matrix, rtol=1e-6)
    differ = int((got != er_matrix).sum())
    pres, psecs = counted("fw_er1024_pred", lambda: solver_on(dev).solve(
        er, predecessors=True), needs=("fw_kleene", "tight_pred"))
    if pres.stats.routes_by_phase["fanout"] != "fw-tile+pred":
        raise AssertionError(f"er1024 pred took {pres.stats.routes_by_phase}")
    if launches["fw_er1024_pred"]["tight_pred"] != 1:
        raise AssertionError("er1024 pred: not one tight_pred launch")
    if not np.array_equal(to_numpy(pres.dist), got):
        raise AssertionError("er1024 pred rows differ from the plain fw solve")
    validate_pred_tree(er, to_numpy(pres.dist), to_numpy(pres.predecessors),
                       pres.sources)
    out["fw_er1024"] = {"spec": ER_SPEC, "route": "fw-tile", "seconds": secs,
                        "pred_route": "fw-tile+pred", "pred_seconds": psecs,
                        "entries_differing_from_squaring": differ,
                        "rtol_vs_squaring": 1e-6,
                        "iterations": dict(res.stats.iterations_by_phase),
                        "edges_relaxed": res.stats.edges_relaxed,
                        "launches": launches["fw_er1024"],
                        "pred_launches": launches["fw_er1024_pred"]}
    emit({"phase": "dense_fw_er1024", **out["fw_er1024"]})
    er_fw_matrix = got
    del res, pres, got

    # 16c: the condensed route, forced, against the default solve.
    grid = pjt.load_graph(PRED_CKPT_SPEC)
    cond = {}
    for label, gr in (("float", grid),
                      ("int", grid.with_weights(np.round(grid.weights)))):
        std, s_std = counted(f"condensed_{label}_standard",
                             lambda: solver_on(dev).solve(gr))
        res, s_cond = counted(f"condensed_{label}", lambda: solver_on(
            dev, partitioned=True).solve(gr), needs=("minplus", "fw_kleene"))
        if res.stats.routes_by_phase["fanout"] != "condensed+fw":
            raise AssertionError(f"condensed took {res.stats.routes_by_phase}")
        want, have = to_numpy(std.dist), to_numpy(res.dist)
        if label == "int":
            if not np.array_equal(have, want):
                raise AssertionError("condensed rows differ on integer weights")
        else:
            np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-4)
        fin = np.isfinite(want)
        plan = res.stats.plan
        cond[label] = {
            "route": "condensed+fw", "seconds": s_cond,
            "standard_seconds": s_std,
            "standard_routes": dict(std.stats.routes_by_phase),
            "parts": plan["num_parts"], "core_size": plan["core_size"],
            "macs": res.stats.edges_relaxed,
            "k_steps": res.stats.iterations_by_phase["fanout"],
            "stage_seconds": plan["seconds"],
            "max_abs_err_vs_standard": float(np.abs(have[fin] - want[fin]).max()),
            "launches": launches[f"condensed_{label}"]}
    n = grid.num_nodes
    ring = pjt.CSRGraph.from_edges(np.arange(n), (np.arange(n) + 1) % n,
                                   np.r_[np.ones(n - 1), -float(n)], n)
    try:
        solver_on(dev, partitioned=True).solve(ring)
    except pjt.NegativeCycleError as e:
        if "across" not in str(e):
            raise AssertionError(f"ring cycle raised elsewhere: {e}")
    else:
        raise AssertionError("the condensed route missed a cycle across parts")
    out["condensed"] = {"spec": PRED_CKPT_SPEC, "V": n, "sources": n, **cond,
                        "negative_cycle_across_parts": "NegativeCycleError"}
    emit({"phase": "condensed_grid64", **out["condensed"]})

    # 16d: the many-small-graphs config through batch_apsp.
    t0 = time.perf_counter()
    graphs = random_graph_batch(BATCH_APSP_GRAPHS, 256, 8 / 256, seed=0)
    gen_s = time.perf_counter() - t0
    res, s_batch = counted("batch_apsp_10k", lambda: solver_on(
        dev).solve_batch(graphs), needs=("fanout_sweep",))
    st = res[0].stats
    if st.routes_by_phase != {"batch_apsp": "batch-vmapped"}:
        raise AssertionError(f"solve_batch took {st.routes_by_phase}")
    sample = np.sort(np.random.default_rng(6).choice(len(graphs), 64,
                                                     replace=False))
    single = solver_on(dev)
    for i in sample:
        gi, got = graphs[i], to_numpy(res[i].dist)
        oracle = csgraph.johnson(gi.to_scipy().astype(np.float64),
                                 directed=True)
        np.testing.assert_array_equal(np.isinf(got), np.isinf(oracle))
        np.testing.assert_allclose(got, oracle, rtol=1e-6)
        if not np.array_equal(got, to_numpy(single.solve(gi).dist)):
            raise AssertionError(f"batch graph {i} differs from its solve()")
    _, s_loop = counted("per_graph_solve_100", lambda: [
        single.solve(gi).dist for gi in graphs[:100]])
    out["batch_apsp"] = {
        "route": "batch-vmapped", "graphs": len(graphs), "V": 256,
        "p": 8 / 256,
        "edges": int(sum(gi.num_real_edges for gi in graphs)),
        "generate_s": gen_s, "seconds": s_batch,
        "phase_seconds": dict(st.phase_seconds),
        "iterations": st.iterations_by_phase["batch_apsp"],
        "edges_relaxed": st.edges_relaxed, "checked_graphs": len(sample),
        "per_graph_loop_100_s": s_loop,
        "launches": launches["batch_apsp_10k"],
        "phase16_s": time.perf_counter() - t_phase}
    emit({"phase": "batch_apsp_10k", **out["batch_apsp"]})
    del res, graphs

    # The kernels the card ran for one closure of each variant (last in
    # the phase: the profiler runs after every timed part), which must be
    # what kleene_plan says: one cluster launch, or the step kernel's t.
    for row in variants.values():
        t = row["t"]
        m = torch.as_tensor(fw_tile_matrix(t, t)).to(dev)
        row["launches_per_closure"] = device_kernels(
            lambda: fw.fw_kleene(m), "kleene")
        want = 1 if row["plan"]["variant"] == "cluster" else t
        if row["launches_per_closure"] != want:
            raise AssertionError(f"fw_kleene at t={t} ran "
                                 f"{row['launches_per_closure']} kernels, "
                                 f"its plan {want}")
        del m
    emit({"phase": "fw_kleene_vs_plain", "checks": checks,
          "timing": variants})
    return launches, {"errs": errs, "timing": timing,
                      "variants": variants}, er_fw_matrix


def drive_dirty_window(dev, rmat) -> dict:
    """Phase 17: the dirty-window route and the priced planner on the
    reference's dirty-window grid at card scale, with the kernels'
    counters from 0 per path (returns them by path).

    1. ``DW_SOURCES`` sources solved three ways with a fresh profile
       store: the default (``pallas-vm``, first, while the store is
       empty), ``dirty_window=True`` (``vm-blocked+dw``) and
       ``use_pallas=False, dirty_window=False`` (``vm-blocked``); exact
       route tags, rows bitwise equal; walls, examined edges and the
       dirty window's overflow (full-sweep) rounds.
    2. The evidence loop in stores of its own, as the reference's bench
       runs it: instrumented ``use_pallas=False`` solves of the grid (each
       width of ``DW_EVIDENCE_WIDTHS``) and R-MAT-20
       (``DW_RMAT_SOURCES``) write ``cuda`` trajectory records;
       ``_dw_decision`` engages for the grid at the first width and
       declines for R-MAT-20; each graph's default solve with its store in
       place, with its decision.
    3. The first store plus the grid's first evidence: ``CostModel`` prices
       ``pallas-vm``, ``vm-blocked`` and ``vm-blocked+dw`` at the grid's
       shape, beside their measured walls; the priced walk's decision and
       whether the translated veto kept ``pallas-vm`` (a default solve,
       rows bitwise equal to step 1's)."""
    import shutil
    import tempfile

    import numpy as np

    from paralleljohnson_tpu_torch.graphs import grid2d, permute_labels
    from paralleljohnson_tpu_torch.observe import (
        CostModel, ProfileStore, shape_bucket,
    )
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy

    launches: dict = {}
    counted = counter(launches)
    t_phase = time.perf_counter()
    grid = permute_labels(grid2d(DW_ROWS, DW_ROWS, negative_fraction=0.0,
                                 seed=7), seed=11)
    v, e = grid.num_nodes, grid.num_real_edges
    rng = np.random.default_rng(0)
    src = np.sort(rng.choice(v, size=DW_SOURCES, replace=False))
    main = tempfile.mkdtemp(prefix="pj-profiles-")
    evidence = tempfile.mkdtemp(prefix="pj-evidence-")
    out: dict = {"spec": f"permute_labels(grid2d({DW_ROWS}, {DW_ROWS}, "
                         "negative_fraction=0.0, seed=7), seed=11)",
                 "V": v, "E": e, "sources": DW_SOURCES}
    try:
        # -- 1: three routes, rows bitwise ---------------------------------
        runs, rows = {}, {}
        for name, kw, needs in (
                ("pallas-vm", {}, ("fanout_sweep",)),
                ("vm-blocked+dw", {"dirty_window": True}, ()),
                ("vm-blocked", {"use_pallas": False, "dirty_window": False},
                 ())):
            res, secs = counted(f"dw_{name}_grid512", lambda kw=kw: solver_on(
                dev, profile_store=main, **kw).solve(grid, src), needs=needs)
            route = res.stats.routes_by_phase.get("fanout")
            if res.stats.routes_by_phase != {"fanout": name}:
                raise AssertionError(f"{name} solve took "
                                     f"{res.stats.routes_by_phase}")
            rows[name] = to_numpy(res.dist)
            conv = (res.stats.convergence or {}).get("fanout") or {}
            runs[name] = {
                "route": route, "seconds": secs,
                "fanout_s": res.stats.phase_seconds["fanout"],
                "iterations": res.stats.iterations_by_phase["fanout"],
                "examined_edges": res.stats.edges_relaxed,
                "full_sweep_rounds": conv.get("full_sweep_rounds"),
                "jfr_skippable_edge_frac": conv.get(
                    "jfr_skippable_edge_frac"),
                "host_reads": {k: n for k, n in launches[
                    f"dw_{name}_grid512"].items()
                    if k.endswith("host_reads") and n},
                "plan": res.stats.plans_by_phase["fanout"]["reason"]}
            del res
        for name in ("vm-blocked+dw", "vm-blocked"):
            if not np.array_equal(rows[name], rows["pallas-vm"]):
                raise AssertionError(f"{name} rows differ from pallas-vm's")
        if runs["vm-blocked+dw"]["full_sweep_rounds"] is None:
            raise AssertionError("the dirty window recorded no trajectory")
        plain_examined = runs["vm-blocked"]["examined_edges"]
        out["routes"] = runs
        out["dw_examined_frac"] = (runs["vm-blocked+dw"]["examined_edges"]
                                   / max(plain_examined, 1))
        emit({"phase": "dirty_window_routes", **out})

        # -- 2: the evidence loop -----------------------------------------
        rsrc = np.sort(np.random.default_rng(1).choice(
            rmat.num_nodes, DW_RMAT_SOURCES, replace=False))
        cases = [(f"grid_B{b}", grid, src[:b], True if i == 0 else None)
                 for i, b in enumerate(DW_EVIDENCE_WIDTHS)]
        cases.append(("rmat20", rmat, rsrc, False))
        stores = {name: tempfile.mkdtemp(prefix="pj-evidence-", dir=evidence)
                  for name, *_ in cases}
        loop = {}
        for name, graph, srcs, engage in cases:
            store = stores[name]
            res, secs = counted(f"dw_evidence_{name}", lambda g=graph, s=srcs,
                                d=store: solver_on(
                                    dev, use_pallas=False, dirty_window=False,
                                    profile_store=d).solve(g, s))
            trajs = [r for r in ProfileStore(store).records()
                     if r["kind"] == "trajectory"]
            if not trajs or {r["platform"] for r in trajs} != {"cuda"}:
                raise AssertionError(f"{name}: trajectory records " + str(
                    [(r["route"], r["platform"]) for r in trajs]))
            backend = solver_on(dev, profile_store=store).backend
            batch = len(srcs) if graph is rmat else DW_SOURCES
            decision = backend._dw_decision(backend.upload(graph), batch)
            if engage is not None and decision["engage"] is not engage:
                raise AssertionError(f"{name}: dw_decision {decision}")
            loop[name] = {"route": res.stats.routes_by_phase["fanout"],
                          "sources": len(srcs), "seconds": secs,
                          "trajectory_records": len(trajs),
                          "device": trajs[-1].get("device"),
                          "summary": {k: trajs[-1]["summary"].get(k) for k in (
                              "iterations", "jfr_skippable_edge_frac",
                              "frontier_half_life")},
                          "dw_decision": {k: decision[k] for k in (
                              "engage", "reason")}}
            del res
        evidence_store = stores[cases[0][0]]
        for name, graph, srcs in ((cases[0][0], grid, cases[0][2]),
                                  ("rmat20", rmat, rsrc)):
            res, secs = counted(f"dw_default_{name}", lambda g=graph, s=srcs,
                                d=stores[name]: solver_on(
                                    dev, profile_store=d).solve(g, s))
            plan = res.stats.plans_by_phase["fanout"]
            loop[name]["default_solve"] = {
                "route": res.stats.routes_by_phase["fanout"],
                "seconds": secs, "chosen": plan["chosen"],
                "reason": plan["reason"], "candidates": plan["candidates"]}
            del res
        emit({"phase": "dirty_window_evidence", **loop})

        # -- 3: the priced routes -----------------------------------------
        store = ProfileStore(main)
        for rec in ProfileStore(evidence_store).records():
            store.append(rec)
        model = CostModel.fit(store)
        priced = {}
        for name in ("pallas-vm", "vm-blocked", "vm-blocked+dw"):
            pred = model.predict(name, num_edges=e, batch=DW_SOURCES,
                                 platform="cuda")
            if pred is None:
                raise AssertionError(f"the cost model does not price {name}")
            priced[name] = {"predicted_s": pred["predicted_s"],
                            "basis": pred["basis"],
                            "measured_fanout_s": runs[name]["fanout_s"]}
        # The decision the priced solve meets (its own records land after).
        backend = solver_on(dev, profile_store=main).backend
        veto = backend._dw_decision(backend.upload(grid), DW_SOURCES)
        res, secs = counted("dw_priced_grid512", lambda: solver_on(
            dev, profile_store=main).solve(grid, src))
        plan = res.stats.plans_by_phase["fanout"]
        if not np.array_equal(to_numpy(res.dist), rows["pallas-vm"]):
            raise AssertionError("the priced solve's rows differ")
        emit({"phase": "dirty_window_priced",
              "shape_bucket": list(shape_bucket(v, e, DW_SOURCES)),
              "priced": priced, "route": res.stats.routes_by_phase["fanout"],
              "seconds": secs, "chosen": plan["chosen"],
              "reason": plan["reason"], "candidates": plan["candidates"],
              "dw_decision": {k: veto[k] for k in ("engage", "reason")},
              "veto_kept_pallas_vm": (
                  res.stats.routes_by_phase["fanout"] == "pallas-vm"
                  and not veto["engage"]),
              "phase17_s": time.perf_counter() - t_phase})
        del res
    finally:
        shutil.rmtree(main, ignore_errors=True)
        shutil.rmtree(evidence, ignore_errors=True)
    return launches


def check_bench_decisions(config: str, d: dict) -> None:
    """The deterministic verdicts of a bench row that the harness records
    without marking the row ``failed``: ``planner_dispatch``'s auto pick
    bitwise its forced run, every forced plan in agreement and none
    declined (``pallas-vm`` measured on the grid and R-MAT); the
    ``dirty_window`` evidence engaging on the grid and declining on
    R-MAT; ``distributed_fleet``'s workers as subprocesses on the card
    with no requeue (a clean run)."""
    if config == "planner_dispatch":
        graphs = d["graphs"]
        declined = {g: v["skipped"] for g, v in graphs.items() if v["skipped"]}
        if not (d["all_bitwise"] and d["all_routes_agree"]) or declined:
            raise AssertionError(
                f"planner_dispatch: all_bitwise {d['all_bitwise']}, "
                f"all_routes_agree {d['all_routes_agree']}, "
                f"declined plans {declined}")
        for g in ("scrambled_grid", "rmat"):
            if "pallas-vm" not in graphs[g]["measured"]:
                raise AssertionError(f"planner_dispatch {g}: pallas-vm "
                                     "was not measured")
    elif config == "dirty_window":
        engage = {g: v["engage"] for g, v in d["dispatch"].items()}
        if engage != {"grid": True, "rmat": False}:
            raise AssertionError(f"dirty_window evidence decisions {engage},"
                                 " expected the grid to engage and R-MAT "
                                 "to decline")
    elif config == "distributed_fleet":
        if d["worker_mode"] != "subprocess" or d["requeues"]:
            raise AssertionError(f"distributed_fleet: {d['worker_mode']} "
                                 f"workers, {d['requeues']} requeues")


def drive_fleet(dev) -> dict:
    """Phase 19: the distributed fleet on the card over ``GRID_SPEC``'s
    first ``FLEET_SOURCES`` sources (``FLEET_SOURCES / FLEET_LEASE``
    leases, ``source_batch_size`` pinned to the lease). (a)
    ``FLEET_WORKERS`` in-process workers, counted as one path
    (``fleet_in_process``) that must launch ``fanout_sweep``: every lease
    committed, no requeue, merged rows (``fleet_rows``) bitwise equal to
    one ``solve()`` of the same sources on the card (``multi_source``
    refuses the grid's negative weights). (b) ``FLEET_PROC_WORKERS``
    worker subprocesses on the card, ``w0`` SIGKILLed after its first
    claim: every lease committed, at least one requeue, ``w0``'s rc -9 and
    the others' 0, rows bitwise equal to (a)'s. A subprocess's launches
    are not counted here; each worker's summary (leases, kernel build
    seconds, wall) is printed. Returns the counts by path."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch import distributed
    from paralleljohnson_tpu_torch.distributed.launch import (
        run_in_process_fleet,
    )

    launches: dict = {}
    counted = counter(launches)
    t_phase = time.perf_counter()
    grid = pjt.load_graph(GRID_SPEC)
    sources = np.arange(FLEET_SOURCES)
    config = {"source_batch_size": FLEET_LEASE}
    root = Path(tempfile.mkdtemp(prefix="pj-fleet-"))

    def plan(name, workers, **kw):
        return distributed.plan_fleet(
            root / name, GRID_SPEC, n_workers=workers,
            num_sources=FLEET_SOURCES, lease_sources=FLEET_LEASE,
            config=config, **kw)

    def summaries(coord, report):
        out = {}
        for wid in report.worker_rcs:
            path = coord.worker_summary_path(wid)
            if not path.exists():  # a killed worker writes none
                out[wid] = None
                continue
            s = json.loads(path.read_text())
            out[wid] = {k: s.get(k) for k in (
                "leases_committed", "sources_solved", "claims",
                "kernel_build_s", "wall_s", "device", "rc")}
        return out

    def check_rows(coord, label):
        rows = distributed.fleet_rows(coord.dir)
        if sorted(rows) != list(range(FLEET_SOURCES)):
            raise AssertionError(f"{label}: fleet rows cover "
                                 f"{len(rows)} sources")
        bad = [int(s) for s in sources if not np.array_equal(rows[s],
                                                             want[s])]
        if bad:
            raise AssertionError(f"{label}: rows of sources {bad[:8]} differ "
                                 "from the card's solve()")

    try:
        ref, ref_s = sync_time(lambda: pjt.ParallelJohnsonSolver(
            pjt.SolverConfig(**config), device=dev).solve(grid, sources))
        want = ref.matrix
        del ref
        # (a) in-process workers, counted.
        coord = plan("in_process", FLEET_WORKERS)
        report, secs = counted("fleet_in_process", lambda: run_in_process_fleet(
            coord, FLEET_WORKERS, device=dev), needs=("fanout_sweep",))
        if not report.ok or report.requeues or set(
                report.worker_rcs.values()) != {0}:
            raise AssertionError(f"in-process fleet: {report.as_dict()}")
        check_rows(coord, "in-process fleet")
        in_process = {"wall_s": secs, "leases": report.leases_total,
                      "requeues": report.requeues,
                      "committed_by": report.status["committed_by"],
                      "workers": summaries(coord, report),
                      "launches": launches["fleet_in_process"]}
        # (b) worker subprocesses on the card, one killed holding a lease.
        coord_b = plan("subprocess", FLEET_PROC_WORKERS,
                       lease_deadline_s=FLEET_DEADLINE_S,
                       heartbeat_stale_s=FLEET_STALE_S,
                       heartbeat_interval_s=0.5)
        report_b, secs_b = sync_time(lambda: distributed.launch_local_fleet(
            coord_b, FLEET_PROC_WORKERS, poll_s=0.25, timeout_s=300,
            self_kill={"w0": 1}, device=dev))
        want_rcs = {f"w{i}": -9 if i == 0 else 0
                    for i in range(FLEET_PROC_WORKERS)}
        if not (report_b.ok and report_b.requeues >= 1
                and report_b.worker_rcs == want_rcs):
            logs = {wid: (coord_b.dir / "logs" / f"{wid}.log").read_text(
                errors="replace")[-2000:] for wid in report_b.worker_rcs}
            raise AssertionError(f"subprocess fleet: {report_b.as_dict()}, "
                                 f"worker logs {logs}")
        check_rows(coord_b, "subprocess fleet")
        emit({"phase": "fleet", "spec": GRID_SPEC, "V": grid.num_nodes,
              "sources": FLEET_SOURCES, "lease_sources": FLEET_LEASE,
              "leases": report.leases_total, "solve_s": ref_s,
              "in_process": in_process,
              "subprocess": {
                  "wall_s": secs_b, "workers": FLEET_PROC_WORKERS,
                  "requeues": report_b.requeues,
                  "extensions": report_b.extensions,
                  "worker_rcs": report_b.worker_rcs,
                  "committed_by": report_b.status["committed_by"],
                  "summaries": summaries(coord_b, report_b)},
              "rows_bitwise_solve": True,
              "phase19_s": time.perf_counter() - t_phase})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def drive_repair(dev) -> dict:
    """Phase 20: incremental repair on the card. The JAX package's
    ``incremental_update`` lattice at ``REPAIR_SIDE`` x ``REPAIR_SIDE``
    (integer weights) is solved into a checkpoint and its
    ``IncrementalState`` attached (path ``incremental_attach``); a
    ``REPAIR_K``-edge update inside the most populated part (the bench's
    draw) is repaired by ``repair_checkpoint`` (path ``repair``): both
    must launch ``fanout_sweep`` (the part closures); ``minplus`` and
    ``fw_kleene`` are counted as they fall (the boundary core's dense
    closure). The repaired rows must equal a fresh ``solve()`` of the
    updated graph bitwise, with fewer dirty parts than parts. Then an
    update of the repaired graph that closes a negative cycle must raise
    ``NegativeCycleError`` (path ``repair_negative_cycle``) and mark the
    status ``failed``. Returns the counts by path."""
    import shutil
    import tempfile

    import numpy as np

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.graphs import grid2d
    from paralleljohnson_tpu_torch.incremental import (
        IncrementalState, read_repair_status, repair_checkpoint,
    )
    from paralleljohnson_tpu_torch.utils.checkpoint import (
        BatchCheckpointer, graph_digest,
    )

    launches: dict = {}
    counted = counter(launches)
    t_phase = time.perf_counter()
    g = grid2d(REPAIR_SIDE, REPAIR_SIDE, seed=17)
    g = g.with_weights(np.maximum(1.0, np.rint(g.weights)).astype(np.float32))
    n = g.num_nodes
    batch = max(16, n // 16)
    root = tempfile.mkdtemp(prefix="pj-repair-")
    try:
        cfg = pjt.SolverConfig(checkpoint_dir=root, source_batch_size=batch)
        _, solve_s = sync_time(lambda: pjt.ParallelJohnsonSolver(
            cfg, device=dev).solve(g))

        def attach():
            st = IncrementalState.build(g, config=cfg, device=dev)
            st.save(BatchCheckpointer(root, graph_key=graph_digest(g)).dir)
            return st

        state, attach_s = counted("incremental_attach", attach,
                                  needs=("fanout_sweep",))
        target = int(np.bincount(state.labels).argmax())
        e = g.num_real_edges
        within = np.flatnonzero((state.labels[g.src[:e]] == target)
                                & (state.labels[g.indices[:e]] == target))
        idx = np.random.default_rng(5).choice(
            within, size=min(REPAIR_K, within.size), replace=False)
        updates = [(int(g.src[i]), int(g.indices[i]),
                    1.0 if j % 2 == 0 else float(g.weights[i]) + 3.0)
                   for j, i in enumerate(idx)]
        new_g, _ = g.apply_edge_updates(updates)
        fresh, fresh_s = sync_time(lambda: pjt.ParallelJohnsonSolver(
            pjt.SolverConfig(source_batch_size=batch), device=dev).solve(new_g))
        want = fresh.matrix
        del fresh
        result, repair_s = counted("repair", lambda: repair_checkpoint(
            root, g, updates, config=cfg, state=state, device=dev),
            needs=("fanout_sweep",))
        if not result.dirty_parts_closed < result.parts_total:
            raise AssertionError(f"repair closed {result.dirty_parts_closed} "
                                 f"of {result.parts_total} parts")
        ck = BatchCheckpointer(root, graph_key=graph_digest(new_g))
        man = ck.manifest()
        if len(man) != n:
            raise AssertionError(f"repaired checkpoint covers {len(man)} of "
                                 f"{n} sources")
        for fn in sorted({f for _b, f in man.values()}):
            srcs = ck.batch_sources(fn)
            loaded = ck.load(int(man[int(srcs[0])][0]), srcs)
            if loaded is None or not np.array_equal(loaded[0], want[srcs]):
                raise AssertionError(f"repaired batch {fn} differs from the "
                                     "fresh solve")
        # A negative cycle through the repaired graph's chained state.
        creating = [(0, 1, 1.0), (1, 0, -5.0)]
        try:
            counted("repair_negative_cycle", lambda: repair_checkpoint(
                root, new_g, creating, config=cfg, device=dev))
        except pjt.NegativeCycleError as exc:
            cycle = str(exc)
        else:
            raise AssertionError("a negative cycle repaired without raising")
        status = read_repair_status(ck.dir)
        if status is None or status["status"] != "failed":
            raise AssertionError(f"negative-cycle repair status {status}")
        out = result.as_dict()
        emit({"phase": "repair", "spec": f"grid2d({REPAIR_SIDE}, "
              f"{REPAIR_SIDE}, seed=17), integer weights", "V": n,
              "E": g.num_real_edges, "k_updates": len(updates),
              "solve_s": solve_s, "attach_s": attach_s,
              "fresh_solve_s": fresh_s, "repair_s": repair_s,
              "repair_speedup": fresh_s / repair_s,
              **{k: out[k] for k in (
                  "parts_total", "dirty_parts_closed", "core_recomputed",
                  "boundary_changed", "affected_rows", "rows_recomputed",
                  "rows_patched", "rows_copied", "batches_rewritten",
                  "expand_macs", "closures_s", "expand_s", "io_s",
                  "wall_s")},
              "boundary": int(state.boundary.size),
              "rows_bitwise_fresh_solve": True,
              "negative_cycle": cycle[:200],
              "launches": {k: launches[k] for k in (
                  "incremental_attach", "repair", "repair_negative_cycle")},
              "phase20_s": time.perf_counter() - t_phase})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def drive_bench(dev) -> dict:
    """Phase 18: ``benchmarks.run`` over every config of the port's
    ``CONFIGS`` at the full preset on ``dev`` (``BENCH_MINI_CONFIGS`` at
    mini), with the flight recorder
    (``<BENCH_DIR>/trace``) and a fresh profile store
    (``<BENCH_DIR>/profiles``), counted as one path (``bench``) that must
    launch all four kernels. Fails on a row with ``failed`` (the
    harness's own checks: FW bitwise against squaring, pipelined rows
    against serial, the tuner's), on the planner's and the dirty
    window's decisions (``check_bench_decisions``), a row not on
    ``cuda``, a config whose Chrome trace does not validate, or a
    heartbeat that never showed CUDA bytes in use (sampled while the
    configs run). Then the ``cpp`` backend on ``BENCH_CPP_CONFIGS`` at
    the same preset, the CPU/OpenMP baseline, beside the card's walls."""
    import shutil
    import threading
    from pathlib import Path

    from paralleljohnson_tpu_torch import benchmarks
    from paralleljohnson_tpu_torch.observe import current_platform
    from paralleljohnson_tpu_torch.utils.telemetry import (
        read_heartbeat, validate_chrome_trace,
    )

    launches: dict = {}
    counted = counter(launches)
    root = Path(BENCH_DIR)
    shutil.rmtree(root, ignore_errors=True)
    trace_dir, profile_dir = root / "trace", root / "profiles"
    heartbeat = trace_dir / "heartbeat.json"
    names = [n for n in benchmarks.CONFIGS if n not in BENCH_OWN_PHASE]
    peak_in_use = [0]
    stop = threading.Event()

    def sample_heartbeat():
        while not stop.wait(0.5):
            try:
                hb = read_heartbeat(heartbeat) or {}
            except (OSError, ValueError):
                continue
            for stats in (hb.get("device_memory") or {}).values():
                peak_in_use[0] = max(peak_in_use[0],
                                     int(stats.get("bytes_in_use", 0)))

    sampler = threading.Thread(target=sample_heartbeat, daemon=True)
    sampler.start()
    def run_all():
        kw = dict(backend="torch", device=dev, telemetry_dir=str(trace_dir),
                  profile_dir=str(profile_dir))
        return (benchmarks.run([n for n in names
                                if n not in BENCH_MINI_CONFIGS],
                               preset=BENCH_PRESET, **kw)
                + benchmarks.run([n for n in names
                                  if n in BENCH_MINI_CONFIGS],
                                 preset="mini", **kw))

    try:
        records, secs = counted(
            "bench", run_all,
            needs=("fanout_sweep", "minplus", "tight_pred", "fw_kleene"))
    finally:
        stop.set()
        sampler.join(timeout=5)
    rows = []
    for rec in records:
        d = rec.detail
        row = {"config": rec.config, "wall_s": rec.wall_s,
               "edges_relaxed_per_sec": rec.edges_relaxed_per_sec,
               "route": d.get("route"), "platform": d.get("platform"),
               "device": d.get("device")}
        if "failed" in d:
            raise AssertionError(f"bench {rec.config} failed: {d['failed']}"
                                 f" (flight file {d.get('flight_recorder')})")
        if d.get("platform") != current_platform(dev) or (
                d["platform"] == "cuda" and not d.get("device")):
            raise AssertionError(f"bench {rec.config} row not on {dev}: {row}")
        check_bench_decisions(rec.config, d)
        trace_file = trace_dir / f"trace-{rec.config}.json"
        validate_chrome_trace(json.loads(trace_file.read_text()))
        # The flight file opens with its meta record; batch_small drives
        # the backend directly, so its file holds no solver span.
        flight = (trace_dir / f"flight-{rec.config}.jsonl").read_text()
        first = flight.splitlines()[0] if flight else "{}"
        if json.loads(first).get("type") != "meta":
            raise AssertionError(f"bench {rec.config}: no flight record")
        if "all_within_band" in d:  # timing-dependent: printed, not held
            row["all_within_band"] = d["all_within_band"]
        for key in ("fleet_speedup", "single_worker_wall_s",
                    "worker_kernel_build_s", "requeues", "repair_speedup",
                    "full_resolve_wall_s", "attach_s", "repair_walls",
                    "dirty_parts", "parts_total", "rows_recomputed",
                    "rows_patched", "rows_copied"):
            if key in d:
                row[key] = d[key]
        rows.append(row)
        emit({"phase": "bench", **row})
    # The full rows (nested detail included) for the records.
    with open(root / "rows.jsonl", "w") as f:
        for rec in records:
            f.write(rec.as_json_line() + "\n")
    if peak_in_use[0] <= 0:
        raise AssertionError("the heartbeat never showed CUDA bytes in use")
    t_cpp = time.perf_counter()
    cpp = benchmarks.run(list(BENCH_CPP_CONFIGS), backend="cpp",
                         preset=BENCH_PRESET, device=dev)
    cpp_s = time.perf_counter() - t_cpp
    by_config = {r["config"]: r for r in rows}
    baseline = {}
    for rec in cpp:
        if "failed" in rec.detail:
            raise AssertionError(f"cpp {rec.config}: {rec.detail['failed']}")
        card = by_config[rec.config]
        baseline[rec.config] = {
            "cpp_wall_s": rec.wall_s, "cuda_wall_s": card["wall_s"],
            "cpp_over_cuda": rec.wall_s / card["wall_s"],
            "cpp_edges_relaxed_per_sec": rec.edges_relaxed_per_sec,
            "platform": rec.detail.get("platform")}
    emit({"phase": "bench_summary", "configs": len(rows), "bench_s": secs,
          "heartbeat_peak_bytes_in_use": peak_in_use[0],
          "cpp_baseline": baseline, "cpp_s": cpp_s,
          "profile_records": sum(1 for _ in open(
              profile_dir / "profiles.jsonl"))})
    return launches


def drive_serve(dev) -> tuple[dict, list]:
    """Phase 21: the serving tier on the card at the bench's
    ``serve_queries`` full size: ``erdos_renyi(SERVE_N, 8 / SERVE_N,
    seed=13)``, a quarter of the sources solved into a checkpointed
    ``TileStore`` (one scheduled batch), a ``LandmarkIndex`` of
    ``SERVE_LANDMARKS`` pivots, then the bench's ``SERVE_QUERIES``-query
    85/15 hit / miss mix (misses answered by landmark bounds) from
    ``SERVE_CLIENTS`` client threads through one ``MicroBatcher``, once
    with the host walk forced and once with the device path forced; then
    one batch through an ``auto`` engine, and the ``serve_overload``
    config at full through real sockets. Counted as one path
    (``serve``) that must launch ``fanout_sweep``. Outside the count it
    fails unless the two response sets are bitwise equal; the store's
    warm rows, the landmark index's forward and reverse rows and the
    card's ``solve()`` of every source are bitwise the plain sweep in
    torch ops (:func:`plain_rows`), and so is every exact answer; every
    landmark interval contains the exact distance; the auto planner on
    ``cuda`` chose ``device_lookup`` with the landmark sub-path on the
    device (f64 probe true); and the overload row has no ``failed``
    verdict but ``OVERLOAD_PRINTED``'s, which is printed. Returns the
    counts by path and the largest absolute difference of each of those
    row sets from the plain sweep's."""
    import shutil
    import tempfile
    import threading
    from pathlib import Path

    import numpy as np
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch import benchmarks
    from paralleljohnson_tpu_torch.graphs import erdos_renyi
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy
    from paralleljohnson_tpu_torch.serve import (
        LandmarkIndex, MicroBatcher, QueryEngine, TileStore,
    )

    launches: dict = {}
    counted = counter(launches)
    t_phase = time.perf_counter()
    n = SERVE_N
    g = erdos_renyi(n, 8.0 / n, seed=13)
    rng = np.random.default_rng(17)
    warm = np.sort(rng.choice(n, size=max(8, n // 4), replace=False))
    cold = np.array(sorted(set(range(n)) - set(map(int, warm))), np.int64)
    hit = rng.random(SERVE_QUERIES) < 0.85
    srcs = np.where(hit, rng.choice(warm, size=SERVE_QUERIES),
                    rng.choice(cold, size=SERVE_QUERIES))
    dsts = rng.integers(0, n, size=SERVE_QUERIES)
    requests = [{"id": i, "source": int(srcs[i]), "dst": int(dsts[i])}
                for i in range(SERVE_QUERIES)]
    root = Path(tempfile.mkdtemp(prefix="pj-serve-"))
    out: dict = {}

    def lookup(store, landmarks, mode):
        engine = QueryEngine(g, store, landmarks=landmarks,
                             miss_policy="landmark", device_lookup=mode,
                             stats_interval_s=0, device=dev)
        mb = MicroBatcher(engine, max_width=max(16, SERVE_CLIENTS))
        answers: list = [None] * len(requests)
        gate = threading.Barrier(SERVE_CLIENTS + 1)
        errors: list = []

        def client(k):
            try:
                gate.wait(timeout=60)
                for req in requests[k::SERVE_CLIENTS]:
                    answers[req["id"]] = mb.submit(req)
            except BaseException as e:  # noqa: BLE001 — surface, don't hang
                errors.append(e)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        gate.wait(timeout=60)
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"serve clients failed or hung: {errors[:3]}")
        stats = engine.stats
        pcts = stats.percentiles()
        path = engine._device_path
        row = {"wall_s": wall, "queries_per_s": len(requests) / wall,
               "device_lookups": stats.device_lookups,
               "host_lookups": stats.host_lookups,
               "tile_rebuilds": None if path is None else path.tile_rebuilds,
               **{k: pcts[k] for k in ("p50_ms", "p50_err_ms", "p99_ms",
                                       "p99_err_ms")},
               "batch_width": stats.batch_hist.percentiles(
                   (50, 99), key="p{p}")}
        engine.close()
        return answers, row

    def serve_path():
        store = TileStore(root / "store", g, hot_rows=max(8, n // 8),
                          warm_rows=n)
        landmarks = LandmarkIndex.build(g, SERVE_LANDMARKS, seed=0,
                                        device=dev)
        warm_engine = QueryEngine(g, store, landmarks=landmarks,
                                  miss_policy="landmark",
                                  stats_interval_s=0, device=dev)
        t0 = time.perf_counter()
        warm_engine.warm(warm)
        out["warm_s"] = time.perf_counter() - t0
        warm_engine.close()
        out["host"] = lookup(store, landmarks, "off")
        out["device"] = lookup(store, landmarks, "on")
        auto = QueryEngine(g, store, landmarks=landmarks,
                           miss_policy="landmark", stats_interval_s=0,
                           device=dev)
        auto.query_batch(requests[:max(16, SERVE_CLIENTS)])
        out["auto"] = auto.last_lookup_decision
        out["auto_f64"] = auto._device_path.landmark_device_ok()
        auto.close()
        out["store"], out["landmarks"] = store, landmarks
        (out["overload"],) = benchmarks.run(
            ["serve_overload"], preset="full", device=dev)

    try:
        _, secs = counted("serve", serve_path, needs=("fanout_sweep",))
        host, host_row = out["host"]
        device, device_row = out["device"]
        if json.dumps(host, sort_keys=True) != json.dumps(device,
                                                          sort_keys=True):
            diff = [i for i, (a, b) in enumerate(zip(host, device)) if a != b]
            raise AssertionError(f"host-forced and device-forced answers "
                                 f"differ at {len(diff)} queries, first "
                                 f"{host[diff[0]]} != {device[diff[0]]}")
        if device_row["device_lookups"] != len(requests) - sum(
                1 for a in device if a.get("tier") in ("warm", "cold")):
            raise AssertionError(f"device path served {device_row}")
        # Every row the card served, held bitwise against the plain sweep
        # in torch ops (:func:`plain_rows`; nonnegative weights, so each
        # row is the sweep's fixpoint with no reweighting): the store's
        # warm rows, the landmark index's forward and reverse pivot rows,
        # and the card's ``solve()`` of every source (``fw=False``: the
        # default's FW would sum sub-paths in another order).
        if g.has_negative_weights:
            raise AssertionError("serve graph has negative weights")
        exact, _, _ = plain_rows(g, np.arange(n), dev)
        store, landmarks = out["store"], out["landmarks"]
        held = {"solve": (pjt.ParallelJohnsonSolver(
                    pjt.SolverConfig(fw=False), device=dev).solve(g).matrix,
                    exact),
                "store": (np.stack([to_numpy(store.get(s)[0])
                                    for s in warm]), exact[warm]),
                "landmark_fwd": (landmarks.fwd, exact[landmarks.sources]
                                 .astype(np.float64)),
                "landmark_rev": (landmarks.rev, plain_rows(
                    g.reverse(), landmarks.sources, dev)[0]
                    .astype(np.float64))}
        errs = []
        for label, (got, want) in held.items():
            errs.append(max_abs_err(torch.as_tensor(got),
                                    torch.as_tensor(want)))
            if got.shape != want.shape or got.tobytes() != want.tobytes():
                raise AssertionError(f"{label} rows on the card are not the "
                                     f"plain sweep's: max_abs_err {errs[-1]}")
        n_exact = n_approx = 0
        for a in device:
            want = float(exact[a["source"], a["dst"]])
            if a["exact"]:
                n_exact += 1
                if a["distance"] != want:
                    raise AssertionError(f"exact answer {a} != plain "
                                         f"row entry {want}")
            else:
                n_approx += 1
                d, err = a["distance"], a["max_error"]
                inside = (np.isinf(d) and np.isinf(want)) or (
                    d - err <= want <= d)
                if a.get("tier") != "landmark" or not inside:
                    raise AssertionError(f"landmark interval of {a} does "
                                         f"not hold the exact {want}")
        auto = out["auto"]
        if (auto["chosen"] != "device_lookup" or not out["auto_f64"]
                or "f64 on the device" not in auto["reason"]):
            raise AssertionError(f"auto lookup decision on cuda: {auto}")
        over = out["overload"]
        wrong = [f for f in over.detail.get("failed", [])
                 if not any(t in f for t in OVERLOAD_PRINTED)]
        if wrong:
            raise AssertionError(f"serve_overload failed: {wrong}")
        emit({"phase": "serve", "V": n, "E": g.num_real_edges,
              "queries": len(requests), "clients": SERVE_CLIENTS,
              "landmarks": SERVE_LANDMARKS, "warm_sources": len(warm),
              "warm_s": out["warm_s"], "host": host_row,
              "device": device_row,
              "device_over_host_speedup":
                  host_row["wall_s"] / device_row["wall_s"],
              "exact_answers": n_exact, "approx_answers": n_approx,
              "answers_bitwise": True, "rows_plain_bitwise": list(held),
              "rows_plain_max_abs_err": max(errs), "auto_decision": auto["chosen"],
              "auto_reason": auto["reason"],
              "overload": {k: over.detail.get(k) for k in (
                  "capacity_per_s", "accepted", "rejected", "shed_answers",
                  "shed_frac", "shed_late_cooldown", "cooldown_timeline",
                  "exact_bitwise_checked", "p50_ms", "p99_ms", "slo")},
              "overload_printed_verdicts": [
                  f for f in over.detail.get("failed", [])
                  if any(t in f for t in OVERLOAD_PRINTED)],
              "overload_wall_s": over.wall_s, "path_s": secs,
              "launches": launches["serve"],
              "phase21_s": time.perf_counter() - t_phase})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, errs


def plain_rows(graph, sources, dev, *, max_iter=None, seed_rows=None):
    """The plain reference of a multi-source sweep on the card, built from
    the graph's own arrays and nothing of the code under test but
    ``relax.bellman_ford_sweeps_vm`` (torch ops): the real edges in
    stable destination order, swept in chunks of ``1 << 20`` edges from
    +inf with 0 at each source (min'd with ``seed_rows`` ``[B, V]`` cast
    to f32), to its fixpoint or ``max_iter`` sweeps. Returns (rows
    ``[B, V]`` on the host, iterations, still_improving)."""
    import numpy as np
    import torch

    from paralleljohnson_tpu_torch.ops import relax
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy

    e = graph.num_real_edges
    dst = np.asarray(graph.indices[:e], np.int64)
    order = np.argsort(dst, kind="stable")
    src = torch.as_tensor(np.asarray(graph.src[:e], np.int64)[order]).to(dev)
    w = torch.as_tensor(np.asarray(graph.weights[:e], np.float32)[order]).to(dev)
    dst = torch.as_tensor(dst[order]).to(dev)
    b = len(sources)
    d0 = torch.full((graph.num_nodes, b), float("inf"), dtype=torch.float32,
                    device=dev)
    d0[torch.as_tensor(np.asarray(sources, np.int64), device=dev),
       torch.arange(b, device=dev)] = 0.0
    if seed_rows is not None:
        d0 = torch.minimum(d0, torch.as_tensor(np.asarray(seed_rows).T).to(
            device=dev, dtype=torch.float32))
    d, iters, improving = relax.bellman_ford_sweeps_vm(
        d0, src, dst, w, edge_chunk=1 << 20,
        max_iter=graph.num_nodes if max_iter is None else int(max_iter))
    return to_numpy(d.T), iters, improving


def hop_against_plain(graph, sources, beta, dev, label, seed_rows=None):
    """``bounded_hop_rows`` on the card (one ``fanout_sweep`` launch per
    edge chunk per sweep) against :func:`plain_rows` capped at ``beta``
    sweeps: rows bitwise, the same iterations and convergence. Returns
    (rows, iterations, converged, chunks, largest absolute error)."""
    import torch

    from paralleljohnson_tpu_torch.ops import hopset as hs

    rows, iters, conv, _ = hs.bounded_hop_rows(
        graph, sources, beta=beta, seed_rows=seed_rows, device=dev)
    n_chunks = -(-graph.num_real_edges // (1 << 20))
    want, p_iters, p_imp = plain_rows(graph, sources, dev, max_iter=beta,
                                      seed_rows=seed_rows)
    err = max_abs_err(torch.from_numpy(rows), torch.from_numpy(want))
    if rows.tobytes() != want.tobytes() or (iters, conv) != (p_iters,
                                                             not p_imp):
        raise AssertionError(
            f"{label}: chunked hop sweep disagrees with plain: max_abs_err "
            f"{err}, iterations {iters} / {p_iters}, converged {conv} / "
            f"{not p_imp}")
    return rows, iters, conv, n_chunks, err


def drive_approx(dev, rmat) -> tuple[dict, list]:
    """Phase 22: the certified approximate tier on the card at the bench's
    ``approx_apsp`` full size: ``grid2d(512, 32, seed=23)``,
    ``APPROX_SOURCES`` sources, an exact ``solve()`` beside
    ``solve_with_budget`` with ``hopset=True`` forced at each epsilon of
    ``APPROX_EPS`` (so a failed launch raises rather than the exact plan
    serving), then a small hopset (k = ``RMAT_HOP_K``, beta =
    ``RMAT_HOP_BETA``) on R-MAT-20, whose 16.7M edges sweep in 16 chunks.
    Counted as one path (``approx``) that must launch ``fanout_sweep``.
    Outside the count, each hopset's forward and reverse beta-hop rows
    and the grid's query rows are held bitwise (with their iterations
    and convergence) against the plain chunked sweep in torch ops
    (:func:`plain_rows`), and every certified interval must hold the
    exact row: the measured error under its certificate, reachability
    true. Returns the counts by path and the comparisons' largest
    absolute errors."""
    import numpy as np

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.graphs import grid2d
    from paralleljohnson_tpu_torch.ops import hopset as hs
    from paralleljohnson_tpu_torch.serve import pick_pivots
    from paralleljohnson_tpu_torch.solver import approx

    launches: dict = {}
    counted = counter(launches)
    t_phase = time.perf_counter()
    g = grid2d(16 * APPROX_SHORT, APPROX_SHORT, seed=23)
    n = g.num_nodes
    sources = np.sort(np.random.default_rng(11).choice(
        n, size=APPROX_SOURCES, replace=False))
    out: dict = {}

    def approx_path():
        solver = pjt.ParallelJohnsonSolver(device=dev)
        res, out["exact_s"] = sync_time(lambda: solver.solve(g, sources))
        out["exact"] = np.asarray(res.matrix, np.float64)
        out["exact_route"] = res.stats.routes_by_phase
        for eps in APPROX_EPS:
            cfg = pjt.SolverConfig(hopset=True, approx_epsilon=eps)
            (r, dec), secs = sync_time(lambda: approx.solve_with_budget(
                g, sources, config=cfg, error_budget=eps, device=dev))
            out[eps] = (r, dec, secs)
        out["rmat_hop"] = hs.build_hopset(rmat, epsilon=0.5, k=RMAT_HOP_K,
                                          beta=RMAT_HOP_BETA, device=dev)

    _, secs = counted("approx", approx_path, needs=("fanout_sweep",))
    exact = out["exact"]
    errs, rows = [], {}
    for eps in APPROX_EPS:
        res, dec, wall = out[eps]
        if dec.chosen.plan.name != "hopset+bf" or res.plan.get("degraded"):
            raise AssertionError(f"eps {eps}: plan {res.plan}")
        hop = res.hopset
        checks = {}
        for label, graph in (("fwd", g), ("rev", g.reverse())):
            got, iters, conv, n_chunks, err = hop_against_plain(
                graph, hop.pivots, hop.beta, dev, f"grid {label} eps {eps}")
            if got.astype(np.float64).tobytes() != getattr(
                    hop, label).tobytes():
                raise AssertionError(f"eps {eps}: the hopset's {label} rows "
                                     "are not the card's sweep")
            errs.append(err)
            checks[label] = {"iterations": iters, "converged": conv,
                             "chunks": n_chunks}
        seed = hop.relay_rows(sources)
        got, iters, conv, _, err = hop_against_plain(
            g, sources, hop.beta, dev, f"grid query eps {eps}",
            seed_rows=seed)
        errs.append(err)
        checks["query"] = {"iterations": iters, "converged": conv}
        est, cert = res.dist, res.max_error
        certified = np.isfinite(cert)
        measured = np.where(np.isfinite(exact) & np.isfinite(est),
                            np.abs(est - exact), 0.0)
        violations = int(np.sum(certified & (measured > cert)))
        wrong_inf = int(np.sum(certified & (np.isfinite(exact)
                                            != np.isfinite(est))))
        if violations or wrong_inf or not certified.all():
            raise AssertionError(
                f"eps {eps}: {violations} entries past their certificate, "
                f"{wrong_inf} reachability mismatches, "
                f"{int((~certified).sum())} uncertified")
        st = res.stats
        rows[f"eps_{eps:g}"] = {
            "beta": hop.beta, "k": hop.k, "hopset_edges": st["hopset_edges"],
            "construction_s": st["construction_s"], "query_s": st["query_s"],
            "wall_s": wall, "speedup": out["exact_s"] / wall,
            "hopset_converged": st["hopset_converged"],
            "query_converged": st["query_converged"],
            "measured_max_error": float(measured.max()),
            "certified_max_bound": float(cert.max()), "sweeps": checks}
    hop = out["rmat_hop"]
    rmat_checks = {}
    for label, graph in (("fwd", rmat), ("rev", rmat.reverse())):
        got, iters, conv, n_chunks, err = hop_against_plain(
            graph, hop.pivots, RMAT_HOP_BETA, dev, f"R-MAT-20 {label}")
        if got.astype(np.float64).tobytes() != getattr(hop, label).tobytes():
            raise AssertionError(f"R-MAT-20 hopset {label} rows are not the "
                                 "card's sweep")
        if n_chunks < 2:
            raise AssertionError(f"R-MAT-20 swept in {n_chunks} chunk")
        errs.append(err)
        rmat_checks[label] = {"iterations": iters, "converged": conv,
                              "chunks": n_chunks}
    if not np.array_equal(hop.pivots, pick_pivots(rmat, RMAT_HOP_K, seed=0)):
        raise AssertionError("R-MAT-20 hopset pivots are not the seeded draw")
    emit({"phase": "approx", "V": n, "E": g.num_real_edges,
          "sources": APPROX_SOURCES, "exact_s": out["exact_s"],
          "exact_route": out["exact_route"], **rows,
          "rmat_hopset": {"k": RMAT_HOP_K, "beta": RMAT_HOP_BETA,
                          "construction_s": hop.construction_s,
                          **rmat_checks},
          "rows_bitwise_plain": True, "certified": True, "path_s": secs,
          "launches": launches["approx"],
          "phase22_s": time.perf_counter() - t_phase})
    return launches, errs


def drive_cli(smi, rmat_sources, rmat_rows, gsrc, grid_pred_rows,
              er_fw_matrix) -> dict:
    """Phase 23: the command line as users run it, ``python -m
    paralleljohnson_tpu_torch ...`` subprocesses on the card with no
    ``--device`` flag (the default is what runs), each one's exit code
    checked and wall printed. Its solves must give phase 3's R-MAT-20
    rows, phase 13's grid rows (with trees that pass
    ``validate_pred_tree``) and phase 16's default ER-1024 matrix bitwise,
    each process launching its kernels (read from its ``--log-stats``
    line, counted in that process from 0). Returns the launches by path."""
    import signal
    import socket
    import tempfile
    from pathlib import Path

    import numpy as np

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "paralleljohnson_tpu_torch"]
    walls, launches = {}, {}
    t_phase = time.perf_counter()

    def run(label, *args, rc=0):
        t0 = time.perf_counter()
        p = subprocess.run([*cmd, *args], capture_output=True, text=True,
                           cwd=root, env=env, timeout=900)
        walls[label] = time.perf_counter() - t0
        print(json.dumps({"cli": label, "rc": p.returncode,
                          "wall_s": walls[label]}), flush=True)
        if p.returncode != rc:
            raise AssertionError(f"cli {label}: rc {p.returncode}, expected "
                                 f"{rc}: {p.stderr[-3000:]}")
        return p

    def solved(label, p, route, needs):
        """The solve's JSON payload; its process's kernel launches from
        the --log-stats line on stderr."""
        payload = json.loads(p.stdout.strip().splitlines()[-1])
        stats = json.loads(p.stderr.strip().splitlines()[-1])
        launches[label] = stats["kernel_launches"]
        got = payload["routes_by_phase"]["fanout"]
        if got != route:
            raise AssertionError(f"cli {label} took route {got}")
        for name in needs:
            if launches[label][name] == 0:
                raise AssertionError(f"cli {label} launched no {name} kernel")
        return payload

    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 1: info names the card and sees phase 1's libraries.
        info = json.loads(run("info", "info", "--json").stdout)
        card = info["devices"][0]
        if f"{card.get('name')}, {card.get('power_limit')}" != smi:
            raise AssertionError(f"cli info devices {info['devices']} do "
                                 f"not name {smi!r}")
        unbuilt = [n for n, lib in info["kernels"]["libraries"].items()
                   if not lib["built"]]
        if unbuilt or info["default_backend_platform"] != "cuda":
            raise AssertionError(f"cli info: unbuilt {unbuilt}, platform "
                                 f"{info['default_backend_platform']}")
        report["info"] = {"devices": info["devices"],
                          "build_dir": info["kernels"]["build_dir"]}
        # 2: R-MAT-20 over phase 3's first CLI_RMAT_SOURCES sources, the
        # main path at full width (the --output writer is zlib: 4 MiB a
        # source).
        out = tmp / "rmat.npz"
        cli_sources = rmat_sources[:CLI_RMAT_SOURCES]
        p = run("solve_rmat20", "solve", RMAT_SPEC, "--sources",
                ",".join(map(str, cli_sources)), "--output", str(out),
                "--json", "--log-stats")
        report["solve_rmat20"] = solved("cli_rmat20", p, "pallas-vm",
                                        ("fanout_sweep",))["phase_seconds"]
        with np.load(out) as z:
            if not (np.array_equal(z["sources"], cli_sources)
                    and np.array_equal(z["dist"],
                                       rmat_rows[:CLI_RMAT_SOURCES])):
                raise AssertionError("cli R-MAT-20 rows differ from phase 3's")
        out.unlink()
        # 3: the grid with trees, phase 4's first CLI_GRID_SOURCES.
        out = tmp / "grid.npz"
        cli_gsrc = gsrc[:CLI_GRID_SOURCES]
        p = run("solve_grid512_pred", "solve", GRID_SPEC, "--sources",
                ",".join(map(str, cli_gsrc)), "--predecessors", "--output",
                str(out), "--json", "--log-stats")
        report["solve_grid512_pred"] = solved(
            "cli_grid512_pred", p, "pallas-vm+pred",
            ("fanout_sweep", "tight_pred"))["phase_seconds"]
        grid = pjt.load_graph(GRID_SPEC)
        with np.load(out) as z:
            dist, pred = z["dist"], z["predecessors"]
        if not np.array_equal(dist, grid_pred_rows[:CLI_GRID_SOURCES]):
            raise AssertionError("cli grid rows differ from phase 13's")
        check = [0, len(cli_gsrc) - 1]
        validate_pred_tree(grid, dist[check], pred[check], cli_gsrc[check])
        del dist, pred
        # 4: dense ER-1024 at the default config (fw-tile).
        out = tmp / "er.npz"
        p = run("solve_er1024", "solve", ER_SPEC, "--output", str(out),
                "--json", "--log-stats")
        report["solve_er1024"] = solved("cli_er1024", p, "fw-tile",
                                        ("minplus", "fw_kleene"))[
                                            "phase_seconds"]
        with np.load(out) as z:
            if not np.array_equal(z["dist"], er_fw_matrix):
                raise AssertionError("cli ER-1024 matrix differs from "
                                     "phase 16's")
        # 5: sssp on the grid, then phase 7's negative cycle as a .gr file.
        p = run("sssp_grid512", "sssp", GRID_SPEC, "--source", str(gsrc[0]),
                "--json")
        if json.loads(p.stdout)["shape"] != [1, grid.num_nodes]:
            raise AssertionError("cli sssp shape")
        cyc = tmp / "cycle.gr"
        cyc.write_text("p sp 4 4\na 1 2 1\na 2 3 2\na 3 4 -4\na 4 2 1\n")
        p = run("solve_negative_cycle", "solve", str(cyc), rc=2)
        if "negative" not in p.stderr:
            raise AssertionError(f"cli negative cycle: {p.stderr[-500:]}")
        # 6: the serve_fleet config, its replicas CLI processes on the card.
        p = run("bench_serve_fleet", "bench", "serve_fleet", "--preset",
                "full")
        row = json.loads(p.stdout.strip().splitlines()[-1])
        if "failed" in row["detail"] or row["detail"]["platform"] != "cuda":
            raise AssertionError(f"cli serve_fleet row: {row['detail']}")
        report["bench_serve_fleet"] = {
            k: row["detail"].get(k) for k in (
                "reroute_lapse_s", "answered", "exact_bitwise_checked",
                "p50_ms", "p99_ms", "verdict", "retry_traces", "device")}
        # 7: a replica on the card registered in a fleet dir, one answer
        # through its socket, top's one document, then SIGTERM: exit 0.
        fleet = tmp / "fleet"
        t0 = time.perf_counter()
        rep = subprocess.Popen(
            [*cmd, "serve", "grid:rows=64,cols=64", "--listen", "127.0.0.1:0",
             "--shed-policy", "reject", "--fleet-dir", str(fleet),
             "--replica-id", "rep-0", "--replica-heartbeat", "0.2"],
            cwd=root, env=env, stdout=subprocess.PIPE, text=True)
        try:
            ann = json.loads(rep.stdout.readline())
            with socket.create_connection((ann["host"], ann["port"]),
                                          timeout=120) as s:
                f = s.makefile("rw", encoding="utf-8", newline="\n")
                json.loads(f.readline())
                f.write(json.dumps({"id": 0, "source": 5, "dst": 4000}) + "\n")
                f.flush()
                answer = json.loads(f.readline())
            want = pjt.ParallelJohnsonSolver().solve(
                pjt.load_graph("grid:rows=64,cols=64"), [5]).matrix[0, 4000]
            if float(answer["distance"]) != float(want):
                raise AssertionError(f"cli replica answered {answer}, "
                                     f"solve() {want}")
            doc = json.loads(run("top", "top", "--once", "--json",
                                 "--fleet-dir", str(fleet)).stdout)
            if list(doc["serve_fleet"]["replicas"]) != ["rep-0"]:
                raise AssertionError(f"cli top: {doc['serve_fleet']}")
            rep.send_signal(signal.SIGTERM)
            rep_rc = rep.wait(timeout=120)
        finally:
            if rep.poll() is None:
                rep.kill()
                rep.wait()
        walls["serve_replica"] = time.perf_counter() - t0
        if rep_rc != 0:
            raise AssertionError(f"cli replica drained with rc {rep_rc}")
        report["top"] = {"verdict": doc["serve_fleet"]["merged"]["verdict"]}
    emit({"phase": "cli", "walls_s": walls, "launches": launches,
          "report": report, "phase23_s": time.perf_counter() - t_phase})
    return launches


# What an in-process mesh must not build: it trades tensors through its
# own exchange.
PROCESS_GROUP_MAKERS = ("ProcessGroupNCCL", "ProcessGroupGloo", "new_group",
                        "init_process_group", "HashStore")


def refuse_process_groups():
    """Make each ``torch.distributed`` constructor of
    ``PROCESS_GROUP_MAKERS`` record its name and raise, until the returned
    ``restore()`` (which may be called more than once). Returns (the
    names asked for, restore)."""
    import torch.distributed as tdist

    built: list = []
    saved = {name: getattr(tdist, name) for name in PROCESS_GROUP_MAKERS
             if hasattr(tdist, name)}

    def refuse(name):
        def make(*args, **kw):
            built.append(name)
            raise AssertionError(f"an in-process mesh built {name}")
        return make

    for name in saved:
        setattr(tdist, name, refuse(name))

    def restore():
        for name, fn in saved.items():
            setattr(tdist, name, fn)
    return built, restore


def mesh_children(stdout: str) -> list[dict]:
    """The ``MESHCHILD`` records in the launcher's output (each a flat
    JSON object; found anywhere in a line)."""
    return [json.loads(m) for m in re.findall(r"MESHCHILD (\{[^{}]*\})",
                                              stdout)]


def mesh_child(out_dir: str) -> int:
    """One process of phase 24's two-process run (``python -m
    torch.distributed.run --nproc_per_node 2 chip_smoke.py --mesh-child
    DIR``): ``multihost.initialize()`` from the launcher's environment,
    ``global_mesh()``, then ``sharded_fanout(replicate=True)`` over
    ``MESH_CHILD_SPEC``'s first ``MESH_CHILD_SOURCES`` sources on the hand
    sweep. Rank 0 saves the rows to DIR/rows.npy; each prints one
    ``MESHCHILD`` JSON line (its device, group backend, sweeps and the
    ``fanout_sweep`` launches of this process)."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend
    from paralleljohnson_tpu_torch.ops.fanout_sweep import fanout_sweep
    from paralleljohnson_tpu_torch.parallel import multihost, sharded_fanout
    from paralleljohnson_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S

    t0 = time.perf_counter()
    if not multihost.initialize(timeout_s=DEFAULT_TIMEOUT_S):
        raise AssertionError("mesh child: no launcher environment")
    mesh = multihost.global_mesh()
    dev = mesh.devices[mesh.world]
    g = pjt.load_graph(MESH_CHILD_SPEC)
    dg = TorchBackend(pjt.SolverConfig(), device=dev).upload(g)
    (indptr_in, src_in, w_in), items = dg.fanout_layout()
    srcs = np.arange(MESH_CHILD_SOURCES)
    garr = multihost.global_sources(mesh, srcs)
    fanout_sweep.launches = 0
    t1 = time.perf_counter()  # the mesh run syncs its rank's stream
    dist, iters, improving, row_sweeps = sharded_fanout(
        mesh, garr, dg.src, dg.dst, dg.weights, num_nodes=g.num_nodes,
        max_iter=g.num_nodes, layout="vertex_major", replicate=True,
        with_row_sweeps=True, n_real_rows=len(srcs),
        in_edges=(indptr_in, src_in, w_in, items))
    secs = time.perf_counter() - t1
    if improving or dist.device != dev:
        raise AssertionError(f"mesh child: improving {improving}, rows on "
                             f"{dist.device}")
    if mesh.world == 0:
        np.save(os.path.join(out_dir, "rows.npy"),
                dist[:len(srcs)].cpu().numpy())
    # One write per line: the processes share the launcher's pipe.
    sys.stdout.write("MESHCHILD " + json.dumps({
        "rank": mesh.world, "world": mesh.size, "device": str(dev),
        "backend": tdist.get_backend(), "mesh": mesh.describe(),
        "sweeps": iters, "row_sweeps": row_sweeps, "fanout_s": secs,
        "launches": fanout_sweep.launches,
        "process_s": time.perf_counter() - t0}) + "\n")
    sys.stdout.flush()
    tdist.destroy_process_group()
    return 0


def mesh_processes(n: int, dev) -> dict:
    """Phase 24's multi-process path: ``n`` processes of
    :func:`mesh_child` under ``python -m torch.distributed.run`` (NCCL
    where each has a card of its own, else gloo), their rows held bitwise
    to one card's solve of the same sources. Raises if the run fails, a
    process launched no sweep, the processes disagree on the row-sweep
    count, or the rows differ; returns the wall seconds and each
    process's record."""
    import socket
    import tempfile

    import numpy as np

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.parallel import mesh as mesh_mod
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy

    with solver_on(dev) as solver:
        want = to_numpy(solver.solve(pjt.load_graph(MESH_CHILD_SPEC),
                                     np.arange(MESH_CHILD_SOURCES)).dist)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k != mesh_mod.MESH_DEVICES_ENV}
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nnodes", "1", "--nproc_per_node", str(n),
             "--master_addr", "127.0.0.1", "--master_port", str(port),
             os.path.abspath(__file__), "--mesh-child", tmp],
            capture_output=True, text=True, cwd=root, env=env,
            timeout=mesh_mod.DEFAULT_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"mesh {n}-process run: rc "
                                 f"{p.returncode}: {p.stderr[-3000:]}")
        children = mesh_children(p.stdout)
        rows = np.load(os.path.join(tmp, "rows.npy"))
    if len(children) != n or any(c["launches"] == 0 for c in children):
        raise AssertionError(f"mesh {n}-process run: {children}")
    if len({c["row_sweeps"] for c in children}) != 1:
        raise AssertionError(f"mesh processes disagree: {children}")
    if not np.array_equal(rows, want):
        raise AssertionError(f"mesh {n}-process rows differ from the "
                             "single-card solve's")
    return {"processes": n, "wall_s": wall, "children": children}


def drive_mesh(dev, rmat, rmat_sources, rmat_rows, grid, gsrc,
               grid_pred_rows) -> dict:
    """Phase 24: the mesh (``parallel.mesh``) on ``MESH_RANKS`` ranks that
    share the card (``PJ_MESH_DEVICES``; the in-process exchange between
    them), each path counted from 0: (a) ``solve()``
    on R-MAT-20 over phase 3's sources, ``mesh_shape=(MESH_RANKS,)``:
    ``sharded-1d``, rows bitwise phase 3's; (b) the grid over phase 4's
    sources with ``edge_shard=True`` and trees: phase 1 ``edge-sharded``,
    the fan-out ``sharded-1d+pred``, rows bitwise phase 13's, trees
    validated; (c) ``mesh_shape=MESH_2D`` on R-MAT-20 over
    ``MESH_2D_SOURCES``: ``sharded-2d``, bitwise; (d) ``sharded_fanout(
    replicate=True)`` called directly: every rank's copy equal to the
    rows, bitwise phase 3's; (e) ``gs-sharded`` and ``dia-sharded`` on a
    ``MESH_GRID_SIDE`` lattice, bitwise the single-card ``pallas-vm``
    solve; (f) two processes under ``torch.distributed.run``
    (:func:`mesh_processes`), rows bitwise the single-card solve. Each
    solver's meshes are closed after its path. Fails on a
    route with ``+1dev-fallback``, or if (a)-(e) built a process group
    (:func:`refuse_process_groups`). Returns the launches by path, summed
    over the in-process paths under ``mesh`` (the child processes' are
    printed)."""
    import numpy as np
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend
    from paralleljohnson_tpu_torch.parallel import make_mesh, sharded_fanout
    from paralleljohnson_tpu_torch.parallel import mesh as mesh_mod
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy
    from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

    launches = {}
    counted = counter(launches)
    report = {}
    t_phase = time.perf_counter()
    saved = os.environ.get(mesh_mod.MESH_DEVICES_ENV)
    os.environ[mesh_mod.MESH_DEVICES_ENV] = f"{dev.type}:0*{MESH_RANKS}"

    def routes_of(res, want, label):
        got = dict(res.stats.routes_by_phase)
        if any(r.endswith("+1dev-fallback") for r in got.values()):
            raise AssertionError(f"mesh {label} fell back: {got}")
        for phase, route in want.items():
            if got.get(phase) != route:
                raise AssertionError(f"mesh {label} took {got}, not {want}")
        return got

    def summary(res, secs, got, label, solver):
        """The path's routes, seconds, mesh, and the host seconds its
        meshes' slowest rank spent in collectives (barrier waits
        included).
        Closes the solver's meshes."""
        be = solver.backend
        meshes = {"fanout": getattr(be, "_mesh_cache", None),
                  "edges": getattr(be, "_edge_mesh_cache", None)}
        report[label] = {
            "routes": got, "seconds": secs,
            "phase_seconds": dict(res.stats.phase_seconds),
            "iterations": dict(res.stats.iterations_by_phase),
            "final_batch": res.stats.final_batch,
            "mesh": be._mesh().describe(),
            "collective_s": {k: m.collective_s for k, m in meshes.items()
                             if m is not None}}
        solver.close()

    built, restore = refuse_process_groups()
    try:
        mesh = make_mesh(device=dev)
        report["mesh"] = {"describe": mesh.describe(),
                          "backends": mesh.backends(),
                          "rank_devices": [str(d) for d in mesh.devices]}
        # (a) R-MAT-20 over phase 3's sources on the 1-D mesh.
        solver = solver_on(dev, mesh_shape=(MESH_RANKS,))
        res, secs = counted("mesh_rmat20",
                            lambda: solver.solve(rmat, rmat_sources),
                            needs=("fanout_sweep",))
        got = routes_of(res, {"fanout": "sharded-1d"}, "rmat20")
        if not np.array_equal(to_numpy(res.dist), rmat_rows):
            raise AssertionError("mesh R-MAT-20 rows differ from phase 3's")
        summary(res, secs, got, "rmat20_sharded_1d", solver)
        del res
        # (b) the grid with edge_shard=True and trees.
        solver = solver_on(dev, mesh_shape=(MESH_RANKS,), edge_shard=True)
        res, secs = counted(
            "mesh_grid512_pred",
            lambda: solver.solve(grid, gsrc, predecessors=True),
            needs=("fanout_sweep", "tight_pred"))
        got = routes_of(res, {"bellman_ford": "edge-sharded",
                              "fanout": "sharded-1d+pred"}, "grid512")
        rows, pred = to_numpy(res.dist), to_numpy(res.predecessors)
        if not np.array_equal(rows, grid_pred_rows):
            raise AssertionError("mesh grid rows differ from phase 13's")
        # The trees of every rank's first and last row in every batch.
        batch = min(res.stats.final_batch, len(gsrc))
        per = -(-batch // MESH_RANKS)
        check = sorted({min(b0 + r * per + k, b0 + batch - 1, len(gsrc) - 1)
                        for b0 in range(0, len(gsrc), batch)
                        for r in range(MESH_RANKS) for k in (0, per - 1)})
        validate_pred_tree(grid, rows[check], pred[check], gsrc[check])
        report["grid512_trees_checked"] = len(check)
        summary(res, secs, got, "grid512_edge_sharded_pred", solver)
        del res, rows, pred
        # (c) the 2-D mesh on R-MAT-20.
        src2d = rmat_sources[:MESH_2D_SOURCES]
        solver = solver_on(dev, mesh_shape=MESH_2D)
        res, secs = counted("mesh_rmat20_2d",
                            lambda: solver.solve(rmat, src2d),
                            needs=("fanout_sweep",))
        got = routes_of(res, {"fanout": "sharded-2d"}, "rmat20 2-D")
        if not np.array_equal(to_numpy(res.dist),
                              rmat_rows[:MESH_2D_SOURCES]):
            raise AssertionError("mesh 2-D R-MAT-20 rows differ from "
                                 "phase 3's")
        summary(res, secs, got, "rmat20_sharded_2d", solver)
        del res
        # (d) sharded_fanout(replicate=True) called directly.
        dg = TorchBackend(pjt.SolverConfig(), device=dev).upload(rmat)
        (indptr_in, src_in, w_in), items = dg.fanout_layout()
        srcs = rmat_sources[:MESH_REPLICATE_SOURCES]
        (dist, iters, improving), secs = counted(
            "mesh_replicate", lambda: sharded_fanout(
                mesh, srcs, dg.src, dg.dst, dg.weights,
                num_nodes=rmat.num_nodes, max_iter=rmat.num_nodes,
                layout="vertex_major", replicate=True,
                in_edges=(indptr_in, src_in, w_in, items)),
            needs=("fanout_sweep",))
        copies = [c for c in dist.replicas
                  if c.device.type == dev.type and torch.equal(c, dist)]
        if improving or len(copies) != MESH_RANKS:
            raise AssertionError(f"mesh replicate: improving {improving}, "
                                 f"{len(copies)} equal copies of "
                                 f"{MESH_RANKS}")
        if not np.array_equal(dist.cpu().numpy(),
                              rmat_rows[:MESH_REPLICATE_SOURCES]):
            raise AssertionError("mesh replicated rows differ from phase 3's")
        report["replicate"] = {"seconds": secs, "sweeps": iters,
                               "copies": len(copies),
                               "copy_bytes": dist.numel() * 4,
                               "collective_s": mesh.collective_s}
        mesh.close()
        del dist, copies, dg, indptr_in, src_in, w_in, items
        # (e) gs-sharded and dia-sharded on a lattice.
        lat = pjt.load_graph(f"grid:rows={MESH_GRID_SIDE},"
                             f"cols={MESH_GRID_SIDE},seed=3")
        lat_src = np.arange(MESH_GRID_SOURCES)
        with solver_on(dev) as solver:
            want = to_numpy(solver.solve(lat, lat_src).dist)
        for label, route, kw in (
                ("mesh_gs", "gs-sharded", dict(gauss_seidel=True,
                                               frontier=False)),
                ("mesh_dia", "dia-sharded", dict(dia=True))):
            solver = solver_on(dev, mesh_shape=(MESH_RANKS,), **kw)
            res, secs = counted(label, lambda: solver.solve(lat, lat_src))
            got = routes_of(res, {"fanout": route}, route)
            if not np.array_equal(to_numpy(res.dist), want):
                raise AssertionError(f"mesh {route} rows differ from "
                                     "pallas-vm's")
            summary(res, secs, got, route, solver)
            del res
        restore()
        if built:
            raise AssertionError(f"the in-process meshes built {built}")
        report["process_groups_built"] = len(built)
        # (f) two processes under torch.distributed.run.
        report["two_process"] = mesh_processes(2, dev)
    finally:
        restore()
        if saved is None:
            os.environ.pop(mesh_mod.MESH_DEVICES_ENV, None)
        else:
            os.environ[mesh_mod.MESH_DEVICES_ENV] = saved
    total = {k: sum(p.get(k, 0) for p in launches.values())
             for k in next(iter(launches.values()))}
    emit({"phase": "mesh", "report": report, "launches": launches,
          "phase24_s": time.perf_counter() - t_phase})
    return {"mesh": total}


def drive_every_card(dev, rmat, rmat_sources, rmat_rows,
                     rmat_rows_f64) -> tuple[dict, dict]:
    """Phase 27: the default mesh over every card. With ``PJ_MESH_DEVICES``
    unset, ``solve()`` on R-MAT-20 over phase 3's sources under a default
    ``SolverConfig`` takes every visible card (``mesh_shape=None``, as the
    JAX package's default mesh takes every device): route ``sharded-1d``
    a rank per card, device copies between them and no process group
    built (:func:`refuse_process_groups`), rows bitwise phase 3's, the hand
    sweep launched (path ``every_card``). Then the same under a default
    ``SolverConfig(precision="f64")`` with trees (path
    ``every_card_f64``): every card again, route ``sharded-1d+pred``, rows
    bitwise ``rmat_rows_f64`` (phase 25's single-card f64 rows), every
    37th tree valid, the sweep and ``tight_pred`` launched. Each solver's
    meshes are closed after. With one card the default mesh is the one
    rank that phases 3-26 already drove: the phase prints one line saying
    so and runs nothing. Returns the counts by path, f32 and f64 apart
    ({} and {} with one card)."""
    import numpy as np
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.parallel import mesh as mesh_mod
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy
    from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"phase": "every_card", "ran": False,
              "why": f"{cards} card visible: the default mesh is one rank, "
                     "which phases 3-26 drove"})
        return {}, {}
    launches: dict = {}
    counted = counter(launches)
    t_phase = time.perf_counter()
    report = {}
    saved = os.environ.pop(mesh_mod.MESH_DEVICES_ENV, None)
    built, restore = refuse_process_groups()
    try:
        for path, precision, trees, needs, route, want in (
                ("every_card", "f32", False, ("fanout_sweep",),
                 "sharded-1d", rmat_rows),
                ("every_card_f64", "f64", True,
                 ("fanout_sweep", "tight_pred"), "sharded-1d+pred",
                 rmat_rows_f64)):
            with pjt.ParallelJohnsonSolver(pjt.SolverConfig(
                    precision=precision), device=dev) as solver:
                res, secs = counted(path, lambda: solver.solve(
                    rmat, rmat_sources, predecessors=trees), needs=needs)
                mesh = solver.backend._mesh()
                row = {"mesh": mesh.describe(), "backends": mesh.backends(),
                       "routes": dict(res.stats.routes_by_phase),
                       "seconds": secs,
                       "phase_seconds": dict(res.stats.phase_seconds),
                       "collective_s": mesh.collective_s,
                       "launches": launches[path]}
            if mesh.size != cards or mesh.backends() != ["threads"]:
                raise AssertionError(f"{path} default mesh: {row}")
            if row["routes"] != {"fanout": route}:
                raise AssertionError(f"{path} default mesh routes: {row}")
            rows = to_numpy(res.dist)
            if not np.array_equal(rows, want):
                raise AssertionError(f"{path}: default-mesh R-MAT-20 rows "
                                     f"differ from one card's")
            if trees:
                check = np.arange(0, len(rmat_sources), 37)
                validate_pred_tree(rmat, rows[check],
                                   to_numpy(res.predecessors)[check],
                                   np.asarray(rmat_sources)[check])
                row["trees_checked"] = len(check)
            report[path] = row
            del res, rows
            torch.cuda.empty_cache()
    finally:
        restore()
        if saved is not None:
            os.environ[mesh_mod.MESH_DEVICES_ENV] = saved
    if built:
        raise AssertionError(f"the every-card meshes built {built}")
    emit({"phase": "every_card", "ran": True, "cards": cards,
          "paths": report, "process_groups_built": len(built),
          "peer_access": {f"{a}->{b}": ok for (a, b), ok in
                          mesh.peer_access().items()},
          "phase27_s": time.perf_counter() - t_phase})
    return ({"every_card": launches["every_card"]},
            {"every_card_f64": launches["every_card_f64"]})


def f64_templates(logs: dict) -> dict:
    """Registers and spill bytes of every f64 instantiation of the four
    kernel sources (template argument ``double``: ``...Id...`` in the
    mangled name), by source and kernel, from the build logs."""
    out = {}
    for name, log in logs.items():
        for f in ptxas_functions(log):
            m = re.search(r"([A-Za-z_]+?)Id([LE].*?)EE", f["function"])
            if m:
                out.setdefault(name, {})[m.group(1) + m.group(2)] = {
                    k: f.get(k) for k in ("registers", "stack_frame",
                                          "spill_stores", "spill_loads")}
    return out


def drive_f64(dev, smi, rmat, rmat_sources, grid, gsrc, er, hub,
              build_logs) -> tuple[dict, dict]:
    """Phase 25: ``precision="f64"`` on the card, on phases 2-5's graphs
    (no new generation). Each f64 kernel against its plain f64 version
    (``torch.equal``, the same flags) at phase 2's shapes, the sweep with
    the main path's hub flags; the f64 kernels' times and bounds (the
    sweep also on the grid at B = 256); then, each path counted from 0:
    R-MAT-20
    over phase 3's 512 sources (``pallas-vm``) and the grid over phase
    4's 256 (``frontier``, ``pallas-vm``), 2 rows each against scipy in
    f64; ER-1024 on ``fw-tile`` and ``dense-squaring-pallas`` against
    scipy; R-MAT-20 with trees over phase 3's sources (trees those of the
    plain pass on its rows); the grid with trees over 64 sources
    (``pallas-vm+pred``, validated); ``cli.main([... "--precision",
    "f64"])`` in process.
    Returns (launches by path, the f64 kernels' rows for the
    ``kernels`` line, the single-card f64 rows phase 26 is held to:
    R-MAT-20's over phase 3's sources, the grid's over the 64 tree
    sources)."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import scipy.sparse.csgraph as csgraph
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch import cli
    from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend
    from paralleljohnson_tpu_torch.ops import fanout_sweep as fs
    from paralleljohnson_tpu_torch.ops import fw
    from paralleljohnson_tpu_torch.ops import minplus as mp_mod
    from paralleljohnson_tpu_torch.ops import pred as pred_mod
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy
    from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree
    from test_torch_cuda import fw_tile_matrix

    f64 = torch.float64
    t_phase = time.perf_counter()
    launches: dict = {}
    counted = counter(launches)
    templates = f64_templates(build_logs)
    bad = {k: t for fns in templates.values() for k, t in fns.items()
           if t.get("stack_frame") or t.get("spill_stores")
           or t.get("spill_loads")}
    if bad or set(templates) != {"fanout_sweep", "minplus", "fw_kleene",
                                 "tight_pred"}:
        raise AssertionError(f"f64 instantiations: spills {bad}, built "
                             f"{sorted(templates)}")
    occ = {"sweep": {f"B{b}{kind}": fs.occupancy(b, dtype=f64,
                                                 hubs=kind == "_hubs")
                     for b in (64, 128, 256, 512) for kind in ("", "_hubs")},
           "minplus": {f"rows{r}": mp_mod.occupancy(r, f64)
                       for r in mp_mod.TILE_ROWS_F64},
           "tight_pred": {f"B{b}{kind}": pred_mod.occupancy(
                              b, dtype=f64, hubs=kind == "_hubs")
                          for b in (64, 128, 512) for kind in ("", "_hubs")}}
    low = [r for r in mp_mod.TILE_ROWS_F64
           if occ["minplus"][f"rows{r}"] < mp_mod.RESIDENT_F64[r]]
    if low or any(o["blocks_per_sm"] < 2 for o in occ["sweep"].values()):
        raise AssertionError(f"f64 occupancy below the plans': {occ}")
    emit({"phase": "f64_build", "occupancy": occ})

    # 25a: each f64 kernel against its plain f64 version.
    def upload64(g):
        dg = TorchBackend(pjt.SolverConfig(precision="f64"),
                          device=dev).upload(g)
        return dg.by_dst(), dg.work_items(), dg

    def sweep_equal(d, lay, itm, label, hubs=None):
        want, imp = fs.fanout_sweep_plain(d, *lay)
        got, flag = fs.fanout_sweep(d, *lay, items=itm, hubs=hubs)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or bool(flag.item()) != bool(imp):
            raise AssertionError(f"f64 fanout_sweep disagrees on {label}")
        return max_abs_err(got, want), want

    def hub_set(dg, b):
        """The main path's hub flags at width b (cached on the device
        graph; None without hubs) and the set's size, bytes one pass wide
        and edge share."""
        flags = dg.hub_flags(b)
        if flags is None:
            return None, {"hub_sources": 0, "hub_bytes": 0,
                          "hub_edge_share": 0.0}
        src = dg.by_dst()[1]
        n = int(torch.unique(src[flags.bool()]).numel())
        return flags, {"hub_sources": n,
                       "hub_bytes": n * fs.hub_row_bytes(b),
                       "hub_edge_share": float(flags.sum()) / src.numel()}

    checks = {"fanout_sweep": [], "minplus": [], "tight_pred": [],
              "fw_kleene": []}
    errs = {k: [] for k in checks}
    lay, itm, dg = upload64(rmat)
    if lay[2].dtype != f64:
        raise AssertionError(f"f64 layout weights are {lay[2].dtype}")
    v, e = rmat.num_nodes, rmat.num_real_edges
    coo = (dg.src[:e], dg.dst[:e], dg.weights[:e])
    rng = np.random.default_rng(25)
    states = {}
    for b in (128, 512):
        src = torch.as_tensor(rng.choice(v, b, replace=False)).to(dev)
        d = torch.full((v, b), float("inf"), dtype=f64, device=dev)
        d[src, torch.arange(b, device=dev)] = 0.0
        for _ in range(3):
            d, _ = fs.fanout_sweep_plain(d, *lay)
        hubs, hub_row = hub_set(dg, b)
        if hubs is None:
            raise AssertionError(f"R-MAT-20 has no f64 hub set at B={b}")
        err, _ = sweep_equal(d, lay, itm, f"R-MAT-20 B={b}", hubs)
        errs["fanout_sweep"].append(err)
        checks["fanout_sweep"].append({"graph": "rmat20", "B": b,
                                       "equal": True, **hub_row})
        conv, sweeps, _ = fs.fanout_fixpoint(d, *lay, max_iter=v, items=itm)
        dt = conv.t().contiguous()
        plain = pred_mod.tight_pred_pass_plain(dt, *coo)
        want, want_flags = pred_mod.tree_flags_plain(plain, dt, src)
        # With the main path's hub flags (L2 policies) and without.
        for h in (hubs, None):
            got, flags = pred_mod.tight_pred_pass(conv, *lay, items=itm,
                                                  sources=src, hubs=h)
            bare = pred_mod.tight_pred_pass(conv, *lay, items=itm, hubs=h)
            torch.cuda.synchronize()
            if not (torch.equal(got.t(), want)
                    and torch.equal(bare.t(), plain)
                    and flags.tolist() == want_flags.tolist() == [0, 0]):
                raise AssertionError(
                    f"f64 tight_pred disagrees on R-MAT-20 B={b} (hubs "
                    f"{h is not None}): flags {flags.tolist()}, plain "
                    f"{want_flags.tolist()}")
            errs["tight_pred"].append(
                float((got.t().long() - want.long()).abs().max()))
            checks["tight_pred"].append({"graph": "rmat20", "B": b,
                                         "hubs": h is not None,
                                         "equal": True,
                                         "flags": flags.tolist(),
                                         "sweeps_to_fixpoint": sweeps})
        states[b] = (d, conv, src, hubs, hub_row)
        del dt, plain, want, bare, got
    # The grid at phase 4's width and sources (its own weights: the same
    # gathers as the reweighted fan-out's): no hubs, one pass.
    grid_lay, grid_itm, grid_dg = upload64(grid)
    d = torch.full((grid.num_nodes, len(gsrc)), float("inf"), dtype=f64,
                   device=dev)
    d[torch.as_tensor(gsrc, device=dev), torch.arange(len(gsrc),
                                                      device=dev)] = 0.0
    for _ in range(3):
        d, _ = fs.fanout_sweep_plain(d, *grid_lay)
    grid_hubs, grid_hub_row = hub_set(grid_dg, len(gsrc))
    err, _ = sweep_equal(d, grid_lay, grid_itm, "the grid B=256", grid_hubs)
    errs["fanout_sweep"].append(err)
    checks["fanout_sweep"].append({"graph": "grid512", "B": len(gsrc),
                                   "equal": True, **grid_hub_row})
    grid_state = (d, grid_hubs, grid_hub_row)
    hub_lay, hub_itm, _ = upload64(hub)
    for b in (1, 5, 128, 200, 512):
        src = torch.as_tensor(rng.integers(0, hub.num_nodes, b)).to(dev)
        d = torch.full((hub.num_nodes, b), float("inf"), dtype=f64,
                       device=dev)
        d[src, torch.arange(b, device=dev)] = 0.0
        for _ in range(3):
            d, _ = fs.fanout_sweep_plain(d, *hub_lay)
        err, _ = sweep_equal(d, hub_lay, hub_itm, f"the hub graph B={b}")
        errs["fanout_sweep"].append(err)
        checks["fanout_sweep"].append({"graph": "hub", "B": b,
                                       "equal": True})
    mp_cases = [(i, 1024, 1024, "") for i in (1, 16, 100, 128, 511, 1024)]
    mp_cases += [(1000, 777, 513, ""), (300, 400, 200, "inf_rows"),
                 (1024, 1024, 1024, "negative"), (300, 300, 300, "d_is_a")]
    for (i, k, j, case) in mp_cases:
        g_rng = np.random.default_rng(i + k + j + len(case))
        dm = torch.as_tensor(g_rng.random((i, k)) * 10)
        am = torch.as_tensor(g_rng.random((k, j)) * 10)
        dm[torch.as_tensor(g_rng.random((i, k)) < 0.3)] = float("inf")
        am[torch.as_tensor(g_rng.random((k, j)) < 0.3)] = float("inf")
        if case == "inf_rows":
            dm[::3] = float("inf")
        if case == "negative":
            dm[torch.as_tensor(g_rng.random((i, k)) < 0.3) & dm.isfinite()] *= -1
        dm, am = dm.to(dev), am.to(dev)
        if case == "d_is_a":
            dm.fill_diagonal_(0.0)
            am = dm
        got, want = mp_mod.minplus_kernel(dm, am), mp_mod.minplus_plain(dm, am)
        torch.cuda.synchronize()
        p = mp_mod.minplus_plan(i, k, j, 8)
        if got.dtype != f64 or not torch.equal(got, want):
            raise AssertionError(f"f64 minplus disagrees at {(i, k, j, case)}")
        errs["minplus"].append(max_abs_err(got, want))
        checks["minplus"].append({"shape": [i, k, j], "case": case,
                                  "tile_rows": p.rows, "splits": p.splits,
                                  "equal": True})
    # The rounds at every RR (t = 40, 41, 200, 500 and 509: +inf padding;
    # at 41 and 509 the last round runs past t), and a tile with -inf
    # entries (NaN candidates, which the kernel's min drops and
    # torch.minimum keeps: equal wherever the plain has none).
    for t in (40, 41, 128, 200, 256, 384, 500, 509, 512, KLEENE_STEP_T):
        for case in ("", "negative_diagonal", "minus_inf"):
            m = torch.as_tensor(fw_tile_matrix(
                t, t, negative_diagonal=case == "negative_diagonal")).double()
            m[torch.isfinite(m)] += 1e-9  # values f32 cannot hold
            if case == "minus_inf":
                m[1, 2] = -float("inf")
            m = m.to(dev)
            got, want = fw.fw_kleene(m), fw.tile_kleene(m)
            torch.cuda.synchronize()
            ok = ~torch.isnan(want)
            if not torch.equal(got[ok], want[ok]):
                raise AssertionError(f"f64 fw_kleene disagrees at t={t} "
                                     f"{case}")
            errs["fw_kleene"].append(max_abs_err(got[ok], want[ok]))
            plan = fw.kleene_plan(t, 8)
            checks["fw_kleene"].append({
                "t": t, "variant": plan.variant, "steps": plan.steps,
                "case": case or "plain", "equal": True,
                "nan_in_plain": int((~ok).sum())})
    plan512 = fw.kleene_plan(fw.DEFAULT_FW_TILE, 8)
    clusters = fw.cluster_occupancy(plan512, torch.cuda.current_device())
    if clusters < 1:
        raise AssertionError(f"the card holds no f64 Kleene cluster: {plan512}")
    emit({"phase": "f64_kernel_vs_plain", "checks": checks,
          "max_abs_err": {k: max(x) for k, x in errs.items()},
          "kleene_plan_512": plan512._asdict(), "clusters_on_card": clusters})

    # 25b: the f64 kernels' times at the main path's shapes, beside their
    # plain versions and bounds (bytes at 8 bytes a value; operations on
    # the FP64 pipes, PEAK_F64_INSTR_S).
    one = torch.ones(1, dtype=torch.int32, device=dev)
    timings = {}

    def time_sweep(key, d, lay, itm, hubs, hub_row, reps):
        """The f64 sweep on the main path's configuration (its hub
        flags), alternating two buffers as the fixpoint does."""
        v, b = d.shape
        e = lay[1].shape[0]
        bufs = (d.clone(), torch.empty_like(d))
        flags = torch.zeros(64 * fs.FLAG_STRIDE, dtype=torch.int32,
                            device=dev)
        words = iter(range(0, flags.numel(), fs.FLAG_STRIDE))
        scratch = torch.empty((itm.n_split, b), dtype=f64, device=dev)
        turn = iter(range(1 << 20))

        def sweep():
            j, r = next(words), next(turn)
            fs.fanout_sweep(bufs[r % 2], *lay, items=itm,
                            out=bufs[(r + 1) % 2], improved=flags[j:j + 1],
                            prev=one, scratch=scratch, hubs=hubs)

        bms, by = bound(8 * 2 * v * b + 4 * (v + 1) + 12 * e, 2 * e * b,
                        instr_s=PEAK_F64_INSTR_S)
        timings[key] = {
            "ms": event_ms(sweep, reps=reps),
            "plain_ms": event_ms(lambda: fs.fanout_sweep_plain(d, *lay),
                                 reps=1),
            "bound_ms": bms, "bound_by": by,
            "gather_depth": fs.occupancy(b, dtype=f64,
                                         hubs=hubs is not None)[
                                             "gather_depth"],
            **hub_row}

    time_sweep(f"fanout_sweep_grid_B{len(gsrc)}", *grid_state[:1], grid_lay,
               grid_itm, *grid_state[1:], reps=20)
    del grid_state, grid_lay, grid_itm, grid_dg
    for b, (d, conv, src, hubs, hub_row) in states.items():
        time_sweep(f"fanout_sweep_B{b}", d, lay, itm, hubs, hub_row, reps=10)
        dt = conv.t().contiguous()
        # The main path's pass, with the sweep's hub flags. The bound
        # counts what the function reads and writes, not the flags (an
        # input of this design only), as the sweep's does.
        bms, by = bound(8 * v * b + 4 * v * b + 4 * (v + 1) + 12 * e
                        + 24 * itm.n_split * b, 4 * e * b,
                        instr_s=PEAK_F64_INSTR_S)
        timings[f"tight_pred_B{b}"] = {
            "ms": event_ms(lambda: pred_mod.tight_pred_pass(
                conv, *lay, items=itm, sources=src, hubs=hubs), reps=5),
            "plain_ms": event_ms(lambda: pred_mod.tree_flags_plain(
                pred_mod.tight_pred_pass_plain(dt, *coo), dt, src),
                reps=1, warmup=0),
            "bound_ms": bms, "bound_by": by,
            "occupancy": pred_mod.occupancy(b, dtype=f64, hubs=True),
            **hub_row}
        del dt
    for (i, k, j) in MINPLUS_SHAPES[:4]:
        g_rng = np.random.default_rng(7)
        dm = torch.as_tensor(g_rng.random((i, k))).to(dev)
        am = torch.as_tensor(g_rng.random((k, j))).to(dev)
        bms, by = minplus_bound(i, k, j, itemsize=8,
                                instr_s=PEAK_F64_INSTR_S)
        p = mp_mod.minplus_plan(i, k, j, 8)
        card = graph_ms(lambda: mp_mod.minplus_kernel(dm, am), reps=20)
        timings[f"minplus_{i}x{k}x{j}"] = {
            "ms": event_ms(lambda: mp_mod.minplus_kernel(dm, am), reps=20),
            "card_ms": card,
            "plain_ms": event_ms(lambda: mp_mod.minplus_plain(dm, am),
                                 reps=2),
            "bound_ms": bms, "bound_by": by, "card_share_of_bound": bms / card,
            "tile_rows": p.rows, "splits": p.splits}
        del dm, am
    for t in (fw.DEFAULT_FW_TILE, KLEENE_STEP_T):
        plan = fw.kleene_plan(t, 8)
        m = torch.as_tensor(fw_tile_matrix(t, t)).double().to(dev)
        dst = torch.empty_like(m)
        scratch = (torch.empty((2, t, t), dtype=f64, device=dev)
                   if plan.variant == "step" else None)
        kleene = lambda: fw.fw_kleene(m, out=dst, scratch=scratch)
        bms, by = bound(16 * t * t, 2 * t ** 3, instr_s=PEAK_F64_INSTR_S)
        timings[f"fw_kleene_{plan.variant}_t{t}"] = {
            "ms": event_ms(kleene, reps=10), "card_ms": graph_ms(kleene,
                                                                 reps=3),
            "plain_ms": event_ms(lambda: fw.tile_kleene(m), reps=1),
            "bound_ms": bms, "bound_by": by, "steps": plan.steps}
        del m, dst, scratch
    emit({"phase": "f64_timing", "device": smi, "timings": timings})
    del states, lay, itm, dg, coo, hub_lay, hub_itm
    torch.cuda.empty_cache()

    # 25c: the solves at f64, each path counted from 0.
    paths = {}

    def solve64(path, g, sources, needs, route, predecessors=False, **kw):
        res, secs = counted(path, lambda: solver_on(
            dev, precision="f64", **kw).solve(g, sources,
                                              predecessors=predecessors),
            needs=needs)
        got = res.stats.routes_by_phase["fanout"]
        if got != route or "float64" not in str(res.dist.dtype):
            raise AssertionError(f"{path}: route {got}, {res.dist.dtype}")
        paths[path] = {"seconds": secs, "route": got,
                       "iterations": dict(res.stats.iterations_by_phase),
                       "phase_seconds": dict(res.stats.phase_seconds),
                       "launches": launches[path]}
        return res

    res = solve64("f64_rmat20", rmat, rmat_sources, ("fanout_sweep",),
                  "pallas-vm")
    rows = to_numpy(res.dist)
    check = [0, len(rmat_sources) - 1]
    oracle = csgraph.dijkstra(rmat.to_scipy().astype(np.float64),
                              directed=True, indices=rmat_sources[check])
    np.testing.assert_array_equal(np.isinf(rows[check]), np.isinf(oracle))
    np.testing.assert_allclose(rows[check], oracle, rtol=1e-12)
    paths["f64_rmat20"]["rows_bitwise_scipy"] = bool(
        np.array_equal(rows[check], oracle))
    del res

    # R-MAT-20 with trees: the f64 pass on the solving path, with the
    # sweep's hub flags, in one batch of all the sources (the memory
    # budget alone would take two of 256; the hub instantiation gains at
    # 512, PERF.md). Rows bitwise the solve's above; trees (and the
    # flags, [0, 0]: no walk) those of the plain pass and tree check on
    # those rows (no negative weight: the potentials are 0, the weights
    # the graph's own).
    walks = pred_mod.pred_reaches_root.walks
    res = solve64("f64_rmat20_pred", rmat, rmat_sources,
                  ("fanout_sweep", "tight_pred"), "pallas-vm+pred",
                  predecessors=True, source_batch_size=len(rmat_sources))
    walks = pred_mod.pred_reaches_root.walks - walks
    if not np.array_equal(to_numpy(res.dist), rows) or walks:
        raise AssertionError(f"f64 R-MAT-20 with trees: rows differ from "
                             f"the solve's, or {walks} walks")
    ref64 = {"rmat_rows": rows}  # phase 26's single-card f64 rows
    del rows
    dg = upload64(rmat)[2]
    e = rmat.num_real_edges
    dt = torch.as_tensor(to_numpy(res.dist)).to(dev)
    srcs = torch.as_tensor(np.asarray(rmat_sources)).to(dev)
    want, want_flags = pred_mod.tree_flags_plain(
        pred_mod.tight_pred_pass_plain(
            dt, dg.src[:e], dg.dst[:e], dg.weights[:e]), dt, srcs)
    got = torch.as_tensor(to_numpy(res.predecessors)).to(dev)
    if not torch.equal(got, want) or want_flags.tolist() != [0, 0]:
        raise AssertionError(f"f64 R-MAT-20 trees differ from the plain "
                             f"pass's (plain flags {want_flags.tolist()})")
    paths["f64_rmat20_pred"].update(
        trees_equal_plain=True, walks=walks,
        hub_edge_share=float(dg.hub_flags(len(rmat_sources)).sum()) / e)
    del res, dt, got, want, dg
    torch.cuda.empty_cache()

    res = solve64("f64_grid512", grid, gsrc, ("fanout_sweep",), "pallas-vm")
    if res.stats.routes_by_phase.get("bellman_ford") != "frontier":
        raise AssertionError(f"f64 grid phase 1: {res.stats.routes_by_phase}")
    h = to_numpy(res.potentials)
    w = grid.weights.astype(np.float64)
    slack = w + h[grid.src] - h[grid.indices]
    if not slack.min() >= -1e-9 * max(1.0, np.abs(h).max()):
        raise AssertionError(f"f64 potentials infeasible: {slack.min()}")
    rows = to_numpy(res.dist)
    check = [0, len(gsrc) - 1]
    d_rew = csgraph.dijkstra(grid.with_weights(np.maximum(slack, 0.0))
                             .to_scipy(), directed=True, indices=gsrc[check])
    oracle = d_rew - h[gsrc[check]][:, None] + h[None, :]
    np.testing.assert_array_equal(np.isinf(rows[check]), np.isinf(oracle))
    np.testing.assert_allclose(rows[check], oracle, rtol=1e-9, atol=1e-9)
    paths["f64_grid512"]["min_slack"] = float(slack.min())
    del res, rows

    er_oracle = csgraph.dijkstra(er.to_scipy().astype(np.float64),
                                 directed=True)
    res = solve64("f64_er1024_fw", er, None, ("fw_kleene", "minplus"),
                  "fw-tile")
    np.testing.assert_allclose(res.matrix, er_oracle, rtol=1e-12)
    er_fw = res.matrix
    res = solve64("f64_er1024_squaring", er, None, ("minplus",),
                  "dense-squaring-pallas", fw=False)
    np.testing.assert_allclose(res.matrix, er_oracle, rtol=1e-12)
    paths["f64_er1024_squaring"]["bitwise_fw"] = bool(
        np.array_equal(res.matrix, er_fw))

    psrc = gsrc[:64]
    res = solve64("f64_grid512_pred", grid, psrc,
                  ("fanout_sweep", "tight_pred"), "pallas-vm+pred",
                  predecessors=True)
    validate_pred_tree(grid, to_numpy(res.dist)[:4],
                       to_numpy(res.predecessors)[:4], psrc[:4])
    ref64.update(grid_pred_sources=psrc, grid_pred_rows=to_numpy(res.dist))
    del res

    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "er64.npz")
        buf = io.StringIO()

        def run_cli():
            with contextlib.redirect_stdout(buf):
                return cli.main(["solve", ER_SPEC, "--precision", "f64",
                                 "--output", out_path, "--json"])

        rc, secs = counted("f64_cli_er1024", run_cli,
                           needs=("fw_kleene", "minplus"))
        payload = json.loads(buf.getvalue().strip().splitlines()[-1])
        with np.load(out_path) as z:
            cli_rows = z["dist"]
        if rc != 0 or payload["routes_by_phase"]["fanout"] != "fw-tile" \
                or cli_rows.dtype != np.float64 \
                or not np.array_equal(cli_rows, er_fw):
            raise AssertionError(f"cli --precision f64: rc {rc}, "
                                 f"{payload.get('routes_by_phase')}, "
                                 f"{cli_rows.dtype}")
        paths["f64_cli_er1024"] = {"seconds": secs, "rc": rc,
                                   "route": "fw-tile", "bitwise_solve": True,
                                   "launches": launches["f64_cli_er1024"]}
    emit({"phase": "f64_solves", "paths": paths,
          "seconds": time.perf_counter() - t_phase})
    rows = {}
    for name, key in (("fanout_sweep", "fanout_sweep_B512"),
                      ("minplus", "minplus_{}x{}x{}".format(
                          *MINPLUS_SHAPES[3])),
                      ("tight_pred", "tight_pred_B512"),
                      ("fw_kleene", f"fw_kleene_cluster_t{fw.DEFAULT_FW_TILE}")):
        rows[name] = dict(timings[key], max_abs_err=max(errs[name]),
                          timed=key)
    return launches, rows, ref64


def drive_f64_layers(dev, rmat, rmat_sources, grid, ref64) -> dict:
    """Phase 26: ``precision="f64"`` above the solver on the card, each
    path counted from 0 and printed with its wall and launches, its rows
    held bitwise to the single-card f64 solve (phase 25's rows in
    ``ref64``, or a single-card f64 solve of the path's own sources):
    (a) the mesh on ``MESH_RANKS`` ranks sharing the card: R-MAT-20 over
    phase 3's sources (``sharded-1d``; each rank's hub flags on a
    ``1 / MESH_RANKS`` share of the L2 budget, printed beside the whole
    budget's set), the first ``F64_MESH_2D_SOURCES`` with trees on
    ``MESH_2D`` (``sharded-2d+pred``: ``tight_pred`` on each source
    group's rank) and the grid with ``edge_shard=True`` and trees over
    phase 25's tree sources (``edge-sharded``, ``sharded-1d+pred``),
    trees validated, then ``gs-sharded`` and ``dia-sharded`` (plain torch
    on each rank) on phase 24's float-weight lattice, held within rtol
    1e-12 to the single-card f64 rows and to scipy's (whether bitwise
    is printed); (b) the fleet, its plan's config at f64, in-process
    workers over the grid; (c) an f64 checkpoint repaired (closures on
    the f64 min-plus); (d) a store from an f64 solve's checkpoint served
    host-forced and device-forced (cold hits, scheduled misses, then hot
    hits); (e) ``approx_apsp`` on R-MAT-20 in f64 with a small hopset
    (every certified interval holding the f64 row) and
    ``solve_with_budget(error_budget=0)`` (the exact plan). Returns the
    launches by path."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import scipy.sparse.csgraph as csgraph
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch import distributed
    from paralleljohnson_tpu_torch.distributed.launch import (
        run_in_process_fleet,
    )
    from paralleljohnson_tpu_torch.graphs import erdos_renyi, grid2d
    from paralleljohnson_tpu_torch.incremental import (
        IncrementalState, repair_checkpoint,
    )
    from paralleljohnson_tpu_torch.ops import fanout_sweep as fs
    from paralleljohnson_tpu_torch.ops import hopset as hs
    from paralleljohnson_tpu_torch.parallel import mesh as mesh_mod
    from paralleljohnson_tpu_torch.serve import QueryEngine, TileStore
    from paralleljohnson_tpu_torch.solver import approx
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy
    from paralleljohnson_tpu_torch.utils.checkpoint import (
        BatchCheckpointer, graph_digest,
    )
    from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

    launches: dict = {}
    counted = counter(launches)
    t_phase = time.perf_counter()
    cfg64 = pjt.SolverConfig(precision="f64")

    def one_card(g, sources):
        with solver_on(dev, precision="f64") as solver:
            return to_numpy(solver.solve(g, sources).dist)

    def done(path, secs, **kw):
        row = {"phase": "f64_layer", "path": path, "seconds": secs,
               "launches": launches[path], **kw}
        emit(row)

    def bitwise(path, got, want):
        got = np.asarray(got)
        if got.dtype != np.float64 or not np.array_equal(got, want):
            raise AssertionError(f"{path}: {got.dtype} rows differ from the "
                                 "single-card f64 solve's")

    def mesh_solve(path, g, sources, routes, needs, **kw):
        with solver_on(dev, precision="f64", **kw) as solver:
            res, secs = counted(path, lambda: solver.solve(
                g, sources, predecessors="pred" in path), needs=needs)
            mesh = solver.backend._mesh()
            info = {"routes": dict(res.stats.routes_by_phase),
                    "mesh": mesh.describe(),
                    "collective_s": mesh.collective_s,
                    "phase_seconds": dict(res.stats.phase_seconds)}
        if info["routes"] != routes:
            raise AssertionError(f"{path} took {info['routes']}")
        return res, secs, info

    # (a) the mesh: no process group (refuse_process_groups).
    saved = os.environ.get(mesh_mod.MESH_DEVICES_ENV)
    os.environ[mesh_mod.MESH_DEVICES_ENV] = f"{dev.type}:0*{MESH_RANKS}"
    built, restore = refuse_process_groups()
    try:
        res, secs, info = mesh_solve(
            "f64_mesh_rmat20", rmat, rmat_sources, {"fanout": "sharded-1d"},
            ("fanout_sweep",), mesh_shape=(MESH_RANKS,))
        bitwise("f64_mesh_rmat20", to_numpy(res.dist), ref64["rmat_rows"])
        del res
        # Each rank's hub set under the one rule, beside the set the whole
        # budget would take (host arithmetic over the out-degrees).
        e = rmat.num_real_edges
        deg = torch.as_tensor(np.bincount(rmat.src[:e],
                                          minlength=rmat.num_nodes))
        per = -(-len(rmat_sources) // MESH_RANKS)
        row_bytes = fs.hub_row_bytes(per)
        hubs = {}
        for label, budget in (("rank", fs.HUB_L2_BYTES // MESH_RANKS),
                              ("whole_l2", fs.HUB_L2_BYTES)):
            h = fs.hub_sources(deg, row_bytes, budget=budget)
            hubs[label] = {"budget_bytes": budget, "hubs": int(h.numel()),
                           "edge_share": float(deg[h].sum()) / e}
        done("f64_mesh_rmat20", secs, hub_sets=hubs, **info)

        src2d = rmat_sources[:F64_MESH_2D_SOURCES]
        res, secs, info = mesh_solve(
            "f64_mesh_rmat20_2d_pred", rmat, src2d,
            {"fanout": "sharded-2d+pred"}, ("fanout_sweep", "tight_pred"),
            mesh_shape=MESH_2D)
        rows, pred = to_numpy(res.dist), to_numpy(res.predecessors)
        bitwise("f64_mesh_rmat20_2d_pred", rows,
                ref64["rmat_rows"][:F64_MESH_2D_SOURCES])
        groups = MESH_2D[0]
        check = sorted({0, len(src2d) // groups, len(src2d) - 1})
        validate_pred_tree(rmat, rows[check], pred[check], src2d[check])
        done("f64_mesh_rmat20_2d_pred", secs, trees_checked=len(check),
             **info)
        del res, rows, pred

        psrc = ref64["grid_pred_sources"]
        res, secs, info = mesh_solve(
            "f64_mesh_grid512_pred", grid, psrc,
            {"bellman_ford": "edge-sharded", "fanout": "sharded-1d+pred"},
            ("fanout_sweep", "tight_pred"), mesh_shape=(MESH_RANKS,),
            edge_shard=True)
        rows, pred = to_numpy(res.dist), to_numpy(res.predecessors)
        bitwise("f64_mesh_grid512_pred", rows, ref64["grid_pred_rows"])
        per = -(-len(psrc) // MESH_RANKS)
        check = sorted({min(r * per + k, len(psrc) - 1)
                        for r in range(MESH_RANKS) for k in (0, per - 1)})
        validate_pred_tree(grid, rows[check], pred[check], psrc[check])
        done("f64_mesh_grid512_pred", secs, trees_checked=len(check), **info)
        del res, rows, pred

        lat = pjt.load_graph(f"grid:rows={MESH_GRID_SIDE},"
                             f"cols={MESH_GRID_SIDE},seed=3")
        lat_src = np.arange(MESH_GRID_SOURCES)
        want = one_card(lat, lat_src)
        oracle = csgraph.dijkstra(lat.to_scipy().astype(np.float64),
                                  directed=True, indices=lat_src)
        for path, route, kw in (
                ("f64_mesh_gs", "gs-sharded", dict(gauss_seidel=True,
                                                   frontier=False)),
                ("f64_mesh_dia", "dia-sharded", dict(dia=True))):
            res, secs, info = mesh_solve(path, lat, lat_src,
                                         {"fanout": route}, (),
                                         mesh_shape=(MESH_RANKS,), **kw)
            rows = to_numpy(res.dist)
            for label, ref in (("one card", want), ("scipy", oracle)):
                if rows.dtype != np.float64 or not np.allclose(
                        rows, ref, rtol=1e-12, atol=0):
                    raise AssertionError(f"{path}: {rows.dtype} rows not "
                                         f"within rtol 1e-12 of {label}'s")
            done(path, secs, bitwise=bool(np.array_equal(rows, want)),
                 bitwise_scipy=bool(np.array_equal(rows, oracle)), **info)
            del res, rows
    finally:
        restore()
        if saved is None:
            os.environ.pop(mesh_mod.MESH_DEVICES_ENV, None)
        else:
            os.environ[mesh_mod.MESH_DEVICES_ENV] = saved
    if built:
        raise AssertionError(f"the f64 in-process meshes built {built}")
    torch.cuda.empty_cache()

    root = Path(tempfile.mkdtemp(prefix="pj-f64-layers-"))
    try:
        # (b) the fleet over the grid, its plan at f64.
        coord = distributed.plan_fleet(
            root / "fleet", GRID_SPEC, n_workers=F64_FLEET_WORKERS,
            num_sources=F64_FLEET_SOURCES, lease_sources=F64_FLEET_LEASE,
            config={"source_batch_size": F64_FLEET_LEASE,
                    "precision": "f64"})
        report, secs = counted("f64_fleet", lambda: run_in_process_fleet(
            coord, F64_FLEET_WORKERS, device=dev), needs=("fanout_sweep",))
        rows = distributed.fleet_rows(coord.dir)
        if not report.ok or sorted(rows) != list(range(F64_FLEET_SOURCES)):
            raise AssertionError(f"f64 fleet: {report.as_dict()}")
        bitwise("f64_fleet", np.stack([rows[s] for s in sorted(rows)]),
                one_card(grid, np.arange(F64_FLEET_SOURCES)))
        done("f64_fleet", secs, leases=report.leases_committed,
             workers=F64_FLEET_WORKERS)
        del rows

        # (c) an f64 checkpoint repaired.
        g = grid2d(F64_REPAIR_SIDE, F64_REPAIR_SIDE, seed=17)
        g = g.astype(np.float64).with_weights(
            np.maximum(1.0, np.rint(g.weights)).astype(np.float64))
        n = g.num_nodes
        ck_dir = str(root / "repair")
        cfg = pjt.SolverConfig(checkpoint_dir=ck_dir, precision="f64",
                               source_batch_size=max(16, n // 16))
        pjt.ParallelJohnsonSolver(cfg, device=dev).solve(g)

        def attach():
            st = IncrementalState.build(g, num_parts=F64_REPAIR_PARTS,
                                        config=cfg, device=dev)
            st.save(BatchCheckpointer(ck_dir, graph_key=graph_digest(g)).dir)
            return st

        state, attach_s = counted("f64_incremental_attach", attach,
                                  needs=("minplus",))
        done("f64_incremental_attach", attach_s,
             core=int(state.boundary.size),
             core_dtype=str(state.core_closed.dtype))
        target = int(np.bincount(state.labels).argmax())
        e = g.num_real_edges
        within = np.flatnonzero((state.labels[g.src[:e]] == target)
                                & (state.labels[g.indices[:e]] == target))
        idx = np.random.default_rng(5).choice(
            within, size=min(F64_REPAIR_K, within.size), replace=False)
        updates = [(int(g.src[i]), int(g.indices[i]),
                    1.0 if j % 2 == 0 else float(g.weights[i]) + 3.0)
                   for j, i in enumerate(idx)]
        result, secs = counted("f64_repair", lambda: repair_checkpoint(
            ck_dir, g, updates, config=cfg, state=state, device=dev),
            needs=("minplus",))
        new_g, _ = g.apply_edge_updates(updates)
        want = one_card(new_g, None)
        ck = BatchCheckpointer(ck_dir, graph_key=graph_digest(new_g))
        man = ck.manifest()
        if len(man) != n:
            raise AssertionError(f"f64 repair covers {len(man)} of {n}")
        for fn in sorted({f for _b, f in man.values()}):
            srcs = ck.batch_sources(fn)
            bitwise("f64_repair", ck.load(int(man[int(srcs[0])][0]),
                                          srcs)[0], want[srcs])
        done("f64_repair", secs, dirty_parts=result.dirty_parts_closed,
             parts=result.parts_total, rows_recomputed=result.rows_recomputed,
             expand_s=result.as_dict().get("expand_s"))
        del want

        # (d) serving from an f64 solve's checkpoint.
        sg = erdos_renyi(SERVE_N, 8 / SERVE_N, seed=13)
        stored = np.arange(0, SERVE_N, SERVE_N // F64_SERVE_STORED)
        pjt.ParallelJohnsonSolver(pjt.SolverConfig(
            precision="f64", checkpoint_dir=str(root / "store_off")),
            device=dev).solve(sg, stored)
        shutil.copytree(root / "store_off", root / "store_on")
        rng = np.random.default_rng(26)
        reqs = [{"id": i, "source": int(s),
                 "dst": [int(t) for t in rng.integers(0, SERVE_N, 4)]}
                for i, s in enumerate(rng.integers(0, SERVE_N,
                                                   F64_SERVE_QUERIES))]
        qsrc = np.unique([r["source"] for r in reqs])

        def serve_both():
            out, lookups = [], []
            for mode in ("off", "on"):
                engine = QueryEngine(sg, TileStore(
                    root / f"store_{mode}", sg, hot_rows=2 * len(qsrc)),
                    config=cfg64, device=dev, device_lookup=mode,
                    stats_interval_s=0)
                try:
                    out.append([engine.query_batch([dict(r) for r in reqs])
                                for _ in range(2)])
                    lookups.append(engine.stats.device_lookups)
                finally:
                    engine.close()
            return out, lookups

        (answers, lookups), secs = counted("f64_serve", serve_both,
                                           needs=("fanout_sweep",))
        if json.dumps(answers[0], sort_keys=True) != json.dumps(
                answers[1], sort_keys=True) or lookups[0] or not lookups[1]:
            raise AssertionError(f"f64 serving: host and device answers "
                                 f"differ, or device lookups {lookups}")
        want = one_card(sg, qsrc)
        at = {int(s): i for i, s in enumerate(qsrc)}
        for r in answers[0][0] + answers[0][1]:
            exact = [float(want[at[r["source"]], t]) for t in r["dst"]]
            if r["distances"] != exact:
                raise AssertionError(f"f64 serving: {r} is not the solve's")
        done("f64_serve", secs, queries=2 * 2 * len(reqs),
             stored=len(stored), device_lookups=lookups[1])
        del want
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (e) the approximate tier on R-MAT-20 in f64.
    rmat64 = rmat.astype(np.float64)
    asrc = rmat_sources[:F64_APPROX_SOURCES]

    def approx_run():
        hop = hs.build_hopset(rmat64, epsilon=0.5, k=RMAT_HOP_K,
                              beta=RMAT_HOP_BETA, seed=0, device=dev)
        return approx.approx_apsp(rmat64, asrc, config=cfg64, hopset=hop,
                                  device=dev)

    res, secs = counted("f64_approx_rmat20", approx_run,
                        needs=("fanout_sweep",))
    exact = ref64["rmat_rows"][:F64_APPROX_SOURCES]
    cert = np.isfinite(res.max_error)
    pinned = cert & ~(np.isinf(res.dist) & np.isinf(exact))
    if not np.all(np.abs(res.dist[pinned] - exact[pinned])
                  <= res.max_error[pinned]):
        raise AssertionError("f64 approx: an interval misses the f64 row")
    done("f64_approx_rmat20", secs, certified_share=float(cert.mean()),
         converged=bool(res.converged),
         construction_s=res.hopset.construction_s,
         query_s=res.stats.get("query_s"))
    (got, dec), secs = counted("f64_approx_exact", lambda: (
        approx.solve_with_budget(rmat64, asrc, config=cfg64,
                                 error_budget=0.0, device=dev)),
        needs=("fanout_sweep",))
    if dec.chosen.plan.name != "exact":
        raise AssertionError(f"error budget 0 took {dec.chosen.plan.name}")
    bitwise("f64_approx_exact", to_numpy(got.dist), exact)
    done("f64_approx_exact", secs, plan=dec.chosen.plan.name)
    del res, got, rmat64
    emit({"phase": "f64_layers", "paths": sorted(launches),
          "phase26_s": time.perf_counter() - t_phase})
    return launches


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2

    import numpy as np
    import scipy.sparse.csgraph as csgraph

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend
    from paralleljohnson_tpu_torch.ops import _cuda
    from paralleljohnson_tpu_torch.ops import fanout_sweep as fs
    from paralleljohnson_tpu_torch.ops.fanout_sweep import (
        fanout_fixpoint, fanout_sweep, fanout_sweep_plain,
    )
    from paralleljohnson_tpu_torch.ops import minplus as mp_mod
    from paralleljohnson_tpu_torch.ops import relax
    from paralleljohnson_tpu_torch.ops.minplus import (
        minplus_fixpoint, minplus_kernel, minplus_plain, minplus_plan,
    )
    from paralleljohnson_tpu_torch.ops import pred as pred_mod
    from paralleljohnson_tpu_torch.ops.pred import (
        certify_pred, pred_reaches_root, tight_pred_pass,
        tight_pred_pass_plain, tree_flags_plain,
    )
    from paralleljohnson_tpu_torch.solver.johnson import _unreweight, to_numpy

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # -- phase 1: the card and the build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = _cuda.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in logs.items()
    }
    occupancy = {f"B{b}": fs.occupancy(b) for b in (128, 256, 512)}
    mp_occupancy = {rows: mp_mod.occupancy(rows) for rows in mp_mod.RESIDENT}
    pred_templates = tight_pred_templates(logs["tight_pred"])
    pred_occupancy = {f"B{b}": pred_mod.occupancy(b) for b in (128, 256, 512)}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "f64_templates": f64_templates(logs),
          "tight_pred_templates": pred_templates,
          "tight_pred_occupancy": pred_occupancy,
          "sweep_occupancy": occupancy,
          "minplus_occupancy": {f"rows{r}": n for r, n in mp_occupancy.items()},
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": kind})
    low = {k: o for k, o in occupancy.items() if o["blocks_per_sm"] < 2}
    if low:
        raise AssertionError(f"sweep kernel below 2 blocks per SM: {low}")
    low = {r: n for r, n in mp_occupancy.items() if n < mp_mod.RESIDENT[r]}
    if low:
        raise AssertionError(f"min-plus tiles below the plan's resident "
                             f"blocks per SM: {low}")
    # A stack frame is a register array that went to local memory (the
    # Kleene kernel's hazard: an array indexed by the step) even where
    # nothing spills.
    spills = [f"{name}: {f}" for name, log in logs.items()
              for f in ptxas_functions(log)
              if f.get("stack_frame") or f.get("spill_stores")
              or f.get("spill_loads")]
    if spills:
        raise AssertionError(f"ptxas reports stack frames or spills: {spills}")

    def sweep_equal(d, layout, items, label):
        """The kernel against the plain sweep on ``d``: raises unless
        ``torch.equal`` with the same flag. Returns (largest absolute
        error, flag, the plain sweep's result)."""
        want, imp = fanout_sweep_plain(d, *layout)
        got, flag = fanout_sweep(d, *layout, items=items)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if not torch.equal(got, want) or bool(flag.item()) != bool(imp):
            raise AssertionError(
                f"fanout_sweep disagrees with plain on {label}: max_abs_err "
                f"{err}, flag {bool(flag.item())}, plain flag {bool(imp)}")
        return err, bool(imp), want

    def pred_equal(d, lay, itm, coo, sources, label):
        """tight_pred on the converged ``d`` [V, B] against the plain
        pass over the COO ``coo`` on ``d``'s transpose, without and with
        the column ``sources``: raises unless the trees are ``torch.equal``
        and, with the sources, the masked trees and the flags equal
        ``tree_flags_plain``'s. Returns (largest absolute difference of
        the int32 trees, share of entries with a tight in-edge, flags)."""
        got = tight_pred_pass(d, *lay, items=itm)
        got_s, flags = tight_pred_pass(d, *lay, items=itm, sources=sources)
        dt = d.t().contiguous()
        plain = tight_pred_pass_plain(dt, *coo)
        want_s, want_flags = tree_flags_plain(plain, dt, sources)
        want = plain.t()
        torch.cuda.synchronize()
        err = max(float((got.long() - want.long()).abs().max()),
                  float((got_s.t().long() - want_s.long()).abs().max()))
        if not (torch.equal(got, want) and torch.equal(got_s.t(), want_s)
                and torch.equal(flags, want_flags)):
            raise AssertionError(
                f"tight_pred disagrees with plain on {label}: max_abs_err "
                f"{err}, flags {flags.tolist()}, plain {want_flags.tolist()}")
        del dt, plain, want_s
        return err, float((got >= 0).float().mean()), flags.tolist()

    # -- phase 2: each kernel against its plain version ---------------------
    t0 = time.perf_counter()
    rmat = pjt.load_graph(RMAT_SPEC)
    gen_s = time.perf_counter() - t0
    v, e = rmat.num_nodes, rmat.num_real_edges
    layout_graph = TorchBackend(pjt.SolverConfig(), device=dev).upload(rmat)
    layout = layout_graph.by_dst()
    items = layout_graph.work_items()
    rng = np.random.default_rng(0)
    sweep_states, sweep_sources = {}, {}
    sweep_checks = []
    for b in (128, 512):
        src = torch.as_tensor(rng.choice(v, b, replace=False)).to(dev)
        sweep_sources[b] = src
        d = torch.full((v, b), float("inf"), device=dev)
        d[src, torch.arange(b, device=dev)] = 0.0
        for _ in range(3):  # a block with finite values to fold
            d, _ = fanout_sweep_plain(d, *layout)
        err, flag, _ = sweep_equal(d, layout, items, f"RMAT-20 B={b}")
        sweep_checks.append({"graph": "rmat20", "B": b, "equal": True,
                             "max_abs_err": err, "flag": flag})
        sweep_states[b] = (d, err)
    # tight_pred on R-MAT-20's converged fan-out (its split hub rows
    # included), B = 128 and 512; the states stay for phase 8's times.
    rmat_coo = (layout_graph.src[:e], layout_graph.dst[:e],
                layout_graph.weights[:e])
    pred_states, pred_checks = {}, []
    for b, (d, _) in sweep_states.items():
        conv, sweeps, _ = fanout_fixpoint(d.clone(), *layout, max_iter=v,
                                          items=items)
        err, tight, flags = pred_equal(conv, layout, items, rmat_coo,
                                       sweep_sources[b], f"RMAT-20 B={b}")
        if flags != [0, 0]:  # weights in [1, 10): every tree descends
            raise AssertionError(f"RMAT-20 B={b} raised tree flags {flags}")
        pred_checks.append({"graph": "rmat20", "B": b, "equal": True,
                            "max_abs_err": err, "tight_share": tight,
                            "flags": flags, "sweeps_to_fixpoint": sweeps})
        pred_states[b] = conv
    # The hub graph of the card tests (JAX-free), on R-MAT-16.
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from test_torch_cuda import hub_graph

    hub = hub_graph(pjt.load_graph("rmat:scale=16,ef=8,seed=2"),
                    fs.ITEM_EDGES, inf_frac=0.3)
    hub_layout_graph = TorchBackend(pjt.SolverConfig(), device=dev).upload(hub)
    hub_layout = hub_layout_graph.by_dst()
    hub_items = hub_layout_graph.work_items()
    hub_rng = np.random.default_rng(3)
    hub_errs = []
    for b in (1, 5, 128, 200, 512):
        src = torch.as_tensor(hub_rng.integers(0, hub.num_nodes, b)).to(dev)
        d = torch.full((hub.num_nodes, b), float("inf"), device=dev)
        d[src, torch.arange(b, device=dev)] = 0.0
        for _ in range(3):
            d, _ = fanout_sweep_plain(d, *hub_layout)
        err, flag, _ = sweep_equal(d, hub_layout, hub_items,
                                   f"the hub graph B={b}")
        sweep_checks.append({"graph": "hub", "B": b, "equal": True,
                             "max_abs_err": err, "flag": flag})
        hub_errs.append(err)
    mp_checks = []
    mp_err = {}
    mp_cases = [(i, 1024, 1024, "") for i in (1, 16, 100, 128, 511, 1024)]
    mp_cases += [(1000, 777, 513, ""), (300, 400, 200, "inf_rows"),
                 (1024, 1024, 1024, "negative"), (512, 512, 512, "negative"),
                 (1024, 1024, 1024, "d_is_a"), (300, 300, 300, "d_is_a")]
    for (i, k, j, case) in mp_cases:
        g_rng = np.random.default_rng(i + k + j + len(case))
        dm = torch.as_tensor(g_rng.random((i, k), dtype=np.float32) * 10)
        am = torch.as_tensor(g_rng.random((k, j), dtype=np.float32) * 10)
        dm[torch.as_tensor(g_rng.random((i, k)) < 0.3)] = float("inf")
        am[torch.as_tensor(g_rng.random((k, j)) < 0.3)] = float("inf")
        if case == "inf_rows":
            dm[::3] = float("inf")
        if case == "negative":  # negative finite entries in both operands
            dm[torch.as_tensor(g_rng.random((i, k)) < 0.3) & dm.isfinite()] *= -1
            am[torch.as_tensor(g_rng.random((k, j)) < 0.3) & am.isfinite()] *= -1
        dm, am = dm.to(dev), am.to(dev)
        if case == "d_is_a":
            dm.fill_diagonal_(0.0)
            am = dm
        got = minplus_kernel(dm, am)
        want = minplus_plain(dm, am)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = max_abs_err(got, want)
        p = minplus_plan(i, k, j)
        mp_checks.append({"shape": [i, k, j], "case": case,
                          "tile_rows": p.rows, "splits": p.splits,
                          "equal": equal, "max_abs_err": err})
        if not equal:
            raise AssertionError(f"minplus disagrees with plain: {mp_checks[-1]}")
        mp_err[(i, k, j, case)] = err
    in_deg = (layout[0][1:] - layout[0][:-1]).cpu()
    hub_deg = (hub_layout[0][1:] - hub_layout[0][:-1]).cpu()
    emit({"phase": "kernel_vs_plain", "rmat_gen_s": gen_s, "V": v, "E": e,
          "max_in_degree": int(in_deg.max()),
          "rows_in_degree_ge_10000": int((in_deg >= 10000).sum()),
          "item_edges": items.item_edges,
          "items": v - items.split_rows.shape[0] + items.n_split,
          "split_items": items.n_split,
          "split_rows": items.split_rows.shape[0],
          "hub_graph": {"V": hub.num_nodes, "E": hub.num_real_edges,
                        "max_in_degree": int(hub_deg.max()),
                        "split_items": hub_items.n_split,
                        "split_rows": hub_items.split_rows.shape[0]},
          "fanout_sweep": sweep_checks, "minplus": mp_checks,
          "tight_pred": pred_checks})

    # -- phases 3-5: the main path ------------------------------------------
    fanout_sweep.launches = 0
    minplus_kernel.launches = 0
    fanout_fixpoint.host_reads = 0
    minplus_fixpoint.host_reads = 0
    per_solve = {}

    class FanoutGraphProbe(TorchBackend):
        """The torch backend, keeping the device graph its fan-out ran on
        (the reweighted one when the graph has negative weights)."""

        fanout_graph = None

        def multi_source(self, dgraph, sources):
            self.fanout_graph = dgraph
            return super().multi_source(dgraph, sources)

    def run_solve(label, graph, sources, backend=None, **kw):
        before = (fanout_sweep.launches, minplus_kernel.launches,
                  fanout_fixpoint.host_reads, minplus_fixpoint.host_reads)
        solver = pjt.ParallelJohnsonSolver(pjt.SolverConfig(**kw),
                                           backend=backend, device="cuda")
        res, secs = sync_time(lambda: solver.solve(graph, sources))
        per_solve[label] = {
            "fanout_sweep": fanout_sweep.launches - before[0],
            "minplus": minplus_kernel.launches - before[1],
            "fanout_host_reads": fanout_fixpoint.host_reads - before[2],
            "minplus_host_reads": minplus_fixpoint.host_reads - before[3],
        }
        return res, secs

    # 3: RMAT-20, 512 sources, route pallas-vm.
    sources = np.sort(np.random.default_rng(1).choice(v, 512, replace=False))
    res, secs = run_solve("rmat20", rmat, sources)
    route = res.stats.routes_by_phase["fanout"]
    if route != "pallas-vm":
        raise AssertionError(f"rmat20 fan-out took route {route}")
    rows = to_numpy(res.dist)
    if rows.shape != (512, v):
        raise AssertionError(f"rmat20 rows shape {rows.shape}")
    check = [0, 511]
    oracle = csgraph.dijkstra(rmat.to_scipy().astype(np.float64),
                              directed=True, indices=sources[check])
    np.testing.assert_array_equal(np.isinf(rows[check]), np.isinf(oracle))
    np.testing.assert_allclose(rows[check], oracle, rtol=1e-5)
    if per_solve["rmat20"]["fanout_sweep"] == 0:
        raise AssertionError("rmat20 solve launched no fanout_sweep kernel")
    emit({"phase": "solve_rmat20", "spec": RMAT_SPEC, "V": v, "E": e,
          "sources": 512, "seconds": secs, "route": route,
          "iterations": dict(res.stats.iterations_by_phase),
          "phase_seconds": dict(res.stats.phase_seconds),
          "launches": per_solve["rmat20"],
          "reachable_fraction": float(np.isfinite(rows).mean()),
          "checked_rows": check})
    rmat_sources, rmat_rows = sources, rows  # for phases 9 and 12
    del res, rows

    # 4: the 512x512 grid with negative weights, 256 sources.
    grid = pjt.load_graph(GRID_SPEC)
    gsrc = np.sort(np.random.default_rng(2).choice(
        grid.num_nodes, 256, replace=False))
    probe = FanoutGraphProbe(pjt.SolverConfig(), device=dev)
    res, secs = run_solve("grid512", grid, gsrc, backend=probe)
    h = to_numpy(res.potentials).astype(np.float64)
    w = grid.weights.astype(np.float64)
    slack = w + h[grid.src] - h[grid.indices]
    tol = 1e-5 * max(1.0, np.abs(h).max(), np.abs(w).max())
    if not slack.min() >= -tol:
        raise AssertionError(f"potentials infeasible: min slack {slack.min()}")
    rows = to_numpy(res.dist)
    check = [0, 255]
    rew = grid.with_weights(np.maximum(slack, 0.0))
    d_rew = csgraph.dijkstra(rew.to_scipy(), directed=True,
                             indices=gsrc[check])
    oracle = d_rew - h[gsrc[check]][:, None] + h[None, :]
    np.testing.assert_array_equal(np.isinf(rows[check]), np.isinf(oracle))
    np.testing.assert_allclose(rows[check], oracle, rtol=1e-5, atol=1e-3)
    emit({"phase": "solve_grid512", "spec": GRID_SPEC,
          "V": grid.num_nodes, "E": grid.num_real_edges, "sources": 256,
          "seconds": secs, "routes": dict(res.stats.routes_by_phase),
          "iterations": dict(res.stats.iterations_by_phase),
          "phase_seconds": dict(res.stats.phase_seconds),
          "launches": per_solve["grid512"], "min_slack": float(slack.min()),
          "checked_rows": check})
    grid_row = rows[0].copy()  # for phase 12's sssp from gsrc[0]
    grid_rows = rows[:64].copy()  # for phases 13 and 14
    grid_fanout_s = res.stats.phase_seconds["fanout"]
    grid_solve_stats = res.stats  # for phase 15
    grid_sweeps = res.stats.iterations_by_phase["fanout"]
    grid_res = res
    del res, rows

    # 5: dense ER-1024, all sources, route dense-squaring-pallas (fw=False:
    # the default takes fw-tile here, phase 16).
    er = pjt.load_graph(ER_SPEC)
    res, secs = run_solve("er1024", er, None, fw=False)
    route = res.stats.routes_by_phase["fanout"]
    if route != "dense-squaring-pallas":
        raise AssertionError(f"er1024 fan-out took route {route}")
    oracle = csgraph.dijkstra(er.to_scipy().astype(np.float64), directed=True)
    np.testing.assert_allclose(res.matrix, oracle, rtol=1e-5)
    er_matrix = to_numpy(res.dist)  # sources 0..V-1: for phases 13 and 14
    if per_solve["er1024"]["minplus"] == 0:
        raise AssertionError("er1024 solve launched no minplus kernel")
    emit({"phase": "solve_er1024", "spec": ER_SPEC, "V": er.num_nodes,
          "E": er.num_real_edges, "sources": er.num_nodes, "seconds": secs,
          "route": route, "iterations": dict(res.stats.iterations_by_phase),
          "launches": per_solve["er1024"]})
    del res
    # 128 sources: 2B < V, route dense-iterate-pallas (minplus_fixpoint).
    esrc = np.sort(np.random.default_rng(4).choice(er.num_nodes, 128,
                                                   replace=False))
    res, secs = run_solve("er1024_b128", er, esrc, fw=False)
    route = res.stats.routes_by_phase["fanout"]
    if route != "dense-iterate-pallas":
        raise AssertionError(f"er1024 (128 sources) took route {route}")
    rows = to_numpy(res.dist)
    oracle = csgraph.dijkstra(er.to_scipy().astype(np.float64), directed=True,
                              indices=esrc)
    np.testing.assert_array_equal(np.isinf(rows), np.isinf(oracle))
    np.testing.assert_allclose(rows, oracle, rtol=1e-5)
    er_iters = res.stats.iterations_by_phase["fanout"]
    er_reads = per_solve["er1024_b128"]["minplus_host_reads"]
    if not 0 < er_reads <= -(-er_iters // mp_mod.PRODUCTS_PER_SYNC) + 1:
        raise AssertionError(f"er1024 (128 sources): {er_reads} host reads "
                             f"for {er_iters} products")
    emit({"phase": "solve_er1024_b128", "spec": ER_SPEC, "V": er.num_nodes,
          "sources": 128, "seconds": secs, "route": route,
          "iterations": er_iters,
          "products_per_sync": mp_mod.PRODUCTS_PER_SYNC,
          "minplus_launches": per_solve["er1024_b128"]["minplus"],
          "minplus_host_reads": er_reads,
          "phase_seconds": dict(res.stats.phase_seconds),
          "checked_rows": "all"})
    del res, rows

    launches = {"fanout_sweep": fanout_sweep.launches,
                "minplus": minplus_kernel.launches}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {name}")
    by_path = {"solve_phases_3_5": dict(launches)}

    # -- phase 6: the sweep against its plain version on the grid's inputs ---
    # The layout the grid solve's fan-out ran on: reweighted weights,
    # clamped at 0, and B = 256 (two float4 per lane). Kernel and plain
    # version run in lockstep from the sources to the fixpoint.
    g_layout = probe.fanout_graph.by_dst()
    g_items = probe.fanout_graph.work_items()
    gv, ge, gb = grid.num_nodes, grid.num_real_edges, len(gsrc)
    d = torch.full((gv, gb), float("inf"), device=dev)
    d[torch.as_tensor(gsrc, device=dev), torch.arange(gb, device=dev)] = 0.0
    d0_grid = d.clone()
    grid_err, sweeps, improving, d_timing = 0.0, 0, True, None
    while improving:
        err, improving, d = sweep_equal(d, g_layout, g_items,
                                        f"the grid at sweep {sweeps}")
        grid_err = max(grid_err, err)
        sweeps += 1
        if sweeps == min(50, grid_sweeps):
            d_timing = d
        if sweeps > grid_sweeps:
            break
    if sweeps != grid_sweeps:
        raise AssertionError(f"lockstep fixpoint took {sweeps} sweeps, the "
                             f"solve {grid_sweeps}")
    d_fix = d
    rows = _unreweight(d.t().contiguous(), grid_res.potentials, gsrc)
    if not torch.equal(rows, grid_res.dist):
        raise AssertionError("the lockstep fixpoint, un-reweighted, differs "
                             "from the grid solve's rows")
    # tight_pred on the same fixpoint, full of zero-weight ties.
    fg = probe.fanout_graph
    g_coo = (fg.src, fg.dst, fg.weights)  # padded: (0, 0, +inf) never tight
    gsrc_dev = torch.as_tensor(gsrc, device=dev)
    grid_pred_err, grid_tight, grid_flags = pred_equal(
        d_fix, g_layout, g_items, g_coo, gsrc_dev,
        "the grid's reweighted fixpoint")
    if grid_flags != [0, 1]:  # zero-weight ties: predecessors at equal dist
        raise AssertionError(f"the grid's tree flags are {grid_flags}, "
                             "expected nondescending alone")
    emit({"phase": "kernel_vs_plain_grid", "spec": GRID_SPEC, "B": gb,
          "sweeps_checked": sweeps, "equal": True, "max_abs_err": grid_err,
          "zero_weight_fraction": float((g_layout[2] == 0).float().mean()),
          "rows_equal_solve": True,
          "tight_pred": {"equal": True, "max_abs_err": grid_pred_err,
                         "tight_share": grid_tight, "flags": grid_flags}})
    del grid_res, rows

    # -- phase 7: negative cycle on the card ---------------------------------
    cyc = pjt.CSRGraph.from_edges([0, 1, 2, 3], [1, 2, 3, 1],
                                  [1.0, 2.0, -4.0, 1.0], 4)
    try:
        pjt.ParallelJohnsonSolver(device="cuda").solve(cyc)
    except pjt.NegativeCycleError:
        emit({"phase": "negative_cycle", "raised": "NegativeCycleError"})
    else:
        raise AssertionError("negative cycle not detected on the card")

    # -- phase 8: times at the main path's shapes ----------------------------
    one = torch.ones(1, dtype=torch.int32, device=dev)

    def sweep_ms(d, lay, itm, reps):
        """Each sweep (and the warm-up) sets a flag of its own, zeroed
        before the timed run, as in the fixpoint."""
        out = torch.empty_like(d)
        flags = torch.zeros((reps + 1) * fs.FLAG_STRIDE, dtype=torch.int32,
                            device=dev)
        words = iter(range(0, flags.numel(), fs.FLAG_STRIDE))
        scratch = torch.empty((itm.n_split, d.shape[1]), device=dev)

        def sweep():
            j = next(words)
            fanout_sweep(d, *lay, items=itm, out=out,
                         improved=flags[j:j + 1], prev=one, scratch=scratch)

        return event_ms(sweep, reps=reps)

    timings = {}
    for b, (d, _) in sweep_states.items():
        ms = sweep_ms(d, layout, items, 10)
        plain = event_ms(lambda: fanout_sweep_plain(d, *layout), reps=2)
        bms, by = bound(4 * (2 * v * b + (v + 1) + 2 * e), 2 * e * b)
        timings[f"fanout_sweep_B{b}"] = {
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "gathered_GB": 4 * e * b / 1e9, "item_edges": items.item_edges,
            "items": v - items.split_rows.shape[0] + items.n_split,
            "split_items": items.n_split,
            "scratch_bytes": 4 * items.n_split * b,
            "gather_depth": fs.occupancy(b)["gather_depth"],
        }
    # The grid fan-out's inputs 50 sweeps in (phase 6's layout).
    d = d_timing
    kernel_ms = sweep_ms(d, g_layout, g_items, 50)
    # The same sweep at the fixpoint, where no row drops and no warp
    # touches the flag.
    at_fixpoint = sweep_ms(d_fix, g_layout, g_items, 50)
    plain = event_ms(lambda: fanout_sweep_plain(d, *g_layout), reps=5)
    bms, by = bound(4 * (2 * gv * gb + (gv + 1) + 2 * ge), 2 * ge * gb)
    # The grid fixpoint from the sources on the host clock, twice, with
    # SWEEPS_PER_SYNC sweeps per host read: what each sweep costs beyond
    # its kernel is the host loop.
    host_loop = []
    for _ in range(2):
        start = d0_grid.clone()
        reads = fanout_fixpoint.host_reads
        (fix, it_fix, imp_fix), secs = sync_time(lambda: fanout_fixpoint(
            start, *g_layout, max_iter=gv, items=g_items))
        if it_fix != grid_sweeps or imp_fix or not torch.equal(fix, d_fix):
            raise AssertionError(f"grid fixpoint: {it_fix} sweeps (solve "
                                 f"{grid_sweeps}), improving {imp_fix}")
        host_loop.append({
            "s": secs, "ms_per_sweep": secs * 1e3 / it_fix,
            "host_loop_ms_per_sweep": secs * 1e3 / it_fix - kernel_ms,
            "host_reads": fanout_fixpoint.host_reads - reads})
        del start, fix
    timings["fanout_sweep_grid512_B256"] = {
        "ms": kernel_ms, "ms_at_fixpoint": at_fixpoint,
        "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "solve_s_per_sweep": grid_fanout_s / grid_sweeps,
        "solve_host_loop_ms_per_sweep":
            grid_fanout_s * 1e3 / grid_sweeps - kernel_ms,
        "sweeps_per_sync": fs.SWEEPS_PER_SYNC,
        "fixpoint_host_clock": host_loop,
    }
    # tight_pred at R-MAT-20's converged fan-out (B = 512, 128) and the
    # grid's fixpoint (B = 256), with the sources as the pred solves call
    # it: the kernel back to back, the plain pass and tree_flags_plain on
    # the transposed block, the bound. Bytes: dist read and pred written
    # once, the CSC, the split rows' int64 partial keys written and read;
    # operations: an add, a subtract and two compares per candidate
    # (gathered rows count as cache hits, as for the sweep).
    def pred_timing(d, lay, itm, coo, ne, sources, reps, plain_reps):
        vv, bb = d.shape
        ms = event_ms(lambda: tight_pred_pass(d, *lay, items=itm,
                                              sources=sources), reps=reps)
        dt = d.t().contiguous()
        plain = event_ms(lambda: tree_flags_plain(
            tight_pred_pass_plain(dt, *coo), dt, sources), reps=plain_reps)
        bms, by = bound(8 * vv * bb + 4 * (vv + 1) + 8 * ne
                        + 16 * itm.n_split * bb, 4 * ne * bb)
        tpl = {k: t for k, t in pred_templates.items()
               if k.startswith(pred_template(bb))}
        return {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                "scratch_bytes": 8 * itm.n_split * bb,
                "split_items": itm.n_split, "template": tpl,
                "occupancy": pred_mod.occupancy(bb)}

    def certify_timing(d, lay, itm, sources, reps):
        """The tree check on the pass's trees: ``certify_pred`` with the
        kernel's flags (one host read; the walk only when a predecessor
        is not strictly closer) beside the check without them (the source
        mask, coverage and the pointer-doubling walk). Returns the times,
        both answers and the walks each ran."""
        p_vm, flags = tight_pred_pass(d, *lay, items=itm, sources=sources)
        p_bv, d_bv = p_vm.t().contiguous(), d.t().contiguous()
        del p_vm
        out = {"flags": flags.tolist()}
        for name, kw in (("with_flags", {"flags": flags}), ("without", {})):
            oks = []
            walks = pred_reaches_root.walks
            out[f"certify_ms_{name}"] = event_ms(lambda: oks.append(bool(
                certify_pred(p_bv.clone() if not kw else p_bv, d_bv, sources,
                             **kw)[1])), reps=reps)
            out[f"ok_{name}"] = all(oks)
            out[f"walks_{name}"] = (pred_reaches_root.walks - walks) / (reps + 1)
        return out

    for b, d in sorted(pred_states.items(), reverse=True):
        timings[f"tight_pred_B{b}"] = pred_timing(
            d, layout, items, rmat_coo, e, sweep_sources[b], 10, 2)
    # The tree check on the B = 512 trees: weights in [1, 10), so the
    # flags certify them with no walk.
    cert = certify_timing(pred_states[512], layout, items,
                          sweep_sources[512], 3)
    if not (cert["ok_with_flags"] and cert["ok_without"]
            and cert["walks_with_flags"] == 0):
        raise AssertionError(f"R-MAT-20 B=512 tree check: {cert}")
    timings["tight_pred_B512"].update(cert)
    timings["tight_pred_grid512_B256"] = pred_timing(
        d_fix, g_layout, g_items, g_coo, ge, gsrc_dev, 20, 3)
    # The grid's trees tie at zero weights: the flags send the check to
    # the walk, which passes.
    cert = certify_timing(d_fix, g_layout, g_items, gsrc_dev, 3)
    if not (cert["flags"] == [0, 1] and cert["ok_with_flags"]
            and cert["ok_without"] and cert["walks_with_flags"] == 1):
        raise AssertionError(f"the grid's tree check: {cert}")
    timings["tight_pred_grid512_B256"].update(cert)
    # Min-plus at the dense route's shapes and 4096^3 (MINPLUS_SHAPES).
    for (i, k, j) in MINPLUS_SHAPES:
        g_rng = np.random.default_rng(7)
        dm = torch.as_tensor(g_rng.random((i, k), dtype=np.float32)).to(dev)
        am = torch.as_tensor(g_rng.random((k, j), dtype=np.float32)).to(dev)
        big = i * k * j > 1 << 30
        eager = event_ms(lambda: minplus_kernel(dm, am), reps=3 if big else 50)
        card = graph_ms(lambda: minplus_kernel(dm, am), reps=3 if big else 50)
        plain = event_ms(lambda: minplus_plain(dm, am), reps=1 if big else 3)
        bms, by = minplus_bound(i, k, j)
        p = minplus_plan(i, k, j)
        timings[f"minplus_{i}x{k}x{j}"] = {
            "ms": eager, "card_ms": card, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by,
            "card_share_of_bound": bms / card, "tile_rows": p.rows,
            "splits": p.splits, "blocks": int(np.prod(p.grid(i, j))),
            "partial_bytes": 4 * i * j * p.splits if p.splits > 1 else 0,
        }
        del dm, am
    # The iterate regime's fixpoint on the 128-source ER-1024 solve's own
    # inputs, on the host clock, twice: beside the products' card time
    # (minplus_128x1024x1024), the rest is the host's share.
    a_er = relax.dense_adjacency(
        *(torch.as_tensor(x).to(dev) for x in (er.src, er.indices,
                                               er.weights)), er.num_nodes)
    d0_er = relax.multi_source_init(torch.as_tensor(esrc).to(dev),
                                    er.num_nodes)
    fix_runs = []
    for _ in range(2):
        start = d0_er.clone()
        before = (minplus_kernel.launches, minplus_fixpoint.host_reads)
        (fix, it_fix, imp_fix), secs = sync_time(lambda: minplus_fixpoint(
            start, a_er, max_iter=er.num_nodes))
        if it_fix != er_iters or imp_fix:
            raise AssertionError(f"er1024 fixpoint: {it_fix} products (solve "
                                 f"{er_iters}), improving {imp_fix}")
        fix_runs.append({
            "s": secs, "products": it_fix,
            "launches": minplus_kernel.launches - before[0],
            "host_reads": minplus_fixpoint.host_reads - before[1],
            "ms_per_product": secs * 1e3 / it_fix})
        del start, fix
    timings["minplus_fixpoint_er1024_B128"] = {
        "host_clock": fix_runs,
        "card_ms": timings["minplus_128x1024x1024"]["card_ms"],
        "products_per_sync": mp_mod.PRODUCTS_PER_SYNC}
    emit({"phase": "timing", "device": kind, "power_limit": smi,
          "timings": timings})
    sweep_errs = [err for _, err in sweep_states.values()]
    pred_errs = [c["max_abs_err"] for c in pred_checks] + [grid_pred_err]
    del sweep_states, pred_states, d, d_fix, d_timing, d0_grid, d0_er, a_er
    torch.cuda.empty_cache()

    # -- phases 9-12: the batch driver and the other entry points -----------
    by_path.update(drive_entry_points(dev, rmat, rmat_sources, rmat_rows,
                                      grid, gsrc[0], grid_row, cyc))
    # -- phases 13-14: predecessor trees and the XLA routes -----------------
    pred_paths, grid_pred_rows = drive_pred_paths(
        dev, rmat, rmat_sources, rmat_rows, grid, gsrc, grid_rows, er,
        er_matrix)
    by_path.update(pred_paths)
    by_path.update(drive_xla_routes(dev, rmat, rmat_sources, rmat_rows, grid,
                                    gsrc, grid_rows, er, er_matrix))
    # -- phase 15: the B=1 routes ------------------------------------------
    by_path.update(drive_b1_routes(dev, grid, gsrc, grid_rows,
                                   grid_solve_stats, cyc))
    # -- phase 16: dense APSP ------------------------------------------------
    dense_paths, kleene, er_fw_matrix = drive_dense_apsp(dev, er, er_matrix)
    by_path.update(dense_paths)
    # -- phase 17: the dirty window and the priced planner ------------------
    by_path.update(drive_dirty_window(dev, rmat))
    # -- phase 18: the bench harness, telemetry, the cpp baseline ----------
    torch.cuda.empty_cache()
    by_path.update(drive_bench(dev))
    # -- phases 19-20: the fleet and incremental repair --------------------
    torch.cuda.empty_cache()
    by_path.update(drive_fleet(dev))
    by_path.update(drive_repair(dev))
    # -- phases 21-22: the serving tier and the approximate tier ---------
    torch.cuda.empty_cache()
    serve_paths, serve_errs = drive_serve(dev)
    by_path.update(serve_paths)
    approx_paths, hop_errs = drive_approx(dev, rmat)
    by_path.update(approx_paths)
    # -- phase 23: the command line ------------------------------------------
    torch.cuda.empty_cache()
    by_path.update(drive_cli(smi, rmat_sources, rmat_rows, gsrc,
                             grid_pred_rows, er_fw_matrix))
    # -- phase 24: the mesh --------------------------------------------------
    torch.cuda.empty_cache()
    by_path.update(drive_mesh(dev, rmat, rmat_sources, rmat_rows, grid,
                              gsrc, grid_pred_rows))
    # -- phase 25: precision="f64" on the card ------------------------------
    torch.cuda.empty_cache()
    f64_paths, f64_rows, ref64 = drive_f64(dev, smi, rmat, rmat_sources,
                                           grid, gsrc, er, hub, logs)
    # -- phase 26: precision="f64" above the solver ------------------------
    torch.cuda.empty_cache()
    f64_paths.update(drive_f64_layers(dev, rmat, rmat_sources, grid, ref64))
    # -- phase 27: the default mesh over every card -------------------------
    every32, every64 = drive_every_card(dev, rmat, rmat_sources, rmat_rows,
                                        ref64["rmat_rows"])
    by_path.update(every32)
    f64_paths.update(every64)
    del ref64
    names = ("fanout_sweep", "minplus", "tight_pred", "fw_kleene")
    launches = {name: sum(p.get(name, 0) for p in by_path.values())
                for name in names}
    launches_f64 = {name: sum(p.get(name, 0) for p in f64_paths.values())
                    for name in names}
    for name, n in launches_f64.items():
        if n == 0:
            raise AssertionError(f"the f64 paths never launched {name}")

    t_sw = timings["fanout_sweep_B512"]
    t_mp = timings["minplus_1024x1024x1024"]
    t_tp = timings["tight_pred_B512"]
    t_kl = kleene["timing"]
    emit({"phase": "done", "smoke_s": time.perf_counter() - t_start})
    emit({"kernels": [
        {"name": "fanout_sweep", "route": "cuda",
         "source": "paralleljohnson_tpu_torch/csrc/fanout_sweep.cu",
         "replaces": "paralleljohnson_tpu/ops/pallas_sweep.py:255",
         "launches": launches["fanout_sweep"],
         "launches_by_path": {k: p["fanout_sweep"] for k, p in by_path.items()},
         "max_abs_err": max(grid_err, *hub_errs,
                            *sweep_errs, *serve_errs, *hop_errs),
         "ms": t_sw["ms"], "plain_ms": t_sw["plain_ms"],
         "bound_ms": t_sw["bound_ms"], "bound_by": t_sw["bound_by"],
         "library_ms": None},
        {"name": "minplus", "route": "cuda",
         "source": "paralleljohnson_tpu_torch/csrc/minplus.cu",
         "replaces": "paralleljohnson_tpu/ops/pallas_kernels.py:117",
         "launches": launches["minplus"],
         "launches_by_path": {k: p["minplus"] for k, p in by_path.items()},
         "max_abs_err": max(mp_err.values()),
         "ms": t_mp["ms"], "card_ms": t_mp["card_ms"],
         "plain_ms": t_mp["plain_ms"], "bound_ms": t_mp["bound_ms"],
         "bound_by": t_mp["bound_by"], "library_ms": None},
        {"name": "tight_pred", "route": "cuda",
         "source": "paralleljohnson_tpu_torch/csrc/tight_pred.cu",
         "replaces": "paralleljohnson_tpu/ops/pred.py:69",
         "launches": launches["tight_pred"],
         "launches_by_path": {k: p.get("tight_pred", 0)
                              for k, p in by_path.items()},
         "max_abs_err": max(pred_errs),
         "ms": t_tp["ms"], "plain_ms": t_tp["plain_ms"],
         "bound_ms": t_tp["bound_ms"], "bound_by": t_tp["bound_by"],
         "library_ms": None},
        {"name": "fw_kleene", "route": "cuda",
         "source": "paralleljohnson_tpu_torch/csrc/fw_kleene.cu",
         "replaces": "paralleljohnson_tpu/ops/fw.py:100",
         "launches": launches["fw_kleene"],
         "launches_by_path": {k: p.get("fw_kleene", 0)
                              for k, p in by_path.items()},
         "max_abs_err": max(kleene["errs"]),
         "ms": t_kl["ms"], "card_ms": t_kl["card_ms"],
         "plain_ms": t_kl["plain_ms"], "bound_ms": t_kl["bound_ms"],
         "bound_by": t_kl["bound_by"], "library_ms": None,
         "variants": {name: {k: row[k] for k in (
             "t", "ms", "card_ms", "plain_ms", "bound_ms")}
             for name, row in kleene["variants"].items()}},
    ] + [
        {"name": f"{name}_f64", "route": "cuda",
         "source": f"paralleljohnson_tpu_torch/csrc/{name}.cu",
         "replaces": replaces, "launches": launches_f64[name],
         "launches_by_path": {k: p.get(name, 0)
                              for k, p in f64_paths.items()},
         "max_abs_err": f64_rows[name]["max_abs_err"],
         "ms": f64_rows[name]["ms"], "card_ms": f64_rows[name].get("card_ms"),
         "plain_ms": f64_rows[name]["plain_ms"],
         "bound_ms": f64_rows[name]["bound_ms"],
         "bound_by": f64_rows[name]["bound_by"], "library_ms": None,
         "timed": f64_rows[name]["timed"]}
        for name, replaces in (
            ("fanout_sweep", "paralleljohnson_tpu/ops/pallas_sweep.py:255"),
            ("minplus", "paralleljohnson_tpu/ops/pallas_kernels.py:117"),
            ("tight_pred", "paralleljohnson_tpu/ops/pred.py:69"),
            ("fw_kleene", "paralleljohnson_tpu/ops/fw.py:100"))
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(sys.argv[2]))
    sys.exit(main())
