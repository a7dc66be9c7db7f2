"""Requests through ``ParallelJohnsonSolver.solve``, each delivered as a
host table: the [S, V] distance rows and the potentials the solve used
come to the host (``to_numpy``, the program's own way there). A request
is delivered when its table has landed. Of each table,
``check.rows_per_request`` rows drawn from the seed, and the
potentials, are kept to be checked.
"""

from __future__ import annotations

import time

from torch.profiler import record_function

from paralleljohnson_tpu_torch.solver.johnson import to_numpy
from pjbench.harness import Retained


def _table(solver, graph, sources):
    res = solver.solve(graph, sources)
    t0 = time.perf_counter()
    with record_function("pjbench.host_table"):
        table = to_numpy(res.dist)
        h = to_numpy(res.potentials)
    return res, table, h, time.perf_counter() - t0


def warm(run, solver, graph, sources) -> None:
    _table(solver, graph, sources)


def drive(run, solver, graph) -> None:
    keep = int(run.cell.traffic["check"]["rows_per_request"])
    run.host_table_s = 0.0
    k = 1
    while not run.closed:
        sources = run.sources(k)
        run.attempted += 1
        try:
            with record_function("pjbench.request"):
                res, table, h, host_s = _table(solver, graph, sources)
        except Exception as e:  # noqa: BLE001 — a failed request is counted
            run.request_failed(e)
            continue
        t = run.deliver(len(sources))
        run.host_table_s += host_s
        for p in run.keep_at(k, 0, len(sources), keep):
            run.retained.append(Retained(t, int(sources[p]), table[p].copy()))
        run.potentials.append((t, h.copy()))
        run.record_request(res.stats)
        del res, table, h
        k += 1
