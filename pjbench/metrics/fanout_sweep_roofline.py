"""The fan-out sweep kernel's share of its roofline: the least time the
card could take for the sweeps the requests needed (the larger of their
bytes over the HBM bandwidth and their operations over the FP32 peak),
over the device time of every launch of the kernel (``sweep_items`` and
its split-row combine), from the profiler, over the whole traced loop.

The bytes and operations come from the frozen copy of ``sweep_cost`` at
each sweep's V, E and width: the solver's counters give the sum of the widths over the
sweeps that did work (``edges_relaxed`` over E) and their number
(``iterations``, one per rank on a mesh, which counts each rank at the
slowest rank's sweeps). The launches past a fixpoint, which return at
entry, add their time and no bytes."""

from pjbench.frozen.costs import sweep_work
from pjbench.frozen.peaks import FP32_FLOPS_PER_S, HBM_BYTES_PER_S


def is_sweep(name: str) -> bool:
    if "sweep_items" in name:
        return True
    # The fan-out's combine reads float rows; tight_pred's (int* pred, ...)
    # has the same template name.
    return "combine_split_rows" in name and "(int*" not in name


def read(run):
    prof = run.trace
    if prof is None or not run.requests:
        return None
    ns = sum(o.end - o.start for o in prof.ops if is_sweep(o.name))
    if ns <= 0:
        return None
    ranks = run.mesh_size
    row_sweeps = sum(r.fanout_row_sweeps for r in run.requests)
    sweeps = ranks * sum(r.fanout_iterations for r in run.requests)
    work = sweep_work(run.num_nodes, run.num_edges, row_sweeps, sweeps)
    least_s = max(work["bytes_accessed"] / HBM_BYTES_PER_S,
                  work["flops"] / FP32_FLOPS_PER_S)
    return 100.0 * least_s / (ns / 1e9)
