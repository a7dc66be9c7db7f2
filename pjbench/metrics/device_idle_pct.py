"""Share of the window in which no operation (kernel, copy, fill) ran on
the first card, from the profiler's timeline."""

from pjbench import trace


def read(run):
    prof = run.trace
    if prof is None or not prof.ops:
        return None
    lo, hi = run.t0_ns, run.t_close_ns
    busy = trace.busy_ns(prof.ops, 0, lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))
