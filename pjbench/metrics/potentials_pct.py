"""Share of the window the solver spent in phase 1, Johnson's potentials
(``stats.phase_seconds["bellman_ford"]``), summed over the window's
requests; nothing to read where no request ran phase 1 (no negative
arcs)."""


def read(run):
    s = [r.phase_seconds["bellman_ford"] for r in run.requests
         if "bellman_ford" in r.phase_seconds]
    if not s or run.window_s <= 0:
        return None
    return 100.0 * sum(s) / run.window_s
