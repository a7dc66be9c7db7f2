"""Share of the window the solver spent in its ``upload`` phase
(``stats.phase_seconds["upload"]``, the host copy of the padded edge
list to the card), summed over the window's requests."""


def read(run):
    s = sum(r.phase_seconds.get("upload", 0.0) for r in run.requests)
    if not run.requests or run.window_s <= 0:
        return None
    return 100.0 * s / run.window_s
