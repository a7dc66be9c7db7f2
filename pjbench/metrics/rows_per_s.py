"""Distance rows delivered per second: every source row delivered in the
window (a request's host table, once on the host) over the window's
length (host clock)."""


def read(run):
    if run.t_close is None or run.window_s <= 0:
        return None
    rows = sum(n for t, n in run.deliveries if t <= run.t_close)
    return rows / run.window_s
