"""Share of the window spent bringing each request's [S, V] table and
potentials to the host (the benchmark's host-clock span around the
program's ``to_numpy``); nothing to read where the traffic delivers no
host table."""


def read(run):
    if run.host_table_s is None or run.window_s <= 0:
        return None
    return 100.0 * run.host_table_s / run.window_s
