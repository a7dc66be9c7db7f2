"""Share of the window in which the program copied a tensor's rows to
the host (its ``pj.host_table`` spans, inside ``to_numpy``: the table
and the potentials a request delivers); nothing to read where the
program has no such span."""

from pjbench import spans


def read(run):
    return spans.window_pct(run, ("pj.host_table",))
