"""Seconds from the process's start to the window's: imports, the graph
built on the card, the kernels loaded (built, in a checkout's first
run), one request of the cell's traffic warmed (host clock)."""


def read(run):
    return run.setup_s
