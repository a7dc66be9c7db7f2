"""Share of the window in which the upload's host side ran: the union of
the program's ``pj.upload.pad`` (the padded edge list), ``pj.upload.src``
(the COO source column) and ``pj.upload.cast`` (the weights' cast)
spans; nothing to read where the program has no such spans."""

from pjbench import spans

NAMES = ("pj.upload.pad", "pj.upload.src", "pj.upload.cast")


def read(run):
    return spans.window_pct(run, NAMES)
