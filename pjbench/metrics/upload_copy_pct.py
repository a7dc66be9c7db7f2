"""Share of the window in which the upload's host-to-device copies ran
(the program's ``pj.upload.copy`` spans); nothing to read where the
program has no such span."""

from pjbench import spans


def read(run):
    return spans.window_pct(run, ("pj.upload.copy",))
