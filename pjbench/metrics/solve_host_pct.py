"""Share of the window the solver spent on its own host work outside the
phases: the union of the program's ``pj.solve.plan`` (the solver-level
plan walk), ``pj.solve.potentials`` (the negative-arc check) and
``pj.solve.observe`` (roofline and profile records) spans; nothing to
read where the program has no such spans."""

from pjbench import spans

NAMES = ("pj.solve.plan", "pj.solve.potentials", "pj.solve.observe")


def read(run):
    return spans.window_pct(run, NAMES)
