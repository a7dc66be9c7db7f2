"""Share of the window the mesh's slowest rank spent in its collectives,
barrier waits included (the program's ``Mesh.collective_s``, read when
the window opens and when it closes); nothing to read on one rank."""


def read(run):
    if run.collective_s is None or run.window_s <= 0:
        return None
    return 100.0 * run.collective_s / run.window_s
