"""The program's own spans in the trace of a ``--trace 1`` run: its
``record_function`` events (``pj.*``, on the profiler's host clock, as
the harness's window is), read by name and clipped to the window."""

from __future__ import annotations

from pjbench import trace


def union(run, names) -> list[tuple[int, int]] | None:
    """The union of the host events named in ``names`` (one nested in
    another of its name counts once), clipped to the window; None without
    a trace, or where the program recorded none of them."""
    prof = run.trace
    if prof is None:
        return None
    spans = [(h.start, h.end) for h in prof.host if h.name in names]
    if not spans:
        return None
    return trace.merged(trace.clip(spans, run.t0_ns, run.t_close_ns))


def window_pct(run, names) -> float | None:
    """Share of the window (%) in which one of ``names`` was open."""
    spans = union(run, names)
    if spans is None or run.t_close_ns <= run.t0_ns:
        return None
    return 100.0 * sum(e - s for s, e in spans) / (run.t_close_ns - run.t0_ns)
