"""The readers of the program's own spans (``pjbench/spans.py``) on
made-up traces: the window's clipping, a span nested in one of its name
counted once, and nothing to read without a trace or without the
spans."""

from __future__ import annotations

import types

import pytest

from conftest import ROOT
from pjbench import manifest
from pjbench.trace import DeviceOp, HostEvent

MS = 1_000_000
HOST_READERS = {
    "upload_host_pct": ("pj.upload.pad", "pj.upload.src", "pj.upload.cast"),
    "upload_copy_pct": ("pj.upload.copy",),
    "host_table_pct": ("pj.host_table",),
    "solve_host_pct": ("pj.solve.plan", "pj.solve.potentials",
                       "pj.solve.observe"),
}


def _run(host=(), ops=(), traced=True):
    """A run whose window is [100, 1100) ms."""
    prof = (types.SimpleNamespace(host=list(host), ops=list(ops))
            if traced else None)
    return types.SimpleNamespace(trace=prof, t0_ns=100 * MS,
                                 t_close_ns=1100 * MS)


def _read(name, run):
    return manifest.metric_reader(ROOT, name).read(run)


def _ev(name, start_ms, end_ms):
    return HostEvent(name, start_ms * MS, end_ms * MS)


@pytest.mark.parametrize("name", sorted(HOST_READERS))
def test_host_span_share_is_clipped_to_the_window(name):
    first, *rest = HOST_READERS[name]
    host = [_ev(first, 0, 150),        # 50 ms inside the window
            _ev(first, 500, 600),      # 100 ms
            _ev(first, 1050, 2000),    # 50 ms
            _ev("pj.solve", 0, 2000), _ev("aten::copy_", 200, 400)]
    assert _read(name, _run(host)) == pytest.approx(20.0)


@pytest.mark.parametrize("name", sorted(HOST_READERS))
def test_nested_and_overlapping_spans_count_once(name):
    names = HOST_READERS[name]
    host = [_ev(names[0], 200, 400), _ev(names[0], 250, 300),
            _ev(names[-1], 350, 500)]
    assert _read(name, _run(host)) == pytest.approx(30.0)


def test_the_upload_steps_are_one_union():
    host = [_ev("pj.upload.pad", 200, 300), _ev("pj.upload.src", 300, 400),
            _ev("pj.upload.cast", 400, 450), _ev("pj.upload.copy", 450, 700)]
    assert _read("upload_host_pct", _run(host)) == pytest.approx(25.0)
    assert _read("upload_copy_pct", _run(host)) == pytest.approx(25.0)


@pytest.mark.parametrize("name", sorted(HOST_READERS))
def test_nothing_to_read_without_a_trace_or_the_spans(name):
    ops = [DeviceOp("k", 0, 200 * MS, 300 * MS)]
    assert _read(name, _run(traced=False)) is None
    # The parent program: its phases only, no ``pj.`` step span.
    host = [_ev("upload", 100, 500), _ev("fanout", 500, 900),
            _ev("pjbench.request", 100, 1000)]
    assert _read(name, _run(host, ops)) is None

