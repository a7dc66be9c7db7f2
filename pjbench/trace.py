"""The device trace of a ``--trace 1`` run, reduced to what the metrics
read.

``torch.profiler`` records the card's operations (kernels, copies,
fills) and the host's ops, CUDA runtime calls and the harness's own
spans. Its clock is the host's wall clock in nanoseconds
(``time.time_ns``), so the harness's window boundaries clip it directly.
From the raw events this keeps, per device, the merged busy intervals,
the time of each kernel by name, and the card's idle gaps labelled by
the innermost host event that was open at their middle.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

# Host events at least this long are also searched as enclosing spans
# when an idle gap is labelled (the nearest-start scan covers the rest).
_LONG_HOST_NS = 5_000_000
_SCAN_BACK = 256


@dataclasses.dataclass
class DeviceOp:
    name: str
    device: int
    start: int
    end: int


@dataclasses.dataclass
class HostEvent:
    name: str
    start: int
    end: int


class Profile:
    """A ``torch.profiler`` session over the card and the host."""

    def __init__(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self.ops: list[DeviceOp] = []
        self.host: list[HostEvent] = []

    def __enter__(self) -> "Profile":
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            start = int(e.start_ns())
            end = start + int(e.duration_ns())
            if e.device_type() == cuda:
                # A host span projected onto the card's timeline
                # (``record_function``) is no operation of the card.
                if e.is_user_annotation():
                    continue
                self.ops.append(DeviceOp(e.name(), int(e.device_index()),
                                         start, end))
            else:
                self.host.append(HostEvent(e.name(), start, end))


def summary(ops, top: int = 40) -> list:
    """``[[full name, launches, seconds], ...]`` of every device operation
    of the trace, by total time."""
    total: dict = defaultdict(lambda: [0, 0])
    for o in ops:
        total[o.name][0] += 1
        total[o.name][1] += o.end - o.start
    ranked = sorted(total.items(), key=lambda kv: -kv[1][1])[:top]
    return [[k, n, ns / 1e9] for k, (n, ns) in ranked]


def merged(intervals) -> list[tuple[int, int]]:
    """Union of (start, end) intervals, sorted."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def busy_ns(ops, device: int, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) in which an operation ran on ``device``."""
    spans = merged(clip([(o.start, o.end) for o in ops if o.device == device],
                        lo, hi))
    return sum(e - s for s, e in spans)


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    parameter list (a copy or fill keeps its parenthesis, which follows a
    space)."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    cut = name.find("(")
    if cut > 0 and name[cut - 1] != " ":
        name = name[:cut]
    return name[:96]


def op_seconds(ops, lo: int, hi: int, top: int = 10) -> list:
    """``[[name, seconds], ...]``: the device operations that took most
    time in [lo, hi), summed over every device."""
    total: dict = defaultdict(int)
    for o in ops:
        s, e = max(o.start, lo), min(o.end, hi)
        if e > s:
            total[short_name(o.name)] += e - s
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / 1e9] for k, v in ranked]


class _HostIndex:
    def __init__(self, host) -> None:
        self.events = sorted(host, key=lambda h: h.start)
        self.starts = [h.start for h in self.events]
        self.long = [h for h in self.events if h.end - h.start >= _LONG_HOST_NS]

    def innermost(self, t: int) -> str:
        best = None
        i = bisect.bisect_right(self.starts, t)
        for h in self.events[max(0, i - _SCAN_BACK):i]:
            if h.end >= t and (best is None or
                               h.end - h.start < best.end - best.start):
                best = h
        if best is None:
            for h in self.long:
                if h.start <= t <= h.end and (
                        best is None
                        or h.end - h.start < best.end - best.start):
                    best = h
        return "host: no traced op" if best is None else best.name[:96]


def idle_gaps(ops, host, device: int, lo: int, hi: int,
              top: int = 10) -> list:
    """``[[host activity, seconds], ...]``: the idle time of ``device`` in
    [lo, hi), summed by the innermost host event open at each gap's
    middle, largest first."""
    spans = merged(clip([(o.start, o.end) for o in ops if o.device == device],
                        lo, hi))
    index = _HostIndex(host)
    total: dict = defaultdict(int)
    edge = lo
    for s, e in spans + [(hi, hi)]:
        if s > edge:
            total[index.innermost((edge + s) // 2)] += s - edge
        edge = max(edge, e)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / 1e9] for k, v in ranked]
