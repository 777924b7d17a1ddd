"""The traced run: ``torch.profiler`` with CUDA activity only (kernels,
copies and the runtime calls that launched them, no host op recording,
so the host runs as in an untraced run) over the whole window, reduced
to what the per-layer readers need.

Spans are the harness's own: ``Spans`` records, on the host's wall
clock, the benchmark's calls into the program (``portbench.*``) and the
optimizer's step (``Optimizer.step#...``); two device synchronises that
both clocks hold move them onto the trace's clock.  A device operation
belongs to a span when the runtime call that launched it (the CUDA
runtime event with the operation's correlation id) ran inside the
span.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                   "cudaGraphLaunch")
NAME_CHARS = 120          # a C++ kernel name is cut to its head


@dataclass
class Span:
    name: str
    start: int
    end: int
    device_ns: int = 0


class Spans:
    """The harness's spans, recorded only while ``on``: a span that
    is still open when recording stops (the window has closed) is
    dropped."""

    def __init__(self):
        self.items: list[Span] = []
        self.on = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        start = time.time_ns()
        try:
            yield
        finally:
            if self.on:
                self.items.append(Span(name, start, time.time_ns()))


@dataclass
class Trace:
    window_s: float                    # host seconds the profiler was on
    busy_ns: int                       # union of device operations
    op_ns: dict                        # device operation name -> ns
    spans: dict = field(default_factory=dict)   # name -> [Span]
    idle_gaps: list = field(default_factory=list)  # [[host label, s]]
    busy: list = field(default_factory=list)    # merged [(start, end)]

    def device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside spans
        called ``name``."""
        return sum(s.device_ns for s in self.spans.get(name, ())) / 1e9

    def busy_within(self, name: str) -> tuple[int, int]:
        """(ns in which some device operation ran inside the spans
        called ``name``, ns those spans last), on the trace's clock."""
        starts = [b[0] for b in self.busy]
        busy = length = 0
        for s in self.spans.get(name, ()):
            length += s.end - s.start
            i = max(0, bisect.bisect_right(starts, s.start) - 1)
            while i < len(self.busy) and self.busy[i][0] < s.end:
                lo, hi = max(self.busy[i][0], s.start), min(self.busy[i][1],
                                                            s.end)
                busy += max(0, hi - lo)
                i += 1
        return busy, length

    def breakdown(self) -> dict:
        top = sorted(self.op_ns.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in top],
                "idle_gaps": self.idle_gaps[:10]}


class Profiler:
    """CUDA activity over the window, with the harness's spans."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self._prof = None
        self.started = None
        self.cost = ""

    def start(self):
        acts = ([torch.profiler.ProfilerActivity.CUDA]
                if torch.cuda.is_available() else
                [torch.profiler.ProfilerActivity.CPU])
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self.host_marks = [_mark()]
        self.spans.on = True
        self.started = time.perf_counter()

    def stop(self) -> Trace:
        self.host_marks.append(_mark())
        self.spans.on = False
        window_s = time.perf_counter() - self.started
        marks = [time.perf_counter()]
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        marks.append(time.perf_counter())
        self._prof = None
        trace = reduce_events(events, self.spans.items, window_s,
                              self.host_marks)
        marks.append(time.perf_counter())
        self.cost = (f"profiler stop {marks[1] - marks[0]:.3f} s "
                     f"({len(events)} events), reduction "
                     f"{marks[2] - marks[1]:.3f} s")
        return trace


def _mark() -> int | None:
    """A host instant that the trace holds too: a device synchronise
    (the runtime's ``cudaDeviceSynchronize``) on an idle device, its
    host time taken as the middle of the call."""
    if not torch.cuda.is_available():
        return None
    before = time.time_ns()
    torch.cuda.synchronize()
    return (before + time.time_ns()) // 2


def reduce_events(events, spans, window_s: float,
                  host_marks=(None, None)) -> Trace:
    cuda = torch.autograd.DeviceType.CUDA
    device, launches, syncs = [], {}, []
    for e in events:
        name = e.name()
        start = e.start_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((start, start + e.duration_ns(), name,
                               e.correlation_id()))
        elif name.startswith(LAUNCH_PREFIXES):
            launches[e.correlation_id()] = start
        elif name == "cudaDeviceSynchronize":
            syncs.append(start + e.duration_ns() // 2)
    _align(spans, host_marks, syncs)
    by_name = defaultdict(list)
    for s in spans:
        by_name[s.name].append(s)
    index = [_SpanIndex(lst) for lst in by_name.values()]
    op_ns = defaultdict(int)
    for start, end, name, corr in device:
        op_ns[name] += end - start
        t = launches.get(corr)
        if t is None:
            continue
        for idx in index:
            span = idx.find(t)
            if span is not None:
                span.device_ns += end - start
    merged = _union(device)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    return Trace(window_s=window_s,
                 busy_ns=sum(e - s for s, e in merged), op_ns=dict(op_ns),
                 spans=dict(by_name), idle_gaps=_label_gaps(gaps, spans),
                 busy=merged)


def _align(spans, host_marks, trace_marks):
    """Move the spans from the host's clock onto the trace's.  Both
    count Unix nanoseconds, the trace's converted from the CPU's
    counter, so they may stand apart by a little and drift: each host
    mark is matched to the trace's synchronise nearest it (the profiler
    makes synchronises of its own as it starts and stops, so the first
    and last need not be the harness's), and the two pairs fix the
    offset and the rate."""
    if None in host_marks or len(trace_marks) < 2:
        return
    h0, h1 = host_marks
    k0 = min(trace_marks, key=lambda k: abs(k - h0))
    k1 = min(trace_marks, key=lambda k: abs(k - h1))
    if h1 <= h0 or k1 <= k0:
        return
    rate = (k1 - k0) / (h1 - h0)
    for s in spans:
        s.start = k0 + round((s.start - h0) * rate)
        s.end = k0 + round((s.end - h0) * rate)


class _SpanIndex:
    """Spans of one name (never overlapping one another), searchable by
    time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: s.start)
        self.starts = [s.start for s in self.spans]

    def find(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.spans[i].start <= t <= self.spans[i].end:
            return self.spans[i]
        return None


def _union(device) -> list:
    """The device operations' intervals merged: [(start, end)], in
    order, apart from one another."""
    merged = []
    for start, end, *_ in sorted(device):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def _label_gaps(gaps, spans, keep: int = 4000) -> list:
    """Idle seconds of the ``keep`` longest gaps, summed by what the host
    was doing when each began: the innermost harness span running then,
    or none."""
    ordered = sorted(spans, key=lambda s: s.start)
    starts = [s.start for s in ordered]
    longest = max((s.end - s.start for s in ordered), default=0)
    total = defaultdict(float)
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:keep]:
        lo = bisect.bisect_left(starts, g0 - longest)
        hi = bisect.bisect_right(starts, g0)
        inside = [s for s in ordered[lo:hi] if s.end >= g0]
        label = (min(inside, key=lambda s: s.end - s.start).name if inside
                 else "outside the harness's spans")
        total[label] += (g1 - g0) / 1e9
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])]
