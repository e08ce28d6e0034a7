"""Reading a ``torch.profiler`` trace of the measured window.

Device operations are the trace's kernels, copies and sets on the card.
Host ranges are the ``record_function`` annotations: the benchmark's own
window and the program's spans (``obs/trace.py`` wraps every span in
one).  Kineto puts both on one clock, so a kernel belongs to a span when
their times overlap.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "portbench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[int, int]


def _merge(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _overlap(a: Interval, merged: List[Interval], starts: List[int]) -> int:
    """Length of ``a`` covered by ``merged`` (sorted, disjoint; ``starts``
    their start times)."""
    i = max(bisect.bisect_right(starts, a[0]) - 1, 0)
    got = 0
    while i < len(merged) and merged[i][0] < a[1]:
        got += max(0, min(a[1], merged[i][1]) - max(a[0], merged[i][0]))
        i += 1
    return got


class DeviceTrace:
    """Device operations and host ranges of one profiled window, in ns."""

    def __init__(self, ops: List[Tuple[str, int, int]],
                 ranges: List[Tuple[str, int, int]]):
        windows = [(a, b) for name, a, b in ranges if name == WINDOW]
        if not windows:
            raise ValueError(f"the trace holds no {WINDOW!r} range")
        self.window = (min(a for a, _ in windows), max(b for _, b in windows))
        w0, w1 = self.window
        self.ops = [(n, max(a, w0), min(b, w1)) for n, a, b in ops
                    if b > w0 and a < w1]
        self.ranges = [r for r in ranges if r[0] != WINDOW]
        self.busy = _merge([(a, b) for _, a, b in self.ops])

    @classmethod
    def from_profile(cls, prof) -> "DeviceTrace":
        """From a finished ``torch.profiler.profile``, through its Chrome
        trace (a format that stays put across torch versions; written to
        a temporary file and removed)."""
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        return cls.from_chrome(events)

    @classmethod
    def from_chrome(cls, events: List[dict]) -> "DeviceTrace":
        """From Chrome-trace events (``ts`` and ``dur`` in microseconds)."""
        ops, ranges = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = int(round(float(e["ts"]) * 1e3))
            b = a + int(round(float(e["dur"]) * 1e3))
            if e.get("cat") in DEVICE_ACTIVITIES:
                ops.append((e.get("name", "?"), a, b))
            elif e.get("cat") == "user_annotation":
                ranges.append((e.get("name", "?"), a, b))
        return cls(ops, ranges)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the card."""
        return sum(b - a for a, b in self.busy) * 1e-9

    def device_s_within(self, span: str) -> float:
        """Device seconds of every operation, counted where it overlaps a
        host range named ``span``."""
        spans = _merge([(a, b) for n, a, b in self.ranges if n == span])
        starts = [a for a, _ in spans]
        return sum(_overlap((a, b), spans, starts)
                   for _, a, b in self.ops) * 1e-9

    def top_ops(self, n: int = 10) -> List[list]:
        """``[[name, seconds], ...]``: the device operations that took the
        most time in all, longest first."""
        tot: Dict[str, int] = defaultdict(int)
        for name, a, b in self.ops:
            tot[name] += b - a
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]

    def _host_timeline(self) -> List[Tuple[int, int, str]]:
        """The window cut into pieces ``(start, end, label)``, each labelled
        by the innermost span open over it (``host`` where none is)."""
        w0, w1 = self.window
        marks = []
        for i, (name, a, b) in enumerate(self.ranges):
            marks.append((max(a, w0), 1, i))
            marks.append((min(b, w1), 0, i))      # ends sort before starts
        marks.sort()
        stack: List[int] = []
        pieces = []
        t = w0
        for when, is_start, i in marks:
            if when > t:
                label = self.ranges[stack[-1]][0] if stack else "host"
                pieces.append((t, when, label))
                t = when
            if is_start:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
        if w1 > t:
            pieces.append((t, w1, "host"))
        return pieces

    def idle_gaps(self, n: int = 10) -> List[list]:
        """``[[label, seconds], ...]``: the card's idle time in the window,
        summed by what the host was doing, which is the innermost span open
        at each moment (``host`` where none is); largest first."""
        w0, w1 = self.window
        edges = [w0] + [t for iv in self.busy for t in iv] + [w1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        tot: Dict[str, int] = defaultdict(int)
        pieces = self._host_timeline()
        j = 0
        for a, b in gaps:
            while j < len(pieces) and pieces[j][1] <= a:
                j += 1
            i = j
            while i < len(pieces) and pieces[i][0] < b:
                s, e, label = pieces[i]
                tot[label] += min(b, e) - max(a, s)
                i += 1
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[label, ns * 1e-9] for label, ns in top]
