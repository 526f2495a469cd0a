"""The device trace of a run's traced steps, reduced to what the per-layer
readers and the result's ``breakdown`` take.

``DeviceTrace`` is a ``torch.profiler`` session (CPU and CUDA activity)
around the traced steps.  Late in a long process the profiler loses the
first device events of a session, so, as ``chip_smoke.py``'s
``device_busy`` does, the session first launches ``MARKERS`` marker
kernels (``torch.cuda._sleep``), which every count leaves out; the traced
window itself is a ``record_function`` span opened after them, and only
device work inside that span counts.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

#: marker kernels launched ahead of the traced window
MARKERS = 1000
#: the traced window's span
WINDOW_SPAN = "radarbench.traced_window"
#: entries of each list of the breakdown
TOP = 10


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    #: every device operation in the window: (name, start s, duration s)
    ops: List[Tuple[str, float, float]]
    #: the device operations that took most time, [name, seconds]
    device_ops: List[list]
    #: idle time of the device by what the host was doing, [name, seconds]
    idle_gaps: List[list]
    markers_kept: int

    def kernel_time(self, *names: str) -> Tuple[int, float]:
        """(launches, device seconds) of the operations whose name holds one
        of ``names``."""
        hits = [d for n, _, d in self.ops if any(k in n for k in names)]
        return len(hits), sum(hits)


def _is_device(e) -> bool:
    """A device operation: a kernel, copy or fill (not the device-side copy
    of a ``record_function`` span)."""
    return (getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name != WINDOW_SPAN)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _innermost(cpu: List[Tuple[float, float, str]], points: List[float]) -> List[str]:
    """For each point (ascending), the name of the innermost CPU event that
    holds it ("host idle" where none does): a sweep over the events by start
    with a stack of the open ones (one thread's events nest)."""
    names, stack, i = [], [], 0
    for p in points:
        while i < len(cpu) and cpu[i][0] <= p:
            stack.append(cpu[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        names.append(stack[-1][2] if stack else "host idle")
    return names


def summarize(prof) -> Optional[TraceSummary]:
    """The traced window's summary, or None when the profiler kept no span
    of the window."""
    events = prof.events()
    window = [e for e in events if e.name == WINDOW_SPAN
              and getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA]
    if not window:
        return None
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    thread = window[0].thread
    markers = 0
    ops = []
    for e in events:
        if not _is_device(e):
            continue
        if "spin_kernel" in e.name:
            markers += 1
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b > a:
            ops.append((e.name, a, b))
    busy = _union([(a, b) for _, a, b in ops])
    per_name: Dict[str, float] = collections.defaultdict(float)
    for n, a, b in ops:
        per_name[n] += b - a
    # idle gaps inside the window, by the innermost host event at their middle
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    cpu = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type != torch.autograd.DeviceType.CUDA
                 and e.thread == thread and e.name != WINDOW_SPAN
                 and e.time_range.end > w0 and e.time_range.start < w1)
    mids = [(a + b) / 2 for a, b in gaps]
    idle: Dict[str, float] = collections.defaultdict(float)
    for (a, b), name in zip(gaps, _innermost(cpu, mids)):
        idle[name] += b - a

    def top(d: Dict[str, float]) -> List[list]:
        return [[n, 1e-6 * v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return TraceSummary(
        window_s=1e-6 * (w1 - w0), busy_s=1e-6 * sum(b - a for a, b in busy),
        ops=[(n, 1e-6 * a, 1e-6 * (b - a)) for n, a, b in ops],
        device_ops=top(per_name), idle_gaps=top(idle), markers_kept=markers)


class DeviceTrace:
    """``with DeviceTrace(device) as tr: ...`` traces the block; then
    ``tr.summary`` is its ``TraceSummary`` (None without a card)."""

    def __init__(self, device: str):
        self.cuda = torch.device(device).type == "cuda"
        self.summary: Optional[TraceSummary] = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        if self.cuda:
            for _ in range(MARKERS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None and self.cuda:
            self.summary = summarize(self._prof)
        return False
