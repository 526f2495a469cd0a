"""The port's tracing: program spans, stage timers and a device trace.

``span(name)`` marks one stage of the program.  It is off unless a
``torch.profiler`` session is recording (the benchmark's traced steps, the
CLI's ``--profile_dir``): off, it reads one flag and does nothing else.
While a session records, a span

  * opens ``torch.profiler.record_function(name)``, so the stage sits in the
    profiler's timeline on the same clock as the kernels it launches;
  * keeps a ``Span`` in ``RECORDS`` (in memory, in the order the spans
    opened): its name, its parent (the span open around it), its host start
    and end (``time.perf_counter``) and, once the process has initialised
    CUDA, a start and an end CUDA event recorded on the current stream.

A span's device ms is the stream's wall time between its two events, idle
time inside the span included, resolved only when read (``summary()``,
after the steps): reading it waits for the end event.  ``summary()`` sums
the records by name, ``reset()`` drops them.  By convention a span named
``sync.<site>`` wraps a call that makes the host wait for the device, so
their number counts the host syncs and their host time the wait.

``StageTimers`` keeps the per-stage host statistics the CLI reports, and
opens a span for each stage it times.  ``device_trace`` is a
``torch.profiler`` session that writes one Chrome trace into its directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

#: the span context when no profiler session records: nothing at all
_OFF = contextlib.nullcontext()


class Span:
    """One recorded span; ``parent`` is the enclosing ``Span`` or None."""

    __slots__ = ("name", "parent", "host_start", "host_end", "events")

    def __init__(self, name: str, parent: Optional["Span"]):
        self.name = name
        self.parent = parent
        self.host_start = self.host_end = time.perf_counter()
        self.events = None

    @property
    def host_ms(self) -> float:
        return (self.host_end - self.host_start) * 1e3

    def device_ms(self) -> Optional[float]:
        """The stream's wall time from the start event to the end event
        (waits for the end event); None where no event was recorded."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


#: every span recorded since the last ``reset()``, in the order they opened
RECORDS: List[Span] = []
#: the spans open now, innermost last (the program opens spans on one thread)
_OPEN: List[Span] = []


def span(name: str):
    """A context that records the block as the span ``name`` while a
    ``torch.profiler`` session records, and does nothing otherwise."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return _recorded(name)


@contextlib.contextmanager
def _recorded(name: str):
    rec = Span(name, _OPEN[-1] if _OPEN else None)
    with torch.profiler.record_function(name):
        if torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        _OPEN.append(rec)
        RECORDS.append(rec)
        rec.host_start = time.perf_counter()
        try:
            yield
        finally:
            rec.host_end = time.perf_counter()
            if rec.events is not None:
                rec.events[1].record()
            _OPEN.pop()


def summary() -> Dict[str, dict]:
    """Per span name: ``count``, ``host_ms`` (total), ``self_ms`` (host
    total less the host time of the spans directly inside) and
    ``device_ms`` (total; None where no span of the name has events)."""
    out: Dict[str, dict] = {}
    child_ms: Dict[int, float] = defaultdict(float)
    for rec in RECORDS:
        if rec.parent is not None:
            child_ms[id(rec.parent)] += rec.host_ms
    for rec in RECORDS:
        s = out.setdefault(rec.name, {"count": 0, "host_ms": 0.0, "self_ms": 0.0,
                                      "device_ms": None})
        s["count"] += 1
        s["host_ms"] += rec.host_ms
        s["self_ms"] += rec.host_ms - child_ms[id(rec)]
        dev = rec.device_ms()
        if dev is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + dev
    return out


def reset() -> None:
    """Drop every recorded span (call it between steps, with no span open)."""
    RECORDS.clear()


class StageTimers:
    """Aggregated per-stage wall statistics (count / total / self / max).

    Stages may nest (live_poll wraps the engine's map_render); the ``self``
    column excludes time spent in nested stages, so self-times sum to at
    most the wall time even when totals overlap.  Caveat: a stage that only
    queues device work (kf_step, kf_segment, pgo_refine_*) times the
    launches, not the device; the wait lands in whichever stage reads a
    result back (odo_fetch, loop_fetch).  Each stage is also a ``span``,
    whose device ms (while a profiler records) time the device."""

    def __init__(self):
        self._total: Dict[str, float] = defaultdict(float)
        self._self: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)
        self._max: Dict[str, float] = defaultdict(float)
        self._stack = []   # [stage, accumulated child ms]

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        self._stack.append([stage, 0.0])
        try:
            with span(stage):
                yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            _, child_ms = self._stack.pop()
            self._total[stage] += ms
            self._self[stage] += ms - child_ms
            self._count[stage] += 1
            self._max[stage] = max(self._max[stage], ms)
            if self._stack:
                self._stack[-1][1] += ms

    def report(self) -> str:
        lines = [
            "stage                    (totals may nest; `self` excludes "
            "nested stages; async stages time the launches, not the device)"
        ]
        for stage in sorted(self._total, key=self._total.get, reverse=True):
            n = self._count[stage]
            tot = self._total[stage]
            lines.append(
                f"{stage:24s} n={n:6d} total={tot:9.1f}ms "
                f"self={self._self[stage]:9.1f}ms "
                f"mean={tot / max(n, 1):7.2f}ms max={self._max[stage]:7.2f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """A ``torch.profiler`` session over the block (CPU and, where there is
    a card, CUDA activity) that writes ``trace.json``, a Chrome trace, into
    ``logdir``; no-op when logdir is None.  The program's spans are on
    inside it and appear in the trace."""
    if logdir is None:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
