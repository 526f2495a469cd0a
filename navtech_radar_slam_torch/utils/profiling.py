"""Wall-clock stage timers and a device trace context.

A copy of ``navtech_radar_slam_tpu/utils/profiling.py``: ``TicToc`` and
``TicTocV2`` are the reference's tic_toc.h (milliseconds; TicTocV2 prints
"<task>: X msec" only when built with display on), ``StageTimers`` the
aggregated per-stage statistics the CLI reports.  ``device_trace`` is a
``torch.profiler`` session in place of ``jax.profiler``: it writes one
Chrome trace into its directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class TicToc:
    """tic_toc.h:10-32 — returns elapsed milliseconds."""

    def __init__(self):
        self.tic()

    def tic(self) -> None:
        self._start = time.perf_counter()

    def toc(self) -> float:
        return (time.perf_counter() - self._start) * 1e3


class TicTocV2(TicToc):
    """tic_toc.h:34-69 — named, print-gated (silent by default)."""

    def __init__(self, name: str = "", display: bool = False):
        super().__init__()
        self.name = name
        self.display = display

    def toc(self) -> float:
        ms = super().toc()
        if self.display:
            print(f"{self.name}: {ms:.1f} msec")
        return ms


class StageTimers:
    """Aggregated per-stage wall statistics (count / total / self / max).

    Stages may nest (live_poll wraps the engine's map_render); the ``self``
    column excludes time spent in nested stages, so self-times sum to at
    most the wall time even when totals overlap.  Caveat: a stage that only
    queues device work (kf_step, kf_segment, pgo_refine_*) times the
    launches, not the device; the wait lands in whichever stage reads a
    result back (odo_fetch, loop_fetch)."""

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

    def mean_ms(self, stage: str) -> float:
        return self._total[stage] / max(self._count[stage], 1)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """A ``torch.profiler`` session over the block (CPU and, where there is
    a card, CUDA activity) that writes ``trace.json``, a Chrome trace, into
    ``logdir``; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import torch

    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
