#!/usr/bin/env python3
"""Where a traced step of the ``odo_fleet_b512`` cell spends its time, per
program span, on one CUDA card.

    python3 tools/fleet_step_look.py <seed> [steps]     (default 4 steps)

Sets up the cell as ``radarbench/run.py`` does for ``--seed``, runs two
untraced steps, then ``steps`` steps under ``torch.profiler`` (after
``radarbench.tracing``'s marker kernels, so that the trace keeps its first
events), and prints per step:

  * the window's ms, the device's busy and idle ms, and its kernel count;
  * for each span (``odo.*``, ``sync.*``): its count, host ms and self ms
    (``utils.profiling.summary``), its device ms (stream wall time), and
    the busy ms and kernels attributed to it: each kernel to the innermost
    device-side span range that holds its start;
  * the idle ms attributed to each span: each gap between the union of the
    kernels' intervals to the innermost span open on the host at the gap's
    middle ("(outside the step's spans)" where none is);
  * the twelve kernels that take the most device time.

Nothing here imports JAX.
"""

from __future__ import annotations

import collections
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from navtech_radar_slam_torch.utils import profiling  # noqa: E402
from radarbench import harness, tracing  # noqa: E402
from radarbench.rehearse import context  # noqa: E402
from radarbench.runners import fleet  # noqa: E402

CUDA = torch.autograd.DeviceType.CUDA


def innermost(spans: list, t: float) -> str:
    """The name of the shortest (start, end, name) span holding ``t``."""
    best = None
    for a, b, n in spans:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, n)
    return best[2] if best else "(outside the step's spans)"


def traced_events(seed: int, steps: int):
    """The profiler's events of ``steps`` traced steps, and the window span."""
    harness.use_cache_dirs()
    st = fleet.setup(context("odo_fleet_b512", seed, (), "cuda:0"))
    for _ in range(2):
        fleet.one_step(st)
    torch.cuda.synchronize()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(tracing.MARKERS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            for _ in range(steps):
                fleet.one_step(st)
            torch.cuda.synchronize()
    ev = prof.events()
    win = next(e for e in ev if e.name == tracing.WINDOW_SPAN and e.device_type != CUDA)
    return ev, win


def main() -> None:
    seed = int(sys.argv[1])
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    ev, win = traced_events(seed, steps)
    w0, w1 = win.time_range.start, win.time_range.end

    def ours(name: str) -> bool:
        return name.startswith(("odo.", "sync."))

    ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in ev
                 if e.device_type == CUDA and not getattr(e, "is_user_annotation", False)
                 and "spin_kernel" not in e.name and e.name != tracing.WINDOW_SPAN
                 and e.time_range.start >= w0 and e.time_range.end <= w1)
    dspan = [(e.time_range.start, e.time_range.end, e.name) for e in ev
             if e.device_type == CUDA and getattr(e, "is_user_annotation", False)
             and ours(e.name)]
    hspan = sorted((e.time_range.start, e.time_range.end, e.name) for e in ev
                   if e.device_type != CUDA and ours(e.name) and e.thread == win.thread)

    busy, kern = collections.defaultdict(float), collections.defaultdict(int)
    for a, b, _ in ops:
        s = innermost(dspan, a)
        busy[s] += b - a
        kern[s] += 1
    union = []
    for a, b, _ in ops:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    edges = [w0] + [x for iv in union for x in iv] + [w1]
    idle = collections.defaultdict(float)
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b > a:
            idle[innermost(hspan, (a + b) / 2)] += b - a

    summ = profiling.summary()
    n = summ["odo.step"]["count"]
    busy_us = sum(b - a for a, b in union)
    print(f"card: {torch.cuda.get_device_name(0)}; seed {seed}; {n} traced steps; window "
          f"{(w1 - w0) / 1e3 / n:.1f} ms a step, busy {busy_us / 1e3 / n:.1f}, idle "
          f"{(w1 - w0 - busy_us) / 1e3 / n:.1f}; kernels {len(ops) / n:.0f}")
    print("span | count/step | host ms | self ms | device ms (stream wall) | busy ms | kernels "
          "| idle ms")
    for name in sorted(set(summ) | set(busy) | set(idle)):
        s = summ.get(name, {})
        print(f"{name} | {s.get('count', 0) / n:.0f} | {s.get('host_ms', 0) / n:.1f} | "
              f"{s.get('self_ms', 0) / n:.1f} | {(s.get('device_ms') or 0) / n:.1f} | "
              f"{busy[name] / 1e3 / n:.1f} | {kern[name] / n:.0f} | {idle[name] / 1e3 / n:.1f}")
    top = collections.defaultdict(float)
    for a, b, name in ops:
        top[name[:90]] += b - a
    for name, v in sorted(top.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {v / 1e3 / n:8.2f} ms/step  {name}")


if __name__ == "__main__":
    main()
