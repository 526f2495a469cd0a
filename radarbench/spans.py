"""The program's own spans of the traced steps, as the per-layer readers
take them: ``navtech_radar_slam_torch.utils.profiling.summary()`` in the
runner's process, per batched odometry step (``odo.step``).

The spans record only while a profiler session records, so in a run they
cover the traced steps alone.  A reader finds nothing to read, and gives
None, without a trace, and where the program records no such span (a port
that has none gives None, and raises nothing).
"""

from __future__ import annotations

from typing import Optional

#: the span of one batched odometry step
STEP = "odo.step"
#: the prefix of a span around a call that makes the host wait for the device
SYNC = "sync."


def summary(rec) -> Optional[dict]:
    """The program's span summary of a traced run with at least one step,
    else None."""
    if rec.trace is None:
        return None
    from navtech_radar_slam_torch.utils import profiling

    read = getattr(profiling, "summary", None)
    if read is None:
        return None
    s = read()
    return s if s.get(STEP, {}).get("count") else None


def per_step(rec, name: str, field: str) -> Optional[float]:
    """``field`` (``device_ms``, ``host_ms``, ``self_ms``) of the spans
    ``name``, summed, per step; None where there is none."""
    s = summary(rec)
    if s is None or name not in s or s[name][field] is None:
        return None
    return s[name][field] / s[STEP]["count"]


def syncs_per_step(rec) -> Optional[float]:
    """``sync.*`` spans per step."""
    s = summary(rec)
    if s is None:
        return None
    return sum(v["count"] for k, v in s.items() if k.startswith(SYNC)) / s[STEP]["count"]
