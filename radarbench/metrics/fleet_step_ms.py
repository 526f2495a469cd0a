"""Mean host time of a batched odometry step over the measured window: the
benchmark's span around each step call, ended by the read of that step's
poses (all the window's steps)."""


def read(rec):
    ms = [1e3 * (b - a) for name, a, b in rec.spans if name == "fleet.step"]
    return sum(ms) / len(ms) if ms else None
