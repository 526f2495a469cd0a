"""Host ms a batched odometry step waits in the top-k's `nonzero` for the
device (`sync.topk`), over the traced steps."""

from radarbench import spans


def read(rec):
    return spans.per_step(rec, "sync.topk", "host_ms")
