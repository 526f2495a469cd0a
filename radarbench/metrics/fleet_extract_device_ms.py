"""Device ms a batched odometry step spends in extraction (`odo.extract`:
K1 x B, the top-k, the descriptors): the stream's wall time between the
span's CUDA events, idle time inside it included, over the traced steps."""

from radarbench import spans


def read(rec):
    return spans.per_step(rec, "odo.extract", "device_ms")
