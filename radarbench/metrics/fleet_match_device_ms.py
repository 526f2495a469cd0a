"""Device ms a batched odometry step spends in matching (`odo.match`, the
vmapped `match_feature_pair`), over the traced steps."""

from radarbench import spans


def read(rec):
    return spans.per_step(rec, "odo.match", "device_ms")
