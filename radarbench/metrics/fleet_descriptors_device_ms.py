"""Device ms a batched odometry step spends in the constellation descriptors
(`odo.descriptors`, inside extraction), over the traced steps."""

from radarbench import spans


def read(rec):
    return spans.per_step(rec, "odo.descriptors", "device_ms")
