"""Device ms a batched odometry step spends in its three ORORA registrations
(`odo.register`, the vmapped `register_scans` calls), over the traced
steps."""

from radarbench import spans


def read(rec):
    return spans.per_step(rec, "odo.register", "device_ms")
