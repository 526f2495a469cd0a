"""Device ms a batched odometry step spends in the spectral scores of its
three registrations (`odo.spectral`), over the traced steps."""

from radarbench import spans


def read(rec):
    return spans.per_step(rec, "odo.spectral", "device_ms")
