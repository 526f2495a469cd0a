"""Host ms a batched odometry step spends issuing registration
(`odo.register_step`: matching and three registrations under vmap), over the
traced steps.  Beside its device ms it tells a host-paced stage from a
device-paced one."""

from radarbench import spans


def read(rec):
    return spans.per_step(rec, "odo.register_step", "host_ms")
