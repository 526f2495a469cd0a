"""Calls a batched odometry step makes that wait for the device (`sync.*`
spans), over the traced steps."""

from radarbench import spans


def read(rec):
    return spans.syncs_per_step(rec)
