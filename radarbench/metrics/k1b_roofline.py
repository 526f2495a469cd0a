"""K1 x B's share of its roofline (%): the frozen bound of one launch over
the step's B scans (``counts/k1b.py``) over the launch's mean device time,
found by name in the profiler's trace of the traced steps."""

from radarbench.counts import k1b


def read(rec):
    if rec.trace is None:
        return None
    n, secs = rec.trace.kernel_time(*k1b.KERNELS)
    if n == 0 or secs <= 0:
        return None
    s = rec.shapes
    return 100.0 * k1b.bound(s["streams"], s["na"], s["nbp"]) / (secs / n)
