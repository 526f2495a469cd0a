"""Device kernels a batched odometry step launches, from the profiler's
trace of the traced steps (copies and fills left out)."""


def read(rec):
    tr, n = rec.trace, rec.counts.get("traced_steps")
    if tr is None or not n:
        return None
    kernels = [name for name, _, _ in tr.ops if not name.startswith(("Memcpy", "Memset"))]
    return len(kernels) / n if kernels else None
