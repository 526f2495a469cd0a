"""The frozen roofline arithmetic."""

from radarbench.counts import k1b


def test_k1b_bound_at_the_batches_in_perf():
    assert round(k1b.bound(64, 400, 3456) * 1e6, 3) == 211.280
    assert round(k1b.bound(256, 400, 3456) * 1e6, 1) == 845.1
    assert round(k1b.bound(512, 400, 3456) * 1e6, 1) == 1690.2
    assert k1b.bytes_moved(1, 400, 3456) == 8 * 400 * 3456
