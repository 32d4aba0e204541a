"""The tail is taken over every step interval of the window."""
import statistics

from port_bench import harness


def test_p95_is_over_all_intervals():
    # 20 calls of 100 steps: 99 steps of 10 ms and one stall of 40 ms each
    ms = ([10.0] * 99 + [40.0]) * 20
    # a median of per-call p95s would read 10 ms; the stalls are 1% of
    # all steps, so the tail of all steps reads 10 ms too, while 6% of
    # stalls must show
    assert harness.p95(ms) == 10.0
    ms6 = ([10.0] * 94 + [40.0] * 6) * 20
    assert harness.p95(ms6) == 40.0
    assert harness.p95(ms6) == statistics.quantiles(sorted(ms6), n=20)[18]


def test_worst_rel_takes_the_worst_block():
    import numpy as np
    b = np.ones((2, 3, 4))
    a = b.copy()
    a[1, 2] *= 1.5
    assert harness.worst_rel(a, b, 2) == 0.5
    assert harness.rel(a, b) < 0.5
