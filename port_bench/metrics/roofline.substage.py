"""Kernel A's (`substage_planes_kernel`) share of its roofline: its
launches times the bound of one RK3 substage at the cell's B
(port_bench/counts/channel.py), over its device time in the traced slice,
in %.  Nothing to read where kernel A did not run."""
from port_bench.counts.peaks import bound_s
from port_bench.harness import kernel_time


def read(run):
    n, t = kernel_time(run["trace"], "substage_planes", "substage_kernel")
    if not n or t <= 0:
        return None
    return 100.0 * n * bound_s(*run["substage"]) / t
