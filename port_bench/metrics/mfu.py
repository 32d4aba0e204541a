"""The step's share of the card's float32 peak while the card is busy: the
counted operations of the traced slice's steps (port_bench/counts, per
step times the steps traced) over the device's busy time in that slice
(the union of its operations' intervals) times the peak, in %."""
from port_bench.counts.peaks import flops_peak


def read(run):
    tr = run["trace"]
    return 100.0 * run["ops_per_step"] * tr["steps"] / (
        tr["busy_s"] * flops_peak())
