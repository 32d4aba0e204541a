"""The eigen-solve kernel's share of its roofline: its launches times the
bound of one solve at the cell's B (port_bench/counts/channel.py), over
its device time in the traced slice, in %.  Nothing to read where no
eigen-solve kernel ran."""
from port_bench.counts.peaks import bound_s
from port_bench.harness import kernel_time


def read(run):
    n, t = kernel_time(run["trace"], "eig_solve_tile", "eig_solve_rows")
    if not n or t <= 0:
        return None
    return 100.0 * n * bound_s(*run["eig_solve"]) / t
