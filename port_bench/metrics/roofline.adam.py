"""Adam's share of its roofline: the bytes Adam needs over the parameters
that can get a gradient (7 x 4 B a parameter a step: the parameter, its
gradient and both moments read, the parameter and both moments written;
`n_live_params` of port_bench/counts/pino.py: in the opo loop the
spectral weights of the one time mode a T = 1 plane holds, and the
leaves outside the spectral convs) at the HBM peak, over the device time
of the optimizer's multi-tensor kernels in the traced slice, in %.
Nothing to read where no multi-tensor kernel ran."""
from port_bench.counts.peaks import HBM_BYTES
from port_bench.harness import kernel_time


def read(run):
    n, t = kernel_time(run["trace"], "multi_tensor_apply")
    nbytes = run.get("adam_bytes_per_step", 0) * run["trace"]["steps"]
    if not n or t <= 0 or not nbytes:
        return None
    return 100.0 * nbytes / HBM_BYTES / t
