"""Idle share of the device in the optimal-observer loop's measured
window, in %: 1 - (the traced slice's device busy time a step) / (the
median step of the untraced window, CUDA events on the device timeline).
The traced slice's own idle share reads the profiler here: it follows each
of the ~3,400 nodes of every `cudaGraphLaunch`, which holds the host long
enough to starve the device, while untraced the host keeps ahead.  Reads
near 0 while the device bounds the step, a little below it where the
profiled kernels run longer than unprofiled ones; the host's share of the
step otherwise."""
from statistics import median


def read(run):
    tr, ms = run["trace"], run["window"].get("step_ms")
    if not ms:
        return None
    return 100.0 * (1.0 - 1e3 * tr["busy_s"] / tr["steps"] / median(ms))
