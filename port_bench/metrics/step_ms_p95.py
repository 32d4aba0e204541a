"""The 95th percentile of every step's interval in the measured window,
in ms: a CUDA event is recorded as each step's policy is called, and a
step runs to the next event on the device timeline, so a stall anywhere
lands in a step.  Nothing to read where the window timed no step."""
from port_bench.harness import p95


def read(run):
    ms = run["window"].get("step_ms")
    return p95(ms) if ms else None
