"""Device operations launched per step of the traced slice (kernels,
copies and fills, as the profiler lists them)."""


def read(run):
    tr = run["trace"]
    return sum(c for _, c, _ in tr["kernels"]) / tr["steps"]
