"""Device milliseconds a control step of the operations launched inside
the program's span `policy.descend` (the optimal-observer's descent), in
the traced slice: the kernels, copies and fills the host issued inside
the span, each replay of the graph's kernels by its `cudaGraphLaunch`'s
correlation id, the union of their intervals over the slice's steps.
Nothing to read where the program has no such span."""


def read(run):
    tr = run["trace"]
    s = tr.get("descent_s")
    if not s:
        return None
    return 1e3 * s / tr["steps"]
