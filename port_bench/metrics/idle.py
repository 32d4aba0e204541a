"""Idle share of the device over the traced slice: 1 - (union of the
device operations' intervals) / (the slice's length), in %."""


def read(run):
    tr = run["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
