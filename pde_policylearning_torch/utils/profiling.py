"""Profiling: the program's spans, traces, timing, FLOP counts and memory
on the card.

Counterpart of `pde_policylearning_tpu/utils/profiling.py` (reference:
ProfileResult, the torch.autograd.profiler table of CPU/CUDA time,
memory and GFLOPS, libs/models/utils_ft.py:861-963; the pympler memory
summaries of run_control.py:22-23).  `torch.profiler` takes the place of
`jax.profiler` and writes a Chrome trace; `FlopCounterMode` counts the
FLOPs that XLA's cost analysis estimates in the JAX package.

Spans mark the layer boundaries of the control loop and the batched
rollout (`span(name)` in `control/loop.py`, `control/policies.py`,
`envs/channel_flow.py`).  They are off unless a `spans()` or `trace()`
block is open; then each is kept in memory as (name, start_ns, end_ns,
parent index), stamped on `time.time_ns()`, the clock torch.profiler
stamps its events with, and while a profiler runs it is also a range of
the same name in the profiler's trace.  `profile_events`,
`host_ms_per_step` and `device_idle` read a profiled slice against them.
"""
from __future__ import annotations

import bisect
import contextlib
import os
import time
from typing import Callable, Optional

import torch

# -- spans -------------------------------------------------------------------

_on = False           # the one flag that an off span reads
_records: list = []   # (name, start_ns, end_ns, parent index) while on
_open: list = []      # indices of the open spans, innermost last
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "records", "index", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # the profiler's range opens first and closes last, so that it
        # holds the span's own stamps; torch's C++ entry to it (the Python
        # `record_function` spends up to ~60 us in its exit, after its
        # stamp, on the CPU)
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch._C._profiler._RecordFunctionFast(
                self.name)
            self.annotation.__enter__()
        self.records = _records
        self.index = len(_records)
        _records.append((self.name, time.time_ns(), None,
                         _open[-1] if _open else -1))
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        name, start, _, parent = self.records[self.index]
        self.records[self.index] = (name, start, time.time_ns(), parent)
        _open.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that records the block as the span `name` while
    spans are on; off, the one shared null context (no clock, no
    allocation, no call into torch)."""
    if not _on:
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def spans():
    """Spans on inside the block; yields the list they are recorded in,
    (name, start_ns, end_ns, parent index) each, parents before children.
    Inside another `spans()` block it yields that block's list."""
    global _on, _records
    was_on, outer = _on, _records
    if not was_on:
        _records = []
    _on = True
    try:
        yield _records
    finally:
        _on, _records = was_on, outer


@contextlib.contextmanager
def trace(log_dir: str = "./outputs/torch-trace"):
    """Profile the block (the CPU, and the card where there is one), with
    the program's spans on, and write its Chrome trace to
    `log_dir/trace.json`; yields the path."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with spans(), profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


# -- reading a profiled slice against the spans ------------------------------

BLOCKED = "Command Buffer Full"


def profile_events(prof) -> dict:
    """What `host_ms_per_step` and `device_idle` read of a torch.profiler
    record, in its ns: `device`, the device operations (start, end,
    correlation id; the profiler's annotations left out); `runtime`, the
    host's CUDA runtime and driver calls (`cuda*`, `cu*`: start, end,
    correlation id); `blocked`, the intervals the host spent blocked with
    the command buffer full (start, end)."""
    from torch.autograd import DeviceType
    device, runtime, blocked = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.duration_ns() <= 0:
            continue
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.name() == BLOCKED:
            blocked.append((e.start_ns(), e.end_ns()))
        elif e.name().startswith("cu"):
            runtime.append((e.start_ns(), e.end_ns(), e.correlation_id()))
    return dict(device=device, runtime=runtime, blocked=blocked)


def host_ms_per_step(records, blocked, name: str) -> Optional[float]:
    """The host ms of a span `name`, on average: each span's length less
    the parts of it that `blocked` (start, end) intervals cover, where the
    host waited for room in the command buffer.  None without such a
    span."""
    steps = [(s, e) for n, s, e, _ in records if n == name]
    if not steps:
        return None
    merged: list = []
    for b0, b1 in sorted(blocked):
        if merged and b0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b1)
        else:
            merged.append([b0, b1])
    ends = [b1 for _, b1 in merged]
    total = 0
    for s, e in steps:
        total += e - s
        for b0, b1 in merged[bisect.bisect_right(ends, s):]:
            if b0 >= e:
                break
            total -= min(e, b1) - max(s, b0)
    return total / len(steps) / 1e6


def device_idle(device, runtime, window_ns: int) -> dict:
    """The device's idle share of a slice `window_ns` long (`idle`, %: 1 -
    the union of the device operations over the slice), and the part of
    it the host caused (`idle_host`, %): over every gap (g0, g1) between
    the union's intervals, the runtime call that issued the operation
    starting at g1 (by correlation id) holds the device until the call
    returns, max(0, min(g1, call end) - g0).  An operation whose call is
    not found (`unmatched`) counts as device-side; where most are,
    `idle_host` is None."""
    ops = sorted(device)
    if not ops:
        return dict(idle=100.0, idle_host=None, unmatched=0, ops=0)
    call_end = {c: e for _, e, c in runtime}
    unmatched = sum(1 for _, _, c in ops if c not in call_end)
    busy = host = 0
    cur_s, cur_e = ops[0][0], ops[0][1]
    for s, e, c in ops[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            if c in call_end:
                host += max(0, min(s, call_end[c]) - cur_e)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return dict(idle=100.0 * (1.0 - busy / window_ns),
                idle_host=None if 2 * unmatched > len(ops)
                else 100.0 * host / window_ns,
                unmatched=unmatched, ops=len(ops))


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def benchmark(fn: Callable, *args, warmup: int = 2, iters: int = 20,
              **kwargs) -> dict:
    """Time `fn(*args, **kwargs)`: `warmup` calls, then `iters` calls with
    one synchronize of the card at the end of the timed loop (the JAX
    function's one `block_until_ready`).  Returns the mean ms a call and
    the calls a second, on the host's clock."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _sync()
    dt = (time.perf_counter() - t0) / iters
    return {"mean_ms": dt * 1e3, "iters_per_s": 1.0 / dt}


def flop_estimate(fn: Callable, *args, **kwargs) -> Optional[float]:
    """The FLOPs of one call, counted by `torch.utils.flop_counter`
    (matrix products and convolutions, 2 a multiply-add; elementwise work
    is not counted), or None where the count fails."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
        return float(counter.get_total_flops())
    except Exception:
        return None


def profile_result(fn: Callable, *args, warmup: int = 2, iters: int = 20,
                   **kwargs) -> dict:
    """`benchmark`, the FLOPs and the achieved GFLOP/s (the reference's
    ProfileResult table, utils_ft.py:861-963)."""
    stats = benchmark(fn, *args, warmup=warmup, iters=iters, **kwargs)
    flops = flop_estimate(fn, *args, **kwargs)
    if flops:
        stats["flops"] = flops
        stats["gflops_per_s"] = flops / (stats["mean_ms"] * 1e-3) / 1e9
    return stats


def memory_summary(device=None) -> str:
    """The card's allocator statistics (`torch.cuda.memory_stats`; bytes
    in MB), one per line; says so where there are none (the CPU)."""
    device = torch.device(device) if device is not None else None
    if not torch.cuda.is_available() or (device is not None
                                         and device.type != "cuda"):
        return "no memory statistics on the CPU"
    stats = torch.cuda.memory_stats(device)
    if not stats:
        return "no memory statistics available"
    return "\n".join(f"{k}: {v / 1e6:.1f} MB" if "bytes" in k
                     else f"{k}: {v}" for k, v in sorted(stats.items()))
