"""Profiling: traces, timing, FLOP counts and memory on the card.

Counterpart of `pde_policylearning_tpu/utils/profiling.py` (reference:
ProfileResult, the torch.autograd.profiler table of CPU/CUDA time,
memory and GFLOPS, libs/models/utils_ft.py:861-963; the pympler memory
summaries of run_control.py:22-23).  `torch.profiler` takes the place of
`jax.profiler` and writes a Chrome trace; `FlopCounterMode` counts the
FLOPs that XLA's cost analysis estimates in the JAX package.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = "./outputs/torch-trace"):
    """Profile the block (the CPU, and the card where there is one) and
    write its Chrome trace to `log_dir/trace.json`; yields the path."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


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
