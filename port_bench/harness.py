"""What every driver shares: the files found by name, the inputs made from
the seed, the traced slice and its reading, and the comparison numbers.

Nothing here imports the program; the drivers do.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import statistics
import time
from contextlib import contextmanager
from typing import Callable

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "port_bench")
# the packaged Re_tau ~ 180 snapshot, read as data
SNAPSHOT = os.path.join(ROOT, "pde_policylearning_torch", "data", "assets",
                        "channel180_minchan.npz")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_files(name: str, config: str) -> tuple[dict, dict]:
    """(the cell's parameters, its configuration), by name."""
    return (load_json(BENCH, "cells", f"{name}.json"),
            load_json(BENCH, "configs", f"{config}.json"))


def reader_path(metric: str) -> str:
    """The reader of a per-layer metric: port_bench/metrics/<metric>.py,
    else the file of the name with its last dotted part taken off, and so
    on, so that one reader serves a quantity in every cell
    (`idle.collect` and `idle.loop` are both read by metrics/idle.py)."""
    parts = metric.split(".")
    for n in range(len(parts), 0, -1):
        path = os.path.join(BENCH, "metrics", ".".join(parts[:n]) + ".py")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no reader for the metric {metric!r}")


def grid_kw(cfg: dict) -> dict:
    """The channel grid's sizes of a configuration, as both the program's
    and the reference's grid take them."""
    return dict(Nx=cfg["Nx"], Ny=cfg["Ny"], Nz=cfg["Nz"], nu=cfg["nu"],
                dt=cfg["dt"])


def pino_model_kw(cfg: dict) -> dict:
    """The widths of a configuration as the program's PINO models take
    them."""
    L = cfg["n_layers"]
    m1, m2, m3 = cfg["modes"]
    return dict(modes1=(m1,) * L, modes2=(m2,) * L, modes3=(m3,) * L,
                layers=(cfg["width"],) * (L + 1), fc_dim=cfg["fc_dim"],
                in_dim=cfg["in_dim"])


# ---------------------------------------------------------------------------
# inputs from the seed
# ---------------------------------------------------------------------------

def generator(seed: int, device):
    import torch
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)


def channel_states(grid_ref, n_envs: int, noise: float, seed: int, device,
                   dtype):
    """`n_envs` states of the packaged snapshot plus normal noise of
    `noise` drawn on `device` from `seed` in one call, admitted by the
    reference's projection in float64, then cast to `dtype`.  Returns
    (U, V, W (B, Nx, R, Nz), dPdx (B,), meanU0 (B,)): the target bulk
    velocity is the snapshot's own."""
    import torch
    from .reference import channel as ref
    snap = np.load(SNAPSHOT)
    f64 = dict(dtype=torch.float64, device=device)
    U0, V0, W0 = (torch.as_tensor(snap[k], **f64)[None] for k in "UVW")
    sizes = [U0.numel(), V0.numel(), W0.numel()]
    draw = torch.randn((n_envs, sum(sizes)), generator=generator(seed, device),
                       **f64)
    U, V, W = (a + noise * d.reshape(n_envs, *a.shape[1:])
               for a, d in zip((U0, V0, W0), draw.split(sizes, 1)))
    U, V, W = ref.admitted_state(grid_ref, U, V, W)
    dPdx = torch.full((n_envs,), float(snap["dPdx"]), **f64)
    meanU0 = ref.bulk(grid_ref, U0).expand(n_envs)
    return tuple(a.to(dtype).contiguous() for a in (U, V, W, dPdx, meanU0))


# ---------------------------------------------------------------------------
# the traced slice
# ---------------------------------------------------------------------------

@contextmanager
def span(name: str):
    """A host span of the benchmark's own, seen in the trace."""
    import torch
    with torch.profiler.record_function(name):
        yield


def _profile():
    """The profiler over the card and the host's operators."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA, ProfilerActivity.CPU])


def _events(prof):
    """(device, host) lists of (start_ns, end_ns, name) of a profile."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and e.duration_ns() > 0:
                dev.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.duration_ns() > 0:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    return dev, host


def traced(fn: Callable[[], int], attempts: int = 3) -> dict:
    """Run `fn` (one steady slice of the window's work; it returns its step
    count) under torch.profiler, the card synchronized before and after,
    and reduce the trace: device time by kernel name, the union of the
    device intervals (busy), the slice's length (window) and the longest
    idle gaps by the innermost host span open across them.  A trace that
    holds no device event is taken again, up to `attempts` slices."""
    import torch
    for _ in range(attempts):
        torch.cuda.synchronize()
        with _profile() as prof:
            t0 = time.perf_counter_ns()
            steps = fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter_ns()
        dev, host = _events(prof)
        if dev:
            return reduce_trace(dev, host, (t1 - t0) * 1e-9, steps)
    raise RuntimeError("torch.profiler read no device event in "
                       f"{attempts} slices")


def _short(name: str) -> str:
    """A kernel's name without the namespaces that every one repeats."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::",
                 "at::cuda::"):
        name = name.replace(junk, "")
    return name[:160]


def reduce_trace(dev, host, window_s: float, steps: int) -> dict:
    """The reading of one traced slice; `dev` and `host` are lists of
    (start_ns, end_ns, name)."""
    by_name: dict = {}
    for s, e, n in dev:
        c, t = by_name.get(n, (0, 0.0))
        by_name[n] = (c + 1, t + (e - s) * 1e-9)
    dev = sorted(dev)
    busy, gaps = 0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    first, last = dev[0][0], cur_e
    # the host's innermost span open at each gap's middle names the gap
    host = sorted(host)
    starts = [h[0] for h in host]
    named: dict = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        mid = (g0 + g1) // 2
        key = "(host between traced calls)"
        # the covering span with the latest start is the innermost
        for i in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 5001), -1):
            if host[i][1] >= mid:
                key = host[i][2]
                break
        named[key] = named.get(key, 0.0) + (g1 - g0) * 1e-9
    return dict(
        kernels=sorted(((n, c, t) for n, (c, t) in by_name.items()),
                       key=lambda k: -k[2]),
        busy_s=busy * 1e-9, window_s=window_s, steps=steps,
        span_s=(last - first) * 1e-9,
        device_ops=[[_short(n), t] for n, _, t in
                    sorted(((n, c, t) for n, (c, t) in by_name.items()),
                           key=lambda k: -k[2])[:10]],
        idle_gaps=[[_short(n), t] for n, t in
                   sorted(named.items(), key=lambda kv: -kv[1])[:10]])


def kernel_time(trace: dict, *names: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds any of
    `names`."""
    hits = [(c, t) for n, c, t in trace["kernels"]
            if any(k in n for k in names)]
    return sum(c for c, _ in hits), sum(t for _, t in hits)


# ---------------------------------------------------------------------------
# statistics and comparison
# ---------------------------------------------------------------------------

def p95(values) -> float:
    """The 95th percentile of all values, by statistics.quantiles'
    exclusive method (the value that 5% of the samples exceed)."""
    vals = sorted(values)
    if len(vals) < 2:
        return float(vals[0])
    return float(statistics.quantiles(vals, n=20)[18])


def rel(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / nb if nb else \
        float(np.linalg.norm(a - b))


def worst_rel(a, b, axes) -> float:
    """The largest relative L2 gap over the leading `axes`-indexed blocks
    (each env, each step): the norm is over the remaining axes."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    red = tuple(range(axes, a.ndim))
    num = np.sqrt(((a - b) ** 2).sum(red))
    den = np.sqrt((b ** 2).sum(red))
    return float(np.max(num / np.where(den > 0, den, 1.0)))


def checked(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number finite and within its limit, {name: [number, limit]})."""
    shown, ok = {}, True
    for k, lim in limits.items():
        v = numbers.get(k, math.nan)
        v = float(v)
        good = math.isfinite(v) and v <= lim
        ok = ok and good
        shown[k] = [v, lim]
    return ok, shown


def memory_peak() -> int:
    import torch
    return int(torch.cuda.max_memory_allocated()) \
        if torch.cuda.is_available() else 0


# ---------------------------------------------------------------------------
# PINO weights from the seed
# ---------------------------------------------------------------------------

def pino_shapes(cfg: dict, out_dim: int) -> list:
    """(name, shape, std) of every leaf of a PINO plane model of `cfg`'s
    widths: the Dense kernels at flax's scale (normal, 1 / sqrt(fan_in)),
    their biases 0; the multiplicative nets' leaves at the variance of
    their uniform draw (1 / (3 fan_in)); the spectral weights normal with
    std 1 / (in x out)."""
    w, f, L, ind = cfg["width"], cfg["fc_dim"], cfg["n_layers"], cfg["in_dim"]
    m1, m2, m3 = cfg["modes"]
    u = (3.0 ** -0.5)
    out = [("fc0.weight", (w, ind), ind ** -0.5), ("fc0.bias", (w,), 0.0)]
    for k in ("mnet1", "mnet2"):
        out += [(f"{k}.A", (w, 1), u), (f"{k}.B", (w, w), u * w ** -0.5),
                (f"{k}.bias", (w,), u * w ** -0.5)]
    for i in range(L):
        out += [(f"head.trunk.sp{i}.w{c}.mm2", (2, m1, m2, m3, w, w),
                 1.0 / (w * w)) for c in range(4)]
        out += [(f"head.trunk.w{i}.weight", (w, w), w ** -0.5),
                (f"head.trunk.w{i}.bias", (w,), 0.0)]
    out += [("head.fc1.weight", (f, w), w ** -0.5),
            ("head.fc1.bias", (f,), 0.0),
            ("head.fc2.weight", (out_dim, f), f ** -0.5),
            ("head.fc2.bias", (out_dim,), 0.0)]
    return out


def pino_weights(cfg: dict, out_dim: int, seed: int, device, dtype) -> dict:
    """Every leaf drawn on `device` from `seed` in one normal draw, split and
    scaled per leaf."""
    import torch
    shapes = pino_shapes(cfg, out_dim)
    sizes = [math.prod(s) for _, s, _ in shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, device),
                       device=device, dtype=dtype)
    return {n: (c * x).reshape(s) for (n, s, c), x in
            zip(shapes, flat.split(sizes))}
