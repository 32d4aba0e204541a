"""Adam over the full-width flagship policy's leaves, four ways.

    python -m pde_policylearning_torch.tools.fused_adam [--steps N]
        [--out DIR]

At the 36 leaves of the full-width `PolicyModel2D` (226,526,081 float32
parameters; seeded leaves and gradients, one leaf in three with a zero
gradient, as the zeroed policy has many): one Adam step of
`training.optimizers.FusedAdam` (csrc/adam.cu), of its plain version
`adam_plain_`, of `torch.optim.Adam(capturable=True)` (torch's foreach
route, which the flagship policy ran before the kernel) and of
`torch.optim.Adam(fused=True)` (torch's own one-pass kernel), each: ms a step
(CUDA events around `--steps` steps after a warm-up, median of three
runs), and from one run under torch.profiler the device ms a step, the
launches a step and the device ms a step of the kernels whose name holds
`multi_tensor_apply` (what the benchmark's `roofline.adam.opo` reads);
beside them the bound, 28 B a parameter at 3.35 TB/s, and the share of
it that each reaches.  Also the update kernel's registers as ptxas gave
them.  Needs a CUDA card; prints one JSON object (and writes it to
DIR/fused_adam.json with `--out`).
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ..models import PolicyModel2D
from ..native import cuda_build
from ..training.optimizers import FusedAdam, adam_plain_
from . import card_name, drag_rows
from .profile_paths import profiled

HBM_BYTES_PER_S = 3.35e12
BYTES_PER_PARAM = 28
LR = 1e-4


def leaves(dev, seed: int = 0):
    """The full-width policy's leaf sizes, seeded starting values and
    gradients (every third leaf's gradient zero)."""
    sizes = [p.numel() for p in PolicyModel2D(
        **drag_rows.FULL_WIDTH, device="meta").parameters()]
    g = torch.Generator(device=dev).manual_seed(seed)
    start = [torch.randn(n, generator=g, device=dev) for n in sizes]
    grads = [torch.zeros(n, device=dev) if i % 3 == 0 else
             1e-3 * torch.randn(n, generator=g, device=dev)
             for i, n in enumerate(sizes)]
    return start, grads


def route(name: str, start, grads):
    """A function that takes one Adam step of route `name` on fresh copies
    of `start` with gradients `grads`."""
    if name == "plain":
        ps = [s.clone() for s in start]
        m = [torch.zeros_like(p) for p in ps]
        v = [torch.zeros_like(p) for p in ps]
        step = torch.zeros((), device=ps[0].device)
        return lambda: adam_plain_(ps, grads, m, v, step, lr=LR)
    ps = [s.clone().requires_grad_() for s in start]
    for p, g in zip(ps, grads):
        p.grad = g
    if name == "fused":
        return FusedAdam(ps, lr=LR).step
    if name == "torch_fused":
        return torch.optim.Adam(ps, lr=LR, fused=True).step
    return torch.optim.Adam(ps, lr=LR, capturable=True).step


def time_route(step, n: int) -> dict:
    from torch.autograd import DeviceType

    def run():
        for _ in range(n):
            step()
    with torch.no_grad():
        run()
        torch.cuda.synchronize()
        ms = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b) / n)
        events = [e for e in profiled(run).events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    us = sum(e.self_device_time_total for e in events)
    mta = [e for e in events if "multi_tensor_apply" in e.name]
    return dict(ms_per_step=sorted(ms)[1], ms_runs=ms,
                device_ms_per_step=us / 1e3 / n,
                launches_per_step=len(events) / n,
                multi_tensor_apply_ms_per_step=sum(
                    e.self_device_time_total for e in mta) / 1e3 / n,
                multi_tensor_apply_launches_per_step=len(mta) / n)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("fused_adam measures the card: no CUDA card")
    dev = torch.device("cuda")
    start, grads = leaves(dev)
    n = sum(s.numel() for s in start)
    bound_ms = 1e3 * BYTES_PER_PARAM * n / HBM_BYTES_PER_S
    out = dict(card=card_name(), torch=torch.__version__, leaves=len(start),
               parameters=n, bound_ms_per_step=bound_ms, bound_by="bytes")
    for name in ("fused", "plain", "torch_capturable", "torch_fused"):
        r = time_route(route(name, start, grads), args.steps)
        r["bound_share"] = bound_ms / r["device_ms_per_step"]
        out[name] = r
        torch.cuda.empty_cache()
    log = cuda_build.build_log
    at = log.find("multi_tensor_apply_adam_kernel")
    out["ptxas"] = [ln.strip() for ln in log[at:].splitlines()[1:4]] \
        if at >= 0 else None
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "fused_adam.json"), "w") as f:
            f.write(text)
    return out


if __name__ == "__main__":
    main()
