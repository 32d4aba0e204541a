"""Where the time goes on the staged and kernel-D paths at 32x130x32 with
the `gt` policy: `batched_rollout` of 8 envs (100 steps) and the closed
loop of one env (`run_closed_loop`, 200 steps), each through the staged
kernels and through kernel D.  Each is timed unprofiled (median of three
runs after a warm-up, host clock around work that ends in a synchronize),
then run once under `torch.profiler`.

    python -m pde_policylearning_torch.tools.profile_paths [--out DIR]

Per path: ms and env-steps/s unprofiled, device ms per step (the sum of
the profiler's device self time), the busy share (device time over the
unprofiled wall time), device launches per step and the eight kernels
with most device time (share %, launches per step).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..control import make_policy, run_closed_loop
from ..envs import NSControlEnv
from ..envs import channel_flow as cf
from ..envs import rk3_cuda as rk
from . import card_name


def measure(fn, n_env_steps: int, n_steps: int):
    """Unprofiled median of three runs after a warm-up, then one run under
    torch.profiler; see the module docstring for the keys."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in ka)
    top = sorted(ka, key=lambda e: -e.self_device_time_total)[:8]
    return dict(
        ms_per_step=1e3 * wall / n_steps, env_steps_per_s=n_env_steps / wall,
        device_ms_per_step=dev_us / 1e3 / n_steps,
        busy_share=dev_us / 1e6 / wall,
        device_launches_per_step=sum(e.count for e in ka) / n_steps,
        top=[(e.key[:60], round(100 * e.self_device_time_total / dev_us, 1),
              round(e.count / n_steps, 1)) for e in top])


def profile_paths(B: int = 8, batched_steps: int = 100,
                  closed_steps: int = 200):
    if not torch.cuda.is_available():
        raise RuntimeError("profile_paths needs a CUDA card")
    dev = torch.device("cuda")
    grid = cf.make_channel_grid(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    states = cf.init_batched_states(grid, B, gen)
    env = NSControlEnv(detect_plane=25, noise_scale=0.05, seed=0, device=dev)
    policy = make_policy("gt", env.grid, detect_plane=25)
    paths = {
        f"B{B}_batched": (lambda: cf.batched_rollout(
            grid, states, batched_steps, policy="gt"),
            B * batched_steps, batched_steps),
        "B1_closed": (lambda: run_closed_loop(
            env, policy, n_steps=closed_steps, log_interval=closed_steps,
            verbose=False), closed_steps, closed_steps)}
    res = {"card": card_name()}
    saved = rk.FULLSTEP
    try:
        for fullstep in (False, True):
            rk.FULLSTEP = fullstep
            for name, (fn, n_env, n) in paths.items():
                key = f"{name}_{'kernelD' if fullstep else 'staged'}"
                res[key] = measure(fn, n_env, n)
                print(key, json.dumps(res[key]), flush=True)
    finally:
        rk.FULLSTEP = saved
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = profile_paths()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_paths.json"), "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
