"""Where the time goes on the staged and kernel-D paths at 32x130x32 with
the `gt` policy: `batched_rollout` of 8 envs (100 steps) and the closed
loop of one env (`run_closed_loop`, 200 steps), each through the staged
kernels and through kernel D; then the observer-policy loop (`fno`, 200
steps through kernel D): `FNO2dObserver(12, 12, 32)` with weights from a
seeded generator and unit normalizers, action_scale 0.3, action_clip
0.01.  Each is timed unprofiled (median of three runs after a warm-up,
host clock around work that ends in a synchronize), then run once under
`torch.profiler`.

    python -m pde_policylearning_torch.tools.profile_paths [--out DIR]

Per path: ms and env-steps/s unprofiled, device ms per step (the sum of
the profiler's device self time), the busy share (device time over the
unprofiled wall time), device launches per step and the eight kernels
with most device time (share %, launches per step), and the launches per
step of the hand-written GEMM, of the x/z FFT kernels, of the eigen-solve
(its two kernels together: `eig_solve_tile_kernel` at B = 1,
`eig_solve_rows_kernel` at B = 8) and of kernel A's stencil pass
(`substage_planes_kernel`; the point-by-point `substage_kernel` and the
`divergence_kernel` of a plane that does not fit), the last two also with
their device us per launch (on a power-of-two grid the GEMM carries the two
products of the wall-pressure solve only: 2 launches per env step, no
transform); for the `fno` loop also the corner-contraction
kernel's share of device time, its launches per step and device us per
launch, the host ms per step spent enqueuing the policy and the env step,
and the device launches and device us of one observer forward on its own.
Needs a CUDA card.
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
from ..models import FNO2dObserver
from . import card_name


def summarize(kernels, wall: float, n_env_steps: int, n_steps: int):
    """The keys of the module docstring from one profiled run: `kernels` is
    a list of (name, launches, device us in all) per device kernel, `wall`
    the unprofiled seconds of the same work."""
    dev_us = sum(us for _, _, us in kernels)
    top = sorted(kernels, key=lambda k: -k[2])[:8]

    def per_step(*names):
        return sum(n for key, n, _ in kernels
                   if any(name in key for name in names)) / n_steps

    def us_per_launch(*names):
        hits = [k for k in kernels if any(name in k[0] for name in names)]
        return sum(k[2] for k in hits) / max(1, sum(k[1] for k in hits))

    def us(*names):
        return sum(k[2] for k in kernels
                   if any(name in k[0] for name in names))

    eig = ("eig_solve_tile", "eig_solve_rows")
    stencil = ("substage_planes", "substage_kernel")
    return dict(
        corner_share=us("corner") / dev_us,
        corner_launches_per_step=per_step("corner"),
        corner_device_us_per_launch=us_per_launch("corner"),
        gemm_launches_per_step=per_step("gemm_kernel"),
        xz_fft_launches_per_step=per_step("xz_fft"),
        eig_tile_launches_per_step=per_step(*eig),
        eig_tile_device_us_per_launch=us_per_launch(*eig),
        kernel_a_launches_per_step=per_step(*stencil),
        kernel_a_device_us_per_launch=us_per_launch(*stencil),
        divergence_launches_per_step=per_step("divergence_kernel"),
        ms_per_step=1e3 * wall / n_steps, env_steps_per_s=n_env_steps / wall,
        device_ms_per_step=dev_us / 1e3 / n_steps,
        busy_share=dev_us / 1e6 / wall,
        device_launches_per_step=sum(k[1] for k in kernels) / n_steps,
        top=[(key[:60], round(100 * t / dev_us, 1), round(n / n_steps, 1))
             for key, n, t in top])


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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.count, e.self_device_time_total)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return summarize(kernels, sorted(walls)[1], n_env_steps, n_steps)


def host_segments(env, policy, n_steps: int):
    """Host ms per step spent enqueuing the policy and the env step, by the
    host clock around each call in a hand-written loop with no synchronize
    inside (the state is not written back to the env)."""
    _, p2 = cf.boundary_pressures(env.grid, env.state)
    st = rk.state_to_kstate(env.state)
    t_policy = t_env = 0.0
    torch.cuda.synchronize()
    for _ in range(n_steps):
        t0 = time.perf_counter()
        op1, op2 = policy(st, p2, None)
        t1 = time.perf_counter()
        st, p2, _ = rk.env_step_k(env.grid, st, op1, op2)
        t_policy += t1 - t0
        t_env += time.perf_counter() - t1
    torch.cuda.synchronize()
    return dict(host_ms_policy=1e3 * t_policy / n_steps,
                host_ms_env_step=1e3 * t_env / n_steps)


def observer_forward(observer, Nx: int, Nz: int, n: int = 50):
    """Device launches and device us of one observer forward on a
    (1, Nx, Nz) plane, from `torch.profiler` over n forwards."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    plane = torch.zeros((1, Nx, Nz), device="cuda")
    observer(plane)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            observer(plane)
        torch.cuda.synchronize()
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return dict(
        device_launches_per_observer_forward=sum(e.count for e in ka) / n,
        device_us_per_observer_forward=sum(e.self_device_time_total
                                           for e in ka) / n)


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
        rk.FULLSTEP = True
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        observer = FNO2dObserver(12, 12, 32, generator=gen)
        observer.requires_grad_(False)
        fno = make_policy("fno", env.grid, model=observer, detect_plane=25,
                          action_scale=0.3, action_clip=0.01)
        res["B1_closed_fno_kernelD"] = measure(
            lambda: run_closed_loop(env, fno, n_steps=closed_steps,
                                    log_interval=closed_steps,
                                    verbose=False),
            closed_steps, closed_steps)
        res["B1_closed_fno_kernelD"].update(
            host_segments(env, fno, closed_steps))
        res["B1_closed_fno_kernelD"].update(
            observer_forward(observer, grid.Nx, grid.Nz))
        print("B1_closed_fno_kernelD",
              json.dumps(res["B1_closed_fno_kernelD"]), flush=True)
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
