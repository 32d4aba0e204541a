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
`eig_solve_rows_kernel` at B = 8), of kernel A's stencil pass
(`substage_planes_kernel`; the point-by-point `substage_kernel` and the
`divergence_kernel` of a plane that does not fit) and of the wall pair's
own kernels (`boundary_planes_kernel`, phase 1; `wall_solve_kernel`, phase
2 before its two-plane synthesis; `rhs_fields_kernel` where phase 1 takes
three launches), the last three also with their device us per launch (on
a power-of-two grid the GEMM carries nothing: 0 launches); for the `fno`
loop also the corner-contraction
kernel's share of device time, its launches per step and device us per
launch, the host ms per step spent enqueuing the policy and the env step,
and the device launches and device us of one observer forward on its own.
Then the `rno` and `transformer` loops (100 steps each through kernel D,
the seeded `RNO2dObserver(12, 12, 34)` and `SimpleTransformer(n_hidden 96,
2 heads, fourier, freq_dim 48, 12 modes)` on the plane repeated over two
steps, the same shaping), and one training step of each observer at its
config's batch (FNO2dObserver(12, 12, 32) B 20, RNO B 32, transformer
B 20 sequences of 2; Adam with the coupled decay, the relative L2 loss, on
seeded inputs), 20 steps a run: the same keys per step.  Last the
flagship slice at full width (`configs/fullfield_pi.yaml`'s observer,
seeded): the `optimal-policy-observer` loop (a zeroed full-width
`PolicyModel2D`, 3 Adam steps a control step) and the full-field
`optimal-observer` loop (10 Adam steps on the action, unit statistics),
50 steps each through kernel D, and one full-field training step (B 32,
the physics-informed loss at weight 1, Adam) on the fields of a 32-step
`gt` rollout, 10 steps a run.  `--flagship-only` runs the last three
alone.  `--training-only` runs the two training entries of the port
alone: one `train_ns` iteration of configs/pino-observer-pretrain-1s.yaml
at full width (batch 4 as 4 remat micro-batches, 128x128x65, on four
generated trajectories), 3 iterations a run, and the on-device DDPG loop
at the `main_ddpg --channel` defaults, 16 warm-up and 112 training steps a
run (env steps per step counted as one).  `--parallel-only` runs the
parallel layer alone on an NCCL mesh of one rank (the card's count):
`data_parallel_rollout` of the 8 envs beside `batched_rollout` (100 `gt`
steps through kernel D, in turns), and the FNO2dObserver(12, 12, 32)
training step at B 20 with and without the gradient all-reduce of
`Trainer(mesh)` (`parallel.all_reduce_gradients`), in turns.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from ..control import make_policy, run_closed_loop
from ..envs import NSControlEnv
from ..envs import channel_flow as cf
from ..envs import rk3_cuda as rk
from ..models import FNO2dObserver, RNO2dObserver, SimpleTransformer
from ..ops.normalization import NormalizerGivenMeanStd
from ..training import adam_l2, fullfield_losses, relative_l2_loss
from . import card_name, drag_rows


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
    wall_fwd = ("boundary_planes", "rhs_fields")
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
        wall_launches_per_step=per_step(*wall_fwd, "wall_solve"),
        wall_fwd_device_us_per_launch=us_per_launch(*wall_fwd),
        wall_solve_device_us_per_launch=us_per_launch("wall_solve"),
        ms_per_step=1e3 * wall / n_steps, env_steps_per_s=n_env_steps / wall,
        device_ms_per_step=dev_us / 1e3 / n_steps,
        busy_share=dev_us / 1e6 / wall,
        device_launches_per_step=sum(k[1] for k in kernels) / n_steps,
        top=[(key[:60], round(100 * t / dev_us, 1), round(n / n_steps, 1))
             for key, n, t in top])


# A run under torch.profiler that read no device event at all (seen now
# and then on an H100, torch 2.11: three such runs in a row) is made again,
# up to this many runs in all.
PROFILE_RUNS = 5


def profiled(fn):
    """torch.profiler's record of one call of fn (the card synchronized
    before and after), from the first of up to PROFILE_RUNS calls whose
    record holds a device event; RuntimeError if none does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_RUNS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            return prof
    raise RuntimeError(f"the profiler read no device event in "
                       f"{PROFILE_RUNS} runs")


def measure(fn, n_env_steps: int, n_steps: int):
    """Unprofiled median of three runs after a warm-up, then one run under
    torch.profiler (`profiled`); see the module docstring for the keys."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # device kernels by name; a range the host annotated (the optimizer's
    # `Optimizer.step`) also shows on the device's timeline, over the
    # kernels it holds, and is left out
    agg = {}
    for e in profiled(fn).events():
        if e.device_type == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            n, t = agg.get(e.name, (0, 0.0))
            agg[e.name] = (n + 1, t + e.self_device_time_total)
    kernels = [(k, n, t) for k, (n, t) in agg.items()]
    return summarize(kernels, sorted(walls)[1], n_env_steps, n_steps)


def host_segments(env, policy, n_steps: int):
    """Host ms per step spent enqueuing the policy and the env step, by the
    host clock around each call in a hand-written loop with no synchronize
    inside (the state is not written back to the env)."""
    _, p2 = cf.boundary_pressures(env.grid, env.state)
    st = rk.state_to_kstate(env.state)
    init_carry = getattr(policy, "init_carry", None)
    carry = init_carry() if init_carry is not None else None
    t_policy = t_env = 0.0
    torch.cuda.synchronize()
    for _ in range(n_steps):
        t0 = time.perf_counter()
        if carry is not None:
            op1, op2, carry = policy(carry, st, p2, None)
        else:
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


def training_steps(model, x, y, n_steps: int, mesh=None):
    """`n_steps` training steps of `model` on one batch (x, y): forward,
    the relative L2 loss, backward (the corner kernel's adjoint and
    strided entries), with a `mesh` the gradient all-reduce of
    `Trainer(mesh)`, Adam with the coupled decay."""
    from ..parallel import all_reduce_gradients
    params = list(model.parameters())
    opt = adam_l2(params, 1e-3, 1e-4)

    def run():
        for _ in range(n_steps):
            opt.zero_grad(set_to_none=True)
            relative_l2_loss(model(x).reshape(y.shape), y).backward()
            if mesh is not None:
                all_reduce_gradients(mesh, params)
            opt.step()
    return run


def observer_paths(env, closed_steps: int = 100, train_steps: int = 20):
    """The `rno` and `transformer` loops and one training step of each
    observer (see the module docstring)."""
    dev = torch.device("cuda")
    res = {}

    def seeded():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return gen

    rno = RNO2dObserver(12, 12, 34, generator=seeded())
    transformer = SimpleTransformer(
        n_hidden=96, n_head=2, attention_type="fourier", freq_dim=48,
        fourier_modes=12, generator=seeded())
    for name, model in (("rno", rno), ("transformer", transformer)):
        model.requires_grad_(False)
        policy = make_policy(name, env.grid, model=model, detect_plane=25,
                             model_timestep=2, action_scale=0.3,
                             action_clip=0.01)
        key = f"B1_closed_{name}_kernelD"
        res[key] = measure(
            lambda: run_closed_loop(env, policy, n_steps=closed_steps,
                                    log_interval=closed_steps,
                                    verbose=False),
            closed_steps, closed_steps)
        res[key].update(host_segments(env, policy, closed_steps))
        print(key, json.dumps(res[key]), flush=True)
        model.requires_grad_(True)
    gen = seeded()
    fno = FNO2dObserver(12, 12, 32, generator=gen)
    for name, model, shape in (("fno", fno, (20, 32, 32, 1)),
                               ("rno", rno, (32, 2, 32, 32, 1)),
                               ("transformer", transformer,
                                (20, 2, 32, 32, 1))):
        x = torch.randn(shape, generator=gen, device=dev)
        y_shape = shape[:1] + shape[2:] if name == "rno" else shape
        y = torch.randn(y_shape, generator=gen, device=dev)
        key = f"train_step_{name}_B{shape[0]}"
        res[key] = measure(training_steps(model, x, y, train_steps),
                           shape[0], train_steps)
        print(key, json.dumps(res[key]), flush=True)
    return res


def fullfield_batch(env, B: int = 32, planes=(-10, -8, -6)):
    """A full-field training batch at the env's grid: the U, V, W fields
    of a B-step `gt` rollout from the env's state (sequences of one step),
    its top V plane and the V planes at `planes` encoded by their own
    statistics over the batch; returns (the normalizer, the arrays in
    `fullfield_losses`' order)."""
    grid = env.grid
    _, outs = cf.rollout(grid, env.state, B, policy="gt",
                         collect_fields=True)
    dpdx = outs[2].reshape(B, 1)
    U, V, W = (a[:, None] for a in outs[3:])       # (B, 1, Nx, Ny, Nz)
    top = V[..., -1, :]
    norm = NormalizerGivenMeanStd(top.mean(0)[0],
                                  top.std(0, correction=0)[0] + 1e-8)
    v_field = torch.stack([norm.encode(V[..., i, :]) for i in planes], 2)
    re = torch.full((B,), 178.1899, device=U.device)
    return norm, (norm.encode(top), v_field, U, V, W, dpdx, re)


def flagship_paths(env, closed_steps: int = 50, train_steps: int = 10):
    """The flagship slice's two loops and one full-field training step
    (see the module docstring)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    observer = drag_rows.fullfield_observer(None, dev, gen)
    unit = NormalizerGivenMeanStd(torch.zeros((), device=dev),
                                  torch.ones((), device=dev))
    res = {}
    for name, key in (("optimal-policy-observer", "opo"),
                      ("optimal-observer", "fullfield_optimal_observer")):
        policy = drag_rows.flagship_policy(name, env, observer, unit)
        key = f"B1_closed_{key}_kernelD"
        res[key] = measure(
            lambda: run_closed_loop(env, policy, n_steps=closed_steps,
                                    log_interval=closed_steps,
                                    verbose=False),
            closed_steps, closed_steps)
        res[key].update(host_segments(env, policy, closed_steps))
        print(key, json.dumps(res[key]), flush=True)
        del policy
    del observer
    model = drag_rows.fullfield_observer(None, dev, gen).requires_grad_(True)
    norm, batch = fullfield_batch(env)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def run():
        for _ in range(train_steps):
            opt.zero_grad(set_to_none=True)
            fullfield_losses(model, env.grid, norm, (-10, -8, -6), 1.0,
                             *batch)[0].backward()
            opt.step()
    res["train_step_fullfield_B32"] = measure(run, 32, train_steps)
    print("train_step_fullfield_B32",
          json.dumps(res["train_step_fullfield_B32"]), flush=True)
    return res


def training_paths(env, pino_iters: int = 3, ddpg_steps=(16, 112)):
    """A full-width PINO iteration and a DDPG step (see the module
    docstring)."""
    from ..control.ddpg import train_ddpg_channel_on_device
    from ..data import KFDataset
    from ..train_pino import build_model
    from ..training.pino_train import make_optimizer, train_ns
    from ..utils import load_yaml
    dev = torch.device("cuda")
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_yaml(os.path.join(here, "..", "..", "configs",
                                 "pino-observer-pretrain-1s.yaml"))
    S, T = int(cfg.data.pde_res[0]), int(cfg.data.pde_res[2])
    with tempfile.TemporaryDirectory() as tmp:
        data = KFDataset.generate(4, S, T, re=float(cfg.data.Re),
                                  save_path=os.path.join(tmp, "kf.npy"),
                                  device=dev).arrays(device=dev)
    model = build_model(cfg.model, dev,
                        torch.Generator(device=dev).manual_seed(0))
    opt, sched = make_optimizer(model, float(cfg.train.base_lr),
                                cfg.train.milestones,
                                float(cfg.train.scheduler_gamma))
    res = {}
    torch.cuda.reset_peak_memory_stats()
    res["train_iter_pino_full_width"] = measure(
        lambda: train_ns(model, data, iterations=pino_iters, batch_size=4,
                         accum_steps=int(cfg.train.accum_steps),
                         optimizer=opt, scheduler=sched,
                         log_interval=pino_iters, verbose=False),
        4 * pino_iters, pino_iters)
    res["train_iter_pino_full_width"]["peak_gib"] = \
        torch.cuda.max_memory_allocated() / 2 ** 30
    print("train_iter_pino_full_width",
          json.dumps(res["train_iter_pino_full_width"]), flush=True)
    del model, opt, sched, data
    warm, n = ddpg_steps
    res["ddpg_step_channel"] = measure(
        lambda: train_ddpg_channel_on_device(n_steps=n, warmup=warm,
                                             env=env, verbose=False),
        warm + n, warm + n)
    print("ddpg_step_channel", json.dumps(res["ddpg_step_channel"]),
          flush=True)
    return res


def parallel_paths(grid, states, batched_steps: int = 100,
                   train_steps: int = 20):
    """The data-parallel rollout and training step on an NCCL mesh of one
    rank, each beside its unsharded path, in turns (see the module
    docstring)."""
    import torch.distributed as dist

    from .. import parallel as par
    dev = torch.device("cuda")
    B = states.U.shape[0]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        par.init_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", 1,
                             0, device=dev)
        try:
            mesh = par.make_mesh(1)
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            fno = FNO2dObserver(12, 12, 32, generator=gen)
            x = torch.randn((20, 32, 32, 1), generator=gen, device=dev)
            y = torch.randn((20, 32, 32, 1), generator=gen, device=dev)
            paths = {
                f"B{B}_batched_kernelD": (lambda: cf.batched_rollout(
                    grid, states, batched_steps, policy="gt"),
                    B * batched_steps, batched_steps),
                f"B{B}_data_parallel_kernelD": (
                    lambda: par.data_parallel_rollout(
                        mesh, grid, states, batched_steps, policy="gt"),
                    B * batched_steps, batched_steps),
                "train_step_fno_B20": (training_steps(fno, x, y,
                                                      train_steps),
                                       20, train_steps),
                "train_step_fno_B20_mesh": (
                    training_steps(fno, x, y, train_steps, mesh), 20,
                    train_steps)}
            for turn in (0, 1):
                for name, (fn, n_env, n) in paths.items():
                    key = f"{name}_{'first' if turn == 0 else 'second'}"
                    res[key] = measure(fn, n_env, n)
                    print(key, json.dumps(res[key]), flush=True)
        finally:
            dist.destroy_process_group()
    return res


def profile_paths(B: int = 8, batched_steps: int = 100,
                  closed_steps: int = 200, flagship_only: bool = False,
                  training_only: bool = False, parallel_only: bool = False):
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
    if parallel_only:
        rk.FULLSTEP = True
        try:
            res.update(parallel_paths(grid, states, batched_steps))
        finally:
            rk.FULLSTEP = saved
        return res
    if flagship_only or training_only:
        rk.FULLSTEP = True
        try:
            res.update((flagship_paths if flagship_only
                        else training_paths)(env))
        finally:
            rk.FULLSTEP = saved
        return res
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
        res.update(observer_paths(env))
        res.update(flagship_paths(env))
        res.update(training_paths(env))
    finally:
        rk.FULLSTEP = saved
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flagship-only", action="store_true")
    ap.add_argument("--training-only", action="store_true")
    ap.add_argument("--parallel-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = profile_paths(flagship_only=args.flagship_only,
                        training_only=args.training_only,
                        parallel_only=args.parallel_only)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_paths.json"), "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
