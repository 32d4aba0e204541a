"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero, printing no
result):
  1. the device: CUDA present, the card's name and power limit;
  2. the kernel build from pde_policylearning_torch/csrc (nvcc, sm_90a),
     and the registers ptxas gave the row-owned eigen-solve's two builds
     against those its host rule assumes;
  3. every kernel of the main path against its plain torch version on the
     card, at the main path's shapes (32x130x32, the packaged Re_tau~180
     snapshot, float32, TF32 off), with its error, both times (CUDA
     events, median of several calls) and its bound on this card: the
     larger of its operations over 67 TFLOP/s (fp32 outside the tensor
     cores) and its bytes over 3.35 TB/s, both counted from the shapes as
     the function needs them (`work` below: the x/z transforms as FFTs),
     with the cost of the kernel as built beside it (the in-kernel FFTs'
     own count) and its time with the transforms forced onto the dense DFT
     products of a grid that is no power of two;
     the x/z transform kernels alone against the T2/Ti2 products and
     against float64 at 32x130x32, at 16x18x64 and at 24x18x20 (which
     takes the DFT products), B = 1 and 3, the route printed;
     Kernels A and B (the staged step, each substage) and the mass-flow
     kernels at B = 1 and B = 8, the whole staged step and kernel D at
     B = 8, and kernel C (the batched wall pressures, B = 8), from the
     developed states of 50 kernel-D steps; both wall phases at B = 1 and
     B = 8 (phase 1 bit for bit the transform kernel on the plain pressure
     RHS; phase 2 and kernel C against plain and against float64); the
     eigen-solve kernel, kernel A's stencil pass and the wall pair alone
     at B = 1 and B = 8 (device time per launch from torch.profiler,
     beside their bounds), and kernel D's device launches per step; the
     wall solve's count by each of its two routes (the function's bound
     is the smaller); the staged step against kernel D over three steps; the Poisson kernel, kernels A, B, C and both wall phases on
     three small ragged grids, on a plane that is no multiple of 16 bytes
     (kernel A's point-by-point pass, the wall pass in three launches), on
     8x258x8 (a basis that does not fit shared memory and is streamed)
     and on 2x1455x2 (taller than the row-owned eigen-solve takes), the
     routes printed; on these two tall grids the Poisson kernel, kernel B
     and the wall solve over eight draws each against float64; the gradient through projection_step on
     the card against the plain version's; env_step with a state that
     needs a gradient, and the rollouts refusing one;
     the fused corner entry (gather, contraction and scatter in one
     launch) against its plain version at the observer's serving shape
     (B 1, 32 x 17 spectrum, 2 x 6 x 6 modes, I = O = 32), its training
     batch (B 20), the legacy weight layout, ragged and wide shapes:
     forward, the gradient to x (the adjoint entry) and the gradients
     through its autograd Function (dw through the weight-gradient entry,
     one launch a conv); the weight-gradient entry against its plain
     version at the FNO's and RNO's training shapes, the dense UNO's five
     blocks, the patch shape (B 80), B 1, B 64 with I = O = 64, ragged and
     wide shapes, each corner alone and both, contiguous and
     channels-first spectra (autograd's layout), bit for bit across all
     of these and between two calls; the strided entry behind `corner_contract` at its four shapes
     with its gradients;
     the fused Adam kernel at the full-width flagship policy's 36 leaves
     (226,526,081 parameters, one leaf in three with a zero gradient)
     against its plain version over three steps: the update p - p0
     (rel L2 1e-5), both moments (1e-6), the zero-gradient leaves
     unmoved bit for bit; timed beside the plain version, torch's fused
     and capturable Adam and its bound, 28 B a parameter;
     the same at the RNO's (I = O = 34, two 12 x 12 corners, B 1 and 32),
     the UNet's (64 -> 32) and the transformer regressor's (96 -> 48,
     48 -> 48 on B x T = 2 and 40 planes) shapes;
     `spectral_conv_nd` (also with output sizes other than the input's)
     and the full-width
     `FNO2dObserver(12, 12, 32)` (forward, and the gradient to its input)
     kernel route against plain route, and a 20-step `fno` closed loop on
     both routes;
  4. the main path: NSControlEnv(32, 130, 32, noise 0.05, seed 0) with the
     opposition policy, run_closed_loop for 2000 steps once to warm up and
     three timed runs; the kernels' launch counts over exactly that run,
     and the device launches per step (exactly LAUNCHES_B1_GT_STEP);
  5. the data-collection path: batched_rollout of 8 envs for 500 `gt`
     steps through kernel D and through the staged kernels
     (PDE_RK3_FULLSTEP=0), one warm-up and three timed runs each, the
     staged kernels' launch counts over exactly the last staged run, the
     device launches per step through kernel D (exactly LAUNCHES_B8_STEP);
     then
     generate_channel_dataset for 100 steps into a temporary directory,
     read back with PDEDataset.from_folder for its normalizers;
  6. the observer-policy path at full width: FNO2dObserver(12, 12, 32)
     with weights from a seeded generator on the card, make_policy('fno',
     action_scale 0.3, action_clip 0.01) and run_closed_loop for 2000
     steps, then make_policy('optimal-observer', opt_steps 10) for 200
     steps, one warm-up and three timed runs each; the fused corner
     entry's launch count over exactly one timed run must be 4 per `fno`
     step and 80 per `optimal-observer` step;
  7. the observer zoo serving at full width with seeded weights:
     RNO2dObserver(12, 12, 34), SimpleTransformer(n_hidden 96, 2 heads,
     fourier, freq_dim 48, 12 modes, 8 encoder and 3 regressor layers) and
     UNet(spectral, 12 modes), each forward on the kernel route against
     the plain route (rel L2 <= 1e-5) with exactly 28, 3 and 1 corner
     launches; make_policy('rno') for 500 steps and
     make_policy('transformer') for 200 (model_timestep 2, action_scale
     0.3, action_clip 0.01), one warm-up and three timed runs each, exactly
     28 and 3 forward corner launches per step, finite series, net flux
     <= 1e-6;
  8. observer training: a 400-step `gt` dataset from
     generate_channel_dataset in a temporary directory, then
     run_pde_observers.main on configs/base_fno.yaml, matlab_rno.yaml and
     base_transformer.yaml (3 epochs, ntrain / ntest cut to the dataset,
     every width as configured): the train loss finite and falling, the
     checkpoint reloaded to the same test loss bit for bit, and exactly
     (forward, adjoint, strided, weight gradient) = (F, F, 0, F) corner
     launches per training step and F forward launches per evaluation
     step (F = 4, 28, 3); one training step of
     FNO at B 20 and of RNO at B 32 on the kernel route against the plain
     route (loss <= 1e-6, every parameter gradient rel L2 <= 1e-5).  The
     backward entries (the fused entry's adjoint, the weight-gradient
     entry, and the strided entry that took dw before it) are held and
     timed at those two training shapes in phase 3, beside their bounds
     and one `einsum`;
  9. the flagship gradient-control slice: a 64-step `gt` dataset with its
     U, V, W fields, run_pde_observers.main on
     configs/fullfield_pi_short.yaml (the full-width PINObserverFullField,
     physics-informed loss) for 2 epochs with ntrain / ntest cut to the
     dataset: the loss finite and falling, the checkpoint reloaded
     (`eval_ckpt`) to the same held-out rel-L2 bit for bit; then
     `optimal-policy-observer` (a zeroed full-width PolicyModel2D) and the
     full-field `optimal-observer` through the seeded full-width observer
     at opt_steps 3 and 10, 200 steps each, one warm-up and three timed
     runs: exactly one kernel-D launch per step and no corner launch (the
     PINO convs are 3-D), exactly 3 x opt_steps fused Adam update
     launches from each policy (the graph's two warm-up calls and its
     capture), finite series, net flux <= 1e-6; then each
     policy (the residual one seeded) replayed as CUDA graphs against
     itself run eagerly, over one control step from one state (the
     full-field `optimal-observer` also on the benchmark cell's inputs
     after a discarded window, and against the float64 reference there)
     and over 20 closed-loop steps, and against the plain env step and
     against itself run eagerly with its Adam's plain version in place
     of the fused kernel over 20 steps;
     every kernel of the path (kernel D, the Poisson solve, the wall
     pair) launched over the phase;
 10. PINO pretrain and finetune (`train_pino`): eight Kolmogorov-flow
     trajectories of configs/pino-observer-pretrain-1s.yaml (128x128x65,
     Re 400) generated on the card; the card's FFT residuals
     (`fdm_ns_vorticity`, `fdm_burgers`) and one trunk layer's `irfftn`
     against the CPU's in float64 (cuFFT's C2R on spectra that are not
     Hermitian against pocketfft's rule); at full width the gradient of a
     batch of 4 as 4 remat micro-batches against one pass and against no
     remat, and two `train_ns` iterations each way; ms an iteration, peak
     memory, busy share and launches an iteration at full width, float32
     and bf16; one `train_ns` iteration at a reduced size against the CPU
     in float64; the solver against the CPU; no kernel of the port
     launched (the convs are 3-D);
 11. DDPG on the channel (`main_ddpg --channel`): the on-device loop at
     the full configuration for 256 warm-up and 512 training steps,
     exactly one kernel-D launch an env step, the Poisson kernel and the
     wall pair launched at construction; env steps/s, launches per step,
     busy share; 20 warm-up and 4 training steps from the same draws,
     networks and state through kernel D against the plain env step.
 12. the parallel layer (`pde_policylearning_torch.parallel`) on NCCL at
     world size 1 in this process (one card takes one rank; the layer's
     multi-rank logic is held by the gloo tests on the CPU):
     `data_parallel_rollout` of 8 envs x 500 `gt` steps bit for bit
     `batched_rollout`, with exactly 500 kernel-D launches (staged: A and B
     1500, C 500), env-steps/s of both; `Trainer(mesh)` against
     `Trainer()` for one epoch of FNO2dObserver(12, 12, 32) at batch 20 on
     400 planes (parameters within 1e-6, ms a step, the gradient
     all-reduce alone, exactly (84, 80, 0, 80) corner launches); the
     patched Trainer (levels 1, padding 0.25, 32x32 planes) and the fused
     corner entry at its patch shape against its plain version (2e-6);
     `sharded_step` at 32x130x32 against `_rk3_step_unfused` on the card
     (U 2e-6, V and W 2e-5, kernel D's one-step limits) and against the
     same step with the plain solve and kernel D's float64 mass flow (the
     fields 2e-6, dPdx 2e-5), launching no kernel; then
     `python -m pde_policylearning_torch.parallel.dryrun --devices 1`.
 13. (run before phase 12: after an NCCL process group in this process
     torch.profiler sees no kernel of the card) the rest of the zoo and
     the 2-D channel: the UNO of neuraloperator's
     U (5 layers, channels [32, 64, 64, 64, 32], scalings [1, 0.5, 1, 2,
     1]) at B 20 of 32 x 32, dense through the corner kernel against its
     plain route (forward and gradients at 1e-5; exactly one forward
     launch a block by hooks on the blocks, (5, 5, 0, 5) a forward and
     backward) and Tucker on the plain route (no launch); the fused entry
     at each block's shape against its plain version, timed beside its
     bound and one `einsum` on the gathered corners; the transformer with a GCN and a GAT lift on (2, 2, 32, 32, 1)
     with the grid's Laplacian as edge, kernel against plain at 1e-5 and
     3 launches a forward; the 2-D env in float64 on the card against the
     CPU (the fresh solve and five fix_flow steps at 1e-10 with the
     iteration counts equal; 80 `gt` and 80 unmanipulated steps of
     `run_control`, the first 32 at 1e-10, the rest beside the growth of
     a 1e-15 perturbation on the CPU, and the step where each blows the
     env up equal; host syncs a step, steps/s, ms a fix_flow step); both `run_cfd_simulation` cases
     at 200 steps against the CPU; the SHT on 32 x 64 in float32 against
     float64 on both grids (1e-5) and the SFNO forward (1e-4) and
     backward; `run_learning_beta_to_k.main` at its defaults, its test
     rel-L2 falling.
 14. (run before phase 12, as 13) DINo at the `train_dino` defaults:
     the generated NS and wave trajectories (64 of 32 x 32 x 10) on the
     card against the CPU from one field (1e-5); `train_dino.main` (navier,
     code 50, hidden 64, dynamics hidden 512, 200 epochs of 4 steps at
     batch 16, float32, TF32 off): the auto-decoding loss falling, the
     eval MSEs finite; `test_dino.main` on the .msgpack it wrote, its MSE
     that of `eval_dino` on the same parameters and data; ms a training
     step, steps/s, device ms, launches and busy share
     (`tools/profile_paths.measure`); 5 training steps (80 trajectories)
     and `eval_dino` on 8 from one set of parameters and data, float32 on
     the card held to float64 on the CPU at DINO_FACTOR times the float32
     CPU run's own distance (one float32 ulp at least for a scalar); the
     spherical shallow water (2 channels, 32 x 64, xyz coordinates) for 20
     epochs, the last five epochs' mean loss 20% below the first five's;
     `utils.profiling` on one decode of a training batch (GFLOP/s, a
     trace, the card's memory statistics); the library's Darcy (2000
     sweeps), Burgers and spherical shallow-water loaders at their
     defaults and `utils.misc`'s spectra on the card against the CPU (the
     shells' sums take atomics there); no kernel of the port launched.
 15. (run before phase 12, as 13) the drag study's tool and the spin-up
     tool: `tools.drag_rows` with the `rand`, `rno` and `transformer`
     rows beside `unmanipulated` and `gt`, 200 staged steps each, from
     seeded full-width observers saved as a `.msgpack` (RNO) and a `.pt`
     (transformer) and a 100-step dataset's normalizers: every row finite,
     3 kernel-A launches a step and no kernel D, exactly 28 and 3 forward
     corner launches a `rno` and `transformer` step, the study's
     summary.json and table.md; the same call again reads the cached rows
     and launches nothing; the spin-up's first 50 steps from the tripped
     state (`init_turbulent_state`, seed 7) on the card against the CPU in
     float64 on the card grid's coordinates (shear and bulk 2e-5, dPdx
     5e-3), exactly 3 launches each of
     kernels A and B a step; ms, device ms, launches and busy share a
     spin-up step (`tools/profile_paths.measure`); `tools.spinup` for two
     500-step chunks, its snapshot in the packaged asset's keys, dtypes and
     shapes, an NSControlEnv built from it on the card and stepped 20
     times.
The line before the last is the per-kernel JSON; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time


def log(msg):
    print(msg, flush=True)


def rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


FAILED = []
# (readings, readings short of the most complete of their call) of
# `device_events`
SHORT_READINGS = [0, 0]


def check(name, err, tol):
    """Record a failed comparison; every phase runs, and the script fails
    at the end if any check did."""
    ok = err <= tol
    log(f"  {name}: rel L2 {err:.3e} (tolerance {tol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILED.append(f"{name}: {err:.3e} > {tol:g}")


def cuda_ms(fn, reps=20, warmup=3):
    """Median time of one call in ms, by CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_events(fn, reads=3):
    """{kernel name: (launches, self device us)} of the device events of
    one call of fn under torch.profiler, from the most complete of `reads`
    readings (each one `tools/profile_paths.profiled`, which reads again
    where the profiler saw no device event at all).  The profiler now and
    then misses launches at the start of its window and was not seen to
    add one, so one short reading is not a launch the code skipped, and
    an exact count is held to the reading with the most launches.  The
    short readings are tallied in SHORT_READINGS."""
    from torch.autograd import DeviceType

    from pde_policylearning_torch.tools.profile_paths import profiled
    best, totals = None, []
    for _ in range(reads):
        got = {e.key: (e.count, e.self_device_time_total)
               for e in profiled(fn).key_averages()
               if e.device_type == DeviceType.CUDA}
        totals.append(sum(n for n, _ in got.values()))
        if best is None or totals[-1] > max(totals[:-1]):
            best = got
    SHORT_READINGS[0] += len(totals)
    SHORT_READINGS[1] += sum(t < max(totals) for t in totals)
    return best


def device_us(fn, names, reps=10):
    """Device time per launch in us of the kernels whose name holds one of
    `names`, from torch.profiler over `reps` calls of fn (`device_events`),
    and their launches per call."""
    for _ in range(3):
        fn()

    def calls():
        for _ in range(reps):
            fn()
    hits = [v for k, v in device_events(calls).items()
            if any(n in k for n in names)]
    count = sum(n for n, _ in hits)
    if not count:
        raise AssertionError(f"no device kernel named like {names} ran")
    return sum(t for _, t in hits) / count, count / reps


def launches_per_step(run, n1=20, n2=40):
    """Device launches per step of `run(k)` (k steps) from torch.profiler
    (`device_events`): the count of a run of n2 steps less that of n1, over
    n2 - n1, so that what runs once per call cancels; and the two counts."""
    counts = []
    for k in (n1, n2):
        run(k)
        counts.append(sum(n for n, _ in device_events(lambda: run(k))
                          .values()))
    return (counts[1] - counts[0]) / (n2 - n1), counts


def fused_adam_row(dev, peak_bytes: float, steps: int = 3) -> dict:
    """The fused Adam kernel (csrc/adam.cu) at the full-width flagship
    policy's 36 leaves, 226,526,081 parameters (`tools/fused_adam.leaves`:
    seeded values, every third leaf's gradient exactly zero): `steps`
    steps of `FusedAdam` against as many of its plain version `adam_plain_`
    on the same inputs on the card, held by the update p - p0 over every
    leaf (the learning rate and both bias corrections scale it; rel L2
    1e-5) and by each moment (1e-6); the zero-gradient leaves bit for bit
    where they started.  Then its row of the kernels line: ms a step,
    the update kernel's device us, the plain version's ms, torch's fused
    Adam's (`library_ms`) and torch's capturable foreach Adam's (the
    policy's optimizer before the kernel), and the bound, 28 B a parameter
    at `peak_bytes`."""
    import torch

    from pde_policylearning_torch.tools import fused_adam as fa
    from pde_policylearning_torch.training import optimizers as optim
    start, grads = fa.leaves(dev)
    n = sum(s.numel() for s in start)
    ours = [s.clone().requires_grad_() for s in start]
    for p, g in zip(ours, grads):
        p.grad = g
    opt = optim.FusedAdam(ours, lr=fa.LR)
    plain = [s.clone() for s in start]
    pm, pv = ([torch.zeros_like(p) for p in plain] for _ in range(2))
    pstep = torch.zeros((), device=dev)

    def plain_step():
        optim.adam_plain_(plain, grads, pm, pv, pstep, lr=fa.LR)
    k0 = optim.fused_adam_kernel.launches
    for _ in range(steps):
        opt.step()
        plain_step()
    torch.cuda.synchronize()
    if optim.fused_adam_kernel.launches - k0 != steps:
        FAILED.append(f"fused Adam: {optim.fused_adam_kernel.launches - k0} "
                      f"update launches over {steps} steps")

    def rel_over(pairs):
        num = den = 0.0
        for a, b in pairs:
            num += float((a.detach() - b).double().square().sum())
            den += float(b.double().square().sum())
        return (num / den) ** 0.5
    check(f"fused Adam at full width, {steps} steps against the plain "
          "version: the update p - p0",
          rel_over((p.detach() - s, q - s)
                   for p, q, s in zip(ours, plain, start)), 1e-5)
    for key, ref in (("exp_avg", pm), ("exp_avg_sq", pv)):
        check(f"fused Adam at full width, {steps} steps against the plain "
              f"version: {key}",
              rel_over((opt.state[p][key], r) for p, r in zip(ours, ref)),
              1e-6)
    still = [i for i, (p, s) in enumerate(zip(ours, start))
             if i % 3 == 0 and not torch.equal(p.detach(), s)]
    if still:
        FAILED.append(f"fused Adam: zero-gradient leaves {still} moved")
    err = max(float((p.detach() - q).abs().max())
              for p, q in zip(ours, plain))
    del plain, pm, pv
    row = dict(name="fused_adam", route="cuda",
               source="pde_policylearning_torch/csrc/adam.cu",
               replaces=None, shape=[len(start), n], max_abs_err=err,
               ms=cuda_ms(opt.step),
               device_us=device_us(opt.step, ["multi_tensor_apply_adam"])[0],
               bound_ms=1e3 * 28 * n / peak_bytes, bound_by="bytes",
               bytes=28 * n)
    del opt, ours
    torch.cuda.empty_cache()
    for key, name in (("plain_ms", "plain"), ("library_ms", "torch_fused"),
                      ("torch_capturable_ms", "torch_capturable")):
        row[key] = cuda_ms(fa.route(name, start, grads))
        torch.cuda.empty_cache()
    log(f"  fused_adam: {row['ms']:.4f} ms a step (update kernel "
        f"{row['device_us']:.1f} us; plain {row['plain_ms']:.4f}, torch "
        f"fused {row['library_ms']:.4f}, torch capturable "
        f"{row['torch_capturable_ms']:.4f}; bound {row['bound_ms']:.4f} ms "
        f"by bytes), max abs err {err:.3e}")
    return row


# device launches per step on a power-of-two grid: kernel D's C entry (3 x
# (stencil pass, transform, eigen-solve, synthesis, correction), mass flow 2,
# wall pressures 3); a `batched_rollout` step of 8 envs through it (the `gt`
# actions and the collected planes besides); a closed-loop `gt` step of one
# env (the scoreboard glue besides).  Any other count fails the run.
LAUNCHES_KERNEL_D = 20
LAUNCHES_B8_STEP = 25
LAUNCHES_B1_GT_STEP = 86
# (geometric mean, worst) of the wall solve's distance from float64 over
# that of the plain solve of the same spectrum, over eight random states on
# a tall grid.  Phase 2: the folded route is no further on average (read on
# an H100: geometric means 0.33 and 0.65, worst 0.47 and 1.13 on 8x258x8
# and 2x1455x2; the CPU emulation 0.37 and 0.69, worst 0.90).  Kernel C:
# its float32 pressure RHS puts both far from float64 (0.6 .. 3e2), beside
# which the two solves differ by ~1e-4: 1.000 in every reading.
WALL_TALL = {"phase 2": (1.0, 1.5), "kernel C": (1.01, 1.01)}


# the U of neuraloperator's UNO at the observer's widths (phase 13)
UNO_KW = dict(in_channels=1, out_channels=1, hidden_channels=32,
              lifting_channels=256, projection_channels=256, n_layers=5,
              uno_out_channels=[32, 64, 64, 64, 32],
              uno_n_modes=[[12, 12], [6, 6], [6, 6], [6, 6], [12, 12]],
              uno_scalings=[[1, 1], [0.5, 0.5], [1, 1], [2, 2], [1, 1]])
# the corner entry's call at each dense UNO block at B 20: (B, H, Wh, I,
# O, m1, m2); I differs from O after the skips, and the middle blocks run
# on 16 x 16 after the 0.5 scaling
UNO_CORNER_SHAPES = {"block0": (20, 32, 17, 32, 32, 6, 6),
                     "block1": (20, 32, 17, 32, 64, 3, 3),
                     "block2": (20, 16, 9, 64, 64, 3, 3),
                     "block3": (20, 16, 9, 128, 64, 3, 3),
                     "block4": (20, 32, 17, 96, 32, 6, 6)}
# phase 14: a float32 run on the card is held to float64 on the CPU at this
# factor times the float32 CPU run's own distance from float64 (Adam's
# m / sqrt(v) magnifies rounding where a gradient is near zero, on either)
DINO_FACTOR = 10


def zoo_phase(dev, smi, h):
    """Phase 13, the rest of the zoo and the 2-D channel, at the sizes the
    slice runs at; `h` holds main's helpers (`zero_counts`,
    `corner_counts`, `bound`, `spec_work`, `spec_inputs`, `cre`).  Returns
    the corner row's new launch counts and times, and the phase's
    numbers."""
    import numpy as np
    import torch

    from pde_policylearning_torch import run_cfd_simulation as cfd
    from pde_policylearning_torch import run_control as rc
    from pde_policylearning_torch import run_learning_beta_to_k as bk
    from pde_policylearning_torch.envs import channel2d as c2
    from pde_policylearning_torch.models import SFNO, UNO, SimpleTransformer
    from pde_policylearning_torch.models.graph import grid_laplacian
    from pde_policylearning_torch.ops import sht
    from pde_policylearning_torch.ops import spectral_cuda as sc
    from pde_policylearning_torch.utils import DotDict

    zero, counts = h["zero_counts"], h["corner_counts"]
    out = {}
    t_phase = time.perf_counter()

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def grads(model, x):
        loss = (model(x) ** 2).mean()
        return loss, torch.autograd.grad(loss, list(model.parameters()))

    # the UNO on the observer's pressure plane, B 20 of 32 x 32 -------------
    log(f"{elapsed()} zoo: UNO (hidden 32, lifting and projection 256, "
        "channels [32, 64, 64, 64, 32], modes [12, 6, 6, 6, 12], scalings "
        "[1, 0.5, 1, 2, 1]) at B 20 of 32 x 32, dense and Tucker")
    x = torch.randn((20, 32, 32, 1), generator=seeded(13), device=dev)
    uno = {b: UNO(**UNO_KW, factorization=None, conv_backend=b,
                  generator=seeded(0), device=dev)
           for b in ("auto", "plain")}
    # the forward entry's launches in each block, read by hooks on them
    per_block, at = [], [0]

    def before(*_):
        at[0] = counts()[0]

    def after(*_):
        per_block.append(counts()[0] - at[0])
    blocks = [getattr(uno["auto"], f"block{i}") for i in range(5)]
    hooks = [b.register_forward_pre_hook(before) for b in blocks] + \
        [b.register_forward_hook(after) for b in blocks]
    with torch.no_grad():
        zero()
        y_k = uno["auto"](x)
        fwd = counts()
        y_p = uno["plain"](x)
    for hook in hooks:
        hook.remove()
    check("UNO dense forward (20, 32, 32, 1), kernel route against plain "
          "route", rel(y_k, y_p), 1e-5)
    zero()
    loss_k, g_k = grads(uno["auto"], x)
    train = counts()
    loss_p, g_p = grads(uno["plain"], x)
    check("UNO dense forward and backward: loss",
          abs(loss_k.item() - loss_p.item()) / abs(loss_p.item()), 1e-5)
    check("UNO dense forward and backward: worst parameter gradient",
          max(rel(a, b) for a, b in zip(g_k, g_p)), 1e-5)
    if fwd != (5, 0, 0, 0) or per_block != [1] * 5 \
            or train != (5, 5, 0, 5):
        FAILED.append(f"UNO dense: corner launches (forward, adjoint, "
                      f"strided, dw) {fwd} a forward ({per_block} a block), "
                      f"{train} a forward and backward; expected (5, 0, 0, "
                      "0), one a block, (5, 5, 0, 5)")
    uno_ms = {b: cuda_ms(lambda m=m: grads(m, x), reps=10)
              for b, m in uno.items()}
    with torch.no_grad():
        uno_fwd_ms = {b: cuda_ms(lambda m=m: m(x), reps=10)
                      for b, m in uno.items()}
    tucker = UNO(**UNO_KW, generator=seeded(0), device=dev)
    zero()
    with torch.no_grad():
        y_t = tucker(x)
    loss_t, g_t = grads(tucker, x)
    tucker_counts = counts()
    if tucker_counts != (0, 0, 0, 0) or not (
            torch.isfinite(y_t).all()
            and all(torch.isfinite(g).all() for g in g_t)):
        FAILED.append(f"UNO Tucker: corner launches {tucker_counts}, "
                      "expected none (the plain route), or non-finite values")
    uno_ms["tucker"] = cuda_ms(lambda: grads(tucker, x), reps=10)
    log(f"  UNO dense: corner launches {fwd} a forward ({per_block} a "
        f"block), {train} a forward and backward; ms a forward "
        f"{uno_fwd_ms}, a forward and backward {uno_ms}; Tucker: "
        f"{tucker_counts}, loss {loss_t.item():.6e}  ({smi})")
    per_shape = {}
    for name, shape in UNO_CORNER_SHAPES.items():
        x_ft, d_ft, ws = h["spec_inputs"](*shape, False)
        views = sc._dense_views(ws)
        modes = shape[5:]
        check(f"fused corners at UNO {name} {shape}: forward",
              rel(h["cre"](sc.spectral_corners_kernel(x_ft, *views)),
                  h["cre"](sc.spectral_corners_plain(x_ft, ws, modes))), 2e-6)
        check(f"fused corners at UNO {name}: dx (adjoint)",
              rel(h["cre"](sc.spectral_corners_kernel(d_ft, *views,
                                                      adjoint=True)),
                  h["cre"](sc.spectral_corners_plain(
                      d_ft, [sc._adjoint_weight(v) for v in views], modes))),
              2e-6)
        b_ms, b_by = h["bound"](*h["spec_work"](*shape))

        def fk(xf=x_ft, vs=views):
            return sc.spectral_corners_kernel(xf, *vs)
        m1, m2 = modes
        corners = torch.cat([x_ft[:, :m1, :m2], x_ft[:, -m1:, :m2]], 1)
        w_c = torch.complex(*(torch.cat([v[i] for v in views])
                              for i in (0, 1)))
        per_shape[name] = dict(
            shape=shape, ms=cuda_ms(fk),
            device_us=device_us(fk, ("spectral_corners",))[0],
            plain_ms=cuda_ms(lambda xf=x_ft, w=ws, m=modes:
                             sc.spectral_corners_plain(xf, w, m)),
            library_ms=cuda_ms(lambda c=corners, w=w_c: torch.einsum(
                "brmi,rmio->brmo", c, w)),
            bound_ms=b_ms, bound_by=b_by)
        log(f"  corner entry at {name}: {per_shape[name]}")
    out["uno"] = dict(forward=fwd, per_block=per_block, training=train,
                      tucker=tucker_counts, ms=uno_ms, forward_ms=uno_fwd_ms,
                      per_shape=per_shape)

    # the transformer with a GCN / GAT feature lift, N = 2 x 32 x 32 --------
    edge = grid_laplacian(32, 32, 2, device=dev).expand(2, -1, -1)
    xg = torch.randn((2, 2, 32, 32, 1), generator=seeded(14), device=dev)
    graph = {}
    for kind in ("gcn", "gat"):
        ms = {b: SimpleTransformer(
            n_hidden=96, n_head=2, attention_type="fourier", freq_dim=48,
            fourier_modes=12, feat_extract_type=kind, num_feat_layers=2,
            conv_backend=b, generator=seeded(1), device=dev)
            .requires_grad_(False) for b in ("auto", "plain")}
        zero()
        o_k = ms["auto"](xg, edge=edge)
        got = counts()
        check(f"transformer ({kind}, N 2048, edge (2, 2048, 2048)): kernel "
              "route against plain route",
              rel(o_k, ms["plain"](xg, edge=edge)), 1e-5)
        if got != (3, 0, 0, 0):
            FAILED.append(f"transformer {kind}: corner launches {got} a "
                          "forward, expected (3, 0, 0, 0)")
        graph[kind] = dict(launches=got, ms=cuda_ms(
            lambda m=ms["auto"]: m(xg, edge=edge), reps=5))
        log(f"  transformer {kind}: {graph[kind]}  ({smi})")
    out["graph"] = graph

    # the 2-D channel, float64, on the card against the CPU -----------------
    log(f"{elapsed()} zoo: the 2-D channel (41 x 41, float64, Re 100) on the "
        "card against the CPU")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env_k = c2.NSControlEnv2D(Re=100.0, fix_flow=True, device=dev)
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    env_c = c2.NSControlEnv2D(Re=100.0, fix_flow=True, device="cpu")
    n_fresh = [int(e.iterations[0]) for e in (env_k, env_c)]
    if n_fresh[0] != n_fresh[1]:
        FAILED.append(f"2-D env construction: iterations {n_fresh}")
    for nm, a, b in (("u", env_k.u, env_c.u), ("p", env_k.p, env_c.p)):
        check(f"2-D env construction (a fresh solve): {nm}",
              float(np.abs(a - b).max() / np.abs(b).max()), 1e-10)
    fix_ms, fix_syncs, fix_iters = [], [], []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, info_k = env_k.step(env_k.gt_control())
        torch.cuda.synchronize()
        fix_ms.append(1e3 * (time.perf_counter() - t0))
        fix_syncs.append(env_k.syncs)
        _, _, _, info_c = env_c.step(env_c.gt_control())
        its = [[int(n) for n in e.iterations] for e in (env_k, env_c)]
        fix_iters.append(sum(its[0]))
        if its[0] != its[1]:
            FAILED.append(f"2-D env fix_flow step {i}: iterations {its}")
        check(f"2-D env fix_flow step {i}: u", rel(env_k.state.u.cpu(),
                                                   env_c.state.u), 1e-10)
        key = "drag_reduction/3_2_dPdx_required"
        check(f"2-D env fix_flow step {i}: F",
              abs(info_k[key] - info_c[key]) / abs(info_c[key]), 1e-10)
    # one fix_flow step and one plain step under the profiler: device time
    # and launches (the graphs' kernels), against the unprofiled time
    env_p = c2.NSControlEnv2D(Re=100.0, device=dev)
    env_p.step(None)
    prof = {}
    for name, e, wall in (("fix_flow step", env_k, fix_ms[-1]),
                          ("plain step", env_p, None)):
        if wall is None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.step(None)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        ev = device_events(lambda e=e: e.step(e.gt_control() if e.fix_flow
                                              else None))
        its = sum(int(n) for n in e.iterations)
        n_dev = sum(n for n, _ in ev.values())
        ms_dev = 1e-3 * sum(t for _, t in ev.values())
        prof[name] = dict(ms=wall, device_ms=ms_dev, busy=ms_dev / wall,
                          launches=n_dev, iterations=its,
                          launches_per_iteration=n_dev / its,
                          device_us_per_iteration=1e3 * ms_dev / its)
        log(f"  2-D env {name} under the profiler: {prof[name]}")
    log(f"  construction: a fresh solve of {n_fresh[0]} iterations of 50 "
        f"sweeps in {ctor_s:.3f} s (the graph's capture included); "
        f"fix_flow steps: ms {[round(t, 2) for t in fix_ms]}, host syncs "
        f"{fix_syncs}, iterations {fix_iters}  ({smi})")
    # 80 steps of each.  At F = 4 without fix_flow the env blows up at its
    # 86th step under `gt` and its 88th without actuation, in the JAX
    # package too, and on the way a difference in the last bit grows ~1e13
    # times by step 72: the card is held to the CPU at 1e-10 over the first
    # 32 steps, beside what a 1e-15 perturbation of u does on the CPU, and
    # must raise where the CPU does
    def per_step(a, b):
        return np.max([np.abs(a[k] - v) / np.maximum(np.abs(v), 1e-300)
                       for k, v in b.items() if "divergence" not in k], 0)

    loops = {}
    marks = [15, 31, 47, 63, 79]
    for policy in ("gt", "unmanipulated"):
        args = DotDict(env_name="NSControlEnv2D", policy_name=policy,
                       control_timestep=80)
        reads = c2.host_read.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rc.run_control(args, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loops[policy] = dict(steps_per_s=80 / dt, ms_per_step=1e3 * dt / 80,
                             syncs_per_step=(c2.host_read.count - reads) / 80)
        ref = rc.run_control(args, device="cpu")["series"]
        dev_err = per_step(res["series"], ref)
        check(f"run_control_2d {policy}: worst series against the CPU over "
              "the first 32 steps", float(dev_err[:32].max()), 1e-10)
        env_a = c2.NSControlEnv2D(Re=100.0, device="cpu")
        env_b = c2.NSControlEnv2D(Re=100.0, device="cpu")
        env_b.state = env_b.state._replace(u=env_b.state.u * (
            1 + 1e-15 * torch.randn((41, 41), dtype=torch.float64,
                                    generator=torch.Generator()
                                    .manual_seed(0))))
        infos = [[], []]
        for _ in range(80):
            for e, acc in zip((env_a, env_b), infos):
                acc.append(e.step(e.gt_control() if policy == "gt"
                                  else None)[3])
        grow = per_step(*({k: np.asarray([i[k] for i in acc]) for k in
                           acc[0]} for acc in infos))
        blow_up = []
        for d in (dev, "cpu"):
            env = c2.NSControlEnv2D(Re=100.0, device=d)
            for i in range(100):
                try:
                    env.step(env.gt_control() if policy == "gt" else None)
                except RuntimeError:
                    break
            blow_up.append(i)
        if blow_up[0] != blow_up[1]:
            FAILED.append(f"2-D env, {policy}: blows up at step {blow_up[0]} "
                          f"on the card, {blow_up[1]} on the CPU")
        loops[policy].update(
            blow_up_step=blow_up[0],
            card_vs_cpu={m + 1: float(dev_err[m]) for m in marks},
            perturbed_1e15_on_cpu={m + 1: float(grow[m]) for m in marks})
        log(f"  run_control_2d {policy}: {loops[policy]} ('control "
            f"exploded!' at step {blow_up} from 0, card and CPU), shear "
            f"last {res['series']['drag_reduction/1_shear_stress'][-1]:.6e}")
    cfd_runs = {}
    for case in ("channel", "cavity"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = cfd.main(["--case", case, "--steps", "200", "--device",
                        str(dev)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ref = cfd.main(["--case", case, "--steps", "200", "--device", "cpu"])
        u_k, u_c = ((r[0].u if case == "channel" else r[0])
                    for r in (got, ref))
        check(f"run_cfd_simulation {case}, 200 steps: u against the CPU",
              rel(u_k.cpu(), u_c), 1e-10)
        cfd_runs[case] = dict(seconds=secs)
    log(f"  run_cfd_simulation on the card: {cfd_runs}")
    out["env2d"] = dict(fresh_iterations=n_fresh[0], construction_s=ctor_s,
                        fix_flow_ms=fix_ms, fix_flow_syncs=fix_syncs,
                        fix_flow_iterations=fix_iters, loops=loops,
                        profile=prof, cfd=cfd_runs)

    # the SHT and the SFNO --------------------------------------------------
    log(f"{elapsed()} zoo: the SHT on 32 x 64 and the SFNO of "
        "neuraloperator's shallow-water example (modes (32, 32), 3 -> 3, "
        "hidden 32, projection 64, dense, batch 4)")
    rng = np.random.default_rng(0)
    sfno_ms = {}
    for grid_name in ("equiangular", "legendre-gauss"):
        coef = rng.normal(size=(4, 32, 32, 3)) \
            + 1j * rng.normal(size=(4, 32, 32, 3))
        for l in range(32):
            coef[:, l, l + 1:] = 0
        coef[:, :, 0] = coef[:, :, 0].real
        f64 = sht.irsht(torch.tensor(coef), 32, 64, grid_name)
        back64 = sht.rsht(f64, 32, 32, grid_name)
        f32 = sht.irsht(torch.tensor(coef, dtype=torch.complex64,
                                     device=dev), 32, 64, grid_name)
        back32 = sht.rsht(f32, 32, 32, grid_name)
        check(f"SHT {grid_name} 32 x 64: irsht in float32 on the card "
              "against float64 on the CPU", rel(f32.cpu(), f64), 1e-5)
        check(f"SHT {grid_name}: the round trip in float32 on the card "
              "against float64 on the CPU",
              rel(torch.view_as_real(back32).cpu(),
                  torch.view_as_real(back64)), 1e-5)
        kw = dict(n_modes=(32, 32), hidden_channels=32, in_channels=3,
                  out_channels=3, projection_channels=64, grid=grid_name)
        model = SFNO(**kw, generator=seeded(2), device=dev)
        cpu = SFNO(**kw, device="cpu", dtype=torch.float64)
        cpu.load_state_dict({k: v.double().cpu()
                             for k, v in model.state_dict().items()})
        xs = f32.detach()
        loss, g = grads(model, xs)
        with torch.no_grad():
            check(f"SFNO {grid_name} forward (4, 32, 64, 3): float32 on the "
                  "card against float64 on the CPU",
                  rel(model(xs).cpu(), cpu(xs.double().cpu())), 1e-4)
        if not (torch.isfinite(loss)
                and all(torch.isfinite(t).all() for t in g)):
            FAILED.append(f"SFNO {grid_name}: non-finite loss or gradient")
        sfno_ms[grid_name] = cuda_ms(lambda m=model: grads(m, xs), reps=10)
    log(f"  SFNO ms a forward and backward: {sfno_ms}  ({smi})")
    out["sfno_ms"] = sfno_ms

    # DeepONet: run_learning_beta_to_k at its defaults ----------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = bk.main(["--device", str(dev)])
    torch.cuda.synchronize()
    bk_s = time.perf_counter() - t0
    if not (np.isfinite(np.asarray(hist)).all() and hist[-1][2] < hist[0][2]):
        FAILED.append(f"run_learning_beta_to_k: the test rel-L2 does not "
                      f"fall: {hist}")
    log(f"  run_learning_beta_to_k.main (2000 iterations): {bk_s:.1f} s, "
        f"test rel-L2 {[r[2] for r in hist]}  ({smi})")
    out["beta_to_k"] = dict(seconds=bk_s, history=hist)
    log(f"{elapsed()} zoo: {time.perf_counter() - t_phase:.1f} s")
    return out


def dino_phase(dev, smi, port_launches):
    """Phase 14, DINo end to end and the last ops, data and utils, at the
    `train_dino` defaults; `port_launches()` counts the launches of every
    kernel of the port since the counts were last set to 0.  Returns the
    phase's numbers."""
    import numpy as np
    import torch

    from pde_policylearning_torch import test_dino as tdino
    from pde_policylearning_torch import train_dino as trdino
    from pde_policylearning_torch.data import dino_datasets as dd
    from pde_policylearning_torch.data import library as lib
    from pde_policylearning_torch.data.synthetic import gaussian_rf_2d
    from pde_policylearning_torch.models.dino import Decoder, Derivative
    from pde_policylearning_torch.tools.profile_paths import measure
    from pde_policylearning_torch.training import dino_train as dt
    from pde_policylearning_torch.utils import profiling
    from pde_policylearning_torch.utils.misc import spectrum2, spectrum3
    t_phase = time.perf_counter()
    out = {}
    tmp = tempfile.mkdtemp()
    cpu32 = dict(device="cpu", dtype=torch.float32)

    def cpu_gen(seed):
        return torch.Generator().manual_seed(seed)

    # the generated trajectories: the card against the CPU from one field
    for name, fn, kw in (
            ("navier", dd.navier_stokes_data_from_field, {}),
            ("wave", dd.wave_data_from_field, dict(alpha=3.0, tau=5.0))):
        w0 = gaussian_rf_2d(32, 64, generator=cpu_gen(1), **kw, **cpu32)
        check(f"DINo data {name} (64, 10, 32, 32, 1): the card against the "
              "CPU, float32", rel(fn(w0.to(dev), 10).cpu(), fn(w0, 10)), 1e-5)

    # the entry at its defaults: navier, 64 x 32 x 32 x 10, code 50,
    # hidden 64, dynamics hidden 512, 200 epochs of 4 steps, float32
    log(f"{elapsed()} DINo: train_dino.main at its defaults (navier, 64 "
        "trajectories of 32 x 32 x 10 frames, code 50, hidden 64, dynamics "
        "hidden 512, 200 epochs at batch 16, lr 1e-2)")
    ckpt = os.path.join(tmp, "dino.msgpack")
    launched = port_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = trdino.main(["--device", str(dev), "--out", ckpt])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    hist, ev = run["history"], run["eval"]
    log(f"  {main_s:.1f} s; autodec {hist['autodec']}; dyn {hist['dyn']}; "
        f"eval {ev['mse']:.4e} in-t {ev['mse_in_t']:.4e} out-t "
        f"{ev['mse_out_t']:.4e}")
    if not (np.isfinite(hist["autodec"]).all()
            and hist["autodec"][-1] < 0.5 * hist["autodec"][0]):
        FAILED.append(f"DINo: the auto-decoding loss does not fall: "
                      f"{hist['autodec']}")
    if not all(np.isfinite(ev[k]) for k in ("mse", "mse_in_t",
                                            "mse_out_t")):
        FAILED.append(f"DINo: eval MSEs not finite: {ev}")

    data, t_grid = run["data"], run["t_grid"]
    dec, dyn = run["dec"], run["dyn"]

    # test_dino on the file this train_dino wrote: the same MSE as
    # eval_dino of the same parameters on the same data
    res = tdino.main(["--ckpt", ckpt, "--device", str(dev)])
    # the data test_dino draws: a generator seeded 1 on the card
    tdata = dd.generate_navier_stokes_data(
        8, 32, 10, generator=torch.Generator(device=dev).manual_seed(1),
        device=dev)
    ref = dt.eval_dino(dec, dyn, tdata, t_grid, code_dim=50)
    check("DINo: test_dino.main on the written .msgpack against eval_dino "
          "of the trained modules (MSE)",
          abs(res["mse"] - ref["mse"]) / ref["mse"], 1e-6)
    out["test_dino"] = {k: res[k] for k in ("mse", "mse_in_t", "mse_out_t")}

    # ms a training step unprofiled, then the device's share under the
    # profiler (tools/profile_paths.measure), 5 epochs = 20 steps a run
    mdec, mdyn = copy.deepcopy(dec), copy.deepcopy(dyn)

    def five_epochs():
        dt.train_dino(mdec, mdyn, data, t_grid, code_dim=50, n_epochs=5,
                      generator=torch.Generator(device=dev).manual_seed(3),
                      verbose=False)
    step = measure(five_epochs, 20, 20)
    out["training_step"] = {k: step[k] for k in (
        "ms_per_step", "device_ms_per_step", "busy_share",
        "device_launches_per_step", "top")}
    out["training_step"]["steps_per_s"] = 1e3 / step["ms_per_step"]
    out["train_dino_main_s"] = main_s
    log("  DINo training step: " + json.dumps(out["training_step"])
        + f"  ({smi})")

    # the card against the CPU: 5 training steps (80 trajectories, batch
    # 16) and eval_dino on 8, from the same parameters and data; float32
    # on the card held to float64 on the CPU at DINO_FACTOR times the
    # float32 CPU run's own distance from float64
    w0 = gaussian_rf_2d(32, 80, generator=cpu_gen(2), **cpu32)
    d32 = dd.navier_stokes_data_from_field(w0, 10)
    perms = [torch.randperm(80, generator=cpu_gen(4)).numpy()]
    g = cpu_gen(5)
    dec0 = Decoder(1, 64, 50, 2, generator=g, device="cpu",
                   dtype=torch.float64)
    dyn0 = Derivative(1, 50, 512, generator=g, device="cpu",
                      dtype=torch.float64)
    tg = torch.linspace(0, 1, 10, dtype=torch.float64)
    runs = {}
    for tag, device, dtype in (("card", dev, torch.float32),
                               ("cpu32", "cpu", torch.float32),
                               ("cpu64", "cpu", torch.float64)):
        m_dec = copy.deepcopy(dec0).to(device, dtype)
        m_dyn = copy.deepcopy(dyn0).to(device, dtype)
        states, h = dt.train_dino(
            m_dec, m_dyn, d32.to(device, dtype), tg.to(device, dtype),
            code_dim=50, n_epochs=1, perms=perms, log_interval=1,
            verbose=False)
        e = dt.eval_dino(m_dec, m_dyn, d32[:8].to(device, dtype),
                         tg.to(device, dtype), code_dim=50)
        vec = torch.cat([states.reshape(-1)]
                        + [p.detach().reshape(-1)
                           for p in (*m_dec.parameters(),
                                     *m_dyn.parameters())])
        runs[tag] = dict(vec=vec.double().cpu(), hist=h, eval=e,
                         pred=e["pred"].double().cpu())
    dino_cpu = {}
    for what in ("vec", "pred"):
        d_card = rel(runs["card"][what], runs["cpu64"][what])
        d_cpu = rel(runs["cpu32"][what], runs["cpu64"][what])
        dino_cpu[what] = (d_card, d_cpu)
        check(f"DINo {what} (5 steps; then eval_dino on 8): float32 on the "
              f"card from float64 ({d_card:.3e}) against {DINO_FACTOR} x the "
              f"float32 CPU run's ({d_cpu:.3e})", d_card,
              DINO_FACTOR * d_cpu)
    # a scalar's float32 distance can land near 0 by chance: it counts as
    # one float32 ulp at least
    eps32 = torch.finfo(torch.float32).eps
    for k in ("mse", "mse_out_t"):
        a, b, c = (runs[t]["eval"][k] for t in ("card", "cpu32", "cpu64"))
        dino_cpu[k] = (abs(a - c) / c, abs(b - c) / c)
        check(f"DINo eval {k}: the card from float64 ({abs(a - c) / c:.3e}) "
              f"against {DINO_FACTOR} x the float32 CPU run's "
              f"({abs(b - c) / c:.3e}, one ulp {eps32:.3e} at least)",
              abs(a - c) / c, DINO_FACTOR * max(abs(b - c) / c, eps32))
    log(f"  DINo card / CPU float32 distances from float64: {dino_cpu}")
    out["card_against_cpu"] = dino_cpu

    # the spherical shallow water: state 2, 32 x 64, xyz coordinates
    log(f"{elapsed()} DINo: shallow water (64 trajectories of 32 x 64 x 10 "
        "frames, 2 channels, xyz coordinates), 20 epochs")
    ds = dd.ShallowWaterDataset(64, 10, 32, 64, device=dev)
    sdata, coords = ds.arrays(dev)
    g = torch.Generator(device=dev).manual_seed(6)
    sdec = Decoder(2, 64, 50, 3, generator=g, device=dev)
    sdyn = Derivative(2, 50, 512, generator=g, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, shist = dt.train_dino(sdec, sdyn, sdata, t_grid, code_dim=50,
                             state_dim=2, n_epochs=20, generator=g,
                             log_interval=1, coords=coords, verbose=False)
    torch.cuda.synchronize()
    sw_s = time.perf_counter() - t0
    # each entry is one batch's loss, noisy from batch to batch (and the
    # decoder gives both channels one value): the last five epochs' mean
    # is held 20% below the first five's
    sw_first, sw_last = (float(np.mean(shist["autodec"][s]))
                         for s in (slice(0, 5), slice(-5, None)))
    if not (np.isfinite(shist["autodec"]).all()
            and sw_last <= 0.8 * sw_first):
        FAILED.append(f"DINo shallow water: the loss does not fall by 20%: "
                      f"{shist['autodec']}")
    log(f"  {sw_s:.1f} s for 80 steps; the last five epochs' mean loss "
        f"{sw_last:.4e} against the first five's {sw_first:.4e} (at most "
        f"0.8 x); autodec {shist['autodec']}")
    out["shallow_water"] = dict(seconds=sw_s, autodec=shist["autodec"])

    # utils/profiling on one decode of a training batch (16 x 10 frames)
    coords2 = dt.make_coords(32, 32, device=dev)
    batch = torch.randn(16, 10, 50, generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)

    def decode():
        with torch.no_grad():
            return dt._decode_batch(dec, coords2, batch, 1, 50)
    prof = profiling.profile_result(decode, warmup=3, iters=20)
    with profiling.trace(os.path.join(tmp, "trace")) as path:
        decode()
    trace_bytes = os.path.getsize(path)
    mem = profiling.memory_summary(dev)
    log(f"  one decode of a training batch: {prof['mean_ms']:.3f} ms, "
        f"{prof.get('flops', 0) / 1e9:.3f} GFLOP, "
        f"{prof.get('gflops_per_s', 0):.1f} GFLOP/s; trace {trace_bytes} "
        f"bytes; memory: " + mem.splitlines()[0] + f"  ({smi})")
    if not (prof.get("flops") and trace_bytes > 0
            and "allocated_bytes" in mem):
        FAILED.append(f"utils/profiling: {prof}, trace {trace_bytes}, "
                      f"{mem[:200]}")
    out["decode"] = prof

    # library loaders at their defaults, the card against the CPU from one
    # field (float32; Burgers by the same rule as DINo)
    grf = gaussian_rf_2d(32, 120, alpha=2.0, tau=3.0, generator=cpu_gen(8),
                         **cpu32)
    a_c, u_c = lib.darcy_from_field(grf.to(dev))
    a_h, u_h = lib.darcy_from_field(grf)
    check("library: Darcy a (120 x 32 x 32) card against CPU",
          rel(a_c.cpu(), a_h), 0.0)
    check("library: Darcy u, 2000 Jacobi sweeps, card against CPU",
          rel(u_c.cpu(), u_h), 1e-5)
    u0 = gaussian_rf_2d(128, 120, generator=cpu_gen(9), **cpu32)[:, :, 0]
    b_card = lib.burgers_from_field(u0.to(dev)).cpu()
    b_32 = lib.burgers_from_field(u0)
    b_64 = lib.burgers_from_field(u0.double())
    check(f"library: Burgers u(T), 500 steps at 128: the card from float64 "
          f"against {DINO_FACTOR} x the CPU float32's "
          f"({rel(b_32, b_64):.3e})", rel(b_card, b_64),
          DINO_FACTOR * rel(b_32, b_64))
    for s_card, s_cpu in zip(lib.load_spherical_swe(device=dev),
                             lib.load_spherical_swe(device="cpu")):
        check("library: spherical SWE (32 x 64) card against CPU",
              rel(torch.as_tensor(s_card.y), torch.as_tensor(s_cpu.y)), 1e-5)
    # utils/misc's spectra: index_add_ sums each shell with atomics on the
    # card, in another order than the CPU's
    for fn, shape in ((spectrum2, (64, 32, 32)),
                      (spectrum3, (4, 32, 32, 32))):
        u = torch.randn(shape, generator=cpu_gen(10))
        check(f"utils.misc {fn.__name__} {shape}: card against CPU, float32",
              rel(fn(u.to(dev)).cpu(), fn(u)), 1e-5)
    n_port = port_launches() - launched
    if n_port:
        FAILED.append(f"DINo phase launched {n_port} kernels of the port")
    log(f"{elapsed()} DINo phase: {time.perf_counter() - t_phase:.1f} s, "
        f"{n_port} launches of the port's kernels")
    out["seconds"] = time.perf_counter() - t_phase
    return out


def study_phase(dev, smi, h):
    """Phase 15, the drag study's tool and the spin-up tool on the card;
    `h` holds main's `zero_counts`, `corner_counts` and `every` (the env
    kernels' wrappers by name).  Returns the phase's numbers and each
    path's launches."""
    import numpy as np
    import torch

    from pde_policylearning_torch.control import make_policy, run_closed_loop
    from pde_policylearning_torch.data import generate_channel_dataset
    from pde_policylearning_torch.envs import NSControlEnv
    from pde_policylearning_torch.envs import channel_flow as cf
    from pde_policylearning_torch.envs import rk3_cuda as rk
    from pde_policylearning_torch.envs.control_env import \
        default_snapshot_path
    from pde_policylearning_torch.tools import drag_rows as dr
    from pde_policylearning_torch.tools import spinup as sp
    from pde_policylearning_torch.tools.profile_paths import measure
    from pde_policylearning_torch.training import save_checkpoint
    zero, corners, every = h["zero_counts"], h["corner_counts"], h["every"]
    t_phase = time.perf_counter()
    out = {}
    tmp = tempfile.mkdtemp()

    def counts():
        return {k: f.launches for k, f in every.items()}

    # the rows of the study at full width from seeded checkpoints, staged
    data = generate_channel_dataset(os.path.join(tmp, "planes"), 100,
                                    detect_plane=25, env_kwargs=dict(
                                        device=dev))
    ckpts = {name: save_checkpoint(
        os.path.join(tmp, f"{name}.{ext}"), dr.observer(
            name, dev, generator=torch.Generator(device=dev).manual_seed(15)))
        for name, ext in (("rno", "msgpack"), ("transformer", "pt"))}
    n_rows, study = 200, os.path.join(tmp, "study")
    runs = {}
    for turn in ("run", "cached"):
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        res, series = dr.drag_rows(n_rows, False, dev, rand=True,
                                   rno=ckpts["rno"],
                                   transformer=ckpts["transformer"],
                                   data=data, out_dir=study)
        torch.cuda.synchronize()
        runs[turn] = (time.perf_counter() - t0, counts(), corners(), res)
    dt, env_counts, corner, res = runs["run"]
    rows = ("unmanipulated", "gt", "rand", "rno", "transformer")
    per_step = {"rno": 28, "transformer": 3}     # corner launches a step
    for name in rows:
        row = res.get(name, {})
        if "failed" in row or not row.get("finite") or \
                len(series.get(name, ())) != n_rows:
            FAILED.append(f"drag study: row {name} {row}")
        elif (row["substage_launches"], row["kernel_d_launches"],
              row["corner_launches"]) != (3 * n_rows, 0,
                                          per_step.get(name, 0) * n_rows):
            FAILED.append(f"drag study: row {name} launched kernel A "
                          f"{row['substage_launches']}, kernel D "
                          f"{row['kernel_d_launches']} and the corner entry "
                          f"{row['corner_launches']} times over {n_rows} "
                          "staged steps")
    want = ((28 + 3) * n_rows, 0, 0, 0)
    if corner != want:
        FAILED.append(f"drag study: corner launches (forward, adjoint, "
                      f"strided, dw) {corner}, expected {want} (28 a `rno` "
                      "step, 3 a `transformer` step)")
    for k in ("poisson", "boundary_fwd", "boundary_solve", "rk3_substage",
              "rk3_solve_correct"):
        if not env_counts[k]:
            FAILED.append(f"drag study: kernel {k} not launched")
    if env_counts["rk3_fullstep"]:
        FAILED.append("drag study: kernel D launched on the staged rows")
    c_dt, c_env, c_corner, c_res = runs["cached"]
    if any(c_env.values()) or any(c_corner) or \
            not all(c_res[n].get("cached") for n in rows):
        FAILED.append(f"drag study: the cached rows launched {c_env} and "
                      f"corner entries {c_corner}, or were run again")
    with open(os.path.join(study, "summary.json")) as f:
        summary = json.load(f)
    if list(summary["tail_mean"]) != list(rows) or \
            not os.path.exists(os.path.join(study, "table.md")):
        FAILED.append(f"drag study: summary.json {summary}")
    out["study"] = dict(seconds=dt, cached_seconds=c_dt, **{
        n: dict(steps_per_s=res[n]["steps_per_s"], tail=res[n]["tail"],
                corner_launches=res[n]["corner_launches"])
        for n in rows if "steps_per_s" in res.get(n, {})})
    out["launches_drag_study"] = dict(env_counts, corner=corner)
    log(f"{elapsed()} drag study: {len(rows)} rows x {n_rows} staged steps "
        f"in {dt:.1f} s, again from the cache in {c_dt:.2f} s; "
        f"{json.dumps(out['study'])}; launches {env_counts}, corner "
        f"{corner}  ({smi})")

    # the spin-up: the first 50 steps from the tripped state on the card
    # against the CPU in float64, then the tool's two 500-step chunks
    Nx, Ny, Nz = 32, 130, 32
    grid = cf.make_channel_grid(Nx, Ny, Nz, device=dev)
    s0 = cf.init_turbulent_state(
        grid, torch.Generator(device=dev).manual_seed(7))
    zero()
    mf0 = rk.mass_flow_kernel.launches
    _, stats = cf.spinup_chunk(grid, s0, 50)
    spin_counts = dict(counts(), mass_flow=rk.mass_flow_kernel.launches - mf0)
    # the float64 run takes the card grid's coordinates: near y = 2 a
    # float32 coordinate is off by up to half an ulp of 2, which moves the
    # top wall's spacing y[-1] - y[-2], and tau_t that divides by it, by
    # ~6e-5 (read on the CPU at 32x65x32: the plain float32 chunk's tau_t
    # 6.5e-5 from the float64 grid's, 3.7e-6 from the float32
    # coordinates')
    g64 = dataclasses.replace(
        cf.make_channel_grid(Nx, Ny, Nz, device="cpu", dtype=torch.float64),
        cache={}, **{k: getattr(grid, k).double().cpu()
                     for k in ("y", "ym", "yg")})
    s64 = cf.ChannelState(**{k: getattr(s0, k).detach().double().cpu()
                             for k in ("U", "V", "W", "dPdx", "meanU0")})
    _, stats64 = cf.spinup_chunk(g64, s64, 50)
    stats = stats.cpu()
    # the shear and the bulk after each staged step at kernel B's limit
    # (kernel A's is 1e-6); dPdx amplifies the bulk's rounding by 2 / dt
    # and takes kernel D's
    for j, (nm, tol) in enumerate((("tau_b", 2e-5), ("tau_t", 2e-5),
                                   ("bulk", 2e-5), ("dPdx", 5e-3))):
        check(f"spin-up: the first 50 steps' {nm} from the tripped state, "
              "the card (staged kernels) against the CPU in float64",
              rel(stats[:, j], stats64[:, j]), tol)
    want = {k: 0 for k in every}
    want.update(rk3_substage=150, rk3_solve_correct=150)
    if {k: spin_counts[k] for k in every} != want or \
            not spin_counts["mass_flow"]:
        FAILED.append(f"spin-up: 50 steps launched {spin_counts}, expected "
                      f"{want} and the mass flow")
    prof = measure(lambda: cf.spinup_chunk(grid, s0, 50), 50, 50)
    snap = os.path.join(tmp, "spinup.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sp.main(["--chunk", "500", "--min-chunks", "2", "--max-chunks",
                   "2", "--seed", "7", "--out", snap])
    wall = time.perf_counter() - t0
    ref = np.load(default_snapshot_path())
    d = np.load(snap)
    if sorted(d.files) != sorted(ref.files) or any(
            (d[k].dtype, d[k].shape) != (ref[k].dtype, ref[k].shape)
            for k in ref.files if k != "history") or \
            d["history"].shape != (2, 4) or got["chunks"] != 2 or \
            not np.isfinite(d["history"]).all():
        FAILED.append("spin-up: the snapshot "
                      f"{[(k, d[k].dtype, d[k].shape) for k in d.files]} "
                      f"or the run {got}")
    env = NSControlEnv(Nx, Ny, Nz, init_cond_path=snap, device=dev)
    res = run_closed_loop(env, make_policy("gt", env.grid), n_steps=20,
                          log_interval=20, verbose=False)
    if not all(np.isfinite(v).all() for v in res["series"].values()):
        FAILED.append("spin-up: 20 steps from the written snapshot are not "
                      "finite")
    out["spinup"] = dict(
        steps_per_s=got["steps_per_s"], wall_seconds=wall,
        ms_per_step=1e3 / got["steps_per_s"],
        device_ms_per_step=prof["device_ms_per_step"],
        device_launches_per_step=prof["device_launches_per_step"],
        busy_share=prof["busy_share"],
        profiled_ms_per_step=1e3 / prof["env_steps_per_s"],
        kernel_launches_per_step={k: v / 50 for k, v in spin_counts.items()
                                  if v},
        history=d["history"].tolist(),
        gt_shear_from_snapshot=float(
            res["series"]["drag_reduction/1_shear_stress"][-1]))
    out["launches_spinup"] = spin_counts
    log(f"{elapsed()} spin-up: {json.dumps(out['spinup'])}  ({smi})")
    shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"{elapsed()} drag study and spin-up phase: {out['seconds']:.1f} s")
    return out


T_START = time.perf_counter()


def elapsed() -> str:
    return f"[{time.perf_counter() - T_START:.0f} s]"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    import numpy as np

    from pde_policylearning_torch.control import make_policy, run_closed_loop
    from pde_policylearning_torch.control.loop import SCOREBOARD_KEYS
    from pde_policylearning_torch.data import (PDEDataset,
                                               generate_channel_dataset)
    from pde_policylearning_torch.envs import NSControlEnv
    from pde_policylearning_torch.envs import channel_flow as cf
    from pde_policylearning_torch.envs import poisson_cuda as pc
    from pde_policylearning_torch.envs import rk3_cuda as rk
    from pde_policylearning_torch.envs import tile_plan, xz_fft
    from pde_policylearning_torch.envs.control_env import \
        default_snapshot_path
    from pde_policylearning_torch.models import FNO2dObserver
    from pde_policylearning_torch.native import cuda_build
    from pde_policylearning_torch.ops import factorized, fourier
    from pde_policylearning_torch.ops import spectral_cuda as sc
    from pde_policylearning_torch.tools.kernel_routes import kernel_registers
    from pde_policylearning_torch.utils import set_solver_precision

    # 1. device -------------------------------------------------------------
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    set_solver_precision()

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {cuda_build.build_seconds:.1f} s) -> "
        f"{cuda_build.library_path().name}")
    regs = [int(w.split()[0]) for w in
            cuda_build.build_log.split("Used ")[1:]]
    spills, fn_name = [], "?"
    for ln in cuda_build.build_log.splitlines():
        if "Function properties for" in ln:
            fn_name = ln.split("Function properties for")[1].strip()
        elif "spill" in ln and " 0 bytes spill stores" not in ln:
            spills.append(f"{fn_name}: {ln.strip()}")
    log(f"  ptxas: {len(regs)} kernels, at most {max(regs, default=0)} "
        f"registers, spilling: {spills or 'none'}")
    # the eigen-solve's host rule picks between the row-owned kernel's two
    # builds by how many blocks of each an SM holds, from their registers
    for lean, name in enumerate(("eig_solve_rows_kernel",
                                 "eig_solve_rows_lean_kernel")):
        got = sorted(set(kernel_registers(cuda_build.build_log,
                                          (name,)).values()))
        want = tile_plan.EIG_ROWS_REGISTERS[lean]
        log(f"  {name}: {got} registers, tile_plan assumes {want} "
            f"({tile_plan.eig_rows_resident(lean)} blocks an SM)")
        if got != [want]:
            FAILED.append(f"{name}: ptxas gave {got} registers, the host "
                          f"rule (tile_plan.EIG_ROWS_REGISTERS) assumes {want}")

    # 3. kernels against their plain versions -------------------------------
    Nx, Ny, Nz, dp = 32, 130, 32, 25
    C = Nx * Nz
    grid = cf.make_channel_grid(Nx=Nx, Ny=Ny, Nz=Nz, device=dev)
    snap = np.load(default_snapshot_path())
    state = cf.init_state(grid, U=snap["U"], V=snap["V"], W=snap["W"],
                          dPdx=float(snap["dPdx"]))
    kst = rk.state_to_kstate(state)
    report = {}
    xz_report = {}

    # the card's published peaks: fp32 outside the tensor cores, HBM3
    PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
    n, m = Ny - 1, Ny - 2
    F2 = 2 * Nx * (Nz // 2 + 1)
    field = (Ny + 1) * C          # one U or W field; V has one row less

    def gemm(M, N, K):
        return 2 * M * N * K

    def work(name, B=1, as_built=False, route=None):
        """(operations, bytes) of one call of an env kernel for B envs,
        from the shapes: what the function needs, not what the kernel
        spends.  The x/z transforms are 2-D real FFTs of Nx x Nz planes,
        2.5 N log2 N operations each for N = Nx Nz points (half the
        5 N log2 N of a complex FFT); the eigen-solve products are counted
        exactly; the stencil passes by the operations per point counted in
        csrc/common.cuh (momentum RHS of three fields 175, RK update 8,
        divergence 8, correction 10, residual 6).  Bytes: every input
        (state, actuation, the cached eigen-solve constants) read once,
        every output written once, 4 bytes each; scratch does not count.
        The wall solve has two routes: the folded one (2 * 3 * m * F2 for
        the three block rows through G, the finish, the (0,0) mode on its
        four rows, the two-plane synthesis; G among the shared bytes) and
        the two-product one (B1 . t / denom1, then A13 . u, and both (0,0)
        columns through the whole Pinv00).  `route` picks one; left None,
        the function's count is that of the route with the smaller bound
        (the wall solve alone at B = 1 by the two products, where G's bytes
        outweigh them; from B = 2, and inside kernels C and D, by the
        folded route).  G counts 4 bytes an element there, the width the
        function needs.
        `as_built` counts what the kernels compute: the folded route with
        G at 8 bytes an element (the kernel keeps it in float64), the
        transforms as the in-kernel FFTs' own operations
        (`xz_fft.fft_flops`: radix-2 butterflies, two real rows a complex
        transform) and their twiddle tables, or, with `as_built="dft"`, the
        dense products with the (Nx Nz, F2) Kronecker DFT matrices, which
        are then inputs too; and kernel A's plane pass and the wall pass
        with the V row that each block computes again (58 of the 175
        operations per point, one row in `tile_plan.substage_rows` /
        `boundary_rows`).  The kernels' own cost, no bound."""
        walled = name in ("boundary_solve", "boundary_batched",
                          "rk3_fullstep")
        if route is None and walled:
            if as_built:
                return work(name, B, as_built, "folded")
            return min((work(name, B, False, r)
                        for r in ("folded", "two_product")),
                       key=lambda fb: bound(*fb)[0])
        refine = grid.refine_steps
        mode00 = 2 * gemm(n, 1, n)           # Pinv00 on the re and im columns

        def fft2(rows, forward=True):        # `rows` planes, either direction
            if as_built == "dft":
                return gemm(rows, F2, C) if forward else gemm(rows, C, F2)
            if as_built:
                return rows * xz_fft.fft_flops(Nx, Nz)
            return rows * 2.5 * C * math.log2(C)

        def solve(k):                        # eig_solve passes, k-row basis
            return ((1 + refine) * (2 * gemm(k, F2, k) + mode00)
                    + refine * 6 * n * F2)

        def spectral(k):                     # transform, solve, synthesis
            return fft2(n) + solve(k) + fft2(n, False)

        state = 2 * field + Ny * C           # U, V, W
        # one DFT matrix (T2 or Ti2), or the two twiddle tables
        dft = {"dft": C * F2, True: Nx + Nz}.get(as_built, 0)
        bordered = 2 * m * m + 2 * m * F2 + n * n   # A1, B1, denom1, g, Pinv00
        fwd = (175 + 8) * field + fft2(n)
        # the wall solve's own constants, and those it reads beside the
        # eigen-solves' (which kernel D counts once)
        if route == "two_product":
            walls = 3 * m + 3 * F2                   # A13, g3
            wall_shared = m * m + m * F2 + n * n     # B1, denom1, Pinv00
            bsolve = (mode00 + gemm(m, F2, m) + gemm(3, F2, m) + 12 * F2
                      + fft2(2, False))
        else:                                        # G, g3, ss, Pinv4, s00
            walls = (2 if as_built else 1) * 3 * m * F2 + 4 * F2 + 5 * n
            wall_shared = 0
            bsolve = (gemm(3, F2, m) + 12 * F2 + gemm(4, 1, n) + n
                      + fft2(2, False))
        sub = (175 + 8) * field + 8 * n * C
        rows_a = tile_plan.substage_rows(B, Ny, C)
        rows_w = tile_plan.boundary_rows(B, Ny, C)
        if as_built and rows_a:
            sub += 58 * -(-n // rows_a) * C
        if as_built and rows_w:
            fwd += 58 * -(-n // rows_w) * C
        cor = spectral(m) + 10 * field
        # (operations per env, words per env, words of shared constants)
        flops, per_env, shared = {
            "poisson": (spectral(n), 2 * n * C,
                        2 * dft + 3 * n * n + n * F2),
            "boundary_fwd": (fwd, state + n * F2, dft),
            "boundary_solve": (bsolve, n * F2 + 2 * C,
                               walls + wall_shared + dft),
            # stage 1: U0, V0, W0 are U, V, W; the RHS fields are written
            "rk3_substage": (sub, state + 2 * C + 2 * state + n * C, 0),
            "rk3_solve_correct": (cor, n * C + 2 * state + 2 * C,
                                  2 * dft + bordered),
            "rk3_fullstep": (3 * (sub + cor) + 3 * n * C + fwd + bsolve,
                             2 * state + 4 * C,
                             2 * dft + bordered + walls),
            "boundary_batched": (fwd + bsolve, state + 2 * C,
                                 2 * dft + walls + wall_shared),
        }[name]
        return B * flops, 4 * (B * per_env + shared)

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    def entry(name, source, replaces, out, ref, fn_kernel, fn_plain,
              flops_bytes, fn_library=None, as_built=None, dft_B=0):
        out, ref = zip(*((a, b) for a, b in zip(out, ref) if b is not None))
        bound_ms, bound_by = bound(*flops_bytes)
        report[name] = dict(
            name=name, route="cuda",
            source=f"pde_policylearning_torch/csrc/{source}",
            replaces=f"pde_policylearning_tpu/{replaces}",
            max_abs_err=max(float((a.double() - b.double()).abs().max())
                            for a, b in zip(out, ref)),
            ms=cuda_ms(fn_kernel), plain_ms=cuda_ms(fn_plain),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=cuda_ms(fn_library) if fn_library else None,
            operations=flops_bytes[0], bytes=flops_bytes[1])
        r = report[name]
        if as_built:                    # the kernel's own cost, no bound
            r["operations_as_built"], r["bytes_as_built"] = as_built
            r["as_built_ms"] = bound(*as_built)[0]
        if dft_B:   # the same entry of dft_B envs, transforms as products
            rk.kernel_args(grid, dft_B, fft=False)
            r["ms_dft_products"] = cuda_ms(fn_kernel)
            rk.kernel_args(grid, dft_B, fft=True)
            log(f"  {name}: {r['ms_dft_products']:.4f} ms with the "
                "transforms forced onto the DFT products")
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
            f"bound {bound_ms:.5f} ms by {bound_by}, library "
            f"{r['library_ms']}), max abs err {r['max_abs_err']:.3e}; "
            f"{flops_bytes[0] / 1e6:.3f} MFLOP, {flops_bytes[1] / 1e6:.3f} "
            "MB" + (f"; as built {as_built[0] / 1e6:.3f} MFLOP, "
                    f"{as_built[1] / 1e6:.3f} MB" if as_built else ""))

    log("x/z transforms alone: kernels against the T2/Ti2 products and "
        "against float64")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for shape in ((Nx, Ny, Nz), (16, 18, 64), (24, 18, 20)):
        g32 = grid if shape == (Nx, Ny, Nz) else cf.make_channel_grid(
            *shape, device=dev)
        g64 = cf.make_channel_grid(*shape, device=dev, dtype=torch.float64)
        gx, gy, gz = shape
        for B in (1, 3):
            route = "fft" if xz_fft.fft_route(gx, gz) else "dft"
            # the kernels run the route whose constants they were given
            given = rk.kernel_args(g32, B).tensors
            if ("twx" in given) != (route == "fft") or \
                    ("T2" in given) == (route == "fft"):
                FAILED.append(f"{shape}: the kernels' constants are not "
                              f"those of the {route} route")
            Y = torch.randn((gy - 1, B * gx * gz), generator=gen, device=dev)
            P = torch.randn((B, gy - 1, 2 * gx * (gz // 2 + 1)),
                            generator=gen, device=dev)
            for nm, a, kern, plain, exact in (
                    ("forward", Y, lambda a: rk.xz_forward_kernel(g32, B, a),
                     lambda a: rk.xz_forward_plain(g32, B, a),
                     lambda a: rk.xz_forward_plain(g64, B, a)),
                    ("inverse", P, lambda a: rk.xz_inverse_kernel(g32, a),
                     lambda a: rk.xz_inverse_plain(g32, a),
                     lambda a: rk.xz_inverse_plain(g64, a))):
                out, ref, ex = kern(a), plain(a), exact(a.double())
                torch.cuda.synchronize()
                e_k, e_p = rel(out, ex), rel(ref, ex)
                log(f"  {gx}x{gy}x{gz} B={B} {nm}, route {route}: against "
                    f"float64 kernel {e_k:.3e}, product {e_p:.3e}")
                # one fp32 sum of Nx Nz terms in another order
                check(f"{gx}x{gy}x{gz} B={B} {nm}: kernel against product",
                      rel(out, ref), 2e-6)
                if route == "fft" and e_k > e_p:
                    FAILED.append(
                        f"{gx}x{gy}x{gz} B={B} {nm}: the FFT kernel is "
                        f"further from float64 ({e_k:.3e}) than the "
                        f"product ({e_p:.3e})")
            if shape == (Nx, Ny, Nz) and B == 1:
                rows = Ny - 1
                xz_report = dict(
                    forward_ms=cuda_ms(
                        lambda: rk.xz_forward_kernel(g32, 1, Y)),
                    inverse_ms=cuda_ms(lambda: rk.xz_inverse_kernel(g32, P)),
                    forward_plain_ms=cuda_ms(
                        lambda: rk.xz_forward_plain(g32, 1, Y)),
                    inverse_plain_ms=cuda_ms(
                        lambda: rk.xz_inverse_plain(g32, P)),
                    library_ms=cuda_ms(lambda: torch.fft.fft(
                        torch.fft.rfft(Y.reshape(rows, gx, gz)), dim=1)),
                    bound_ms=bound(rows * 2.5 * C * math.log2(C),
                                   4 * rows * (C + F2))[0])
                rk.kernel_args(g32, 1, fft=False)
                xz_report["forward_ms_dft_products"] = cuda_ms(
                    lambda: rk.xz_forward_kernel(g32, 1, Y))
                xz_report["inverse_ms_dft_products"] = cuda_ms(
                    lambda: rk.xz_inverse_kernel(g32, P))
                rk.kernel_args(g32, 1, fft=True)
                log(f"  {rows} planes of {gx}x{gz}, one wrapper call, ms: "
                    f"{json.dumps(xz_report)}")

    log("poisson (env construction: cal_pressure right-hand side)")
    rhs = cf._pressure_rhs(grid, state)
    out = pc.poisson_solve_kernel(grid, rhs)
    ref = pc.poisson_solve_plain(grid, rhs)
    # tolerance of the JAX kernel's own test against its reference path;
    # both f32 solves are also held against a float64 solve
    check("p", rel(out, ref), 2e-4)
    grid64 = cf.make_channel_grid(Nx=Nx, Ny=Ny, Nz=Nz, device=dev,
                                  dtype=torch.float64)
    exact = pc.poisson_solve_plain(grid64, rhs.double())
    log(f"  against float64: kernel {rel(out, exact):.3e}, "
        f"plain {rel(ref, exact):.3e}")
    entry("poisson", "poisson.cu", "envs/poisson_pallas.py:76", [out], [ref],
          lambda: pc.poisson_solve_kernel(grid, rhs),
          lambda: pc.poisson_solve_plain(grid, rhs), work("poisson"),
          as_built=work("poisson", as_built=True), dft_B=1)

    def pressure_rhs(gr, B, U, V, W, dP):
        """The plain pressure RHS (divergence of cf.compute_rhs), packed."""
        Fu, Fv, Fw = cf.compute_rhs(gr, *(rk._unpack(a, gr, B)
                                          for a in (U, V, W)),
                                    dP.reshape(B, 1, 1, 1))
        return rk._pack(cf.divergence(gr, Fu, Fv, Fw)).contiguous()

    def wall_checks(gr, gr64, B, U, V, W, dP, tag, tall=False):
        """Both wall phases and kernel C against their plain versions.
        Phase 1 where it is one launch: bit for bit the transform kernel
        (the same routine) on the plain pressure RHS.  Phase 2 and kernel
        C: within 2e-5 of plain, and their solve no further from float64
        than the plain float32 solve of the same spectrum (phase 2: t of
        the plain phase 1; kernel C: its own phase 1's t, whose float32
        rounding, FFT or DFT product against the plain T2 product, moves
        both by more than the solve does), by at most 1e-6 (p is rounded
        to float32).  The full plain route's distance is printed beside it.
        On a tall graded grid (`tall`) both float32 solves sit 1e-5 .. 1e-2
        from float64 (a random state's RHS much further), set by float32
        rounding inside the solve, so the two routes differ from each
        other by more than 2e-5: no check here, the caller holds the
        kernel's distance from float64 against the plain solve's over
        several draws.  Returns (phase 1's spectrum, the plain one, {check:
        (kernel, plain, plain solve of the kernel's spectrum) errors
        against float64})."""
        rows_w = rk.kernel_args(gr, B).dims.bnd_rows
        t_k = rk.boundary_fwd_kernel(gr, U, V, W, dP)
        t_p = rk.boundary_fwd_plain(gr, U, V, W, dP)
        if rows_w:
            bits = float((t_k - rk.xz_forward_kernel(
                gr, B, pressure_rhs(gr, B, U, V, W, dP))).abs().max())
            log(f"  {tag}: phase 1 in one launch, {rows_w} cell rows a "
                f"block; against the transform kernel on the plain "
                f"pressure RHS max abs {bits:.3e}")
            if bits != 0.0:
                FAILED.append(f"{tag}: phase 1 is not bit for bit the "
                              f"transform of the plain pressure RHS ({bits})")
        else:
            log(f"  {tag}: phase 1 in three launches (RHS fields, "
                "divergence, transform)")
        check(f"{tag} t (forward)", rel(t_k, t_p), 2e-5)
        p_k = rk.boundary_solve_kernel(gr, t_p)
        p_p = rk.boundary_solve_plain(gr, t_p)
        p_x = rk.boundary_solve_plain(gr64, t_p.double())
        c_k = rk.boundary_kernel(gr, U, V, W, dP)
        c_x = rk.boundary_solve_plain(gr64, rk.boundary_fwd_plain(
            gr64, U.double(), V.double(), W.double(), dP.double()))
        c_p = rk.boundary_solve_plain(gr, t_p)
        c_s = rk.boundary_solve_plain(gr, t_k)
        errs = {}
        for nm, k, pl, same, ex in (("phase 2", p_k, p_p, p_p, p_x),
                                    ("kernel C", c_k, c_p, c_s, c_x)):
            if not tall:
                check(f"{tag} {nm} p1", rel(k[0], pl[0]), 2e-5)
                check(f"{tag} {nm} p2", rel(k[1], pl[1]), 2e-5)
            e_k, e_p, e_s = rel(k, ex), rel(pl, ex), rel(same, ex)
            errs[nm] = (e_k, e_p, e_s)
            log(f"  {tag} {nm} against float64: kernel {e_k:.3e}, plain "
                f"{e_p:.3e}, plain solve of the kernel's spectrum "
                f"{e_s:.3e}" + (f", kernel / that {e_k / e_s:.3f}"
                                if tall else ""))
            if not tall and e_k > e_s + 1e-6:
                FAILED.append(f"{tag} {nm}: further from float64 ({e_k:.3e})"
                              f" than the plain solve ({e_s:.3e}) allows")
        return t_k, t_p, errs

    log("boundary pair (first observation)")
    dP1 = state.dPdx.reshape(1)
    t_k, t_p, wall_f64 = wall_checks(grid, grid64, 1, kst.U, kst.V, kst.W,
                                     dP1, "B=1 snapshot")
    p_k = rk.boundary_solve_kernel(grid, t_p)
    p_p = rk.boundary_solve_plain(grid, t_p)
    entry("boundary_fwd", "boundary.cu", "envs/rk3_pallas.py:351", [t_k],
          [t_p],
          lambda: rk.boundary_fwd_kernel(grid, kst.U, kst.V, kst.W, dP1),
          lambda: rk.boundary_fwd_plain(grid, kst.U, kst.V, kst.W, dP1),
          work("boundary_fwd"),
          as_built=work("boundary_fwd", as_built=True), dft_B=1)
    entry("boundary_solve", "boundary.cu", "envs/rk3_pallas.py:408", [p_k],
          [p_p], lambda: rk.boundary_solve_kernel(grid, t_p),
          lambda: rk.boundary_solve_plain(grid, t_p), work("boundary_solve"),
          as_built=work("boundary_solve", as_built=True), dft_B=1)
    report["boundary_solve"]["float64_err"] = dict(
        zip(("kernel", "plain"), wall_f64["phase 2"]))

    def step_args(states):
        def cat(name):
            return torch.cat([getattr(s, name) for s in states],
                             1).contiguous()
        ops = [cf.gt_control(s, dp) for s in states]
        return (grid, len(states), cat("U"), cat("V"), cat("W"),
                torch.stack([s.dPdx for s in states]),
                torch.stack([s.meanU0 for s in states]),
                torch.cat([o[0] for o in ops])[None].contiguous(),
                torch.cat([o[1] for o in ops])[None].contiguous())

    def run_steps(step, st, n):
        rows, states = [], []
        for _ in range(n):
            U, V, W, dPdx, p = step(*step_args([st]))
            st = st.replace(U=U, V=V, W=W, dPdx=dPdx.reshape(()))
            states.append(st)
            p2 = p[1].reshape(Nx, Nz)
            info = rk.step_metrics_k(grid, st, p2)
            rows.append(torch.stack([info[k] for k in SCOREBOARD_KEYS]))
        return st, p2, torch.stack(rows, 1), states

    log("kernel D, 50 gt steps from the snapshot")
    st_k, p2_k, s_k, _ = run_steps(rk.env_step_full_kb_kernel, kst, 50)
    st_p, p2_p, s_p, states_p = run_steps(rk.env_step_full_kb_plain, kst,
                                          50)
    for name in ("U", "V", "W"):
        check(f"50-step {name}", rel(getattr(st_k, name),
                                     getattr(st_p, name)), 1e-5)
    check("50-step p2", rel(p2_k, p2_p), 5e-4)
    s_k, s_p = s_k.cpu().double().numpy(), s_p.cpu().double().numpy()
    for i, k in enumerate(SCOREBOARD_KEYS):
        # -|sum(div)| of a projected field is the sum of ~1.3e5 cells of
        # float32 projection residual (~1e-3 at this grid, either version),
        # so it takes an absolute bound only; the guard trips at 10
        atol = 1e-2 if "divergence" in k else 1e-6
        worst = float(np.max((np.abs(s_k[i] - s_p[i]) - atol)
                             / np.abs(s_p[i])))
        log(f"  50-step {k}: kernel {s_k[i, -1]:.6e} plain {s_p[i, -1]:.6e} "
            f"worst rel {max(worst, 0.0):.3e} (rtol 5e-3, atol {atol:g})")
        if worst > 5e-3:
            FAILED.append(f"50-step {k}: worst rel {worst:.3e} > 5e-3")

    log("kernel D, one step")

    def f64_errors(args, out, ref):
        a64 = [a.double() if torch.is_tensor(a) else a for a in args]
        a64[0] = grid64
        exact = rk.env_step_full_kb_plain(*a64)
        return {nm: (rel(o, e), rel(r, e)) for nm, o, r, e in zip(
            ("U", "V", "W", "p2"), (*out[:3], out[4][1]),
            (*ref[:3], ref[4][1]), (*exact[:3], exact[4][1]))}

    # the first controlled step from the snapshot switches the actuation
    # on; there both float32 versions sit ~2e-5 (V) and ~6e-5 (p2) from a
    # float64 step, so each is held against float64 instead of each other
    args0 = step_args([kst])
    errs = f64_errors(args0, rk.env_step_full_kb_kernel(*args0),
                      rk.env_step_full_kb_plain(*args0))
    for nm, (e_k, e_p) in errs.items():
        log(f"  first step, {nm} against float64: kernel {e_k:.3e} "
            f"plain {e_p:.3e}")
        check(f"first step {nm}: kernel/plain error against float64",
              e_k / e_p, 2.0)
    # from the developed states after 50 steps: kernel against plain
    for states in ([st_p], [st_p, st_k]):
        args = step_args(states)
        out = rk.env_step_full_kb_kernel(*args)
        ref = rk.env_step_full_kb_plain(*args)
        B = len(states)
        check(f"B={B} U", rel(out[0], ref[0]), 2e-6)
        check(f"B={B} V", rel(out[1], ref[1]), 2e-5)
        check(f"B={B} W", rel(out[2], ref[2]), 2e-5)
        check(f"B={B} p2", rel(out[4][1], ref[4][1]), 2e-5)
        check(f"B={B} dPdx", rel(out[3], ref[3]), 5e-3)
        if B == 1:
            args1, out1, ref1 = args, out, ref
            log("  against float64: " + ", ".join(
                f"{nm} kernel {e_k:.3e} plain {e_p:.3e}" for nm, (e_k, e_p)
                in f64_errors(args, out, ref).items()))
    entry("rk3_fullstep", "rk3_fullstep.cu", "envs/rk3_pallas.py:1058",
          out1, ref1, lambda: rk.env_step_full_kb_kernel(*args1),
          lambda: rk.env_step_full_kb_plain(*args1), work("rk3_fullstep"),
          as_built=work("rk3_fullstep", as_built=True), dft_B=1)

    def check_stages(args, tag):
        """Kernels A and B on each substage and the mass-flow kernels
        against their plain versions, each stage fed the plain outputs of
        the stage before; returns stage 1's (args, kernel, plain) of A and
        of B."""
        _, B, U0, V0, W0, dP, mU, op1, op2 = args
        Uc, Vc, Wc, F1 = U0, V0, W0, None
        for i, (c_cur, c_prev) in enumerate(rk._RK3_STAGES):
            a_args = (grid, B, Uc, Vc, Wc, U0, V0, W0, F1, op1, op2, dP,
                      c_cur, c_prev, i == 0)
            out_a = rk.substage_kernel(*a_args)
            ref_a = rk.substage_plain(*a_args)
            for nm, o, r in zip(("Un", "Vn", "Wn", "div", "Fu", "Fv", "Fw"),
                                out_a, ref_a):
                if r is not None:
                    check(f"{tag} A stage {i + 1} {nm}", rel(o, r), 1e-6)
            b_args = (grid, B, ref_a[3], *ref_a[:3], op1, op2)
            out_b = rk.solve_correct_kernel(*b_args)
            ref_b = rk.solve_correct_plain(*b_args)
            for nm, o, r, tol in zip("UVW", out_b, ref_b, (2e-6, 2e-5, 2e-5)):
                check(f"{tag} B stage {i + 1} {nm}", rel(o, r), tol)
            if i == 0:
                F1 = ref_a[4:]
                first = (a_args, out_a, ref_a), (b_args, out_b, ref_b)
            Uc, Vc, Wc = ref_b
        U_mk, dP_mk = rk.mass_flow_kernel(grid, B, Uc.clone(), mU, dP)
        U_mp, dP_mp = rk.mass_flow_plain(grid, B, Uc, mU, dP)
        check(f"{tag} mass flow U", rel(U_mk, U_mp), 1e-7)
        check(f"{tag} mass flow dPdx", rel(dP_mk, dP_mp), 1e-6)
        return first

    def check_steps(args, tag):
        """The staged step and kernel D against their plain versions, with
        kernel D's one-step bounds."""
        for nm, step, plain in (
                ("staged step", rk.rk3_step_kb, rk.rk3_step_kb_plain),
                ("kernel D", rk.env_step_full_kb_kernel,
                 rk.env_step_full_kb_plain)):
            out, ref = step(*args), plain(*args)
            pairs = [("U", 2e-6), ("V", 2e-5), ("W", 2e-5), ("dPdx", 5e-3)]
            for j, (q, tol) in enumerate(pairs):
                check(f"{tag} {nm} {q}", rel(out[j], ref[j]), tol)
            if len(out) == 5:
                check(f"{tag} {nm} p2", rel(out[4][1], ref[4][1]), 2e-5)

    built, needed = (report["rk3_fullstep"]["operations_as_built"],
                     report["rk3_fullstep"]["operations"])
    log(f"  kernel D operations as built {built / 1e9:.4f} GFLOP, the "
        f"function's {needed / 1e9:.4f} GFLOP ({built / needed:.3f}x)")
    if built > 1.3 * needed:
        FAILED.append(f"kernel D as built does {built / needed:.2f}x the "
                      "function's operations (limit 1.3x)")

    log("kernels A and B, each substage, from the state after 50 steps")
    a0, b0 = check_stages(args1, "B=1")
    # kernel A is bitwise the plain version on the card (every term rounds
    # as torch's does; the build keeps fmad off)
    worst_a = max(float((o - r).abs().max()) for o, r in zip(a0[1], a0[2])
                  if r is not None)
    log(f"  kernel A, stage 1, B=1: max abs error {worst_a:.3e}")
    entry("rk3_substage", "rk3_staged.cu", "envs/rk3_pallas.py:199", a0[1],
          a0[2], lambda: rk.substage_kernel(*a0[0]),
          lambda: rk.substage_plain(*a0[0]), work("rk3_substage"),
          as_built=work("rk3_substage", as_built=True))
    entry("rk3_solve_correct", "rk3_staged.cu", "envs/rk3_pallas.py:319",
          b0[1], b0[2], lambda: rk.solve_correct_kernel(*b0[0]),
          lambda: rk.solve_correct_plain(*b0[0]), work("rk3_solve_correct"),
          as_built=work("rk3_solve_correct", as_built=True), dft_B=1)

    # phase 5 runs every kernel at B = 8 (packed columns, per-env dPdx and
    # mass flow); hold each one there too
    log("B=8 (the last 8 states of the 50-step run): kernels A, B, the "
        "mass flow, the staged step, kernel D, kernel C")
    args8 = step_args(states_p[-8:])
    a8, b8 = check_stages(args8, "B=8")
    check_steps(args8, "B=8")

    log("the eigen-solve kernel and kernel A's pass alone: device us per "
        "launch (torch.profiler) beside the bound")
    alone = {}
    for Bn, (a_case, b_case) in ((1, (a0, b0)), (8, (a8, b8))):
        plan = tile_plan.eig_plan(n, m, Bn, F2)
        rows_a = tile_plan.substage_rows(Bn, Ny, C)
        route = (f"row-owned, tiles of {plan.tc}, "
                 f"{40 if plan.lean else 48} registers" if plan.tc else
                 f"warp-owned, {plan.warps} warps, "
                 f"{'resident' if plan.resident else 'streamed'} basis")
        refine = grid.refine_steps
        tile_work = (Bn * ((1 + refine) * (2 * gemm(m, F2, m)
                                           + 2 * gemm(n, 1, n))
                           + refine * 6 * n * F2),
                     4 * (2 * Bn * n * F2 + 2 * m * m + 2 * m * F2 + n * n))
        tile_us, tile_n = device_us(
            lambda: rk.solve_correct_kernel(*b_case[0]),
            ("eig_solve_tile", "eig_solve_rows"))
        a_us, a_n = device_us(
            lambda: rk.substage_kernel(*a_case[0]),
            ("substage_planes", "substage_kernel", "divergence_kernel"))
        if tile_n != 1 or a_n != (1 if rows_a else 2):
            FAILED.append(f"B={Bn}: {tile_n} eigen-solve launches per solve "
                          f"and {a_n} of kernel A per substage")
        # the wall pair on the same state: phase 1's plane pass, phase 2's
        # column kernel and its two-plane synthesis
        Uw, Vw, Ww, dPw = (a_case[0][k] for k in (2, 3, 4, 11))
        t_w = rk.boundary_fwd_plain(grid, Uw, Vw, Ww, dPw)
        fwd_us, fwd_n = device_us(
            lambda: rk.boundary_fwd_kernel(grid, Uw, Vw, Ww, dPw),
            ("boundary_planes", "rhs_fields", "divergence_kernel",
             "xz_fft_forward"))
        col_us, col_n = device_us(lambda: rk.boundary_solve_kernel(grid, t_w),
                                  ("wall_solve",))
        inv_us, inv_n = device_us(lambda: rk.boundary_solve_kernel(grid, t_w),
                                  ("xz_fft_inverse", "gemm", "split_sum"))
        if (fwd_n, col_n, inv_n) != (1, 1, 1):
            FAILED.append(f"B={Bn}: wall pair launches {fwd_n} + {col_n} + "
                          f"{inv_n}, expected 1 + 1 + 1")
        Bargs = args1 if Bn == 1 else args8
        _, d_n = device_us(lambda: rk.env_step_full_kb_kernel(*Bargs), ("",))
        if d_n != LAUNCHES_KERNEL_D:
            FAILED.append(f"B={Bn}: kernel D made {d_n} device launches, "
                          f"expected {LAUNCHES_KERNEL_D}")
        alone[f"B{Bn}"] = dict(
            eig_route=route, eig_device_us=tile_us,
            eig_bound_us=1e3 * bound(*tile_work)[0],
            kernel_a_rows_per_block=rows_a, kernel_a_device_us=a_us * a_n,
            kernel_a_bound_us=1e3 * bound(*work("rk3_substage", Bn))[0],
            wall_rows_per_block=rk.kernel_args(grid, Bn).dims.bnd_rows,
            wall_fwd_device_us=fwd_us * fwd_n,
            wall_fwd_bound_us=1e3 * bound(*work("boundary_fwd", Bn))[0],
            wall_solve_column_us=col_us, wall_solve_inverse_us=inv_us,
            wall_solve_bound_us=1e3 * bound(*work("boundary_solve", Bn))[0],
            kernel_d_launches=d_n)
        log(f"  B={Bn}: {json.dumps(alone[f'B{Bn}'])}")
    report["rk3_solve_correct"]["eig_kernel_alone"] = {
        k: {q: v[q] for q in v if q.startswith("eig")}
        for k, v in alone.items()}
    report["rk3_substage"]["pass_alone"] = {
        k: {q: v[q] for q in v if q.startswith("kernel_a")}
        for k, v in alone.items()}
    report["boundary_fwd"]["pass_alone"] = {
        k: {q: v[q] for q in v if q.startswith("wall_fwd")
            or q == "wall_rows_per_block"} for k, v in alone.items()}
    report["boundary_solve"]["phase_alone"] = {
        k: {q: v[q] for q in v if q.startswith("wall_solve")}
        for k, v in alone.items()}
    _, B8, U8, V8, W8, dP8, _, _, _ = args8
    _, _, wall_f64_8 = wall_checks(grid, grid64, B8, U8, V8, W8, dP8, "B=8")
    p_k = rk.boundary_kernel(grid, U8, V8, W8, dP8)
    p_p = rk.boundary_solve_plain(grid, rk.boundary_fwd_plain(grid, U8, V8,
                                                              W8, dP8))
    entry("boundary_batched", "boundary.cu", "envs/rk3_pallas.py:426", [p_k],
          [p_p], lambda: rk.boundary_kernel(grid, U8, V8, W8, dP8),
          lambda: rk.boundary_solve_plain(grid, rk.boundary_fwd_plain(
              grid, U8, V8, W8, dP8)), work("boundary_batched", B8),
          as_built=work("boundary_batched", B8, as_built=True), dft_B=B8)
    report["boundary_batched"]["float64_err"] = dict(
        zip(("kernel", "plain"), wall_f64_8["kernel C"]))
    # the wall solve's two routes, whose smaller bound is the function's
    for name, Bw in (("boundary_solve", 1), ("boundary_batched", B8),
                     ("rk3_fullstep", 1)):
        r = report[name]
        for route in ("folded", "two_product"):
            ops, nbytes = work(name, Bw, route=route)
            r[f"operations_{route}"], r[f"bytes_{route}"] = ops, nbytes
            r[f"bound_ms_{route}"] = bound(ops, nbytes)[0]
        r["bound_route"] = min(("folded", "two_product"),
                               key=lambda q: r[f"bound_ms_{q}"])
        log(f"  {name}: folded route {r['operations_folded'] / 1e6:.3f} "
            f"MFLOP, {r['bytes_folded'] / 1e6:.3f} MB, bound "
            f"{r['bound_ms_folded']:.5f} ms; two products "
            f"{r['operations_two_product'] / 1e6:.3f} MFLOP, "
            f"{r['bytes_two_product'] / 1e6:.3f} MB, bound "
            f"{r['bound_ms_two_product']:.5f} ms; the function's bound is "
            f"the {r['bound_route']} route's")

    log("other grids: the Poisson kernel, kernel A, kernel B, both wall "
        "phases and kernel C where the eigen-solve's columns straddle envs "
        "and end ragged (3x9x4: 16 tile columns per env; 2x6x2: 2), on a "
        "plane of 9 floats (3x9x3: kernel A point by point, the wall pass "
        "in three launches), with a streamed basis (8x258x8) and taller than "
        "the row-owned kernel's tiles (2x1455x2)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    # the draws of the checks added after kernels A and B come from
    # generators of their own, so that theirs stay the same: gen_w for the
    # wall pair, gen_t for the further draws on the tall grids
    gen_w = torch.Generator(device=dev)
    gen_w.manual_seed(4)
    gen_t = torch.Generator(device=dev)
    gen_t.manual_seed(5)

    def ratio_limits(tag, ratios, mean_tol, worst_tol):
        """Kernel / plain distances from float64 over several draws: their
        geometric mean and the worst one, each against its limit."""
        check(f"{tag}: geometric mean kernel/plain error against float64 "
              f"over {len(ratios)} draws",
              math.exp(sum(map(math.log, ratios)) / len(ratios)), mean_tol)
        check(f"{tag}: worst kernel/plain error against float64 over "
              f"{len(ratios)} draws", max(ratios), worst_tol)

    for shape in ((3, 9, 4), (2, 6, 2), (24, 18, 20), (3, 9, 3), (8, 258, 8),
                  (2, 1455, 2)):
        gs = cf.make_channel_grid(*shape, device=dev)
        g64 = cf.make_channel_grid(*shape, device=dev, dtype=torch.float64)
        gx, gy, gz = shape
        tall = gy > 130
        rhs_s = torch.randn((gx, gy - 1, gz), generator=gen, device=dev)
        rhs_s = rhs_s - rhs_s.mean()
        out_s = pc.poisson_solve_kernel(gs, rhs_s)
        ref_s = pc.poisson_solve_plain(gs, rhs_s)
        if not tall:
            check(f"{gx}x{gy}x{gz} poisson", rel(out_s, ref_s), 2e-4)
        else:
            # random right-hand sides on a tall graded mesh: both float32
            # solves sit ~1e-4 .. 1e-1 from a float64 one, set by float32
            # rounding inside the solve, around which each scatters 0.7x ..
            # 1.75x from one right-hand side to the next
            # (tests/test_torch_tiles.py): so each is held against float64
            # over eight of them, the geometric mean of kernel / plain at
            # most 1.25 and any one at most 2
            ratios = []
            for r in range(8):
                if r:
                    rhs_s = torch.randn((gx, gy - 1, gz), generator=gen_w,
                                        device=dev)
                    rhs_s = rhs_s - rhs_s.mean()
                    out_s = pc.poisson_solve_kernel(gs, rhs_s)
                    ref_s = pc.poisson_solve_plain(gs, rhs_s)
                exact = pc.poisson_solve_plain(g64, rhs_s.double())
                e_k, e_p = rel(out_s, exact), rel(ref_s, exact)
                log(f"  {gx}x{gy}x{gz} poisson against float64: kernel "
                    f"{e_k:.3e} plain {e_p:.3e}")
                ratios.append(e_k / e_p)
            ratio_limits(f"{gx}x{gy}x{gz} poisson", ratios, 1.25, 2.0)
        kb_ratios, wall_ratios = [], {"phase 2": [], "kernel C": []}
        for B in (1, 3):
            cols = B * gx * gz
            plans = [tile_plan.eig_plan(gy - 1, K, B, 2 * gx * (gz // 2 + 1))
                     for K in (gy - 1, gy - 2)]
            log(f"  {gx}x{gy}x{gz} B={B}: eigen-solve plans {plans}, kernel A "
                f"rows per block {tile_plan.substage_rows(B, gy, gx * gz)}")

            def rnd(rows, g=gen):
                return torch.randn((rows, cols), generator=g, device=dev)

            def b_draw(g):
                return (gs, B, 0.01 * rnd(gy - 1, g), rnd(gy + 1, g),
                        rnd(gy, g), rnd(gy + 1, g), rnd(1, g), rnd(1, g))
            b_args = b_draw(gen)
            # on 2x1455x2 the plain float32 step itself sits up to 5e-5
            # from float64 (its eigenbasis spreads the solve's float32
            # rounding most; tests/test_torch_tiles.py), so there the 2e-5
            # against plain does not apply: kernel B is held against float64
            # over eight draws on both tall grids, as the Poisson kernel
            for d in range(4 if tall else 1):
                if d:
                    b_args = b_draw(gen_t)
                out_b = rk.solve_correct_kernel(*b_args)
                ref_b = rk.solve_correct_plain(*b_args)
                for nm, o, r in zip("UVW", out_b, ref_b):
                    if gy <= 1453:
                        check(f"{gx}x{gy}x{gz} B={B} kernel B {nm}",
                              rel(o, r), 2e-5)
                    else:
                        log(f"  {gx}x{gy}x{gz} B={B} kernel B {nm}: against "
                            f"plain {rel(o, r):.3e}")
                if tall:
                    ex_b = rk.solve_correct_plain(g64, B, *(
                        a.double() for a in b_args[2:]))

                    def cat(fields):
                        return torch.cat([f.double().flatten()
                                          for f in fields])
                    e_k, e_p = (rel(cat(out_b), cat(ex_b)),
                                rel(cat(ref_b), cat(ex_b)))
                    log(f"  {gx}x{gy}x{gz} B={B} kernel B (U, V, W) against "
                        f"float64: kernel {e_k:.3e} plain {e_p:.3e}, kernel "
                        f"against plain {rel(cat(out_b), cat(ref_b)):.3e}")
                    kb_ratios.append(e_k / e_p)
            # kernel A: stage 1 with the RHS written, stage 2 on F1
            U0, V0, W0 = rnd(gy + 1), rnd(gy), rnd(gy + 1)
            dP = torch.randn(B, generator=gen, device=dev)
            a1 = (gs, B, U0, V0, W0, U0, V0, W0, None, rnd(1), rnd(1), dP,
                  *rk._RK3_STAGES[0], True)
            ref1 = rk.substage_plain(*a1)
            a2 = (gs, B, rnd(gy + 1), rnd(gy), rnd(gy + 1), U0, V0, W0,
                  ref1[4:], a1[9], a1[10], dP, *rk._RK3_STAGES[1], False)
            for tag, a_args, ref_a in (("stage 1", a1, ref1),
                                       ("stage 2", a2,
                                        rk.substage_plain(*a2))):
                out_a = rk.substage_kernel(*a_args)
                worst = max(rel(o, r) for o, r in zip(out_a, ref_a)
                            if r is not None)
                check(f"{gx}x{gy}x{gz} B={B} kernel A {tag}", worst, 1e-6)
            for d in range(4 if tall else 1):
                g = gen_t if d else gen_w
                _, _, errs = wall_checks(
                    gs, g64, B, rnd(gy + 1, g), rnd(gy, g), rnd(gy + 1, g),
                    torch.randn(B, generator=g, device=dev),
                    f"{gx}x{gy}x{gz} B={B}", tall=tall)
                for nm, (e_k, _, e_s) in errs.items():
                    wall_ratios[nm].append(e_k / e_s)
        if tall:
            ratio_limits(f"{gx}x{gy}x{gz} kernel B", kb_ratios, 1.25, 2.0)
            # the wall solve on a tall grid against the plain solve of the
            # same spectrum
            for nm, ratios in wall_ratios.items():
                ratio_limits(f"{gx}x{gy}x{gz} {nm}", ratios, *WALL_TALL[nm])

    log("staged step (rk3_step_k + wall pair) against kernel D, 3 steps")
    sa = sb = st_p
    for _ in range(3):
        _, _, U, V, W, dP, mU, o1, o2 = step_args([sa])
        U, V, W, dPa = rk.rk3_step_k(grid, U, V, W, dP, mU, o1, o2)
        sa = sa.replace(U=U, V=V, W=W, dPdx=dPa.reshape(()))
        p2a = rk.boundary_pressures_k(grid, U, V, W, dPa)[1]
        U, V, W, dPb, p = rk.env_step_full_kb_kernel(*step_args([sb]))
        sb = sb.replace(U=U, V=V, W=W, dPdx=dPb.reshape(()))
        p2b = p[1:2]
    check("staged/kernel D U", rel(sa.U, sb.U), 1e-5)
    check("staged/kernel D V", rel(sa.V, sb.V), 1e-4)
    check("staged/kernel D p2", rel(p2a, p2b), 1e-4)

    log("gradient through projection_step on the card")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    weights = [torch.randn(a.shape, generator=gen, device=dev)
               for a in (state.U, state.V, state.W)]

    def projection_grads(project):
        fields = [a.clone().requires_grad_()
                  for a in (state.U, state.V, state.W)]
        out = project(*fields)
        loss = sum((o * w).sum() for o, w in zip(out, weights))
        return torch.autograd.grad(loss, fields), out[0].grad_fn

    n0 = pc.poisson_solve_kernel.launches
    g_k, fn_k = projection_grads(
        lambda U, V, W: cf.projection_step(grid, U, V, W))
    if pc.poisson_solve_kernel.launches != n0 + 1 or fn_k is None:
        FAILED.append("projection_step on the card: kernel not launched "
                      "or no grad_fn")
    g_p, _ = projection_grads(lambda U, V, W: cf.pressure_correction(
        grid, U, V, W, pc.poisson_solve_plain(grid, cf.divergence(
            grid, U, V, W))))
    for nm, a, b in zip("UVW", g_k, g_p):
        check(f"grad {nm}", rel(a, b), 1e-5)

    log("env_step with a state that needs a gradient (staged kernels in "
        "rk3_step's Function); the rollouts refuse such a state")
    ops0 = cf.gt_control(state, dp)
    U_req = state.U.clone().requires_grad_()
    n0 = rk.substage_kernel.launches
    st_g, p2_g, _, _ = cf.env_step(grid, state.replace(U=U_req), *ops0)
    (g_U,) = torch.autograd.grad(st_g.U.sum() + p2_g.sum(), U_req)
    if rk.substage_kernel.launches != n0 + 3 or not torch.isfinite(g_U).all():
        FAILED.append("env_step with grad: staged kernels not launched 3 "
                      "times or non-finite gradient")
    st_n, p2_n, _, _ = cf.env_step(grid, state, *ops0)   # kernel D
    check("env_step with grad against without: U", rel(st_g.U, st_n.U), 1e-5)
    check("env_step with grad against without: p2", rel(p2_g, p2_n), 1e-4)
    try:
        cf.rollout(grid, state.replace(U=U_req), 1)
        FAILED.append("rollout on the card took a state that needs a "
                      "gradient")
    except RuntimeError as e:
        if "passes no gradient" not in str(e):
            raise

    log("corner contraction (the observer's spectral convolutions)")

    def corner_inputs(R, B, M2, I, O, seed=0):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return [torch.randn(sh, generator=g, device=dev) for sh in
                [(R, B, M2, I), (R, B, M2, I), (R, M2, I, O), (R, M2, I, O)]]

    def corner_work(R, B, M2, I, O):
        return (8 * R * M2 * B * I * O,
                4 * (2 * R * B * M2 * I + 2 * R * M2 * I * O
                     + 2 * R * B * M2 * O))

    def corner_grads(fn, args):
        args = [a.clone().requires_grad_() for a in args]
        or_, oi_ = fn(*args)
        return torch.autograd.grad((or_ ** 2).sum() + (or_ * oi_).sum(), args)

    serving, training = (12, 1, 6, 32, 32), (12, 20, 6, 32, 32)
    log("  the strided entry behind corner_contract (its own VJP included)")
    # one fp32 sum of <= 64 terms taken in another order
    strided = {}
    for tag, shape in (("serving B=1", serving), ("training B=20", training),
                       ("ragged", (4, 3, 3, 5, 6)),
                       ("large", (24, 64, 12, 64, 64))):
        args = corner_inputs(*shape)
        out = sc.corner_contract_kernel(*args)
        torch.cuda.synchronize()
        ref = sc.corner_contract_plain(*args)
        check(f"corner {tag} or", rel(out[0], ref[0]), 2e-6)
        check(f"corner {tag} oi", rel(out[1], ref[1]), 2e-6)
        if shape in (serving, training):
            n0 = sc.corner_contract_kernel.launches
            g_k = corner_grads(sc.corner_contract, args)
            if sc.corner_contract_kernel.launches != n0 + 3:
                FAILED.append(f"corner {tag}: forward + dx + dw should be 3 "
                              "launches")
            g_p = corner_grads(sc.corner_contract_plain, args)
            for nm, a, b in zip(("dxr", "dxi", "dwr", "dwi"), g_k, g_p):
                check(f"corner {tag} {nm}", rel(a, b), 2e-6)
            x_c = torch.complex(args[0], args[1])
            w_c = torch.complex(args[2], args[3])
            strided[shape[1]] = dict(
                ms=cuda_ms(lambda: sc.corner_contract_kernel(*args)),
                bound_ms=bound(*corner_work(*shape))[0],
                bytes=corner_work(*shape)[1],
                library_ms=cuda_ms(lambda: torch.einsum(
                    "rbmi,rmio->rbmo", x_c, w_c)))
            log(f"  strided entry at B={shape[1]}: {strided[shape[1]]}")

    log("  the fused entry: corner gather, contraction and scatter in one "
        "launch, spectrum to spectrum")

    def spec_inputs(B, H, Wh, I, O, m1, m2, legacy, seed=0):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)

        def rnd(*sh):
            return torch.randn(sh, generator=g, device=dev)
        x_ft = torch.complex(rnd(B, H, Wh, I), rnd(B, H, Wh, I))
        d_ft = torch.complex(rnd(B, H, Wh, O), rnd(B, H, Wh, O))
        ws = [{"tensor": rnd(2, I, O, m1, m2)} if legacy
              else {"mm2": rnd(2, m1, m2, I, O)} for _ in range(2)]
        return x_ft, d_ft, ws

    def spec_work(B, H, Wh, I, O, m1, m2):
        """The function as now defined: the two corners of the input
        spectrum in (the output depends on nothing else of it, and the
        kernel reads nothing else), the whole output spectrum out, both
        corners' weights, 8 bytes a complex64; 8 operations per complex
        multiply-add."""
        return (8 * B * 2 * m1 * m2 * I * O,
                8 * (B * 2 * m1 * m2 * I + B * H * Wh * O
                     + 2 * m1 * m2 * I * O))

    def spec_grads(fn, x_ft, ws, modes):
        x_ft = x_ft.clone().requires_grad_()
        leaves = [v.clone().requires_grad_() for w in ws for v in w.values()]
        o = fn(x_ft, [{k: v} for w, v in zip(ws, leaves) for k in w], modes)
        loss = (o.real ** 2).sum() + (o.real * o.imag).sum()
        return torch.autograd.grad(loss, [x_ft, *leaves])

    def cre(a):
        return torch.view_as_real(a) if a.is_complex() else a

    Wh = Nz // 2 + 1
    spec_serving = (1, Nx, Wh, 32, 32, 6, 6)
    spec_training = (20, Nx, Wh, 32, 32, 6, 6)
    spec_rno_training = (32, Nx, Wh, 34, 34, 12, 12)
    for tag, shape, legacy in (
            ("serving B=1", spec_serving, False),
            ("training B=20", spec_training, False),
            # the RNO (I = O = 34), the UNet's last block (64 -> 32) and the
            # transformer's regressor (96 -> 48, 48 -> 48 on B x T planes),
            # two 12 x 12 corners, serving and at their training batches
            ("RNO serving B=1", (1, Nx, Wh, 34, 34, 12, 12), False),
            ("RNO training B=32", spec_rno_training, False),
            ("UNet B=1", (1, Nx, Wh, 64, 32, 12, 12), False),
            ("transformer B*T=2, 96 -> 48", (2, Nx, Wh, 96, 48, 12, 12),
             False),
            ("transformer B*T=2, 48 -> 48", (2, Nx, Wh, 48, 48, 12, 12),
             False),
            ("transformer training B*T=40, 96 -> 48",
             (40, Nx, Wh, 96, 48, 12, 12), False),
            ("transformer training B*T=40, 48 -> 48",
             (40, Nx, Wh, 48, 48, 12, 12), False),
            ("legacy layout", (2, Nx, Wh, 32, 32, 6, 6), True),
            ("ragged", (3, 9, 5, 5, 6, 4, 3), False),
            ("ragged, legacy", (3, 9, 5, 5, 7, 3, 5), True),
            ("wide", (2, 16, 9, 200, 300, 3, 4), False),
            ("all ones", (1, 2, 1, 1, 1, 1, 1), False)):
        x_ft, d_ft, ws = spec_inputs(*shape, legacy)
        modes = shape[5:]
        views = sc._dense_views(ws)
        out = sc.spectral_corners_kernel(x_ft, *views)
        dx = sc.spectral_corners_kernel(d_ft, *views, adjoint=True)
        torch.cuda.synchronize()
        ref = sc.spectral_corners_plain(x_ft, ws, modes)
        dref = sc.spectral_corners_plain(
            d_ft, [sc._adjoint_weight(v) for v in views], modes)
        check(f"fused corners {tag}: forward", rel(cre(out), cre(ref)), 2e-6)
        check(f"fused corners {tag}: dx (adjoint)", rel(cre(dx), cre(dref)),
              2e-6)
        if not bool(((out == 0) == (ref == 0)).all()):
            FAILED.append(f"fused corners {tag}: zeros are not where the "
                          "plain version has them")
        n0 = (sc.spectral_corners_kernel.launches,
              sc.corner_contract_kernel.launches,
              sc.spectral_corners_dw_kernel.launches)
        g_k = spec_grads(sc.spectral_corners, x_ft, ws, modes)
        n1 = (sc.spectral_corners_kernel.launches - n0[0],
              sc.corner_contract_kernel.launches - n0[1],
              sc.spectral_corners_dw_kernel.launches - n0[2])
        if n1 != (2, 0, 1):
            FAILED.append(f"fused corners {tag}: forward + dx should be 2 "
                          "launches of the fused entry, none of the strided "
                          f"entry and dw one of the dw entry, got {n1}")
        g_p = spec_grads(sc.spectral_corners_plain, x_ft, ws, modes)
        for nm, a, b in zip(("dx", "dw low", "dw high"), g_k, g_p):
            check(f"fused corners {tag}: {nm} through the Function",
                  rel(cre(a), cre(b)), 2e-6)
        if shape in (spec_serving, spec_training):
            corners = torch.cat([x_ft[:, :6, :6], x_ft[:, -6:, :6]], 1)
            w_c = torch.complex(*(torch.cat([v[i] for v in views])
                                  for i in (0, 1)))
            name = "corner_contract" if shape == spec_serving \
                else "corner_b20"
            entry(name, "corner_contract.cu", "ops/pallas_kernels.py:28",
                  [cre(out)], [cre(ref)],
                  lambda: sc.spectral_corners_kernel(x_ft, *views),
                  lambda: sc.spectral_corners_plain(x_ft, ws, modes),
                  spec_work(*shape),
                  lambda: torch.einsum("brmi,rmio->brmo", corners, w_c))
            report[name]["adjoint_ms"] = cuda_ms(
                lambda: sc.spectral_corners_kernel(d_ft, *views,
                                                   adjoint=True))
    b20 = report.pop("corner_b20")
    report["corner_contract"].update(
        {f"{k}_b20": b20[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "max_abs_err",
                                      "adjoint_ms")})
    # the earlier function (stacked corner rows in, stacked rows out) and
    # its bytes, beside the row's
    for B, r in strided.items():
        sfx = "" if B == 1 else "_b20"
        report["corner_contract"].update(
            {f"strided_entry_{k}{sfx}": v for k, v in r.items()})

    log("  the weight-gradient entry: both corners' dw = conj(x)^T dout in "
        "one launch, from the two spectra")
    # one fp32 sum of B terms a gradient entry, taken in another order
    dw_shapes = {"FNO training B=20": spec_training,
                 "RNO training B=32": spec_rno_training,
                 **{f"UNO {k}": v for k, v in UNO_CORNER_SHAPES.items()},
                 "patch B=80": (80, Nx, Wh, 32, 32, 12, 12),
                 "B=1": spec_serving,
                 "B=64, I = O = 64": (64, Nx, Wh, 64, 64, 12, 12),
                 "ragged": (3, 9, 5, 5, 6, 4, 3),
                 "ragged, odd widths, B=37": (37, 9, 5, 7, 5, 3, 5),
                 "wide": (2, 16, 9, 200, 300, 3, 4),
                 "all ones": (1, 2, 1, 1, 1, 1, 1)}
    n0 = sc.spectral_corners_dw_kernel.launches
    for tag, shape in dw_shapes.items():
        m1, m2 = shape[5:]
        x_ft, d_ft, _ = spec_inputs(*shape, False)
        got = sc.spectral_corners_dw_kernel(x_ft, d_ft, m1, m2)
        again = sc.spectral_corners_dw_kernel(x_ft, d_ft, m1, m2)
        alone = [sc.spectral_corners_dw_kernel(x_ft, d_ft, m1, m2, want)[c]
                 for c, want in enumerate(((True, False), (False, True)))]
        # the layout the backward reads in place: x_ft channels-first (as
        # rfftn leaves it), dout too where no gradient to x asked for a copy
        first = sc.spectral_corners_dw_kernel(
            *(a.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
              for a in (x_ft, d_ft)), m1, m2)
        torch.cuda.synchronize()
        ref = sc.spectral_corners_dw_plain(x_ft, d_ft, m1, m2)
        check(f"dw entry {tag} {shape}",
              rel(torch.stack(got), torch.stack(ref)), 2e-6)
        if not all(torch.equal(a, b) for a, b in zip(got, again)) or \
                not all(torch.equal(a, b) for a, b in zip(got, alone)) or \
                not all(torch.equal(a, b) for a, b in zip(got, first)):
            FAILED.append(f"dw entry {tag}: two calls, each corner alone "
                          "or channels-first spectra against both corners "
                          "of contiguous ones, are not the same bit for bit")
    if sc.spectral_corners_dw_kernel.launches != n0 + 5 * len(dw_shapes):
        FAILED.append("dw entry: not one launch a call")

    log("  the backward entries at the training shapes (FNO B 20, RNO B 32)")

    def backward_entries(shape):
        """The gradient to x (the fused entry's adjoint: the corners of
        dout in, the whole dx spectrum out), both corners' weight gradients
        conj(x)^T dout (the weight-gradient entry, one launch) and, as the
        backward took them before it, one corner's (the strided entry, the
        channel axis in the batch role), each against its plain version,
        timed by CUDA events and by the profiler's device time, beside its
        bound (counted as `spec_work` counts: 8 bytes a complex64, 8
        operations a complex multiply-add) and one `einsum` on the
        gathered corners."""
        B, H, Wc, I, O, m1, m2 = shape
        x_ft, d_ft, ws = spec_inputs(*shape, False)
        views = sc._dense_views(ws)
        d_c = torch.cat([d_ft[:, :m1, :m2], d_ft[:, -m1:, :m2]], 1)
        x_cc = torch.cat([x_ft[:, :m1, :m2], x_ft[:, -m1:, :m2]],
                         1).conj().resolve_conj()
        w_c = torch.complex(*(torch.cat([v[i] for v in views])
                              for i in (0, 1)))
        xb, db = x_ft[:, :m1, :m2], d_ft[:, :m1, :m2]
        args = (xb.real.permute(1, 3, 2, 0), xb.imag.permute(1, 3, 2, 0),
                db.real.permute(1, 2, 0, 3), db.imag.permute(1, 2, 0, 3))
        fns = {
            "adjoint": (
                lambda: sc.spectral_corners_kernel(d_ft, *views,
                                                   adjoint=True),
                lambda: sc.spectral_corners_plain(
                    d_ft, [sc._adjoint_weight(v) for v in views], (m1, m2)),
                lambda: torch.einsum("brmo,rmio->brmi", d_c, w_c.conj()),
                spec_work(B, H, Wc, O, I, m1, m2), "spectral_corners"),
            "dw": (
                lambda: sc.spectral_corners_dw_kernel(x_ft, d_ft, m1, m2),
                lambda: sc.spectral_corners_dw_plain(x_ft, d_ft, m1, m2),
                lambda: torch.einsum("bhwi,bhwo->hwio", x_cc, d_c),
                (8 * B * 2 * m1 * m2 * I * O,
                 8 * (B * 2 * m1 * m2 * (I + O) + 2 * m1 * m2 * I * O)),
                "corners_dw"),
            "strided": (
                lambda: sc.corner_contract_kernel(*args, conj_x=True),
                lambda: sc.corner_contract_plain(args[0], -args[1], *args[2:]),
                lambda: torch.einsum("bhwi,bhwo->hwio", xb.conj(), db),
                (8 * B * m1 * m2 * I * O,
                 8 * (B * m1 * m2 * (I + O) + m1 * m2 * I * O)),
                "corner_contract")}
        out = {}
        for nm, (fk, fp, fl, fb, kname) in fns.items():
            got, want = (torch.stack(a) if isinstance(a, (tuple, list))
                         else torch.view_as_real(a) for a in (fk(), fp()))
            check(f"{nm} entry at {shape}", rel(got, want), 2e-6)
            b_ms, b_by = bound(*fb)
            out[nm] = dict(
                ms=cuda_ms(fk), device_us=device_us(fk, (kname,))[0],
                plain_ms=cuda_ms(fp), library_ms=cuda_ms(fl),
                bound_ms=b_ms, bound_by=b_by, operations=fb[0],
                bytes=fb[1],
                max_abs_err=float((got - want).abs().max()))
            log(f"  {nm} at B={B}, I={I}, O={O}, {m1}x{m2}: {out[nm]}")
        return out

    report["corner_contract"]["backward_entries"] = bw = {
        "fno_b20": backward_entries(spec_training),
        "rno_b32": backward_entries(spec_rno_training)}
    # the weight-gradient entry's row of the kernels line: RNO B 32, the
    # FNO's B 20 beside it; its launches are phase 8's
    report["corner_dw"] = dict(
        name="corner_dw", route="cuda",
        source="pde_policylearning_torch/csrc/corner_contract.cu",
        replaces="pde_policylearning_tpu/ops/pallas_kernels.py:109",
        shape=spec_rno_training,
        **{k: bw["rno_b32"]["dw"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_us", "operations", "bytes")},
        **{f"{k}_fno_b20": bw["fno_b20"]["dw"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms",
            "device_us")})

    log("fused Adam at the full-width flagship policy's leaves: kernel "
        "against plain version")
    report["fused_adam"] = fused_adam_row(dev, PEAK_BYTES)

    log("spectral_conv_nd and FNO2dObserver(12, 12, 32): kernel route "
        "against plain route")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    observer = FNO2dObserver(12, 12, 32, generator=gen)    # 'auto', the card
    observer.requires_grad_(False)
    observer_plain = FNO2dObserver(12, 12, 32, conv_backend="plain")
    observer_plain.load_state_dict(observer.state_dict())
    observer_plain.requires_grad_(False)
    convs = observer.fno2d.fno_blocks.convs
    ws = convs._layer_weights(1)
    for B in (1, 20):
        xb = torch.randn((B, Nx, Nz, 32), generator=gen, device=dev)
        n0 = sc.spectral_corners_kernel.launches
        conv_k = fourier.spectral_conv_nd(xb, ws, (6, 6), fft_norm="forward",
                                          bias=convs.bias[1])
        if sc.spectral_corners_kernel.launches != n0 + 1:
            FAILED.append("spectral_conv_nd('auto') on the card did not "
                          "launch the corner kernel")
        conv_p = fourier.spectral_conv_nd(xb, ws, (6, 6), fft_norm="forward",
                                          bias=convs.bias[1],
                                          backend="plain")
        check(f"spectral_conv_nd B={B}", rel(conv_k, conv_p), 1e-5)
    # output sizes other than the input's (irfftn cuts or pads the spectrum)
    for sizes in ((48, 40), (20, 24), (33, 31)):
        conv_k, conv_p = (fourier.spectral_conv_nd(
            xb, ws, (6, 6), fft_norm="forward", output_sizes=sizes,
            backend=be) for be in ("kernel", "plain"))
        if tuple(conv_k.shape) != (20, *sizes, 32):
            FAILED.append(f"output_sizes {sizes}: shape {conv_k.shape}")
        check(f"spectral_conv_nd output_sizes {sizes}", rel(conv_k, conv_p),
              1e-5)

    # training: the gradients to x and to the stored weights through the
    # conv, kernel route (dx fused entry, dw the weight-gradient entry)
    def conv_grads(backend):
        xg = xb.clone().requires_grad_()
        leaves = [v.detach().clone().requires_grad_() for w in ws
                  for v in w.values()]
        out = fourier.spectral_conv_nd(
            xg, [{k: v} for w, v in zip(ws, leaves) for k in w], (6, 6),
            fft_norm="forward", backend=backend)
        return torch.autograd.grad((out ** 2).mean(), [xg, *leaves])

    for nm, a, b in zip(("x", "w low", "w high"), conv_grads("kernel"),
                        conv_grads("plain")):
        check(f"spectral_conv_nd B=20 gradient to {nm}", rel(a, b), 1e-5)
    # a factorized weight is not the kernel's: 'auto' contracts it as the
    # caller's `implementation` says, with no launch, and 'kernel' raises
    tucker = [factorized.init_factorized(gen, (32, 32, 6, 6), "tucker")
              for _ in range(2)]
    n0 = sc.spectral_corners_kernel.launches
    conv_t = fourier.spectral_conv_nd(xb, tucker, (6, 6),
                                      implementation="factorized")
    dense_t = [{"tensor": torch.view_as_real(factorized.to_dense(w))
                .movedim(-1, 0)} for w in tucker]
    check("spectral_conv_nd, Tucker weights on the card ('auto', plain "
          "route) against their dense form through the kernel",
          rel(conv_t, fourier.spectral_conv_nd(xb, dense_t, (6, 6),
                                               backend="kernel")), 1e-5)
    if sc.spectral_corners_kernel.launches != n0 + 1:
        FAILED.append("Tucker weights under 'auto' launched the corner "
                      "kernel, or the legacy dense layout did not")
    try:
        fourier.spectral_conv_nd(xb, tucker, (6, 6), backend="kernel")
        FAILED.append("backend='kernel' took Tucker weights")
    except ValueError as e:
        if "backend='kernel' requires" not in str(e):
            raise
    p2_real = p2_p.reshape(1, Nx, Nz)         # the wall pressure after 50 steps
    check("observer forward on a real p2 plane",
          rel(observer(p2_real), observer_plain(p2_real)), 1e-5)

    def action_grad(model):
        v = (-st_p.V[Ny - dp]).reshape(Nx, Nz).clone().requires_grad_()
        loss = torch.linalg.vector_norm(model(v[None, :, :, None])) \
            + 0.1 * torch.linalg.vector_norm(v)
        return torch.autograd.grad(loss, v)[0]

    n0 = sc.spectral_corners_kernel.launches
    g_k = action_grad(observer)
    if sc.spectral_corners_kernel.launches != n0 + 8:
        FAILED.append("gradient through the frozen observer: expected 4 "
                      "forward + 4 dx launches, got "
                      f"{sc.spectral_corners_kernel.launches - n0}")
    check("observer gradient to its input", rel(g_k, action_grad(
        observer_plain)), 1e-5)

    # 4. the main path ------------------------------------------------------
    log(f"{elapsed()} main path: NSControlEnv(32, 130, 32) + gt, "
        "run_closed_loop 2000")
    rk.FULLSTEP = True
    kernels = {"rk3_fullstep": rk.env_step_full_kb_kernel,
               "poisson": pc.poisson_solve_kernel,
               "boundary_fwd": rk.boundary_fwd_kernel,
               "boundary_solve": rk.boundary_solve_kernel}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    env = NSControlEnv(Nx, Ny, Nz, detect_plane=dp, noise_scale=0.05, seed=0,
                       device=dev)
    policy = make_policy("gt", env.grid, detect_plane=dp)
    n = 2000
    runs, series = [], None
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_closed_loop(env, policy, n_steps=n, log_interval=n,
                              detect_plane=dp, verbose=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i == 0:
            series = res["series"]
            log(f"  warm-up run: {n / dt:.2f} steps/s")
        else:
            runs.append(n / dt)
    launches = {k: fn.launches for k, fn in kernels.items()}
    shear = series["drag_reduction/1_shear_stress"]
    div = res["series"]["drag_reduction/4_1_-|divergence|"]
    log(f"  steps/s: runs {[round(r, 2) for r in runs]} median "
        f"{sorted(runs)[1]:.2f}  ({smi})")
    log(f"  shear stress: first {shear[0]:.6e} last {shear[-1]:.6e}; "
        f"last run's max |div| {np.abs(div).max():.3e} (guard 10)")
    log(f"  launches: {launches}")
    for k, v in res["series"].items():
        if not np.isfinite(v).all():
            raise AssertionError(f"non-finite {k}")
    for name in ("U", "V", "W"):
        if not np.isfinite(getattr(env, name)).all():
            raise AssertionError(f"non-finite {name}")
    if launches["rk3_fullstep"] != 4 * n:
        raise AssertionError(f"kernel D launched {launches['rk3_fullstep']} "
                             f"times for {4 * n} steps")
    per_step, counts = launches_per_step(lambda k: run_closed_loop(
        env, policy, n_steps=k, log_interval=k, detect_plane=dp,
        verbose=False))
    log(f"  device launches per closed-loop gt step {per_step} (runs of 20 "
        f"and 40 steps: {counts})")
    if per_step != LAUNCHES_B1_GT_STEP:
        FAILED.append(f"{per_step} device launches per closed-loop gt step, "
                      f"expected {LAUNCHES_B1_GT_STEP}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} not launched on the main path")

    # 5. the data-collection path -------------------------------------------
    B, T = 8, 500
    log(f"{elapsed()} data collection: batched_rollout of {B} envs, {T} "
        "gt steps")
    staged = {"rk3_substage": rk.substage_kernel,
              "rk3_solve_correct": rk.solve_correct_kernel,
              "boundary_batched": rk.boundary_kernel}
    every = {**kernels, **staged}
    expect = {True: {"rk3_fullstep": T},
              False: {"rk3_substage": 3 * T, "rk3_solve_correct": 3 * T,
                      "boundary_batched": T}}
    for fullstep in (True, False):
        rk.FULLSTEP = fullstep
        rates = []
        for r in range(4):
            gen = torch.Generator(device=dev)
            gen.manual_seed(r)
            states = cf.init_batched_states(grid, B, gen)
            torch.cuda.synchronize()
            for fn in every.values():
                fn.launches = 0
            t0 = time.perf_counter()
            states, outs = cf.batched_rollout(grid, states, T,
                                              detect_plane=dp, policy="gt")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in every.items()}
            if r:
                rates.append(B * T / dt)
            want = {k: expect[fullstep].get(k, 0) for k in every}
            if counts != want:
                raise AssertionError(f"FULLSTEP={fullstep}: launches "
                                     f"{counts}, expected {want}")
            shapes = [tuple(o.shape) for o in outs]
            if shapes != [(B, T, Nx, Nz), (B, T, Nx, Nz), (B, T)]:
                raise AssertionError(f"batched_rollout shapes {shapes}")
            for a in (*outs, states.U, states.V, states.W):
                if not torch.isfinite(a).all():
                    raise AssertionError("non-finite batched_rollout output")
        log(f"  {'kernel D' if fullstep else 'staged A+B+C'}: env-steps/s "
            f"runs {[round(x, 2) for x in rates]} median "
            f"{sorted(rates)[1]:.2f}  ({smi})")
        if not fullstep:
            staged_launches = {k: counts[k] for k in staged}
    rk.FULLSTEP = True
    log(f"  staged launches (last run): {staged_launches}")
    per_step, counts = launches_per_step(lambda k: cf.batched_rollout(
        grid, states, k, detect_plane=dp, policy="gt"))
    log(f"  device launches per batched_rollout step through kernel D, B={B}:"
        f" {per_step} (runs of 20 and 40 steps: {counts})")
    if per_step != LAUNCHES_B8_STEP:
        FAILED.append(f"{per_step} device launches per B={B} step, expected "
                      f"{LAUNCHES_B8_STEP}")

    n_data = 100
    log(f"generate_channel_dataset, {n_data} steps, read back by PDEDataset")
    env = NSControlEnv(Nx, Ny, Nz, detect_plane=dp, noise_scale=0.05, seed=0,
                       device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        generate_channel_dataset(tmp, n_data, env=env, detect_plane=dp)
        files = os.listdir(tmp)
        meta = np.load(os.path.join(tmp, "metadata.npy"),
                       allow_pickle=True).item()
        p0 = np.load(os.path.join(tmp, f"P_planes_{n_data - 1:06d}.npy"))
        dataset = PDEDataset.from_folder(tmp, range(n_data), x_range=Nx,
                                         y_range=Nz)
    if len(files) != 2 * n_data + 1 \
            or set(meta) != {"P_planes", "V_planes", "re"}:
        raise AssertionError(f"dataset: {len(files)} files, keys {set(meta)}")
    if p0.shape != (Nx, Nz) or not np.isfinite(p0).all():
        raise AssertionError("dataset: bad P plane")
    planes = dataset.arrays()
    for a, norm in zip(planes, (dataset.p_norm, dataset.v_norm)):
        if tuple(a.shape) != (n_data, Nx, Nz, 1) or not a.is_cuda \
                or not torch.isfinite(a).all() or float(norm.std.min()) <= 0:
            raise AssertionError("dataset: bad normalized planes")
    log(f"  {len(files)} files, metadata keys {sorted(meta)}; std of p "
        f"{float(dataset.p_norm.std.mean()):.3e}, of v "
        f"{float(dataset.v_norm.std.mean()):.3e}")

    # 6. the observer-policy path -------------------------------------------
    log(f"{elapsed()} observer-policy path: FNO2dObserver(12, 12, 32) serving")
    shaping = dict(model=observer, detect_plane=dp, p_norm=dataset.p_norm,
                   v_norm=dataset.v_norm)

    def fresh_env():
        return NSControlEnv(Nx, Ny, Nz, detect_plane=dp, noise_scale=0.05,
                            seed=0, device=dev)

    # the two routes through the same 20 steps from the same state
    short = []
    for model in (observer, observer_plain):
        e = fresh_env()
        pol = make_policy("fno", e.grid, **{**shaping, "model": model},
                          action_scale=0.3, action_clip=0.01)
        short.append((run_closed_loop(e, pol, n_steps=20, log_interval=20,
                                      detect_plane=dp, verbose=False,
                                      collect_planes=True), e))
    check("20 fno steps, kernel route against plain route: opV2",
          rel(torch.as_tensor(short[0][0]["opV2"]),
              torch.as_tensor(short[1][0]["opV2"])), 1e-4)
    check("20 fno steps, kernel route against plain route: U",
          rel(short[0][1].state.U, short[1][1].state.U), 1e-5)

    policy_runs = {}
    for name, n_pol, per_step, kw in (
            ("fno", 2000, 4, dict(action_scale=0.3, action_clip=0.01)),
            ("optimal-observer", 200, 80, dict(opt_steps=10))):
        env = fresh_env()
        policy = make_policy(name, env.grid, **shaping, **kw)
        rates = []
        for i in range(4):
            torch.cuda.synchronize()
            for fn in (*every.values(), sc.spectral_corners_kernel,
                       sc.corner_contract_kernel,
                       sc.spectral_corners_dw_kernel):
                fn.launches = 0
            t0 = time.perf_counter()
            res = run_closed_loop(env, policy, n_steps=n_pol,
                                  log_interval=n_pol, detect_plane=dp,
                                  verbose=False, collect_planes=(i == 0))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if i:
                rates.append(n_pol / dt)
            else:
                actions = res["opV2"]      # the warm-up run's planes
            got = (sc.spectral_corners_kernel.launches,
                   rk.env_step_full_kb_kernel.launches,
                   sc.corner_contract_kernel.launches,
                   sc.spectral_corners_dw_kernel.launches)
            if got != (per_step * n_pol, n_pol, 0, 0):
                raise AssertionError(
                    f"{name}: (fused corner entry, kernel D, strided corner "
                    f"entry, dw entry) launches {got} over {n_pol} steps, "
                    f"expected {(per_step * n_pol, n_pol, 0, 0)}")
            for k, v in res["series"].items():
                if not np.isfinite(v).all():
                    raise AssertionError(f"{name}: non-finite {k}")
        shear = res["series"]["drag_reduction/1_shear_stress"]
        div = res["series"]["drag_reduction/4_1_-|divergence|"]
        flux = np.abs(actions.mean(axis=(1, 2))).max()
        log(f"  {name}: steps/s runs {[round(r, 2) for r in rates]} median "
            f"{sorted(rates)[1]:.2f}  ({smi}); corner launches per run "
            f"{got[0]} ({per_step} per step); shear last {shear[-1]:.6e}, "
            f"max |div| {np.abs(div).max():.3e} (guard 10), max |opV2| "
            f"{np.abs(actions).max():.3e}, max |plane mean| {flux:.1e}")
        if flux > 1e-6:
            raise AssertionError(f"{name}: actuation has a net flux {flux}")
        policy_runs[name] = got[0]

    corner, strided_entry, dw_entry = sc.spectral_corners_kernel, \
        sc.corner_contract_kernel, sc.spectral_corners_dw_kernel

    def zero_counts():
        for fn in (*every.values(), corner, strided_entry, dw_entry):
            fn.launches = 0
        corner.adjoint_launches = 0

    def corner_counts():
        """(forward, adjoint, strided, dw) launches of the corner kernel's
        entries since `zero_counts`."""
        return (corner.launches - corner.adjoint_launches,
                corner.adjoint_launches, strided_entry.launches,
                dw_entry.launches)

    # 7. the observer zoo serving -------------------------------------------
    log(f"{elapsed()} observer zoo at full width, seeded: "
        "RNO2dObserver(12, 12, 34), "
        "SimpleTransformer(96, 2 heads, fourier, freq_dim 48, 12 modes, 8 + "
        "3 layers), UNet(spectral, 12 modes)")
    from pde_policylearning_torch import models as zoo
    zoo_models = {
        "rno": (lambda be, g: zoo.RNO2dObserver(
            12, 12, 34, conv_backend=be, generator=g), (1, 2, Nx, Nz, 1), 28),
        "transformer": (lambda be, g: zoo.SimpleTransformer(
            n_hidden=96, n_head=2, attention_type="fourier", freq_dim=48,
            fourier_modes=12, conv_backend=be, generator=g),
            (1, 2, Nx, Nz, 1), 3),
        "unet": (lambda be, g: zoo.UNet(
            use_spectral_conv=True, modes=12, conv_backend=be, generator=g),
            (1, Nx, Nz, 1), 1)}
    served = {}
    for name, (make, shape, per_forward) in zoo_models.items():
        g = torch.Generator(device=dev)
        g.manual_seed(7)
        model_k, model_p = make("auto", g), make("plain", g)
        model_p.load_state_dict(model_k.state_dict())
        for m in (model_k, model_p):
            m.requires_grad_(False)
        x = torch.randn(shape, generator=g, device=dev)
        zero_counts()
        out_k = model_k(x)
        got = corner_counts()
        if got != (per_forward, 0, 0, 0):
            FAILED.append(f"{name} forward: corner launches (forward, "
                          f"adjoint, strided, dw) {got}, expected "
                          f"{(per_forward, 0, 0, 0)}")
        check(f"{name} forward {tuple(out_k.shape)}, kernel route against "
              "plain route", rel(out_k, model_p(x)), 1e-5)
        served[name] = model_k

    loop_runs = {}
    for name, n_pol, per_step in (("rno", 500, 28), ("transformer", 200, 3)):
        env = fresh_env()
        policy = make_policy(name, env.grid, model=served[name],
                             detect_plane=dp, p_norm=dataset.p_norm,
                             v_norm=dataset.v_norm, model_timestep=2,
                             action_scale=0.3, action_clip=0.01)
        rates = []
        for i in range(4):
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            res = run_closed_loop(env, policy, n_steps=n_pol,
                                  log_interval=n_pol, detect_plane=dp,
                                  verbose=False, collect_planes=(i == 0))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if i:
                rates.append(n_pol / dt)
            else:
                actions = res["opV2"]
            got = (*corner_counts(), rk.env_step_full_kb_kernel.launches)
            want = (per_step * n_pol, 0, 0, 0, n_pol)
            if got != want:
                raise AssertionError(
                    f"{name}: (corner forward, adjoint, strided, dw, kernel "
                    "D) "
                    f"launches {got} over {n_pol} steps, expected {want}")
            for k, v in res["series"].items():
                if not np.isfinite(v).all():
                    raise AssertionError(f"{name}: non-finite {k}")
        flux = np.abs(actions.mean(axis=(1, 2))).max()
        shear = res["series"]["drag_reduction/1_shear_stress"]
        log(f"  {name}: steps/s runs {[round(r, 2) for r in rates]} median "
            f"{sorted(rates)[1]:.2f}  ({smi}); corner launches per run "
            f"{got[0]} ({per_step} per step); shear last {shear[-1]:.6e}, "
            f"max |opV2| {np.abs(actions).max():.3e}, max |plane mean| "
            f"{flux:.1e}")
        if flux > 1e-6:
            raise AssertionError(f"{name}: actuation has a net flux {flux}")
        loop_runs[name] = got[0]

    # 8. observer training --------------------------------------------------
    from pde_policylearning_torch import run_pde_observers as rpo
    from pde_policylearning_torch.training import (load_checkpoint,
                                                   relative_l2_loss)
    from pde_policylearning_torch.utils import load_yaml
    here = os.path.dirname(os.path.abspath(__file__))
    n_gen, epochs = 400, 3
    trained = {}
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "planes")
        t0 = time.perf_counter()
        generate_channel_dataset(folder, n_gen, env=fresh_env(),
                                 detect_plane=dp)
        log(f"{elapsed()} observer training: a {n_gen}-step gt dataset in "
            f"{time.perf_counter() - t0:.1f} s; run_pde_observers.main, "
            f"{epochs} epochs each, widths as configured")

        def config(name, **over):
            args = load_yaml(os.path.join(here, "configs", name))
            args.update(DATA_FOLDER=folder, epochs=epochs, set_epoch=-1,
                        out_dir=os.path.join(tmp, "out"), **over)
            return args

        for name, over, per_step in (
                ("base_fno.yaml", dict(ntrain=300, ntest=100), 4),
                ("matlab_rno.yaml", {}, 28),
                ("base_transformer.yaml", dict(ntrain=300, ntest=100), 3)):
            args = config(name, **over)
            train_ds, train, test = rpo.load_arrays(args, dev)
            bs = args.batch_size
            steps = train[0].shape[0] // bs
            test_steps = max(1, test[0].shape[0] // min(bs, test[0].shape[0]))
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            _, hist = rpo.main(args, device=dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = corner_counts()
            want = (epochs * (steps + test_steps) * per_step,
                    epochs * steps * per_step, 0, epochs * steps * per_step)
            if got != want:
                FAILED.append(f"{name}: corner launches (forward, adjoint, "
                              f"strided, dw) {got}, expected {want}")
            tr, te = hist["train_loss"], hist["test_loss"]
            if not (np.isfinite(tr + te).all() and tr[-1] < tr[0]):
                FAILED.append(f"{name}: train loss {tr} does not fall")
            model, _ = rpo.build_model(args, device=dev)
            load_checkpoint(hist["checkpoint"], model)
            again = float(rpo.make_trainer(args, model, train_ds.v_norm)
                          .test_loss(test).float())
            if again != hist["best_loss"]:
                FAILED.append(f"{name}: the checkpoint reloads to test loss "
                              f"{again!r}, training read {hist['best_loss']!r}")
            trained[args.model_name] = dict(
                forward=got[0], adjoint=got[1], strided=got[2], dw=got[3],
                per_training_step=(per_step, per_step, 0, per_step),
                steps=epochs * steps, train_loss=tr, test_loss=te,
                ms_per_epoch=[1e3 * t for t in hist["epoch_time"]],
                seconds=dt)
            log(f"  {args.model_name}: {steps} steps of {bs} an epoch, "
                f"train {tr}, test {te}, best {hist['best_loss']!r} "
                f"(reloaded {again!r}); {dt:.1f} s; corner launches "
                f"(forward, adjoint, strided, dw) {got}  ({smi})")

        # one training step on the kernel route against the plain route
        for name, B in (("base_fno.yaml", 20), ("matlab_rno.yaml", 32)):
            args = config(name)
            train_ds, (x, y), _ = rpo.load_arrays(args, dev)
            step = []
            for backend in ("auto", "plain"):
                g = torch.Generator(device=dev)
                g.manual_seed(0)
                m, _ = rpo.build_model(args, device=dev, generator=g,
                                       conv_backend=backend)
                loss = relative_l2_loss(m(x[:B]).reshape(y[:B].shape),
                                        y[:B], train_ds.v_norm)
                step.append((loss, torch.autograd.grad(
                    loss, list(m.parameters()))))
            (lk, gk), (lp, gp) = step
            check(f"{args.model_name} B={B} training step: loss",
                  abs(lk.item() - lp.item()) / abs(lp.item()), 1e-6)
            check(f"{args.model_name} B={B} training step: worst parameter "
                  "gradient", max(rel(a, b) for a, b in zip(gk, gp)), 1e-5)

    # 9. the flagship gradient-control slice --------------------------------
    from pde_policylearning_torch.control import (
        make_fullfield_optimal_observer, make_optimal_policy_observer)
    from pde_policylearning_torch.models import PolicyModel2D
    from pde_policylearning_torch.tools import drag_rows as dr
    # every kernel of the path counted from here to the end of the phase:
    # the dataset's rollout, the env constructions, the loops
    zero_counts()
    n_ff, ff_epochs = 64, 2
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "fullfield")
        t0 = time.perf_counter()
        generate_channel_dataset(folder, n_ff, env=fresh_env(),
                                 detect_plane=dp, save_fields=True)
        log(f"{elapsed()} flagship slice: a {n_ff}-step gt dataset with its "
            "fields in "
            f"{time.perf_counter() - t0:.1f} s; run_pde_observers.main on "
            f"fullfield_pi_short.yaml, {ff_epochs} epochs, widths as "
            "configured")
        args = load_yaml(os.path.join(here, "configs",
                                      "fullfield_pi_short.yaml"))
        # batches of 8, so that an epoch is 7 steps: the first Adam step
        # from the initial draw overshoots (in the JAX package too)
        args.update(DATA_FOLDER=folder, epochs=ff_epochs, set_epoch=-1,
                    ntrain=56, ntest=8, batch_size=8,
                    out_dir=os.path.join(tmp, "out"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hist = rpo.main(args, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        total = hist["total"]
        if not (np.isfinite(total + hist["data"] + hist["pde"]).all()
                and total[-1] < total[0]):
            FAILED.append(f"full-field training: loss {total} does not fall")
        args.eval_ckpt = hist["checkpoint"]
        _, again = rpo.main(args, device=dev)
        if again["test_rel_l2"] != hist["test_rel_l2"]:
            FAILED.append("full-field checkpoint reloads to held-out rel-L2 "
                          f"{again['test_rel_l2']!r}, training read "
                          f"{hist['test_rel_l2']!r}")
        log(f"  total {total}, data {hist['data']}, pde {hist['pde']}; "
            f"held-out rel-L2 {hist['test_rel_l2']!r} (reloaded "
            f"{again['test_rel_l2']!r}); {dt:.1f} s, "
            f"{[round(1e3 * t, 1) for t in hist['epoch_time']]} ms an epoch "
            f"of {56 // args.batch_size} steps of {args.batch_size}  ({smi})")
        norm = dr.top_plane_norm(folder, dev)
    flagship = dict(training=dict(
        loss=total, test_rel_l2=hist["test_rel_l2"], seconds=dt,
        ms_per_epoch=[1e3 * t for t in hist["epoch_time"]]))

    g = torch.Generator(device=dev)
    g.manual_seed(9)
    ff_observer = dr.fullfield_observer(None, dev, g)
    n_pol = 200
    from pde_policylearning_torch.training import optimizers as optim
    for name, opt_steps in (("optimal-policy-observer", 3),
                            ("optimal-policy-observer", 10),
                            ("optimal-observer", 3), ("optimal-observer", 10)):
        env = fresh_env()
        policy = dr.flagship_policy(name, env, ff_observer, norm, opt_steps)
        adam0 = optim.fused_adam_kernel.launches
        rates = []
        for i in range(4):
            torch.cuda.synchronize()
            n0 = rk.env_step_full_kb_kernel.launches
            c0 = corner_counts()
            t0 = time.perf_counter()
            res = run_closed_loop(env, policy, n_steps=n_pol,
                                  log_interval=n_pol, detect_plane=dp,
                                  verbose=False, collect_planes=(i == 0))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if i:
                rates.append(n_pol / dt)
            else:
                actions = res["opV2"]
            got = (rk.env_step_full_kb_kernel.launches - n0,
                   *(b - a for a, b in zip(c0, corner_counts())))
            if got != (n_pol, 0, 0, 0, 0):
                raise AssertionError(
                    f"{name}: (kernel D, corner forward, adjoint, strided, "
                    f"dw) launches {got} over {n_pol} steps, expected "
                    f"{(n_pol, 0, 0, 0, 0)}")
            for k, v in res["series"].items():
                if not np.isfinite(v).all():
                    raise AssertionError(f"{name}: non-finite {k}")
        # both policies' inner steps go through the fused Adam kernel:
        # one update launch a step in the graph's two warm-up calls and
        # its capture, none on replay
        adam = optim.fused_adam_kernel.launches - adam0
        report["fused_adam"].setdefault("launches_flagship", {})[
            f"{name} opt_steps {opt_steps}"] = adam
        if adam != 3 * opt_steps:
            raise AssertionError(f"{name}, opt_steps {opt_steps}: {adam} "
                                 "fused Adam launches over 4 runs")
        flux = np.abs(actions.mean(axis=(1, 2))).max()
        shear = res["series"]["drag_reduction/1_shear_stress"]
        log(f"  {name}, opt_steps {opt_steps}: steps/s runs "
            f"{[round(r, 2) for r in rates]} median {sorted(rates)[1]:.2f}  "
            f"({smi}); kernel D {n_pol} per run; shear last {shear[-1]:.6e},"
            f" max |opV2| {np.abs(actions).max():.3e}, max |plane mean| "
            f"{flux:.1e}")
        if flux > 1e-6:
            raise AssertionError(f"{name}: actuation has a net flux {flux}")
        flagship[f"{name} opt_steps {opt_steps}"] = dict(
            steps_per_s=rates, median=sorted(rates)[1])
        del policy

    # 20 steps from the same state: each policy replayed as CUDA graphs on
    # kernel D, against itself run eagerly, against the plain env step and,
    # for the residual policy, run eagerly with its Adam's plain version in
    # place of the fused kernel (phase 3 holds the kernel alone).
    # The residual policy is a seeded PolicyModel2D with its output layer
    # scaled by 1e-3 (the zeroed one only moves a constant, which the
    # zero-flux step removes)
    policy_model = PolicyModel2D(**dr.FULL_WIDTH, device=dev, generator=g)
    with torch.no_grad():
        for prm in policy_model.head.fc2.parameters():
            prm.mul_(1e-3)
    kernel_d = rk.env_step_full_kb_kernel
    adam_kernel = optim.fused_adam_kernel

    def plain_adam(params, grads, m, v, step, scal, **kw):
        optim.adam_plain_(params, grads, m, v, step, **kw)

    def flagship_pair(name, e, graph):
        if name == "optimal-observer":
            return make_fullfield_optimal_observer(
                e.grid, observer_model=ff_observer, bound_v_norm=norm,
                detect_plane=dp, cuda_graph=graph)
        return make_optimal_policy_observer(
            e.grid, observer_model=ff_observer, policy_model=policy_model,
            detect_plane=dp, cuda_graph=graph)

    # (opV2, U) limits of the 20-step loops, read on an H100: the
    # residual policy's loops part by 3e-5 and 3e-7.  The full-field
    # `optimal-observer`'s Adam moves every entry of the action by about
    # +-lr whatever its gradient's size, so an entry whose gradient is
    # near zero flips its step with the last bit, and its loops part by
    # 3.4e-2 and 7.3e-5 (5.4e-3 and 3.0e-5 against the plain env step)
    # where one control step from one state agrees to float32 rounding
    loop_tol = {"optimal-policy-observer": (1e-4, 1e-5),
                "optimal-observer": (0.1, 3e-4)}
    for name in dr.FLAGSHIP:
        e = fresh_env()
        kst = rk.state_to_kstate(e.state)
        _, p2_0 = cf.boundary_pressures(e.grid, e.state)
        one = []
        for graph in (True, False):
            pol = flagship_pair(name, e, graph)
            one.append(pol(pol.init_carry(), kst, p2_0, None)[1])
        check(f"one {name} step from one state, CUDA graph against eager: "
              "opV2", rel(*one), 1e-5)
        routes, variants = {}, [(True, None), (False, None), (True, "env"),
                                (False, "adam")]
        for graph, plain in variants:
            e = fresh_env()
            pol = flagship_pair(name, e, graph)
            if plain == "env":
                rk.env_step_full_kb_kernel = rk.env_step_full_kb_plain
            if plain == "adam":
                optim.fused_adam_kernel = plain_adam
            try:
                routes[graph, plain] = (run_closed_loop(
                    e, pol, n_steps=20, log_interval=20, detect_plane=dp,
                    verbose=False, collect_planes=True), e)
            finally:
                rk.env_step_full_kb_kernel = kernel_d
                optim.fused_adam_kernel = adam_kernel
        r_k, e_k = routes[True, None]
        # `gt`'s action is -v_plane of the step before
        log(f"  20 {name} steps: off gt by at most "
            f"{np.abs(r_k['opV2'][1:] + r_k['v_plane'][:-1]).max():.3e}, "
            f"actions at most {np.abs(r_k['opV2']).max():.3e}")
        for key, what in (((False, None), "run eagerly"),
                          ((True, "env"), "on the plain env step"),
                          ((False, "adam"), "run eagerly with Adam's plain "
                                            "version")):
            r, e = routes[key]
            check(f"20 {name} steps, CUDA graphs on kernel D against {what}:"
                  " opV2", rel(torch.as_tensor(r_k["opV2"]),
                               torch.as_tensor(r["opV2"])),
                  loop_tol[name][0])
            check(f"20 {name} steps, CUDA graphs on kernel D against {what}:"
                  " U", rel(e_k.state.U, e.state.U), loop_tol[name][1])
    flagship_launches = {k: fn.launches for k, fn in kernels.items()}
    log(f"  launches over the phase: {flagship_launches}")
    log("  flagship " + json.dumps(flagship))
    for k, v in flagship_launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} not launched on the flagship "
                                 "path")
    del ff_observer, policy_model, pol, routes
    # one optimal-observer step as above, on the benchmark cell's inputs at
    # full width after its set-up and a window
    # (port_bench/drivers/ffo.py:capture_case): the case where the replays
    # read a freed one-element tensor.  After the launches are read, since
    # its windows run for a wall-clock time
    from port_bench import harness as bench_harness
    from port_bench.drivers import ffo as bench_ffo
    case = bench_ffo.capture_case(2 ** 31 + 2121)
    check("one optimal-observer step on the benchmark cell's inputs, CUDA "
          "graph against eager: opV2", case["graph_eager"], 1e-5)
    check("the same, CUDA graph against the float64 reference: opV2",
          case["graph_ref"], bench_harness.cell_files(
              "pino-fullfield-oo.ffo-loop", "pino-fullfield-oo"
          )[0]["limits"]["opV2_rel"])
    if not case["replays_equal"]:
        FAILED.append("optimal-observer: two replays from one state part")

    # 10. PINO pretrain and finetune (train_pino) ---------------------------
    from pde_policylearning_torch import train_pino as tp
    from pde_policylearning_torch.data import (KFDataset,
                                               ns_vorticity_rollout)
    from pde_policylearning_torch.ops import pde_losses
    from pde_policylearning_torch.training import pino_train as pt
    # no kernel of the port is on this path (the PINO convs are 3-D, the
    # residuals and the solver torch FFTs): none may launch over the phase
    zero_counts()
    pcfg = load_yaml(os.path.join(here, "configs",
                                  "pino-observer-pretrain-1s.yaml"))
    S, T_kf = int(pcfg.data.pde_res[0]), int(pcfg.data.pde_res[2])
    n_kf = 8
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kf = KFDataset.generate(n_kf, S, T_kf, re=float(pcfg.data.Re),
                                save_path=os.path.join(tmp, "kf.npy"),
                                seed=0, device=dev)
        gen_s = time.perf_counter() - t0
    u_kf, a_kf, re_kf = kf.arrays(device=dev)
    log(f"{elapsed()} PINO: {n_kf} Kolmogorov-flow trajectories "
        f"{S}x{S}x{T_kf} (Re {pcfg.data.Re:g}) generated in {gen_s:.1f} s; "
        f"|w| mean {float(u_kf.abs().mean()):.4f}")
    if not (torch.isfinite(u_kf).all() and tuple(u_kf.shape)
            == (n_kf, S, S, T_kf)):
        raise AssertionError("PINO: non-finite or misshapen trajectories")
    pino = dict(generate_seconds=gen_s)

    # the card's FFT routes against the CPU's in float64 on the same
    # float32 input: cuFFT's C2R is undefined for a spectrum that is not
    # Hermitian (the residuals' `1j * k * f_h`, a spectral layer's corners)
    # and pocketfft's rule is the reference's.  A rule that differed would
    # part them by O(1); the limits allow float32 rounding, which the NS
    # residual amplifies (its terms cancel to the truncation error of a
    # central time difference)
    w = u_kf[:2]
    check("PINO: fdm_ns_vorticity, card against CPU float64",
          rel(pde_losses.fdm_ns_vorticity(w, 1.0 / re_kf[:2]).cpu(),
              pde_losses.fdm_ns_vorticity(w.double().cpu(),
                                          1.0 / re_kf[:2].double().cpu())),
          1e-3)
    gb = torch.Generator(device=dev).manual_seed(3)
    ub = torch.randn((4, 16, 128), generator=gb, device=dev)
    check("PINO: fdm_burgers, card against CPU float64",
          rel(pde_losses.fdm_burgers(ub, 0.01).cpu(),
              pde_losses.fdm_burgers(ub.double().cpu(), 0.01)), 1e-4)
    gw = torch.Generator(device=dev).manual_seed(4)
    model_kf = tp.build_model(pcfg.model, dev, gw)
    layer = model_kf.trunk.sp0
    x_in = torch.randn((1, S, S, T_kf, 4), generator=gw, device=dev)
    x_ft = fourier.rfftn(x_in, axes=(1, 2, 3))
    w4 = [{"mm2": getattr(layer, f"w{i}").mm2[..., :4, :4]}
          for i in range(4)]
    out_ft = sc.spectral_corners_plain(x_ft, w4, layer.modes)
    check("PINO: one trunk layer's irfftn (8^3 x 4 corners, 4 channels), "
          "card against CPU float64",
          rel(fourier.irfftn(out_ft, (S, S, T_kf), (1, 2, 3)).cpu(),
              fourier.irfftn(out_ft.cpu().to(torch.complex128),
                             (S, S, T_kf), (1, 2, 3))), 1e-5)
    forcing = pde_losses.get_forcing(S, device=dev)

    def batch_grads(model, accum):
        """The gradient of one batch of 4 as train_ns takes it with
        `accum` micro-batches."""
        model.zero_grad(set_to_none=True)
        for ib in torch.arange(4, device=dev).reshape(accum, -1):
            (pt.ns_losses(model, a_kf[ib], u_kf[ib], re_kf[ib], forcing)[0]
             / accum).backward()
        return [p.grad.detach().clone() for p in model.parameters()]

    def flat(gs):
        return torch.cat([g.reshape(-1) for g in gs])

    g_acc = batch_grads(model_kf, 4)
    torch.cuda.reset_peak_memory_stats()
    model_kf.trunk.remat = False
    g_full = batch_grads(model_kf, 1)
    peak_full = torch.cuda.max_memory_allocated() / 2 ** 30
    g_noremat = batch_grads(model_kf, 4)
    model_kf.trunk.remat = True
    check("PINO: gradient of a batch of 4, 4 micro-batches against one "
          "pass", rel(flat(g_acc), flat(g_full)), 1e-5)
    # per parameter the two float32 gradients part where a tensor's
    # gradient is a sum that cancels (f32 rounding over ~4M points), so
    # each is held against float64: on its worst parameter accumulation
    # is to be no further from float64 than one pass is, within 2x
    m64 = copy.deepcopy(model_kf).double()
    a_kf, u_kf, re_kf = (x.double() for x in (a_kf, u_kf, re_kf))
    forcing = forcing.double()
    g64 = batch_grads(m64, 4)
    a_kf, u_kf, re_kf = (x.float() for x in (a_kf, u_kf, re_kf))
    forcing = forcing.float()
    del m64
    worst = [max(rel(a, b) for a, b in zip(g, g64))
             for g in (g_acc, g_full)]
    log(f"  PINO: worst parameter's gradient from float64: 4 micro-batches "
        f"{worst[0]:.3e}, one pass {worst[1]:.3e}; from each other "
        f"{max(rel(a, b) for a, b in zip(g_acc, g_full)):.3e}")
    check("PINO: the same, worst parameter: distance from float64, "
          "4 micro-batches over one pass", worst[0] / worst[1], 2.0)
    del g64
    check("PINO: gradient, remat against no remat",
          rel(flat(g_acc), flat(g_noremat)), 1e-6)
    # two train_ns iterations from the same weights and batches: the loss
    # parts of the first, and of the second, which reads the first update.
    # Adam's first step moves an entry by about lr whatever its gradient's
    # size, so an entry whose gradient is near zero may step either way
    # with the last bit; such an entry moves the loss by next to nothing,
    # which makes the losses after the step the measure of the update
    hists = []
    for accum in (4, 1):
        m = tp.build_model(pcfg.model, dev,
                           torch.Generator(device=dev).manual_seed(4))
        h = pt.train_ns(m, (u_kf[:4], a_kf[:4], re_kf[:4]), iterations=2,
                        batch_size=4, accum_steps=accum, verbose=False,
                        generator=torch.Generator(device=dev).manual_seed(5),
                        learning_rate=1e-3, milestones=[25, 50, 75, 100])
        hists.append(torch.tensor([h[k] for k in ("total", "data", "ic",
                                                  "f")]))
    check("PINO: train_ns, accum_steps 4 against one pass: the loss parts "
          "of the first iteration", rel(hists[0][:, 0], hists[1][:, 0]),
          1e-6)
    check("PINO: the same, after one update", rel(hists[0][:, 1],
                                                  hists[1][:, 1]), 1e-5)
    del g_acc, g_full, g_noremat, m

    # full width as configured (batch 4 as 4 remat micro-batches), and the
    # bf16 config; ms per iteration, peak memory, busy share, launches
    tcfg = pcfg.train
    for tag, dtype in (("f32", None), ("bf16", "bf16")):
        m = tp.build_model(pcfg.model, dev,
                           torch.Generator(device=dev).manual_seed(4))
        opt, sched = pt.make_optimizer(m, float(tcfg.base_lr),
                                       tcfg.milestones,
                                       float(tcfg.scheduler_gamma))
        data = (u_kf, a_kf, re_kf)

        def iters(k, m=m, opt=opt, sched=sched, dtype=dtype):
            return pt.train_ns(
                m, data, iterations=k, batch_size=int(tcfg.batchsize),
                accum_steps=int(tcfg.accum_steps), compute_dtype=dtype,
                optimizer=opt, scheduler=sched, log_interval=k,
                verbose=False)
        iters(2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n_it = 10
        t0 = time.perf_counter()
        hist = iters(n_it)
        torch.cuda.synchronize()
        ms_it = 1e3 * (time.perf_counter() - t0) / n_it
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ev = device_events(lambda: iters(3))
        dev_ms = sum(t for _, t in ev.values()) / 1e3 / 3
        launches_it = sum(n for n, _ in ev.values()) / 3
        if not np.isfinite(hist["total"]).all():
            FAILED.append(f"PINO {tag}: non-finite loss {hist['total']}")
        log(f"  full width {tag}: {ms_it:.2f} ms an iteration (batch 4 as "
            f"4 remat micro-batches), device {dev_ms:.2f} ms, busy "
            f"{dev_ms / ms_it:.1%}, {launches_it:.0f} launches an iteration, "
            f"peak {peak:.2f} GiB (a batch of 4 in one pass, no remat: "
            f"{peak_full:.2f} GiB); loss {hist['total'][0]:.4f} -> "
            f"{hist['total'][-1]:.4f}  ({smi})")
        pino[tag] = dict(ms_per_iter=ms_it, device_ms=dev_ms,
                         busy=dev_ms / ms_it, launches_per_iter=launches_it,
                         peak_gib=peak, loss=hist["total"])
        del m, opt, sched
    pino["peak_gib_batch4_one_pass"] = peak_full

    # a reduced size: one iteration on the card against the CPU in float64
    # from the same weights and the same batch (the whole set, so that the
    # two generators' orders do not matter)
    small = dict(layers=[8, 8, 8], modes1=[4, 4], modes2=[4, 4],
                 modes3=[3, 3], fc_dim=16)
    kf_small = KFDataset(u=kf.u[:2, ::4, ::4, ::8], a=kf.a[:2, ::4, ::4, ::8],
                         re=kf.re[:2])
    m_c = tp.build_model(small, dev,
                         torch.Generator(device=dev).manual_seed(6))
    m_p = tp.build_model(small, "cpu").double()
    m_p.load_state_dict({k: v.double().cpu()
                         for k, v in m_c.state_dict().items()})
    sets = {m_c: kf_small.arrays(torch.float32, dev),
            m_p: kf_small.arrays(torch.float64, "cpu")}
    parts = ("total", "data", "ic", "f")
    grads = []
    for m, (u_s, a_s, re_s) in sets.items():
        f_s = pde_losses.get_forcing(u_s.shape[1], device=u_s.device,
                                     dtype=u_s.dtype)
        m.zero_grad(set_to_none=True)
        pt.ns_losses(m, a_s, u_s, re_s, f_s)[0].backward()
        grads.append(flat([p.grad.cpu() for p in m.parameters()]))
    check("PINO reduced size: the gradient of one batch, card against CPU "
          "float64", rel(*grads), 1e-4)
    h_c, h_p = (pt.train_ns(m, d, iterations=2, batch_size=2, verbose=False)
                for m, d in sets.items())
    for it, tol in ((0, 1e-5), (1, 1e-5)):
        check(f"PINO reduced size: train_ns iteration {it + 1}'s loss "
              "parts, card against CPU float64", rel(
                  torch.tensor([h_c[k][it] for k in parts]),
                  torch.tensor([h_p[k][it] for k in parts])), tol)
    # the solver itself: 64 steps at 64x64, card against CPU float64
    w0 = u_kf[:2, ::2, ::2, 0]
    fk = pde_losses.get_forcing(64, device=dev)[0, :, :, 0]
    check("PINO: ns_vorticity_rollout, 64 steps at 64x64, card against CPU"
          " float64", rel(ns_vorticity_rollout(w0, fk, 1 / 400.0, 1e-3, 64,
                                               32).cpu(),
                          ns_vorticity_rollout(w0.double().cpu(),
                                               fk.double().cpu(), 1 / 400.0,
                                               1e-3, 64, 32)), 1e-5)
    got = (*corner_counts(), *(fn.launches for fn in every.values()))
    if any(got):
        FAILED.append(f"PINO: a kernel of the port launched on its path: "
                      f"{got}")
    log("  pino " + json.dumps(pino))
    del model_kf, kf, u_kf, a_kf, re_kf, data
    torch.cuda.empty_cache()

    # 11. DDPG on the channel DNS (main_ddpg --channel) ---------------------
    from pde_policylearning_torch.control.ddpg import (
        draw_channel_noise, train_ddpg_channel_on_device)
    warm_n, train_n = 256, 512
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env = fresh_env()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, met = train_ddpg_channel_on_device(n_steps=train_n, warmup=warm_n,
                                          env=env, verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ddpg_launches = {k: fn.launches for k, fn in kernels.items()}
    n_env = warm_n + train_n
    for k in ("warmup_shear", "shear", "critic_loss", "actor_loss"):
        if not np.isfinite(met[k]).all():
            FAILED.append(f"DDPG: non-finite {k}")
    if ddpg_launches["rk3_fullstep"] != n_env:
        FAILED.append(f"DDPG: kernel D launched "
                      f"{ddpg_launches['rk3_fullstep']} times for {n_env} "
                      "env steps")
    for k, v in ddpg_launches.items():
        if v <= 0:
            FAILED.append(f"DDPG: kernel {k} not launched on the path")
    per_step, counts = launches_per_step(
        lambda k: train_ddpg_channel_on_device(
            n_steps=k, warmup=16, env=env, verbose=False))
    ev = device_events(lambda: train_ddpg_channel_on_device(
        n_steps=64, warmup=16, env=env, verbose=False))
    t1 = time.perf_counter()
    train_ddpg_channel_on_device(n_steps=64, warmup=16, env=env,
                                 verbose=False)
    torch.cuda.synchronize()
    busy = sum(t for _, t in ev.values()) / 1e6 / (time.perf_counter() - t1)
    log(f"{elapsed()} DDPG: env built in {build_s:.1f} s; {warm_n} warm-up "
        f"+ {train_n} training steps at the --channel defaults in "
        f"{dt:.1f} s, {n_env / dt:.2f} env steps/s ({smi}); device "
        f"launches per training step {per_step} (runs of 20 and 40: "
        f"{counts}), busy {busy:.1%} over 80 steps; kernel launches "
        f"{ddpg_launches}; shear warm-up {met['warmup_shear'].mean():.6e}, "
        f"training {met['shear'].mean():.6e}")
    # kernel D against the plain env step along the path: the same draws,
    # networks and state, 20 warm-up steps and 4 training steps
    gd = torch.Generator(device=dev).manual_seed(11)
    draws = draw_channel_noise(20, 4, Nx * Nz, 64, gd)
    from pde_policylearning_torch.control.ddpg import Actor, Critic
    nets = (Actor(Nx * Nz, Nx * Nz, 0.01, generator=gd, device=dev),
            Critic(Nx * Nz, Nx * Nz, generator=gd, device=dev))
    pair = []
    for plain in (False, True):
        e = fresh_env()
        if plain:
            rk.env_step_full_kb_kernel = rk.env_step_full_kb_plain
        try:
            _, m_ = train_ddpg_channel_on_device(
                n_steps=4, warmup=20, env=e, draws=draws, verbose=False,
                actor=copy.deepcopy(nets[0]), critic=copy.deepcopy(nets[1]))
        finally:
            rk.env_step_full_kb_kernel = kernel_d
        pair.append((m_, e))
    (m_k, e_k), (m_p, e_p) = pair
    # the 20 warm-up steps take no update: the env alone (phase 3's
    # 50-step limits of kernel D against plain); the updates that follow
    # amplify float32 rounding through Adam's first steps
    check("DDPG: 20 warm-up steps, kernel D against the plain env step: "
          "shear", rel(torch.as_tensor(m_k["warmup_shear"]),
                       torch.as_tensor(m_p["warmup_shear"])), 1e-5)
    check("DDPG: 4 training steps after them: shear", rel(
        torch.as_tensor(m_k["shear"]), torch.as_tensor(m_p["shear"])), 1e-4)
    check("DDPG: the state after them: U", rel(e_k.state.U, e_p.state.U),
          1e-5)
    check("DDPG: the state after them: p2", rel(
        torch.as_tensor(m_k["p2"]), torch.as_tensor(m_p["p2"])), 5e-4)
    ddpg = dict(env_steps_per_s=n_env / dt, seconds=dt,
                launches_per_step=per_step, busy=busy,
                kernel_launches=ddpg_launches,
                warmup_shear=float(met["warmup_shear"].mean()),
                shear=float(met["shear"].mean()))
    log("  ddpg " + json.dumps(ddpg))

    # 13. the rest of the zoo and the 2-D channel.  It runs before phase 12:
    # once this process has had an NCCL process group, torch.profiler sees
    # no kernel of the card here (an H100 run read none), and phase 13
    # reads device times by the profiler
    zoo = zoo_phase(dev, smi, dict(
        zero_counts=zero_counts, corner_counts=corner_counts, bound=bound,
        spec_work=spec_work, spec_inputs=spec_inputs, cre=cre))

    # 14. DINo end to end and the last ops, data and utils; before phase 12
    # for the same reason as phase 13
    def port_launches():
        return sum(fn.launches for fn in every.values()) \
            + sum(corner_counts())
    dino = dino_phase(dev, smi, port_launches)
    log("  dino " + json.dumps({k: v for k, v in dino.items()
                                if k != "decode"}))

    # 15. the drag study's tool and the spin-up tool; before phase 12 for
    # the same reason as phase 13 (the spin-up is profiled)
    study = study_phase(dev, smi, dict(zero_counts=zero_counts,
                                       corner_counts=corner_counts,
                                       every=every))

    # 12. the parallel layer on NCCL at world size 1 ------------------------
    # One card takes one NCCL rank: the layer's multi-rank logic is held by
    # the gloo tests on the CPU; here its collectives run at world size 1
    # in this process, and the dry run in ranks of its own.
    import torch.distributed as dist

    from pde_policylearning_torch import parallel as par
    from pde_policylearning_torch.models import FNO
    from pde_policylearning_torch.training import Trainer
    t_par = time.perf_counter()
    rdv = tempfile.mkdtemp()
    par.init_distributed(f"file://{os.path.join(rdv, 'rendezvous')}", 1, 0,
                         device=dev)
    try:
        mesh = par.make_mesh(1)
        log(f"{elapsed()} parallel layer: backend {mesh.backend}, world "
            f"{mesh.world_size}, dp {mesh.dp} x mp {mesh.mp}, {mesh.device}")
        if (mesh.backend, mesh.world_size, mesh.device.type) != \
                ("nccl", 1, "cuda"):
            FAILED.append(f"parallel: the mesh is {mesh}, not NCCL at world "
                          "size 1 on the card")
        # data_parallel_rollout against batched_rollout, through kernel D
        # and through the staged kernels: bit for bit, exact launches
        Bd, Td = 8, 500
        expect_dp = {True: {"rk3_fullstep": Td},
                     False: {"rk3_substage": 3 * Td,
                             "rk3_solve_correct": 3 * Td,
                             "boundary_batched": Td}}
        dp_launches, dp_corner, dp_rates = {}, {}, {}
        for fullstep in (True, False):
            rk.FULLSTEP = fullstep
            gen = torch.Generator(device=dev)
            gen.manual_seed(12)
            states0 = cf.init_batched_states(grid, Bd, gen)

            def batched():
                return cf.batched_rollout(grid, states0, Td, detect_plane=dp)

            def data_parallel():
                return par.data_parallel_rollout(mesh, grid, states0, Td,
                                                 detect_plane=dp)
            runs = {}
            for name, fn in (("batched_rollout", batched),
                             ("data_parallel_rollout", data_parallel),
                             ("data_parallel_rollout again", data_parallel),
                             ("batched_rollout again", batched)):
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                s_, o_ = fn()
                torch.cuda.synchronize()
                runs[name] = (Bd * Td / (time.perf_counter() - t0),
                              (s_.U, s_.V, s_.W, s_.dPdx, *o_),
                              {k: f.launches for k, f in every.items()},
                              corner_counts())
            tag = "kernel D" if fullstep else "staged A+B+C"
            want = {k: expect_dp[fullstep].get(k, 0) for k in every}
            for name, (_, _, counts, corners) in runs.items():
                if counts != want or any(corners):
                    FAILED.append(f"parallel, {tag}: {name} launched "
                                  f"{counts} and corner entries {corners}, "
                                  f"expected {want} and none")
            ref = runs["batched_rollout"][1]
            for name in ("data_parallel_rollout",
                         "data_parallel_rollout again"):
                if not all(torch.equal(a, b)
                           for a, b in zip(runs[name][1], ref)):
                    FAILED.append(f"parallel, {tag}: {name} is not "
                                  "batched_rollout bit for bit")
            dp_launches[fullstep] = runs["data_parallel_rollout"][2]
            dp_corner[fullstep] = runs["data_parallel_rollout"][3]
            dp_rates[tag] = {name: r[0] for name, r in runs.items()}
            log(f"  {tag}: {Bd} envs x {Td} gt steps, env-steps/s "
                + ", ".join(f"{k} {v:.2f}" for k, v in dp_rates[tag].items())
                + f"; launches {dp_launches[fullstep]}  ({smi})")
        rk.FULLSTEP = True

        # Trainer(mesh) against Trainer() from the same parameters: the
        # base_fno budget's observer and batch on 400 planes, one epoch
        gen = torch.Generator(device=dev)
        gen.manual_seed(13)
        xs = torch.randn((420, Nx, Nz, 1), generator=gen, device=dev)
        ys = 0.5 * xs + 0.1 * torch.randn(xs.shape, generator=gen, device=dev)
        tr_d, te_d = (xs[:400], ys[:400]), (xs[400:], ys[400:])
        base = FNO2dObserver(12, 12, 32, generator=gen, device=dev)
        dp_train = {}
        for name, kw in (("Trainer()", {}), ("Trainer(mesh)", dict(mesh=mesh)),
                         ("Trainer(mesh) again", dict(mesh=mesh)),
                         ("Trainer() again", {})):
            m = copy.deepcopy(base)
            trainer = Trainer(m, n_epochs=1, batch_size=20, verbose=False,
                              **kw)
            # the run's training steps (one forward with the gradient on
            # each) and the forward entry's launches in them, read by
            # hooks on the model
            tally = dict(steps=0, train_forward=0, at=0)

            def before(*_):
                tally["at"] = corner_counts()[0]

            def after(*_):
                if torch.is_grad_enabled():
                    tally["steps"] += 1
                    tally["train_forward"] += corner_counts()[0] - tally["at"]
            hooks = (m.register_forward_pre_hook(before),
                     m.register_forward_hook(after))
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            trainer.train(tr_d, te_d)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            for h in hooks:
                h.remove()
            dp_train[name] = (1e3 * dt / tally["steps"], m, corner_counts(),
                              {k: f.launches for k, f in every.items()},
                              tally)
        worst = max(rel(a, b) for a, b in zip(
            dp_train["Trainer(mesh)"][1].parameters(),
            dp_train["Trainer()"][1].parameters()))
        check("parallel: Trainer(mesh) at world size 1 against Trainer(), "
              "one epoch of FNO2dObserver(12, 12, 32) at batch 20: worst "
              "parameter", worst, 1e-6)
        want = (20 * 4 + 4, 20 * 4, 0, 20 * 4)
        for name, (_, _, got, env, tally) in dp_train.items():
            if got != want or any(env.values()) or tally["steps"] != 20:
                FAILED.append(f"parallel: {name} corner launches (forward, "
                              f"adjoint, strided, dw) {got}, expected {want}; "
                              f"env kernels {env}, expected none; "
                              f"{tally['steps']} training steps, expected 20")
        got, _, tally = dp_train["Trainer(mesh)"][2:]
        dp_per_step = (tally["train_forward"] / tally["steps"],
                       *(n / tally["steps"] for n in got[1:]))
        m = dp_train["Trainer(mesh)"][1]
        (m(xs[:20]) ** 2).mean().backward()
        params = list(m.parameters())
        allreduce_ms = cuda_ms(lambda: par.all_reduce_gradients(mesh, params))
        dp_training = {k: v[0] for k, v in dp_train.items()}
        log(f"  Trainer: ms a training step (one evaluation batch an epoch "
            f"included) {json.dumps(dp_training)}; the gradient all-reduce "
            f"alone {allreduce_ms:.4f} ms ({sum(p.numel() for p in params)} "
            f"parameters); corner launches (forward, adjoint, strided, dw) "
            "an "
            f"epoch {dp_train['Trainer(mesh)'][2]}, a training step "
            f"{dp_per_step} over {tally['steps']} training steps  ({smi})")

        # the patched training step: levels 1, padding 0.25, 32x32 planes
        # -> 4 patches of 32x32 a plane with the coarse context channel
        patcher = par.MultigridPatching2D(1, 0.25, mesh)
        pm = FNO((12, 12), 32, in_channels=2, out_channels=1, generator=gen,
                 device=dev)
        zero_counts()
        _, ph = Trainer(pm, n_epochs=1, batch_size=20, verbose=False,
                        patcher=patcher, mesh=mesh).train(
            (xs[:40], ys[:40]), te_d)
        torch.cuda.synchronize()
        patched = corner_counts()
        if patched != (3 * 4, 2 * 4, 0, 2 * 4) or not np.isfinite(
                ph["train_loss"] + ph["test_loss"]).all():
            FAILED.append(f"parallel: the patched Trainer launched {patched} "
                          f"corner entries, losses {ph}")
        pshape = (80, 32, 17, 32, 32, 12, 12)
        x_ft, d_ft, ws = spec_inputs(*pshape, False)
        views = sc._dense_views(ws)
        out = sc.spectral_corners_kernel(x_ft, *views)
        dx = sc.spectral_corners_kernel(d_ft, *views, adjoint=True)
        torch.cuda.synchronize()
        check("parallel: fused corners at the patch shape (80 patches, 32 x "
              "17 spectrum, 32 -> 32, 12 x 12): forward",
              rel(cre(out), cre(sc.spectral_corners_plain(x_ft, ws,
                                                          pshape[5:]))), 2e-6)
        check("parallel: fused corners at the patch shape: dx (adjoint)",
              rel(cre(dx), cre(sc.spectral_corners_plain(
                  d_ft, [sc._adjoint_weight(v) for v in views],
                  pshape[5:]))), 2e-6)
        for nm, a, b in zip(("dx", "dw low", "dw high"),
                            spec_grads(sc.spectral_corners, x_ft, ws,
                                       pshape[5:]),
                            spec_grads(sc.spectral_corners_plain, x_ft, ws,
                                       pshape[5:])):
            check(f"parallel: fused corners at the patch shape: {nm} "
                  "through the Function", rel(cre(a), cre(b)), 2e-6)
        log(f"  patched Trainer: corner launches (forward, adjoint, strided, "
            "dw) "
            f"{patched} over 2 steps and 1 evaluation batch; losses {ph}")

        # the x-sharded step at the full grid against the unsharded step
        st = cf.init_state(grid, U=snap["U"], V=snap["V"], W=snap["W"],
                           dPdx=float(snap["dPdx"]))
        ops = 0.01 * torch.randn((2, Nx, Nz), generator=gen, device=dev)
        ops = ops - ops.mean(dim=(1, 2), keepdim=True)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        sh = par.sharded_step(mesh, grid, par.shard_env_state(mesh, st),
                              ops[0], ops[1])
        torch.cuda.synchronize()
        sh_ms = 1e3 * (time.perf_counter() - t0)
        if any(f.launches for f in every.values()) or any(corner_counts()):
            FAILED.append("parallel: the x-sharded step launched a kernel "
                          "of the port")
        # kernel D's one-step limits against `_rk3_step_unfused` on the
        # card; dPdx amplifies the bulk velocity's rounding by 2 / dt, so
        # it takes kernel D's dPdx limit (5e-3), and is held again against
        # the float64 step on the CPU at that limit
        ref = cf._rk3_step_unfused(grid, st, ops[0], ops[1])
        g64 = cf.make_channel_grid(Nx, Ny, Nz, device="cpu",
                                   dtype=torch.float64)
        ref64 = cf._rk3_step_unfused(
            g64, cf.ChannelState(**{k: getattr(st, k).double().cpu()
                                    for k in ("U", "V", "W", "dPdx",
                                              "meanU0")}),
            ops[0].double().cpu(), ops[1].double().cpu())
        for nm, tol in (("U", 2e-6), ("V", 2e-5), ("W", 2e-5),
                        ("dPdx", 5e-3)):
            check(f"parallel: sharded_step at {Nx}x{Ny}x{Nz} against "
                  f"_rk3_step_unfused on the card: {nm}",
                  rel(getattr(sh, nm), getattr(ref, nm)), tol)
        check("parallel: sharded_step's dPdx against the float64 step",
              rel(sh.dPdx.cpu(), ref64.dPdx), 5e-3)
        log(f"  sharded_step: {sh_ms:.1f} ms (first call); against "
            f"_rk3_step_unfused: " + ", ".join(
                f"{nm} {rel(getattr(sh, nm), getattr(ref, nm)):.3e}"
                for nm in ("U", "V", "W", "dPdx"))
            + "; from the float64 step (the unfused float32 step's in "
            "brackets): " + ", ".join(
                f"{nm} {rel(getattr(sh, nm).cpu(), getattr(ref64, nm)):.3e} "
                f"({rel(getattr(ref, nm).cpu(), getattr(ref64, nm)):.3e})"
                for nm in ("U", "V", "W", "dPdx")))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    # the dry run on its own NCCL rank (the card's count: 1)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "pde_policylearning_torch.parallel.dryrun",
         "--devices", "1"], capture_output=True, text=True, timeout=420,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    dry = None
    if run.returncode == 0:
        dry = json.loads(run.stdout.strip().splitlines()[-1])
    if dry is None or (dry["backend"], dry["world"], dry["device"]) != \
            ("nccl", 1, "cuda:0"):
        FAILED.append(f"parallel: dryrun --devices 1 failed (rc "
                      f"{run.returncode}): {run.stdout[-2000:]} "
                      f"{run.stderr[-2000:]}")
    log(f"  dryrun --devices 1: {time.perf_counter() - t0:.1f} s, {dry}")
    log(f"{elapsed()} parallel layer: {time.perf_counter() - t_par:.1f} s")
    parallel = dict(rates=dp_rates, training_ms_per_step=dp_training,
                    allreduce_ms=allreduce_ms, sharded_step_ms=sh_ms,
                    dryrun=dry)
    log("  parallel " + json.dumps(parallel))

    log(f"{elapsed()} profiler: {SHORT_READINGS[1]} of {SHORT_READINGS[0]} "
        "readings "
        "short of the most complete reading of their call")
    if FAILED:
        raise AssertionError("failed checks: " + "; ".join(FAILED))
    for k, v in {**launches, **staged_launches,
                 "corner_contract": policy_runs["fno"]}.items():
        report[k]["launches"] = v
    report["corner_contract"]["launches_optimal_observer"] = \
        policy_runs["optimal-observer"]
    report["corner_contract"]["launches_rno"] = loop_runs["rno"]
    report["corner_contract"]["launches_transformer"] = \
        loop_runs["transformer"]
    for k, v in flagship_launches.items():
        report[k]["launches_flagship"] = v
    for k, v in ddpg_launches.items():
        report[k]["launches_ddpg"] = v
    for k in every:
        # over the two data-parallel rollouts (kernel D, then staged), and
        # over the Trainer(mesh) epoch
        report[k]["launches_data_parallel"] = sum(
            c[k] for c in dp_launches.values())
        report[k]["launches_dp_training"] = dp_train["Trainer(mesh)"][3][k]
    entries = ("forward", "adjoint", "strided", "dw")
    report["corner_contract"]["launches_data_parallel"] = dict(
        zip(entries, map(sum, zip(*dp_corner.values()))))
    report["corner_contract"]["launches_dp_training"] = dict(
        zip(entries, dp_train["Trainer(mesh)"][2]),
        per_training_step=dp_per_step,
        steps=dp_train["Trainer(mesh)"][4]["steps"])
    # phase 15: the study's five rows (200 staged steps each) and the
    # spin-up's 50 steps, read in the run
    for k in every:
        report[k]["launches_drag_study"] = study["launches_drag_study"][k]
        report[k]["launches_spinup"] = study["launches_spinup"][k]
    report["corner_contract"]["launches_drag_study"] = dict(
        zip(entries, study["launches_drag_study"]["corner"]))
    report["corner_contract"]["launches_training"] = {
        k: {n: v[n] for n in (*entries, "per_training_step", "steps")}
        for k, v in trained.items()}
    # the weight-gradient entry on the training paths: phase 8's three
    # configs (the kernels line's count), Trainer(mesh), the dense UNO
    report["corner_dw"].update(
        launches=sum(v["dw"] for v in trained.values()),
        launches_training={k: v["dw"] for k, v in trained.items()},
        launches_dp_training=dp_train["Trainer(mesh)"][2][3],
        launches_uno_forward_backward=zoo["uno"]["training"][3])
    # phase 13: the dense UNO (a forward, a forward and backward), the
    # Tucker UNO (forward and backward), the graph transformers (a forward),
    # read in the run; the entry at each UNO block's shape
    report["corner_contract"]["launches_zoo"] = dict(
        uno_dense_forward=zoo["uno"]["forward"],
        uno_dense_per_block=zoo["uno"]["per_block"],
        uno_dense_forward_backward=zoo["uno"]["training"],
        uno_tucker=zoo["uno"]["tucker"],
        **{f"transformer_{k}": v["launches"]
           for k, v in zoo["graph"].items()})
    report["corner_contract"]["uno_shapes"] = zoo["uno"]["per_shape"]
    print(json.dumps({"kernels": [report[k] for k in
                                  (*every, "corner_contract", "corner_dw",
                                   "fused_adam")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
