"""Closed-loop control entry of the port.

Counterpart of the repository's `run_control.py` (reference:
run_control.py:26, run_control): runs a control policy against the
channel-flow DNS env and reports the drag-reduction scoreboard.

    python -m pde_policylearning_torch.run_control \\
        --control_yaml configs/base_control.yaml [--policy_name gt] \\
        [--device cpu]

It reads `configs/base_control.yaml` as it is and builds the policies
the repository's `run_control.py` builds from it: `unmanipulated`, `gt`,
`rand`, and the observer policies `fno`, `rno`, `transformer` and
`optimal-observer` (the observer
from `model_checkpoint`, a checkpoint of the port's `run_pde_observers`,
or seeded weights where there is none; the normalizers of the first 100
planes of `DATA_FOLDER`).  With `collect_data` the run's planes are
written in the trainable format.  With `env_name: NSControlEnv2D` it runs
the 2-D channel env (`run_control_2d`) instead.  It runs on the card
unless `--device` names another.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import models
from .control import make_policy, run_closed_loop
from .control.loop import save_collected_dataset
from .data import PDEDataset
from .envs import NSControlEnv, NSControlEnv2D
from .training import load_checkpoint
from .utils import (default_parser, load_yaml, merge_args_with_yaml,
                    resolve_device)

OBSERVER_POLICIES = ("fno", "rno", "transformer", "optimal-observer")


def run_control(args, observer_model=None, train_dataset=None, device=None):
    """Run `args.policy_name` on a fresh `NSControlEnv` on `device` (None:
    `args.device`, else the card); `observer_model` holds its own
    parameters.  Returns `run_closed_loop`'s result."""
    device = resolve_device(device if device is not None
                            else args.get("device"))
    if args.get("env_name", "NSControlEnvMatlab") == "NSControlEnv2D":
        return run_control_2d(args, device)
    env = NSControlEnv(
        Re=float(args.get("Re", -1)),
        detect_plane=int(args.get("detect_plane", 25)),
        test_plane=int(args.get("test_plane", 124)),
        noise_scale=float(args.get("init_noise_scale", 0.05)),
        seed=int(args.get("seed", 0)),
        spinup_steps=int(args.get("spinup_steps", 0)), device=device)
    print("Environment is initialized!", flush=True)

    policy_name = args.policy_name
    pkw = {}
    if policy_name in ("fno", "rno", "transformer") \
            and train_dataset is not None:
        pkw = {"model": observer_model, "p_norm": train_dataset.p_norm,
               "v_norm": train_dataset.v_norm,
               "model_timestep": int(args.get("model_timestep", 1)),
               "action_scale": float(args.get("action_scale", 0.3)),
               "action_clip": args.get("action_clip", 0.01)}
    elif policy_name == "optimal-observer":
        # the gradient goes to the action alone
        observer_model.requires_grad_(False)
        pkw = {"model": observer_model,
               "bound_v_norm": getattr(train_dataset, "bound_v_norm", None),
               "opt_steps": int(args.get("opt_steps", 10))}
    policy_fn = make_policy(
        policy_name, env.grid,
        detect_plane=int(args.get("detect_plane", 25)),
        rand_scale=float(args.get("rand_scale", 1.0)), **pkw)

    result = run_closed_loop(
        env, policy_fn,
        n_steps=int(args.get("control_timestep", 2000)),
        log_interval=int(args.get("log_interval", 200)),
        collect_planes=bool(args.get("collect_data", False)),
        detect_plane=int(args.get("detect_plane", 25)),
        seed=int(args.get("seed", 0)))

    series = result["series"]
    ss = series["drag_reduction/1_shear_stress"]
    rel = series.get("drag_reduction_relative/1_shear_stress")
    print(f"Final shear stress: {ss[-1]:.6f} (initial {ss[0]:.6f})")
    if rel is not None:
        print(f"Relative shear stress vs init: {rel[-1]:.4f}")

    if args.get("collect_data", False):
        out_dir = os.path.join(args.get("output_dir", "./outputs"),
                               args.get("exp_name", "control"))
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, "control_series.npz"), **series)
        np.save(os.path.join(out_dir, "opV2.npy"), result["opV2"])
        save_collected_dataset(result, out_dir)
        print(f"Collected data saved under {out_dir} "
              "(trainable P_planes/V_planes + metadata)")
    return result


def run_control_2d(args, device=None):
    """The 2-D env's control loop (run_control.py:86-110): `gt` (the
    opposition control) or no actuation, `control_timestep` steps (100 by
    default).  Returns {"series": {key: array over the steps}}."""
    env = NSControlEnv2D(
        detect_plane=int(args.get("detect_plane", -10)),
        bc_type=args.get("bc_type", "original"),
        Re=float(args.get("Re", 100.0)) if float(args.get("Re", -1)) > 0
        else 100.0,
        fix_flow=bool(args.get("fix_flow", False)),
        device=resolve_device(device))
    n_steps = int(args.get("control_timestep", 100))
    policy = args.get("policy_name", "unmanipulated")
    series = []
    for i in range(n_steps):
        bc = env.gt_control() if policy == "gt" else None
        _, _, _, info = env.step(bc)
        series.append(info)
        if (i + 1) % max(1, n_steps // 5) == 0:
            print(f"step {i + 1}/{n_steps}: shear "
                  f"{info['drag_reduction/1_shear_stress']:.5f}", flush=True)
    return {"series": {k: np.asarray([s[k] for s in series])
                       for k in series[0]}}


def build_observer(args, device=None, generator=None):
    """The observer that `args.policy_name` serves (run_control.py's
    dispatch): `FNO2dObserver` for `fno` and `optimal-observer`, the
    transformer, or the RNO, with its config's widths."""
    kw = dict(device=device, generator=generator)
    if args.policy_name in ("fno", "optimal-observer"):
        return models.FNO2dObserver(modes1=args.modes, modes2=args.modes,
                                    width=args.width, **kw)
    if args.policy_name == "transformer":
        return models.SimpleTransformer(
            n_hidden=int(args.get("n_hidden", 96)),
            n_head=int(args.get("n_head", 2)),
            attention_type=args.get("attention_type", "fourier"),
            freq_dim=int(args.get("freq_dim", 48)),
            fourier_modes=int(args.get("modes", 12)), **kw)
    return models.RNO2dObserver(modes1=args.modes, modes2=args.modes,
                                width=args.width,
                                layer_num=int(args.get("layer_num", 1)),
                                **kw)


def main(argv=None):
    parser = default_parser()
    parser.add_argument("--policy_name", type=str, default=None)
    cli = parser.parse_args(argv)
    args = merge_args_with_yaml(cli, load_yaml(cli.control_yaml))
    if cli.policy_name:
        args.policy_name = cli.policy_name
    device = resolve_device(args.get("device"))

    observer_model, train_dataset = None, None
    if args.policy_name in OBSERVER_POLICIES:
        gen = torch.Generator(device=device).manual_seed(0)
        observer_model = build_observer(args, device, gen)
        if args.get("model_checkpoint"):
            load_checkpoint(args.model_checkpoint, observer_model)
        total = len([f for f in os.listdir(args.DATA_FOLDER)
                     if f.startswith("P_plane")])
        train_dataset = PDEDataset.from_folder(
            args.DATA_FOLDER, np.arange(min(100, total)),
            downsample_rate=int(args.get("downsample_rate", 1)),
            x_range=int(args.get("x_range", 32)),
            y_range=int(args.get("y_range", 32)), device=device)
    return run_control(args, observer_model, train_dataset, device)


if __name__ == "__main__":
    main()
