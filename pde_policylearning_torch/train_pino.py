"""PINO pretrain / finetune / test entry of the port.

Counterpart of the repository's `train_pino.py` (reference:
train_pino.py:140-237): trains a 3-D physics-informed observer
(`PINObserver2d`) on Kolmogorov-flow trajectories with the data + IC +
residual loss of `training.pino_train.train_ns`, reading the
repository's configs as they are (`configs/pino-observer-*.yaml`).

    python -m pde_policylearning_torch.train_pino \\
        --config configs/pino-observer-pretrain-1s.yaml [--device cpu]
    python -m pde_policylearning_torch.train_pino --config ... --test \\
        --ckpt outputs/pino-pretrain.pt
    python -m pde_policylearning_torch.train_pino \\
        --config configs/pino-observer-finetune-1s.yaml \\
        --resume outputs/pino-pretrain.resume.pt

Checkpoints are torch files (`training/checkpoint.py`) named after the
config's `ckpt_name` with `.pt` in place of its extension; every
`save_interval` iterations the model, Adam and the schedule go to
`<name>.resume.pt`, which `--resume` continues from.  `--resume` also
takes a JAX resume blob (`<name>.msgpack.resume.npy`, read with numpy
alone) and carries its parameters, Adam moments and counts
(`utils.transplant.load_jax_resume`); `--ckpt` (and `--resume`) take the
JAX entry's `.msgpack` as well (`training.checkpoint.load_checkpoint`).
A missing data file is generated by the pseudo-spectral solver on the
run's device.  It runs on the card
unless `--device` names another; `--iterations` stops a run of the
config early.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .data.pino_datasets import KFDataset
from .models.pino import PINObserver2d
from .training.checkpoint import load_checkpoint, save_checkpoint
from .training.pino_train import eval_ns, make_optimizer, train_ns
from .utils import load_yaml, resolve_device, set_solver_precision
from .utils.transplant import load_jax_resume


def build_model(mcfg, device=None, generator=None):
    return PINObserver2d(
        modes1=tuple(mcfg["modes1"]), modes2=tuple(mcfg["modes2"]),
        modes3=tuple(mcfg["modes3"]),
        fc_dim=int(mcfg.get("fc_dim", 128)),
        layers=tuple(mcfg["layers"]),
        in_dim=int(mcfg.get("in_dim", 4)),
        out_dim=int(mcfg.get("out_dim", 1)),
        act=mcfg.get("act", "gelu"),
        pad_ratio=tuple(mcfg.get("pad_ratio", (0.0, 0.0))),
        remat=bool(mcfg.get("remat", False)),
        generator=generator, device=device)


def load_or_generate(dcfg, n_samples, offset=0, device=None):
    """The config's trajectories [offset, offset + n_samples): read from
    its data file, or generated on `device` (seed `offset`) and saved
    there first.  A split at a non-zero offset has a file of its own."""
    path = dcfg["paths"][0] if isinstance(dcfg.get("paths"), list) else \
        dcfg.get("paths", "./data/kf_data.npy")
    S = int(dcfg["pde_res"][0])
    T = int(dcfg["pde_res"][2])
    re = float(dcfg.get("Re", 40))
    cache = path if offset == 0 else f"{path}.off{offset}.npy"
    usable = (os.path.exists(cache)
              and np.load(cache, mmap_mode="r").shape[0] >= n_samples)
    if not usable:
        print(f"No data at {cache} covering [{offset}, {offset + n_samples});"
              f" generating {n_samples} KF trajectories "
              f"(S={S}, T={T}, Re={re})...", flush=True)
        return KFDataset.generate(n_samples, S, T, re=re, save_path=cache,
                                  seed=offset, device=device)
    return KFDataset.from_file(
        [cache], tuple(dcfg["data_res"]), tuple(dcfg["pde_res"]),
        tuple(dcfg["raw_res"]), n_samples=n_samples, offset=0,
        t_duration=float(dcfg.get("t_duration", 1.0)), with_re=True)


def checkpoint_paths(cfg):
    """(checkpoint, resume file) under `ckpt_dir`."""
    stem = os.path.splitext(cfg.get("ckpt_name", "pino.msgpack"))[0]
    ckpt_dir = cfg.get("ckpt_dir", "./outputs")
    return (os.path.join(ckpt_dir, stem + ".pt"),
            os.path.join(ckpt_dir, stem + ".resume.pt"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str,
                        default="configs/pino-observer-pretrain-1s.yaml")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="a checkpoint of this entry (parameters), "
                             "or the JAX entry's .msgpack")
    parser.add_argument("--resume", type=str, default=None,
                        help="a .resume.pt of this entry, or a JAX "
                             ".resume.npy blob (parameters, Adam, count)")
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("--iterations", type=int, default=None,
                        help="stop at this iteration instead of the "
                             "config's (a shorter run of the same config)")
    args = parser.parse_args(argv)
    cfg = load_yaml(args.config)
    device = resolve_device(args.device)
    set_solver_precision()
    generator = torch.Generator(device=device).manual_seed(
        int(cfg.get("seed", 0)))
    model = build_model(cfg["model"], device, generator)
    dcfg, tcfg = cfg["data"], cfg["train"]

    def split(n_key, n_default, off_key, off_default):
        return load_or_generate(dcfg, int(dcfg.get(n_key, n_default)),
                                int(dcfg.get(off_key, off_default)),
                                device).arrays(device=device)

    if args.test:
        eval_data = split("n_test", 16, "test_offset", 1)
        load_checkpoint(args.ckpt, model)
        err = eval_ns(model, eval_data)
        print(f"test rel-L2: {err:.5f}")
        return {"test": err}

    train_data = split("n_samples", 64, "train_offset", 0)
    eval_data = split("n_test", 16, "test_offset", 1)
    optimizer, scheduler = make_optimizer(
        model, float(tcfg.get("base_lr", 1e-3)), tcfg.get("milestones"),
        float(tcfg.get("scheduler_gamma", 0.5)))
    start_iter = 0
    if args.ckpt:
        load_checkpoint(args.ckpt, model)
    if args.resume:
        if args.resume.endswith(".npy"):
            blob = np.load(args.resume, allow_pickle=True).item()
            start_iter = load_jax_resume(model, blob, optimizer, scheduler)
        else:
            start_iter = load_checkpoint(args.resume, model, optimizer,
                                         scheduler)
        print(f"resuming from {args.resume} at iter {start_iter}")

    save_path, resume_path = checkpoint_paths(cfg)
    save_every = int(tcfg.get("save_interval", 2000))

    def checkpoint_fn(done, model_, optimizer_, scheduler_):
        if done % save_every:
            return
        save_checkpoint(resume_path, model_, optimizer_, scheduler_, done)
        print(f"  [ckpt] iter {done} -> {resume_path}", flush=True)

    iterations = args.iterations or int(tcfg.get("iterations", 2000))
    history = train_ns(
        model, train_data,
        iterations=iterations,
        batch_size=int(tcfg.get("batchsize", 4)),
        xy_weight=float(tcfg.get("xy_loss", 5.0)),
        ic_weight=float(tcfg.get("ic_loss", 1.0)),
        f_weight=float(tcfg.get("f_loss", 1.0)),
        t_interval=float(dcfg.get("t_duration", 1.0)),
        generator=generator,
        compute_dtype=tcfg.get("compute_dtype"),
        eval_data=eval_data,
        accum_steps=int(tcfg.get("accum_steps", 1)),
        checkpoint_fn=checkpoint_fn,
        optimizer=optimizer, scheduler=scheduler,
        start_iter=start_iter,
        log_interval=int(tcfg.get("log_interval", 200)))

    if float(tcfg.get("xy_loss", 5.0)) == 0.0:
        # the equation-only finetune is test-time adaptation: its metric is
        # the rel-L2 on the finetuned trajectory, whose data it never saw
        history["tta"] = eval_ns(model, train_data)
        print(f"finetuned-trajectory rel-L2: {history['tta']:.5f}")

    history["checkpoint"] = save_checkpoint(save_path, model,
                                            epoch=iterations)
    print(f"Checkpoint saved at {save_path}")
    return history


if __name__ == "__main__":
    main()
