"""Observer training entry of the port.

Counterpart of the non-full-field branch of the repository's
`run_pde_observers.py` (`main`; reference: run_pde_observers.py main :29,
epoch loop :167-324): trains a wall-pressure -> velocity observer on
channel-flow plane data, tracks the best test loss and saves the best
parameters as a torch checkpoint.

    python -m pde_policylearning_torch.run_pde_observers \\
        --train_yaml configs/base_fno.yaml [--device cpu]

It reads the repository's configs as they are (`base_fno.yaml`,
`matlab_rno.yaml`, `base_transformer.yaml`).  Without a dataset at
`DATA_FOLDER` it generates one with the port's `generate_channel_dataset`
(the `gt` policy) on the same device.  It runs on the card unless
`--device` names another.  The full-field observer (`PINObserverFullField`)
and the hand-off to the control loop (`run_control`) are not ported yet.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import models
from .data import PDEDataset, SequentialPDEDataset, generate_channel_dataset
from .training import Trainer, save_checkpoint
from .utils import (MetricsLogger, default_parser, load_yaml,
                    merge_args_with_yaml, resolve_device,
                    set_solver_precision)

_FULLFIELD = "ROADMAP.md queue 1 item 4 (the flagship gradient-control slice)"


def build_model(args, device=None, generator=None, conv_backend="auto"):
    """The observer named by `model_name` (run_pde_observers.py:47,
    98-113) on `device`, drawn from `generator`, its 2-D spectral convs on
    `conv_backend`; returns (model, whether it takes sequences)."""
    name = args.model_name
    kw = dict(device=device, generator=generator, conv_backend=conv_backend)
    if name in ("FNO2dObserver", "FNO2dObserverOld"):
        return models.FNO2dObserver(
            modes1=args.modes, modes2=args.modes, width=args.width,
            use_v_plane=bool(args.get("use_v_plane", False)), **kw), False
    if name == "RNO2dObserver":
        return models.RNO2dObserver(
            modes1=args.modes, modes2=args.modes, width=args.width,
            recurrent_index=args.get("recurrent_index", 0),
            layer_num=args.get("layer_num", 1), **kw), True
    if name == "UNet":
        return models.UNet(
            use_spectral_conv=bool(args.get("use_spectral_conv", True)),
            **kw), False
    if name == "Transformer2D":
        return models.SimpleTransformer(
            node_feats=1, n_hidden=int(args.get("n_hidden", 96)),
            n_head=int(args.get("n_head", 2)),
            attention_type=args.get("attention_type", "fourier"),
            fourier_modes=args.modes,
            freq_dim=int(args.get("freq_dim", 48)), **kw), True
    raise ValueError(f"Model not supported: {name}")


def load_or_generate_data(args, device=None):
    """The train and test plane indices of `DATA_FOLDER`, generating the
    folder first where it holds no dataset."""
    folder = args.DATA_FOLDER
    if not os.path.exists(os.path.join(folder, "metadata.npy")):
        n = int(args.get("generate_steps",
                         args.get("ntrain", 1000) + args.get("ntest", 200)))
        print(f"No dataset at {folder}; generating {n} steps from the "
              "channel env...", flush=True)
        generate_channel_dataset(
            folder, n, policy="gt",
            env_kwargs={"spinup_steps": int(args.get("spinup_steps", 0)),
                        "device": device})
    total = len([f for f in os.listdir(folder) if f.startswith("P_plane")])
    ntrain = min(args.ntrain, int(total * 0.75))
    ntest = min(args.ntest, total - ntrain)
    indices = np.arange(total)
    if args.get("random_split", True):
        np.random.default_rng(0).shuffle(indices)
    return indices[:ntrain], indices[ntrain:ntrain + ntest]


def load_arrays(args, device=None):
    """(train dataset, (x_train, y_train), (x_test, y_test)) as the model
    is trained on them, on `device`: planes, or length-`model_timestep`
    sequences for a recurrent model or the transformer (whose targets are
    the whole sequence; the RNO's the plane at `recurrent_index`)."""
    train_idx, test_idx = load_or_generate_data(args, device)
    kw = dict(downsample_rate=args.downsample_rate, x_range=args.x_range,
              y_range=args.y_range, device=device)
    transformer = args.get("model_name") == "Transformer2D"
    if bool(args.get("recurrent_model", False)) or transformer:
        kw["timestep"] = int(args.get("model_timestep", 2))
        train_ds, test_ds = (SequentialPDEDataset.from_folder(
            args.DATA_FOLDER, idx, **kw) for idx in (train_idx, test_idx))
        (x_train, y_train), (x_test, y_test) = (train_ds.arrays(),
                                                test_ds.arrays())
        if not transformer:
            ri = int(args.get("recurrent_index", 0))
            y_train, y_test = y_train[:, ri], y_test[:, ri]
    else:
        train_ds, test_ds = (PDEDataset.from_folder(args.DATA_FOLDER, idx,
                                                    **kw)
                             for idx in (train_idx, test_idx))
        (x_train, y_train), (x_test, y_test) = (train_ds.arrays(),
                                                test_ds.arrays())
    return train_ds, (x_train, y_train), (x_test, y_test)


def make_trainer(args, model, decoder):
    return Trainer(
        model,
        n_epochs=args.epochs if args.get("set_epoch", -1) <= 0
        else args.set_epoch,
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        weight_decay=args.get("weight_decay", 1e-4),
        step_size=args.get("step_size", 100), gamma=args.get("gamma", 0.5),
        decoder=decoder, log_interval=int(args.get("log_interval", 50)),
        max_chunk_steps=int(args.get("max_chunk_steps", 4000)))


def checkpoint_path(args) -> str:
    return os.path.join(args.get("out_dir", "./outputs"),
                        f"{args.path_name}_{args.exp_name}.pt")


def main(args, device=None):
    """Train the configured observer on `device` (None: `args.device`,
    else the card).  Returns (the best parameters as a state dict,
    history); history['checkpoint'] is the file written."""
    if args.get("model_name") == "PINObserverFullField" or \
            args.get("dataset_name") == "FullFieldNSDataset":
        raise NotImplementedError(
            f"the full-field observer branch is not ported yet: {_FULLFIELD}")
    device = resolve_device(device if device is not None
                            else args.get("device"))
    set_solver_precision()
    train_ds, train, test = load_arrays(args, device)
    gen = torch.Generator(device=device).manual_seed(0)
    model, _ = build_model(args, device=device, generator=gen)
    trainer = make_trainer(args, model, train_ds.v_norm)
    t0 = time.time()
    best_state, history = trainer.train(train, test, generator=gen)
    print(f"Training done in {time.time() - t0:.1f}s; "
          f"best test rel-L2 = {history['best_loss']:.6f}", flush=True)

    if not args.get("close_wandb", True) or args.get("log_dir"):
        logger = MetricsLogger(
            log_dir=args.get("log_dir", "./outputs/logs"),
            use_wandb=not args.get("close_wandb", True),
            project=args.get("project_name"), name=args.get("exp_name"),
            config=dict(args))
        for ep, (tr, te) in enumerate(zip(history["train_loss"],
                                          history["test_loss"])):
            logger.log({"train/avg_train_loss": tr,
                        "test/avg_test_loss": te}, step=ep)
        logger.log({"test/best_loss": history["best_loss"]})
        logger.finish()

    model.load_state_dict(best_state)
    history["checkpoint"] = save_checkpoint(checkpoint_path(args), model,
                                            epoch=len(history["train_loss"]))
    print(f"Best model saved at {history['checkpoint']}!", flush=True)
    if args.get("run_control", False):
        raise NotImplementedError(
            "run_control after training is not ported yet: "
            f"{_FULLFIELD}")
    return best_state, history


if __name__ == "__main__":
    cli = default_parser().parse_args()
    main(merge_args_with_yaml(cli, load_yaml(cli.train_yaml)))
