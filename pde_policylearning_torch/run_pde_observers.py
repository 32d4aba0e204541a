"""Observer training entry of the port.

Counterpart of the repository's `run_pde_observers.py` (reference:
run_pde_observers.py main :29, epoch loop :167-324): trains a
wall-pressure -> velocity observer on channel-flow plane data, tracks the
best test loss and saves the best parameters as a torch checkpoint, then
with `run_control` hands the observer to the control loop
(`run_control.run_control`).  A config naming `PINObserverFullField` or
`FullFieldNSDataset` takes the physics-informed full-field branch
(`main_fullfield`): the top wall's v-plane -> the V planes at
`plane_indexs`, trained with `training.train_fullfield_observer`.

    python -m pde_policylearning_torch.run_pde_observers \\
        --train_yaml configs/base_fno.yaml [--device cpu]

It reads the repository's configs as they are (`base_fno.yaml`,
`matlab_rno.yaml`, `base_transformer.yaml`, `fullfield_pi.yaml`,
`fullfield_pi_short.yaml`).  Without a dataset at `DATA_FOLDER` it
generates one with the port's `generate_channel_dataset` (the `gt`
policy; with the U, V, W fields for the full-field branch) on the same
device.  It runs on the card unless `--device` names another.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import models
from .data import (FullFieldNSDataset, PDEDataset, SequentialPDEDataset,
                   generate_channel_dataset)
from .envs import channel_flow as cf
from .training import (Trainer, eval_fullfield_observer, load_checkpoint,
                       save_checkpoint, train_fullfield_observer)
from .utils import (MetricsLogger, default_parser, load_yaml,
                    merge_args_with_yaml, resolve_device,
                    set_solver_precision)


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


def n_epochs(args) -> int:
    return args.epochs if args.get("set_epoch", -1) <= 0 else args.set_epoch


def make_trainer(args, model, decoder):
    return Trainer(
        model, n_epochs=n_epochs(args),
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        weight_decay=args.get("weight_decay", 1e-4),
        step_size=args.get("step_size", 100), gamma=args.get("gamma", 0.5),
        decoder=decoder, log_interval=int(args.get("log_interval", 50)),
        max_chunk_steps=int(args.get("max_chunk_steps", 4000)))


def checkpoint_path(args) -> str:
    return os.path.join(args.get("out_dir", "./outputs"),
                        f"{args.path_name}_{args.exp_name}.pt")


def grid_shape(args) -> tuple:
    """The full-field branch's (Nx, Ny, Nz)."""
    return (int(args.get("x_range", 32)), int(args.get("Ny", 130)),
            int(args.get("y_range", 32)))


def build_fullfield_model(args, plane_num: int, device=None, generator=None):
    """`PINObserverFullField` from the config (run_pde_observers.py
    :104-107), on `device`, drawn from `generator`."""
    return models.PINObserverFullField(
        plane_num=plane_num,
        modes1=tuple(args.get("modes1", (8, 8, 8, 8))),
        modes2=tuple(args.get("modes2", (8, 8, 8, 8))),
        modes3=tuple(args.get("modes3", (1, 1, 1, 1))),
        layers=tuple(args.get("layers", (args.get("width", 16),) * 5)),
        fc_dim=int(args.get("fc_dim", 64)), in_dim=1,
        pad_ratio=tuple(args.get("pad_ratio", (0.0, 0.0))),
        generator=generator, device=device)


def load_fullfield_data(args, device=None):
    """(train dataset, test dataset or None, plane_indexs) of the
    full-field branch: `DATA_FOLDER` generated first (`generate_steps`
    steps with fields) where it holds no dataset, then the sequential
    split, `ntrain` rows (default: all) and the next `ntest` (default:
    none)."""
    folder = args.DATA_FOLDER
    nx, ny, nz = grid_shape(args)
    if not os.path.exists(os.path.join(folder, "metadata.npy")):
        n = int(args.get("generate_steps", 64))
        print(f"Generating {n} full-field steps from the channel env...",
              flush=True)
        generate_channel_dataset(
            folder, n, policy="gt", save_fields=True,
            env_kwargs={"Nx": nx, "Ny": ny, "Nz": nz, "noise_scale": 0.05,
                        "device": device})
    total = len([f for f in os.listdir(folder) if f.startswith("U_field")])
    plane_indexs = list(args.get("plane_indexs", [-2, -5, -10]))
    timestep = int(args.get("model_timestep", 1))
    ntrain = int(args.get("ntrain", total))
    ntest = int(args.get("ntest", 0))
    train_rows = np.arange(min(ntrain, total))
    test_rows = np.arange(len(train_rows), min(ntrain + ntest, total))
    ds, test_ds = (FullFieldNSDataset.from_folder(
        folder, rows, plane_indexs, timestep=timestep, device=device)
        if len(rows) else None for rows in (train_rows, test_rows))
    return ds, test_ds, plane_indexs


def main_fullfield(args, device):
    """The physics-informed full-field branch (run_pde_observers.py
    :200-239; the JAX entry's `main_fullfield`) on `device`: train the
    configured `PINObserverFullField` (or, with `eval_ckpt`, reload it
    from a file of either package: `.pt` or the JAX `.msgpack`),
    save the checkpoint before the held-out evaluation, and return (the
    model's state dict, history); history['checkpoint'] is the file
    written and history['test_rel_l2'] the held-out decoded rel-L2."""
    ds, test_ds, plane_indexs = load_fullfield_data(args, device)
    grid = cf.make_channel_grid(*grid_shape(args), device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    model = build_fullfield_model(args, len(plane_indexs), device, gen)
    if args.get("eval_ckpt"):
        load_checkpoint(str(args.eval_ckpt), model)
        history = {}
    else:
        _, history = train_fullfield_observer(
            model, ds, grid, plane_indexs=plane_indexs,
            n_epochs=n_epochs(args), batch_size=int(args.batch_size),
            learning_rate=float(args.learning_rate),
            pde_loss_weight=float(args.get("pde_loss_weight", 0.0)),
            generator=gen)
        # saved before the evaluation, as the JAX entry does
        history["checkpoint"] = save_checkpoint(
            checkpoint_path(args), model, epoch=len(history["total"]))
        print(f"Best model saved at {history['checkpoint']}!", flush=True)
    if test_ds is not None:
        history["test_rel_l2"] = eval_fullfield_observer(model, test_ds)
        print(f"Held-out decoded data rel-L2 ({len(test_ds)} rows): "
              f"{history['test_rel_l2']:.6f}", flush=True)
    return dict(model.state_dict()), history


def main(args, device=None):
    """Train the configured observer on `device` (None: `args.device`,
    else the card).  Returns (the best parameters as a state dict,
    history); history['checkpoint'] is the file written.  A full-field
    config goes to `main_fullfield`."""
    device = resolve_device(device if device is not None
                            else args.get("device"))
    set_solver_precision()
    if args.get("model_name") == "PINObserverFullField" or \
            args.get("dataset_name") == "FullFieldNSDataset":
        return main_fullfield(args, device)
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
        from .run_control import run_control
        args.setdefault("policy_name", "fno")
        run_control(args, model, train_ds, device)
    return best_state, history


if __name__ == "__main__":
    cli = default_parser().parse_args()
    main(merge_args_with_yaml(cli, load_yaml(cli.train_yaml)))
