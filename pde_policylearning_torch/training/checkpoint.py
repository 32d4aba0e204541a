"""Checkpoints in torch's own format.

Counterpart of `pde_policylearning_tpu/training/checkpoint.py` (reference:
the torch.save / torch.load dictionaries across the training scripts,
run_pde_observers.py:313, libs/pino_utils/utils.py:156-195): one file
holding the module's `state_dict`, optionally the optimizer's and the
scheduler's, and the epoch.  It is read back with `weights_only=True`
(tensors and plain containers only).  There is no path from or into the
JAX package's msgpack and orbax files.
"""
from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    scheduler=None, epoch: int = 0) -> str:
    """Write {'model', ['optimizer',] ['scheduler',] 'epoch'} to `path`
    (its directory made) and return the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    state = {"model": model.state_dict(), "epoch": int(epoch)}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    if scheduler is not None:
        state["scheduler"] = scheduler.state_dict()
    torch.save(state, path)
    return path


def load_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    scheduler=None) -> int:
    """Fill `model` (and the optimizer and scheduler given) from a file of
    `save_checkpoint`, each tensor on the device of what it fills; return
    the epoch."""
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    if scheduler is not None:
        scheduler.load_state_dict(state["scheduler"])
    return int(state["epoch"])
