"""Carrying parameters across from the JAX package.

`load_jax_params` fills a module of the port from a flax parameter tree
given as nested dicts of numpy arrays (`jax.tree.map(np.asarray,
variables['params'])` on the JAX side; this module imports no JAX).  The
port's modules keep the flax names, so the tree's path is the parameter's
name:

    params['fno2d']['lifting']['fc']['kernel']
        -> fno2d.lifting.fc.weight          (transposed)
    params['fno2d']['fno_blocks']['convs']['w0']['mm2']
        -> fno2d.fno_blocks.convs.w0.mm2    (stored layout kept)
    params['fno2d']['fno_blocks']['convs']['bias']
        -> fno2d.fno_blocks.convs.bias
    params[...]['w0']['factors'][1]         (a list under a key)
        -> ....w0.factors1

A flax `Dense` kernel is (in, out) and becomes `nn.Linear`'s (out, in)
weight; every other leaf keeps its name and layout.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix=""):
    """Nested dicts / lists of arrays -> {dotted name: array}; list items
    append their index to the key (`factors` -> `factors0`, ...)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        elif isinstance(v, (list, tuple)):
            out.update({f"{prefix}{k}{i}": a for i, a in enumerate(v)})
        else:
            out[f"{prefix}{k}"] = v
    return out


def load_jax_params(module: nn.Module, params: dict) -> nn.Module:
    """Copy a flax parameter tree into `module` in place (each value cast
    to the parameter's dtype and device) and return the module.

    Raises KeyError on a key of the tree that names no parameter of the
    module, on a parameter of the module that the tree does not fill, and
    ValueError on a shape mismatch."""
    own = dict(module.named_parameters())
    filled = set()
    with torch.no_grad():
        for name, value in _flatten(params).items():
            value = np.asarray(value)
            target = name
            if name.endswith(".kernel") or name == "kernel":
                target = name[:-len("kernel")] + "weight"
                value = value.T
            if target not in own:
                raise KeyError(f"load_jax_params: no parameter {target!r} "
                               f"for the tree's key {name!r}")
            p = own[target]
            if tuple(p.shape) != tuple(value.shape):
                raise ValueError(
                    f"load_jax_params: {target} has shape {tuple(p.shape)}, "
                    f"the tree's {name} gives {tuple(value.shape)}")
            p.copy_(torch.as_tensor(np.ascontiguousarray(value)))
            filled.add(target)
    missing = sorted(set(own) - filled)
    if missing:
        raise KeyError("load_jax_params: the tree fills no value for "
                       f"{missing}")
    return module
