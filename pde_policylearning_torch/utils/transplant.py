"""Carrying parameters across from the JAX package.

`load_jax_params` fills a module of the port from a flax parameter tree
given as nested dicts of numpy arrays (`jax.tree.map(np.asarray,
variables['params'])` on the JAX side; this module imports no JAX), and
from the `batch_stats` collection beside it where the module has
BatchNorm buffers.  The port's modules keep the flax names, so the tree's
path is the parameter's name:

    params['fno2d']['lifting']['fc']['kernel']
        -> fno2d.lifting.fc.weight          (a Dense kernel, transposed)
    params['fno2d']['fno_blocks']['convs']['w0']['mm2']
        -> fno2d.fno_blocks.convs.w0.mm2    (stored layout kept)
    params[...]['w0']['factors'][1]         (a list under a key)
        -> ....w0.factors1
    batch_stats['down1']['BatchNorm_0']['mean']
        -> down1.BatchNorm_0.running_mean

Each layout goes by the rule of the torch module that owns the leaf:
- `nn.Linear`: a flax `Dense` kernel (in, out) becomes the weight
  (out, in), transposed;
- `nn.Conv2d`: a flax `Conv` kernel (kh, kw, in, out) becomes the weight
  (out, in, kh, kw), `permute(3, 2, 0, 1)`;
- `nn.ConvTranspose2d`: a flax `ConvTranspose` kernel (kh, kw, in, out),
  with flax's `transpose_kernel=False`, correlates the dilated input with
  the kernel as it is, where torch's transposed convolution correlates
  with the kernel flipped: the weight (in, out, kh, kw) is the kernel
  flipped in both spatial axes, `permute(2, 3, 0, 1)`;
- `nn.LayerNorm`, `nn.BatchNorm2d`: `scale` becomes `weight`;
- the `batch_stats` collection's `mean` and `var` fill a BatchNorm's
  `running_mean` and `running_var`.
Every other leaf keeps its name and layout.
"""
from __future__ import annotations

from typing import Optional

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


_NORMS = (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)


def _carry(owner: Optional[nn.Module], leaf: str, value: np.ndarray):
    """(torch name of the leaf, value in the torch layout) by the rule of
    the module that owns it."""
    if leaf == "kernel":
        if isinstance(owner, nn.Linear):
            return "weight", value.T
        if isinstance(owner, nn.Conv2d):
            return "weight", value.transpose(3, 2, 0, 1)
        if isinstance(owner, nn.ConvTranspose2d):
            return "weight", value[::-1, ::-1].transpose(2, 3, 0, 1)
    if leaf == "scale" and isinstance(owner, _NORMS):
        return "weight", value
    if isinstance(owner, nn.modules.batchnorm._BatchNorm) \
            and leaf in ("mean", "var"):
        return f"running_{leaf}", value
    return leaf, value


def load_jax_params(module: nn.Module, params: dict,
                    batch_stats: Optional[dict] = None) -> nn.Module:
    """Copy a flax parameter tree (and its `batch_stats` collection) into
    `module` in place, each value cast to the target's dtype and device,
    and return the module.

    Raises KeyError on a key of the trees that names nothing of the
    module, on a parameter or BatchNorm statistic of the module that the
    trees do not fill, and ValueError on a shape mismatch."""
    own = dict(module.named_parameters())
    own.update((n, b) for n, b in module.named_buffers()
               if n.endswith(("running_mean", "running_var")))
    owners = dict(module.named_modules())
    filled = set()
    trees = [(params, "params")]
    if batch_stats is not None:
        trees.append((batch_stats, "batch_stats"))
    with torch.no_grad():
        for tree, collection in trees:
            for name, value in _flatten(tree).items():
                prefix, _, leaf = name.rpartition(".")
                leaf, value = _carry(owners.get(prefix), leaf,
                                     np.asarray(value))
                target = f"{prefix}.{leaf}" if prefix else leaf
                if target not in own:
                    raise KeyError(f"load_jax_params: no parameter "
                                   f"{target!r} for the {collection} "
                                   f"key {name!r}")
                p = own[target]
                if tuple(p.shape) != tuple(value.shape):
                    raise ValueError(
                        f"load_jax_params: {target} has shape "
                        f"{tuple(p.shape)}, the tree's {name} gives "
                        f"{tuple(value.shape)}")
                p.copy_(torch.as_tensor(value.copy(order="C")))
                filled.add(target)
    missing = sorted(set(own) - filled)
    if missing:
        raise KeyError("load_jax_params: the tree fills no value for "
                       f"{missing}")
    return module
