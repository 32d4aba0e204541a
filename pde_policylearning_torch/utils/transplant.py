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
Every other leaf keeps its name and layout (a 0-d leaf, such as
DeepONet's scalar `bias`, included).

One rule is not about layouts: a module whose flax counterpart builds one
of two sets of leaves at call time (the transformer's graph feature
lift, a GCN / GAT with an edge and a Dense without) names them in its
`jax_alternatives`, tuples of the local name prefixes of each set.  A
tree that fills every parameter of one set leaves the others as they
are, and they do not count as missing.
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
    missing = set(own) - filled
    for mname, owner in owners.items():
        routes = getattr(owner, "jax_alternatives", None)
        if routes is None:
            continue
        base = f"{mname}." if mname else ""
        local = [n[len(base):] for n in own if n.startswith(base)]
        sets = [{base + n for n in local if n.startswith(r)}
                for r in routes]
        if any(s and not (s & missing) for s in sets):
            missing -= set().union(*sets)
    missing = sorted(missing)
    if missing:
        raise KeyError("load_jax_params: the tree fills no value for "
                       f"{missing}")
    return module


def _flax_path(owners: dict, name: str) -> tuple:
    """The flax tree path of the port's parameter `name` (the inverse of
    `_carry`'s naming): a Dense/Conv weight is the `kernel`, a norm's
    weight its `scale`.  Factor lists are not carried (the PINO models'
    weights are dense)."""
    prefix, _, leaf = name.rpartition(".")
    owner = owners.get(prefix)
    if leaf == "weight" and isinstance(owner, (nn.Linear, nn.Conv2d,
                                               nn.ConvTranspose2d)):
        leaf = "kernel"
    elif leaf == "weight" and isinstance(owner, _NORMS):
        leaf = "scale"
    return (*prefix.split("."), leaf) if prefix else (leaf,)


def jax_leaf_order(module: nn.Module) -> list:
    """The port's parameter names in the order of `jax.tree.leaves` of the
    flax parameter tree (dict keys sorted at each level): the order in
    which the JAX package's resume blobs list their leaves."""
    owners = dict(module.named_modules())
    names = [n for n, _ in module.named_parameters()]
    return sorted(names, key=lambda n: _flax_path(owners, n))


def _tree(paths_values) -> dict:
    """Nested dicts from (path, value) pairs."""
    tree = {}
    for path, value in paths_values:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return tree


def load_jax_resume(module: nn.Module, blob: dict, optimizer=None,
                    scheduler=None) -> int:
    """Carry a JAX PINO resume blob (`train_pino.py`'s
    `{"params", "opt_state", "done"}`, each a list of leaves in
    `jax.tree.leaves` order) into `module` and, where given, a
    `torch.optim.Adam` over its parameters and the `MultiStepLR` on it.

    `optax.adam(lr)`'s state lists Adam's count, the first moments (one
    per parameter leaf, in the parameters' order), the second moments,
    then the schedule's count where the rate is a schedule (none for a
    constant rate).  The moments become `exp_avg` / `exp_avg_sq` in the
    parameters' layout, the count Adam's `step`, and the schedule's count
    the scheduler's epoch (`pino_train.set_iteration`).  Returns `done`,
    the iteration to continue from."""
    owners = dict(module.named_modules())
    order = jax_leaf_order(module)
    params = dict(module.named_parameters())
    n = len(order)
    leaves = list(blob["params"])
    if len(leaves) != n:
        raise ValueError(f"load_jax_resume: the blob has {len(leaves)} "
                         f"parameter leaves, the module {n}")
    paths = [_flax_path(owners, name) for name in order]
    load_jax_params(module, _tree(zip(paths, leaves)))
    if optimizer is not None:
        state = list(blob["opt_state"])
        if len(state) not in (2 * n + 1, 2 * n + 2):
            raise ValueError(f"load_jax_resume: {len(state)} optimizer "
                             f"leaves for {n} parameters")
        count = int(np.asarray(state[0]))
        for name, path, mu, nu in zip(order, paths, state[1:n + 1],
                                      state[n + 1:2 * n + 1]):
            p = params[name]
            prefix, _, _ = name.rpartition(".")
            moments = [torch.as_tensor(np.ascontiguousarray(
                _carry(owners.get(prefix), path[-1], np.asarray(m))[1]))
                .to(dtype=p.dtype, device=p.device) for m in (mu, nu)]
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": moments[0], "exp_avg_sq": moments[1]}
        if scheduler is not None:
            from ..training.pino_train import set_iteration
            sched_count = int(np.asarray(state[-1])) \
                if len(state) == 2 * n + 2 else count
            set_iteration(optimizer, scheduler, sched_count)
    return int(blob["done"])
