"""torch's default initialization, drawn again from a generator.

Counterpart of `pde_policylearning_tpu/training/torch_init.py`.  torch
draws an `nn.Linear`'s weight from U(+-sqrt(1/fan_in)) and its bias from
U(+-1/sqrt(fan_in)) (torch/nn/modules/linear.py reset_parameters); flax's
`Dense` draws lecun-normal weights and zero biases.  The port's layers
keep torch's default unless `models.layers.init_linears_` or
`flax_init_` draws them flax's way; `torch_reinit` is the way back, from
an explicit generator.  Its rule is the JAX function's, leaf by leaf of
the flax tree (the 1x1 convolutions of the reference are Linear layers
here, as Dense layers there):
- each Linear's weight and bias by torch's formula;
- every other leaf named `bias` (the spectral convolutions' per-layer
  bias (n_layers, out); also, as in the JAX function, a norm's or a
  Conv2d's bias and MultiplicativeNet's) from the reference's
  init_std * randn, init_std = 1 / width^2, width its last axis
  (spectral_convolution.py:223-224,272);
- every other leaf (the spectral weights, Conv2d kernels, norms' scales)
  as it is.
`exclude` names substrings of the leaves' flax paths ('/lifting/fc/kernel',
`utils.transplant`) to leave as they are.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..utils.transplant import _flax_path


def torch_reinit(module: nn.Module, generator: torch.Generator,
                 exclude: Sequence[str] = ()) -> nn.Module:
    """Redraw `module`'s parameters in place by the rule above, in the
    order of `named_parameters`, from `generator`; returns the module."""
    owners = dict(module.named_modules())
    with torch.no_grad():
        for name, p in module.named_parameters():
            path = "/" + "/".join(_flax_path(owners, name))
            if any(e in path for e in exclude):
                continue
            prefix, _, leaf = name.rpartition(".")
            owner = owners.get(prefix)
            if isinstance(owner, nn.Linear):
                bound = owner.in_features ** -0.5
                p.uniform_(-bound, bound, generator=generator)
            elif leaf == "bias":
                width = p.shape[-1] if p.ndim else 1
                p.normal_(0.0, 1.0, generator=generator).div_(width ** 2)
    return module
