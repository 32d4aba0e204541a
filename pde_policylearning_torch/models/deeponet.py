"""DeepONet (branch / trunk operator network).

Counterpart of `pde_policylearning_tpu/models/deeponet.py` (reference:
run_learning_beta_to_k.ipynb cell 6, deepxde's `DeepONetCartesianProd`,
which learns PDE-backstepping gain kernels beta -> k):
branch(u_sensors) . trunk(coords) + bias.  Names follow the flax tree
(`branch.fc{i}`, `trunk.fc{i}`, the scalar `bias`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..utils.device import resolve_device
from . import layers

_ACT = {"tanh": torch.tanh, "relu": F.relu, "gelu": layers.gelu}


class _MLP(nn.Module):
    """Dense layers `fc{i}`, the activation after every one but the
    last."""

    def __init__(self, in_features: int, widths: Sequence[int],
                 activation: str = "tanh", generator=None, **factory):
        super().__init__()
        self.n = len(widths)
        self.act = _ACT[activation]
        for i, w in enumerate(widths):
            self.add_module(f"fc{i}", layers.dense(
                in_features if i == 0 else widths[i - 1], w, generator,
                **factory))

    def forward(self, x):
        for i in range(self.n - 1):
            x = self.act(getattr(self, f"fc{i}")(x))
        return getattr(self, f"fc{self.n - 1}")(x)


class DeepONetCartesianProd(nn.Module):
    """out[b, n] = sum_p branch(u_b)_p * tanh(trunk(x_n))_p + bias.

    branch input (B, n_sensors), trunk input (N, coord_dim), output
    (B, N).  flax sizes the first layers from the inputs; here they are
    `n_sensors` and `coord_dim`."""

    def __init__(self, n_sensors: int, coord_dim: int,
                 branch_layers: Sequence[int], trunk_layers: Sequence[int],
                 activation: str = "tanh",
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if branch_layers[-1] != trunk_layers[-1]:
            raise ValueError("branch and trunk must share the latent width p")
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.branch = _MLP(n_sensors, branch_layers, activation, generator,
                           **factory)
        self.trunk = _MLP(coord_dim, trunk_layers, activation, generator,
                          **factory)
        self.bias = nn.Parameter(torch.zeros((), **factory))

    def forward(self, u_sensors, coords):
        b = self.branch(u_sensors)
        t = torch.tanh(self.trunk(coords))
        return torch.einsum("bp,np->bn", b, t) + self.bias
