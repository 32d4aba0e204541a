"""Shared model layers: lifting/projection, channel-MLP, skips, norms.

Counterpart of `pde_policylearning_tpu/models/layers.py` (reference:
neuralop/models/tfno.py:11-38, mlp.py:10, skip_connections.py:5-61,
normalization_layers.py:5).

Every module passes `**factory` (`device`, `dtype`) to its parameters.
Layout: channels-last (B, d1..dN, C).  The reference's 1x1 ConvNd layers
are `nn.Linear` over the trailing channel axis, rank-agnostic.  The
default non-linearity is the tanh approximation of GELU, which is what
`flax.linen.gelu` computes (torch's default is the exact erf form), and
the norms use population variances, as `jnp.var` does.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import torch
from torch import nn

gelu = partial(nn.functional.gelu, approximate="tanh")


class Lifting(nn.Module):
    """Pointwise lift to hidden width (tfno.py:11)."""

    def __init__(self, in_channels: int, out_channels: int, **factory):
        super().__init__()
        self.fc = nn.Linear(in_channels, out_channels, **factory)

    def forward(self, x):
        return self.fc(x)


class Projection(nn.Module):
    """Two-layer pointwise projection head (tfno.py:23)."""

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: Optional[int] = None,
                 non_linearity: Callable = gelu, **factory):
        super().__init__()
        hidden = hidden_channels or in_channels
        self.fc1 = nn.Linear(in_channels, hidden, **factory)
        self.fc2 = nn.Linear(hidden, out_channels, **factory)
        self.non_linearity = non_linearity

    def forward(self, x):
        return self.fc2(self.non_linearity(self.fc1(x)))


class ChannelMLP(nn.Module):
    """n-layer pointwise MLP used inside FNO blocks (mlp.py:10), with the
    non-linearity after every layer (the reference's `i < n_layers` is
    always true)."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 hidden_channels: Optional[int] = None, n_layers: int = 2,
                 non_linearity: Callable = gelu, dropout: float = 0.0,
                 **factory):
        super().__init__()
        out_ch = out_channels or in_channels
        hidden = hidden_channels or in_channels
        widths = [in_channels] + [hidden] * (n_layers - 1) + [out_ch]
        self.n_layers = n_layers
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"fc{i}", nn.Linear(a, b, **factory))
        self.non_linearity = non_linearity
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None

    def forward(self, x, deterministic: bool = True):
        for i in range(self.n_layers):
            x = self.non_linearity(getattr(self, f"fc{i}")(x))
            if self.dropout is not None and not deterministic:
                x = self.dropout(x)
        return x


class SoftGating(nn.Module):
    """Learned per-channel gate (skip_connections.py:38)."""

    def __init__(self, channels: int, use_bias: bool = False, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, **factory))
        self.bias = nn.Parameter(torch.ones(channels, **factory)) \
            if use_bias else None

    def forward(self, x):
        if self.bias is not None:
            return self.weight * x + self.bias
        return self.weight * x


class SkipConnection(nn.Module):
    """'linear' (1x1 conv) / 'identity' / 'soft-gating'
    (skip_connections.py:5)."""

    def __init__(self, in_channels: int, out_channels: int,
                 skip_type: str = "soft-gating", **factory):
        super().__init__()
        t = skip_type.lower()
        if t == "linear":
            self.conv = nn.Linear(in_channels, out_channels, bias=False,
                                  **factory)
        elif t == "soft-gating":
            self.gate = SoftGating(out_channels, **factory)
        elif t != "identity":
            raise ValueError(f"Got skip type {skip_type!r}")
        self.skip_type = t

    def forward(self, x):
        if self.skip_type == "linear":
            return self.conv(x)
        if self.skip_type == "soft-gating":
            return self.gate(x)
        return x


def _normalize(x, dims, eps):
    mean = torch.mean(x, dim=dims, keepdim=True)
    var = torch.var(x, dim=dims, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + eps)


def instance_norm(x, eps: float = 1e-5):
    """InstanceNorm over spatial dims, no affine (torch default)."""
    return _normalize(x, tuple(range(1, x.ndim - 1)), eps)


class GroupNorm(nn.Module):
    """GroupNorm with one group (== LayerNorm over channel+space, affine)."""

    def __init__(self, channels: int, eps: float = 1e-5, **factory):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, **factory))
        self.bias = nn.Parameter(torch.zeros(channels, **factory))
        self.eps = eps

    def forward(self, x):
        return _normalize(x, tuple(range(1, x.ndim)), self.eps) \
            * self.scale + self.bias


class AdaIN(nn.Module):
    """Adaptive instance norm conditioned on an embedding
    (normalization_layers.py:5); the embedding is a call argument."""

    def __init__(self, embed_dim: int, in_channels: int,
                 mlp_hidden: int = 512, eps: float = 1e-5, **factory):
        super().__init__()
        self.mlp0 = nn.Linear(embed_dim, mlp_hidden, **factory)
        self.mlp1 = nn.Linear(mlp_hidden, 2 * in_channels, **factory)
        self.in_channels = in_channels
        self.eps = eps

    def forward(self, x, embedding):
        wb = self.mlp1(gelu(self.mlp0(embedding.reshape(-1))))
        weight, bias = wb[:self.in_channels], wb[self.in_channels:]
        return _normalize(x, tuple(range(1, x.ndim)), self.eps) \
            * weight + bias


def init_linears_(module: nn.Module, generator: torch.Generator) -> None:
    """Redraw every `nn.Linear` under `module` from `generator` (on the
    parameters' device): normal weights of variance 1/fan_in and zero
    biases, the scale of flax's `Dense` default.  Without this call the
    layers keep torch's own default init from the global generator."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5,
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


def flax_init_(m: nn.Module, generator: Optional[torch.Generator] = None,
               std: Optional[float] = None) -> nn.Module:
    """Draw the weight of an `nn.Linear`, `nn.Conv2d` or
    `nn.ConvTranspose2d` as flax's `Dense`, `Conv` and `ConvTranspose` do
    by default (normal of variance 1 / fan_in, fan_in = in x kh x kw; the
    scale of lecun_normal) or of `std` where given, and zero its bias;
    from `generator` (None: torch's global generator).  Returns `m`."""
    w = m.weight
    if std is None:
        fan_in = w.shape[0] if isinstance(m, nn.ConvTranspose2d) \
            else w.shape[1]
        std = (fan_in * math.prod(w.shape[2:])) ** -0.5
    with torch.no_grad():
        w.normal_(0.0, std, generator=generator)
        if m.bias is not None:
            m.bias.zero_()
    return m


def dense(in_features: int, out_features: int,
          generator: Optional[torch.Generator] = None,
          std: Optional[float] = None, **factory) -> nn.Linear:
    """A flax `Dense` as an `nn.Linear`, drawn by `flax_init_`."""
    return flax_init_(nn.Linear(in_features, out_features, **factory),
                      generator, std)


def factory(device=None, dtype=torch.float32) -> dict:
    """`device` (None: the card, raising without one) and `dtype` as the
    keyword arguments of a torch constructor."""
    from ..utils.device import resolve_device
    return dict(device=resolve_device(device), dtype=dtype)
