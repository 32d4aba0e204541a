"""Multiplicative filter networks (PINO conditioning, DINo's INR).

Counterpart of `pde_policylearning_tpu/models/mfn.py` (reference:
libs/models/pino_models/pinobserver.py:14-129, libs/DINo/network.py:45-190).
The parameters keep the flax names and layouts: `MultiplicativeNet`'s `A`
(out, code), `B` (out, in) and `bias` (out,); `MFNFourierLayer`'s `weight`
(out // 2, in); `FourierNet`'s `filter{i}`, `bilinear{i}` and the Dense
`output`.  They are drawn as the JAX package's `_kaiming_uniform` draws
them: uniform in +-1/sqrt(last axis), the bias's bound from its own length.
Every module takes `generator` (None: torch's global generator), `device`
(None: the card) and `dtype`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from . import layers


def kaiming_uniform(shape, generator: Optional[torch.Generator] = None,
                    **factory) -> nn.Parameter:
    """torch's `kaiming_uniform_(a=sqrt(5))` on (out, in): uniform in
    +-1/sqrt(shape[-1]) (the JAX package's `_kaiming_uniform`)."""
    bound = 1.0 / math.sqrt(shape[-1])
    t = torch.empty(shape, **factory)
    t.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(t)


class MultiplicativeNet(nn.Module):
    """out = x1 @ B^T + code @ A^T + bias, the code term broadcast over the
    spatial axes (pinobserver.py:14-63)."""

    def __init__(self, in_features: int, code_features: int,
                 out_features: int, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        f = layers.factory(device, dtype)
        self.A = kaiming_uniform((out_features, code_features), generator, **f)
        self.B = kaiming_uniform((out_features, in_features), generator, **f)
        self.bias = kaiming_uniform((out_features,), generator, **f)

    def forward(self, x1, code):
        """x1: (B, *spatial, I); code: (B, J) or (B,) -> (B, *spatial, O)."""
        if code.ndim < 2:
            code = code[..., None]
        bias_code = (code @ self.A.T).reshape(
            code.shape[0], *([1] * (x1.ndim - 2)), self.A.shape[0])
        return x1 @ self.B.T + bias_code + self.bias


class MFNFourierLayer(nn.Module):
    """Sine / cosine filter (pinobserver.py:96-112): `out_features` in all,
    half sines and half cosines."""

    def __init__(self, in_features: int, out_features: int,
                 weight_scale: float = 1.0, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = kaiming_uniform((out_features // 2, in_features),
                                      generator,
                                      **layers.factory(device, dtype))
        self.weight_scale = weight_scale

    def forward(self, x):
        lin = x @ (self.weight * self.weight_scale).T
        return torch.cat([torch.sin(lin), torch.cos(lin)], dim=-1)


class FourierNet(nn.Module):
    """MFN with Fourier filters: out = Linear(prod_i filter_i(x) *
    bilinear_i(code)) (pinobserver.py:66-129, DINo network.py:132-190)."""

    def __init__(self, in_features: int, code_features: int,
                 hidden_size: int, out_size: int, n_layers: int = 3,
                 input_scale: float = 256.0, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        scale = input_scale / math.sqrt(n_layers + 1)
        self.n_layers = n_layers
        for i in range(n_layers + 1):
            self.add_module(f"filter{i}", MFNFourierLayer(
                in_features, hidden_size, scale, **kw))
            self.add_module(f"bilinear{i}", MultiplicativeNet(
                in_features if i == 0 else hidden_size, code_features,
                hidden_size, **kw))
        self.output = layers.dense(hidden_size, out_size, generator,
                                   **layers.factory(device, dtype))

    def forward(self, x, code):
        out = self.filter0(x) * self.bilinear0(x * 0.0, code)
        for i in range(1, self.n_layers + 1):
            out = getattr(self, f"filter{i}")(x) \
                * getattr(self, f"bilinear{i}")(out, code)
        out = self.output(out)
        if out.shape[-1] == 1:
            out = out.squeeze(-1)
        return out
