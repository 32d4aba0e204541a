"""U-shaped Neural Operator.

Counterpart of `pde_policylearning_tpu/models/uno.py` (reference:
neuralop/models/uno.py:15): per-layer channel lists, per-layer resolution
scalings, and horizontal skip connections resampled to the current
resolution.  Tucker-factorized by default (uno.py:236), as the JAX module
is.

Each layer is an `FNOBlocks` of one layer, `block{i}`; a layer that takes
a horizontal skip gets the skip's channels concatenated after its input.
Its spectral conv returns the spectrum of its input's shape and the
inverse transform cuts or zero-pads it to the output size, so a 0.5
scaling drops the high corner of the first axis, as both packages and the
reference do.  A dense UNO (`factorization=None`) on a CUDA float32 input
takes the corner-contraction kernel in every block (`conv_backend`
'auto'); a Tucker one takes the plain route (`fourier.kernel_eligible`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ..ops import padding as padding_ops
from ..ops import resample as resample_ops
from ..utils.device import resolve_device
from . import layers
from .fno import FNOBlocks


class UNO(nn.Module):
    """lift -> [pad] -> n_layers x (concatenate the skip, FNOBlock at its
    scaling) -> [unpad] -> project.  x: (B, d1..dN, in_channels).  The
    parameters live on `device` (None: the card); with a `generator` they
    are all drawn from it."""

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: int, uno_out_channels: Sequence[int],
                 uno_n_modes: Sequence[Sequence[int]],
                 uno_scalings: Sequence[Any], lifting_channels: int = 256,
                 projection_channels: int = 256, n_layers: int = 4,
                 horizontal_skips_map: Optional[Dict[int, int]] = None,
                 use_mlp: bool = False, mlp_dropout: float = 0.0,
                 mlp_expansion: float = 0.5,
                 non_linearity: Callable = layers.gelu,
                 norm: Optional[str] = None, preactivation: bool = False,
                 fno_skip: str = "linear", horizontal_skip: str = "linear",
                 mlp_skip: str = "soft-gating", separable: bool = False,
                 factorization: Optional[str] = "tucker", rank: float = 1.0,
                 implementation: str = "factorized",
                 domain_padding: Optional[float] = None,
                 domain_padding_mode: str = "one-sided",
                 fft_norm: str = "forward", conv_backend: str = "auto",
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if not (len(uno_out_channels) == len(uno_n_modes)
                == len(uno_scalings) == n_layers):
            raise ValueError("uno_out_channels, uno_n_modes and "
                             "uno_scalings need one entry per layer")
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.n_layers = n_layers
        self.n_dim = len(uno_n_modes[0])
        self.domain_padding = domain_padding
        self.domain_padding_mode = domain_padding_mode
        if horizontal_skips_map is None:
            # default U shape: layer n-1-i skips from layer i (uno.py:158)
            horizontal_skips_map = {n_layers - i - 1: i
                                    for i in range(n_layers // 2)}
        self.skips_map = dict(horizontal_skips_map)

        self.lifting = layers.Lifting(in_channels, hidden_channels, **factory)
        prev_out = hidden_channels
        for i in range(n_layers):
            if i in self.skips_map:
                prev_out += uno_out_channels[self.skips_map[i]]
            self.add_module(f"block{i}", FNOBlocks(
                in_channels=prev_out, out_channels=uno_out_channels[i],
                n_modes=tuple(uno_n_modes[i]), n_layers=1,
                output_scaling_factor=uno_scalings[i], use_mlp=use_mlp,
                mlp_dropout=mlp_dropout, mlp_expansion=mlp_expansion,
                non_linearity=non_linearity, norm=norm,
                preactivation=preactivation, fno_skip=fno_skip,
                mlp_skip=mlp_skip, separable=separable,
                factorization=factorization, rank=rank,
                implementation=implementation, fft_norm=fft_norm,
                conv_backend=conv_backend, generator=generator, **factory))
            if i in self.skips_map.values():
                self.add_module(f"hskip{i}", layers.SkipConnection(
                    uno_out_channels[i], uno_out_channels[i],
                    horizontal_skip, **factory))
            prev_out = uno_out_channels[i]
        self.projection = layers.Projection(
            prev_out, out_channels, projection_channels,
            non_linearity=non_linearity, **factory)
        if generator is not None:
            layers.init_linears_(self, generator)

    def forward(self, x, deterministic: bool = True):
        """x: (B, d1..dN, in_channels) -> (B, e1..eN, out_channels)."""
        axes = list(range(1, 1 + self.n_dim))
        x = self.lifting(x)
        padded = self.domain_padding is not None and self.domain_padding > 0
        if padded:
            x = padding_ops.pad_domain(x, self.domain_padding,
                                       self.domain_padding_mode)
        skip_outputs = {}
        for i in range(self.n_layers):
            if i in self.skips_map:
                skip = skip_outputs[self.skips_map[i]]
                factors = [x.shape[a] / skip.shape[a] for a in axes]
                x = torch.cat([x, resample_ops.resample(skip, factors, axes)],
                              dim=-1)
            x = getattr(self, f"block{i}")(x, 0, deterministic=deterministic)
            if i in self.skips_map.values():
                skip_outputs[i] = getattr(self, f"hskip{i}")(x)
        if padded:
            x = padding_ops.unpad_domain(x, self.domain_padding,
                                         self.domain_padding_mode)
        return self.projection(x)
