"""`nn.Module` around the spectral-convolution core op.

Counterpart of `pde_policylearning_tpu/models/spectral_layers.py`
(reference: neuralop/models/spectral_convolution.py:143,
FactorizedSpectralConv and its 1d/2d/3d subclasses; here one rank-generic
module).  The parameters keep the JAX package's names and stored layouts
(`w{i}` per corner and layer, or one joint `weight`; `bias`
(n_layers, out)), so a flax parameter tree loads key by key
(`utils/transplant.py`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..ops import factorized, fourier
from ..utils.device import resolve_device


def _norm_tuple(n_modes) -> tuple[int, ...]:
    if isinstance(n_modes, int):
        return (n_modes,)
    return tuple(int(m) for m in n_modes)


def _as_parameters(weight: dict) -> nn.ParameterDict:
    """A factorized weight dict as registered parameters; the `factors`
    list becomes `factors0`, `factors1`, ..."""
    flat = {}
    for k, v in weight.items():
        if isinstance(v, (list, tuple)):
            flat.update({f"{k}{i}": f for i, f in enumerate(v)})
        else:
            flat[k] = v
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in flat.items()})


def _as_weight(params: nn.ParameterDict) -> dict:
    """Inverse of `_as_parameters`: the dict `ops.factorized` consumes."""
    weight, factors = {}, {}
    for k, v in params.items():
        if k.startswith("factors"):
            factors[int(k[len("factors"):])] = v
        else:
            weight[k] = v
    if factors:
        weight["factors"] = [factors[i] for i in range(len(factors))]
    return weight


class SpectralConv(nn.Module):
    """N-D factorized spectral convolution holding `n_layers` layer weights.

    Calling convention: ``conv(x, index)`` picks layer `index`'s weights,
    so FNOBlocks shares one module across layers (and one tensor under
    joint factorization).

    `n_modes` are total mode counts per dim; each corner keeps `m//2`
    (spectral_convolution.py:196-203).  `backend` is
    `ops.fourier.spectral_conv_nd`'s: 'auto' sends an eligible 2-D conv on
    a CUDA tensor through the corner-contraction kernel.  The weights are
    drawn from `generator` (the global generator when None) on `device`
    (None: the card).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 n_modes: Union[int, Sequence[int]], n_layers: int = 1,
                 separable: bool = False,
                 factorization: Optional[str] = None, rank: float = 0.5,
                 implementation: str = "reconstructed",
                 joint_factorization: bool = False, use_bias: bool = True,
                 backend: str = "auto", fft_norm: str = "backward",
                 init_std: Union[str, float] = "auto",
                 output_scaling_factor=None,
                 incremental_n_modes: Optional[Sequence[int]] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        modes = _norm_tuple(n_modes)
        self.order = len(modes)
        self.half_total_n_modes = tuple(m // 2 for m in modes)
        self.n_corners = 2 ** (self.order - 1)
        self.n_layers = n_layers
        self.separable = separable
        self.implementation = implementation
        self.joint_factorization = joint_factorization
        self.backend = backend
        self.fft_norm = fft_norm
        self.output_scaling_factor = output_scaling_factor
        self.incremental_n_modes = incremental_n_modes
        std = (1.0 / (in_channels * out_channels) if init_std == "auto"
               else float(init_std))
        fact = factorization or "dense"
        if separable:
            if in_channels != out_channels:
                raise ValueError(
                    "separable requires in_channels == out_channels, got "
                    f"{in_channels} != {out_channels}")
            wshape = (in_channels, *self.half_total_n_modes)
        else:
            wshape = (in_channels, out_channels, *self.half_total_n_modes)

        n_total = self.n_corners * n_layers
        n_lead = len(wshape) - self.order  # 1 separable, 2 regular

        def init(shape, lead):
            return _as_parameters(factorized.init_factorized(
                generator, shape, fact, rank=rank, std=std, dtype=dtype,
                n_lead=lead, device=device))

        if joint_factorization:
            self.weight = init((n_total, *wshape), n_lead + 1)
        else:
            for i in range(n_total):
                self.add_module(f"w{i}", init(wshape, n_lead))
        self.bias = nn.Parameter(torch.zeros(
            (n_layers, out_channels), dtype=dtype, device=device)) \
            if use_bias else None

    def _layer_weights(self, index: int):
        base = self.n_corners * index
        if self.joint_factorization:
            joint = _as_weight(self.weight)
            return [factorized.take_layer(joint, base + i)
                    for i in range(self.n_corners)]
        return [_as_weight(getattr(self, f"w{base + i}"))
                for i in range(self.n_corners)]

    def forward(self, x, index: int = 0,
                half_modes: Optional[Sequence[int]] = None):
        """x: (B, d1..dN, C_in) -> (B, e1..eN, C_out).

        `half_modes` overrides the per-corner mode counts at call time (the
        incremental_n_modes mechanism); must be <= half_total_n_modes."""
        if half_modes is None:
            if self.incremental_n_modes is not None:
                inc = _norm_tuple(self.incremental_n_modes)
                half_modes = tuple(m // 2 for m in inc)
            else:
                half_modes = self.half_total_n_modes
        ws = self._layer_weights(index)
        if tuple(half_modes) != self.half_total_n_modes:
            ws = [fourier.slice_weight_modes(w, half_modes, self.separable)
                  for w in ws]
        output_sizes = None
        if self.output_scaling_factor is not None:
            factor = self.output_scaling_factor[index]
            if isinstance(factor, (int, float)):
                factor = [factor] * self.order
            output_sizes = [
                int(round(s * r))
                for s, r in zip(x.shape[1:1 + self.order], factor)]
        bias = self.bias[index] if self.bias is not None else None
        return fourier.spectral_conv_nd(
            x, ws, half_modes,
            fft_norm=self.fft_norm,
            separable=self.separable,
            implementation=self.implementation,
            bias=bias,
            output_sizes=output_sizes,
            backend=self.backend,
        )
