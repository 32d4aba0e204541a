"""Spherical FNO: spectral convolution through spherical harmonic
transforms.

Counterpart of `pde_policylearning_tpu/models/sfno.py` (reference:
neuralop/models/spherical_convolution.py:165, FactorizedSphericalConv: the
SHT in place of the FFT, and the 'dhconv' contraction, diagonal in m with
weights per degree l).  The transforms are `ops/sht.py`'s; the
contraction is a complex einsum.  Names follow the flax tree (`convs.w{i}`,
`convs.bias`, `skip{i}.conv`, `lifting.fc`, `projection.fc1`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..ops import factorized
from ..ops.sht import irsht, rsht
from ..utils.device import resolve_device
from . import layers
from .spectral_layers import _as_parameters, _as_weight


class SphericalConv(nn.Module):
    """SHT -> truncated per-degree contraction -> inverse SHT.

    n_modes = (lmax, mmax).  'dhconv' weights are (in, out, lmax),
    diagonal in m; 'full' weights are (in, out, lmax, mmax).  `n_layers`
    weights `w{i}` and a bias (n_layers, out); `conv(x, i)` uses layer
    i's.  lmax is clipped to nlat, and mmax to nlon // 2 + 1 and lmax."""

    def __init__(self, in_channels: int, out_channels: int,
                 n_modes: Sequence[int], n_layers: int = 1,
                 use_bias: bool = True, factorization: Optional[str] = None,
                 rank: float = 0.5, contraction: str = "dhconv",
                 grid: str = "equiangular",
                 init_std: Union[str, float] = "auto",
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.n_modes = tuple(int(m) for m in n_modes)
        self.contraction = contraction
        self.grid = grid
        lmax, mmax = self.n_modes
        std = (1.0 / (in_channels * out_channels) if init_std == "auto"
               else float(init_std))
        if contraction == "dhconv":
            wshape = (in_channels, out_channels, lmax)
        else:
            wshape = (in_channels, out_channels, lmax, mmax)
        for i in range(n_layers):
            self.add_module(f"w{i}", _as_parameters(
                factorized.init_factorized(
                    generator, wshape, factorization or "dense", rank=rank,
                    std=std, dtype=dtype, device=device)))
        self.bias = nn.Parameter(torch.zeros(
            (n_layers, out_channels), dtype=dtype, device=device)) \
            if use_bias else None

    def forward(self, x, index: int = 0):
        """x: (B, nlat, nlon, C_in) -> (B, nlat, nlon, C_out)."""
        nlat, nlon = x.shape[-3], x.shape[-2]
        lmax = min(self.n_modes[0], nlat)
        mmax = min(self.n_modes[1], nlon // 2 + 1, lmax)
        in_dtype = x.dtype
        if in_dtype not in (torch.float32, torch.float64):
            x = x.float()
        flm = rsht(x, lmax=lmax, mmax=mmax, grid=self.grid)
        w = factorized.to_dense(_as_weight(getattr(self, f"w{index}")))
        w = w.to(flm.dtype)
        if self.contraction == "dhconv":
            out = torch.einsum("blmi,iol->blmo", flm, w[..., :lmax])
        else:
            out = torch.einsum("blmi,iolm->blmo", flm,
                               w[..., :lmax, :mmax])
        y = irsht(out, nlat, nlon, grid=self.grid)
        if self.bias is not None:
            y = y + self.bias[index]
        if in_dtype not in (torch.float32, torch.float64):
            y = y.to(in_dtype)
        return y


class SFNO(nn.Module):
    """Spherical FNO: lift -> n_layers x (spherical conv + skip, gelu
    between layers) -> project, with one `convs` module holding the
    layers' weights (the reference's FNO with
    SpectralConv=FactorizedSphericalConv).  The parameters live on
    `device` (None: the card); with a `generator` they are all drawn from
    it."""

    def __init__(self, n_modes: Sequence[int], hidden_channels: int,
                 in_channels: int = 3, out_channels: int = 1,
                 lifting_channels: int = 256,
                 projection_channels: int = 256, n_layers: int = 4,
                 factorization: Optional[str] = None, rank: float = 0.5,
                 contraction: str = "dhconv", grid: str = "equiangular",
                 fno_skip: str = "linear",
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.n_layers = n_layers
        self.lifting = layers.Lifting(in_channels, hidden_channels, **factory)
        self.convs = SphericalConv(
            hidden_channels, hidden_channels, tuple(n_modes),
            n_layers=n_layers, factorization=factorization, rank=rank,
            contraction=contraction, grid=grid, generator=generator,
            **factory)
        for i in range(n_layers):
            self.add_module(f"skip{i}", layers.SkipConnection(
                hidden_channels, hidden_channels, fno_skip, **factory))
        self.projection = layers.Projection(
            hidden_channels, out_channels, projection_channels, **factory)
        if generator is not None:
            layers.init_linears_(self, generator)

    def forward(self, x, deterministic: bool = True):
        """x: (B, nlat, nlon, in_channels) -> (B, nlat, nlon,
        out_channels)."""
        x = self.lifting(x)
        for i in range(self.n_layers):
            x = self.convs(x, i) + getattr(self, f"skip{i}")(x)
            if i < self.n_layers - 1:
                x = layers.gelu(x)
        return self.projection(x)
