"""Observer models: wall pressure -> off-wall velocity.

Counterpart of `pde_policylearning_tpu/models/observers.py` (reference:
libs/models/fno_models.py:16 (FNO2dObserver), libs/models/rno_models.py:12
(RNO2dObserver), libs/unet_models.py:94 (UNet)).  Observers take
channels-last planes: p_plane (B, H, W, 1) [and optionally v_plane],
append a normalized coordinate grid where the reference does, and regress
the target plane.  Each takes `generator`, `device` (None: the card),
`dtype` and `conv_backend` for its 2-D spectral convs.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..utils.device import resolve_device
from . import layers
from .fno import FNO
from .rno import RNO2d, RNOSpectralConv2d


def make_grid(shape, dtype=torch.float32, device=None):
    """Normalized (x, y) coordinate channels (B, H, W, 2) for (B, H, W, ...)
    inputs (fno_models.py:51-57)."""
    b, h, w = shape[0], shape[1], shape[2]
    gx = torch.linspace(0, 1, h, dtype=dtype, device=device)
    gy = torch.linspace(0, 1, w, dtype=dtype, device=device)
    return torch.stack([gx[:, None].expand(h, w), gy[None, :].expand(h, w)],
                       -1).expand(b, h, w, 2)


class FNO2dObserver(nn.Module):
    """p_plane [+ v_plane] + grid -> FNO2d -> target plane
    (fno_models.py:16-57).  `generator`, `device` (None: the card), `dtype`
    and `conv_backend` go to the `FNO`."""

    def __init__(self, modes1: int, modes2: int, width: int,
                 use_v_plane: bool = False,
                 reference_act_quirk: bool = False,
                 conv_backend: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.use_v_plane = use_v_plane
        self.fno2d = FNO(
            n_modes=(modes1, modes2), hidden_channels=width,
            in_channels=4 if use_v_plane else 3, out_channels=1,
            reference_act_quirk=reference_act_quirk,
            conv_backend=conv_backend, generator=generator, device=device,
            dtype=dtype)

    def forward(self, p_plane, v_plane=None):
        if p_plane.ndim == 3:
            p_plane = p_plane[..., None]
        feats = [p_plane]
        if self.use_v_plane:
            feats.append(v_plane[..., None] if v_plane.ndim == 3
                         else v_plane)
        feats.append(make_grid(p_plane.shape, p_plane.dtype,
                               p_plane.device))
        return self.fno2d(torch.cat(feats, dim=-1))


class RNO2dObserver(nn.Module):
    """Thin wrapper over RNO2d (rno_models.py:12-15): p_plane (B, T, H, W,
    1) -> the plane at `recurrent_index` (B, H, W, 1)."""

    def __init__(self, modes1: int, modes2: int, width: int,
                 recurrent_index: int = 0, layer_num: int = 1,
                 pad_amount: Optional[tuple] = None, pad_dim: str = "1",
                 conv_backend: str = "auto",
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.rno = RNO2d(modes1, modes2, width,
                         recurrent_index=recurrent_index,
                         layer_num=layer_num, pad_amount=pad_amount,
                         pad_dim=pad_dim, conv_backend=conv_backend,
                         generator=generator, device=device, dtype=dtype)

    def forward(self, p_plane, v_plane=None, timestep: Optional[int] = None,
                deterministic: bool = True):
        return self.rno(p_plane, v_plane, timestep=timestep,
                        deterministic=deterministic)


def _nchw(fn, x):
    """Apply a channels-first op to a channels-last tensor."""
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class DoubleConv(nn.Module):
    """(conv3x3 -> BN -> relu) x 2 (unet_models DoubleConv); channels-last
    in and out.  flax's BatchNorm (momentum 0.99, eps 1e-5) is torch's
    `momentum=0.01`; `train` normalizes by the batch's statistics (the
    population variance, as flax does) and updates the running ones, where
    torch's update takes the unbiased variance and flax's the population
    one.  No trainer of either package trains this module (its
    statistics are not parameters)."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None, generator=None,
                 device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        mid = mid_channels or out_channels
        self.Conv_0 = layers.flax_init_(nn.Conv2d(
            in_channels, mid, 3, padding=1, bias=False, **factory), generator)
        self.BatchNorm_0 = nn.BatchNorm2d(mid, eps=1e-5, momentum=0.01,
                                          **factory)
        self.Conv_1 = layers.flax_init_(nn.Conv2d(
            mid, out_channels, 3, padding=1, bias=False, **factory),
            generator)
        self.BatchNorm_1 = nn.BatchNorm2d(out_channels, eps=1e-5,
                                          momentum=0.01, **factory)

    def forward(self, x, train: bool = False):
        def block(x):
            for conv, bn in ((self.Conv_0, self.BatchNorm_0),
                             (self.Conv_1, self.BatchNorm_1)):
                x = F.relu(F.batch_norm(
                    conv(x), bn.running_mean, bn.running_var, bn.weight,
                    bn.bias, training=train, momentum=bn.momentum,
                    eps=bn.eps))
            return x
        return _nchw(block, x)


class UNet(nn.Module):
    """Encoder-decoder observer with an optional spectral conv in the last
    up-block (libs/unet_models.py:94-135): p_plane (B, H, W[, 1]) + grid
    -> inc -> 4 x (max-pool, DoubleConv) -> 4 x (up, concatenate the skip,
    DoubleConv; the last one a 64 -> 32 channel `RNOSpectralConv2d` with
    `use_spectral_conv`) -> outc.  Up-sampling is a 2 x 2 stride-2
    transposed conv (flax's `ConvTranspose`, see `utils/transplant.py` for
    its kernel), or a nearest repeat with `bilinear`.  `use_v_plane` is
    accepted and unused, as in the reference."""

    def __init__(self, n_classes: int = 1, bilinear: bool = False,
                 use_v_plane: bool = False, use_spectral_conv: bool = True,
                 modes: int = 12, conv_backend: str = "auto",
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.bilinear = bilinear
        self.use_spectral_conv = use_spectral_conv
        factor = 2 if bilinear else 1
        self.inc = layers.dense(3, 32, generator, **factory)
        chans = [32, 64, 128, 256, 512 // factor]
        for i in range(4):
            self.add_module(f"down{i + 1}", DoubleConv(
                chans[i], chans[i + 1], generator=generator, **factory))
        small = chans[4]
        for i, (skip, out) in enumerate(zip(
                chans[3::-1], (256 // factor, 128 // factor, 64 // factor,
                               32))):
            name = f"up{i + 1}"
            if not bilinear:
                self.add_module(f"{name}_tconv", layers.flax_init_(
                    nn.ConvTranspose2d(small, small // 2, 2, stride=2,
                                       **factory), generator))
            cat = skip + (small if bilinear else small // 2)
            if i == 3 and use_spectral_conv:
                self.add_module(f"{name}_spec", RNOSpectralConv2d(
                    cat, out, modes, modes, conv_backend=conv_backend,
                    generator=generator, **factory))
            else:
                self.add_module(name, DoubleConv(cat, out,
                                                 generator=generator,
                                                 **factory))
            small = out
        self.outc = layers.dense(32, n_classes, generator, **factory)

    def _up(self, i, x_small, x_skip, train):
        name = f"up{i}"
        if self.bilinear:
            x_up = x_small.repeat_interleave(2, 1).repeat_interleave(2, 2)
        else:
            x_up = _nchw(getattr(self, f"{name}_tconv"), x_small)
        dh = x_skip.shape[1] - x_up.shape[1]
        dw = x_skip.shape[2] - x_up.shape[2]
        x_up = F.pad(x_up, (0, 0, dw // 2, dw - dw // 2, dh // 2,
                            dh - dh // 2))
        x = torch.cat([x_skip, x_up], dim=-1)
        if i == 4 and self.use_spectral_conv:
            return getattr(self, f"{name}_spec")(x)
        return getattr(self, name)(x, train=train)

    def forward(self, p_plane, v_plane=None, train: bool = False):
        if p_plane.ndim == 3:
            p_plane = p_plane[..., None]
        grid = make_grid(p_plane.shape, p_plane.dtype, p_plane.device)
        xs = [self.inc(torch.cat([p_plane, grid], dim=-1))]
        for i in range(1, 5):
            x = _nchw(lambda a: F.max_pool2d(a, 2, 2), xs[-1])
            xs.append(getattr(self, f"down{i}")(x, train=train))
        x = xs[4]
        for i in range(1, 5):
            x = self._up(i, x, xs[4 - i], train)
        return self.outc(x)
