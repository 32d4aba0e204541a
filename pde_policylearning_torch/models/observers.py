"""Observer models: wall pressure -> off-wall velocity.

Counterpart of `pde_policylearning_tpu/models/observers.py` (reference:
libs/models/fno_models.py:16) for `FNO2dObserver`.  Observers take
channels-last planes: p_plane (B, H, W, 1) [and optionally v_plane],
append a normalized coordinate grid, and regress the target plane.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .fno import FNO


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
