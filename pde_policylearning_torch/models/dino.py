"""DINo: an implicit-neural-representation forecaster.

Counterpart of `pde_policylearning_tpu/models/dino.py` (reference:
libs/DINo/ode_model.py:21-46 (Derivative, Decoder), libs/DINo/network.py
:96-130 (MLP, SetEncoder), the training flow of train_dino.py).

A FourierNet INR decodes (coordinates, latent code) -> field value; a
swish MLP is the vector field of the latent codes in time; a forecast is
the fixed-step RK4 integration of the code ODE, then the decode.  The
parameters keep the flax names (`net.fc0` ... `net.fc3`, `net.filter{i}`,
`net.bilinear{i}`, `net.output`, `ave_kernel`, `ave_bias`), so a flax tree
loads key by key (`utils/transplant.py:load_jax_params`).  The Dense
layers are drawn as flax draws them (`layers.flax_init_`) from
`generator`; `device` None is the card.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from . import layers
from .mfn import FourierNet


class SwishMLP(nn.Module):
    """A 4-layer swish MLP (network.py:96-110): three hidden layers of
    `hidden_size`, each followed by x * sigmoid(x), then `fc3` to
    `out_size` (default: `in_size`)."""

    def __init__(self, in_size: int, hidden_size: int,
                 out_size: Optional[int] = None, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        f = layers.factory(device, dtype)
        widths = [in_size] + [hidden_size] * 3
        for i in range(3):
            self.add_module(f"fc{i}", layers.dense(widths[i], widths[i + 1],
                                                   generator, **f))
        self.fc3 = layers.dense(hidden_size, out_size or in_size, generator,
                                **f)

    def forward(self, x):
        for i in range(3):
            x = nn.functional.silu(getattr(self, f"fc{i}")(x))
        return self.fc3(x)


class Derivative(nn.Module):
    """The latent codes' vector field du/dt = MLP(u) (ode_model.py:21-28);
    the codes are (B, state_c * code_c)."""

    def __init__(self, state_c: int, code_c: int, hidden_c: int,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.net = SwishMLP(state_c * code_c, hidden_c, generator=generator,
                            device=device, dtype=dtype)

    def forward(self, t, u):
        return self.net(u)


class Decoder(nn.Module):
    """The INR decoder: FourierNet(coords, code) -> value
    (ode_model.py:31-46), input scale 64.  x: (..., coord_dim); codes
    (B, state_c * code_c), broadcast over x's middle axes."""

    def __init__(self, state_c: int, hidden_c: int, code_c: int,
                 coord_dim: int, n_layers: int = 3, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.net = FourierNet(coord_dim, state_c * code_c, hidden_c, 1,
                              n_layers, input_scale=64.0,
                              generator=generator, device=device,
                              dtype=dtype)

    def forward(self, x, codes):
        return self.net(x, codes)


class SetEncoder(nn.Module):
    """Aggregate n_cond per-frame codes into one (network.py:113-130):
    a swish MLP per frame, then the reference's Conv1d(code, code, n_cond)
    over the frame axis as a weighted sum, `ave_kernel` (n_cond, C, C)
    drawn lecun-normal and `ave_bias` (C,) zero."""

    def __init__(self, code_size: int, n_cond: int, hidden_size: int,
                 out_size: Optional[int] = None, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        out = out_size or code_size
        self.net = SwishMLP(code_size, hidden_size, out_size,
                            generator=generator, device=device, dtype=dtype)
        kernel = torch.empty(n_cond, out, out, device=device, dtype=dtype)
        kernel.normal_(0.0, (n_cond * out) ** -0.5, generator=generator)
        self.ave_kernel = nn.Parameter(kernel)
        self.ave_bias = nn.Parameter(torch.zeros(out, device=device,
                                                 dtype=dtype))

    def forward(self, x):
        """x: (B, n_cond, code_size) -> (B, out_size)."""
        h = self.net(x)
        return torch.einsum("bnc,ncd->bd", h, self.ave_kernel) \
            + self.ave_bias


def odeint_rk4(f: Callable, y0: torch.Tensor, ts: torch.Tensor
               ) -> torch.Tensor:
    """Fixed-step RK4 over the time grid `ts` (the reference's torchdiffeq
    rk4, train_dino.py:234-236); f(t, y) -> dy/dt.  Returns
    (T, *y0.shape), y0 first."""
    ys = [y0]
    y = y0
    for t0, t1 in zip(ts[:-1], ts[1:]):
        h = t1 - t0
        k1 = f(t0, y)
        k2 = f(t0 + h / 2, y + h / 2 * k1)
        k3 = f(t0 + h / 2, y + h / 2 * k2)
        k4 = f(t1, y + h * k3)
        y = y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        ys.append(y)
    return torch.stack(ys)
