"""Recurrent Neural Operator (a GRU whose gates are Fourier layers).

Counterpart of `pde_policylearning_tpu/models/rno.py` (reference:
neuralop/models/rno.py: SpectralConv2d :34, SpectralConvWithFC :80,
SpectralRegressor :109, FourierLayer2d :215, RNO_cell :231, RNO_layer
:263, RNO2d :293).

Layout: channels-last (B, [T,] H, W, C).  The recurrence over T is a
Python loop (the JAX package scans it); the autoregressive `predict`
likewise.  Every 2-D spectral conv goes through
`ops.fourier.spectral_conv_nd` with the module's `conv_backend`: on a CUDA
tensor under 'auto', one launch of the corner-contraction kernel between
the FFTs.  Names follow the flax tree (`layer0.scan.cell.f1.spec_conv.w0`,
`regressor.spec0.linear`), so `utils/transplant.load_jax_params` fills
them.  Every module takes `generator` (None: torch's global generator),
`device` (None: the card) and `dtype`; the draws follow the JAX package's
initializers: the spectral weights normal of std sqrt(2) / (in x out), the
input projection's kernel and the scalar gate biases normal(1), every
other dense layer flax's default scale (`layers.flax_init_`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import factorized, fourier
from ..utils.device import resolve_device
from . import layers
from .spectral_layers import _as_parameters, _as_weight


def _activation(name: str):
    return F.silu if name == "silu" else F.relu


def _normal_scalar(generator, **factory) -> nn.Parameter:
    """A scalar parameter drawn from normal(1), as flax's
    `nn.initializers.normal(1.0)` of shape ()."""
    t = torch.empty((), **factory)
    t.normal_(0.0, 1.0, generator=generator)
    return nn.Parameter(t)


class RNOSpectralConv2d(nn.Module):
    """2-D spectral conv keeping modes1 rows (both signs) x modes2 columns,
    'ortho' norm (rno.py:34-77): weights `w0` (low rows), `w1` (high rows),
    each {'mm2': (2, modes1, modes2, in, out)}."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int,
                 modes2: int, norm: str = "ortho", conv_backend: str = "auto",
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.modes = (modes1, modes2)
        self.norm = norm
        self.conv_backend = conv_backend
        # xavier-normal with gain scale * sqrt(in + out) (rno.py:42-48)
        std = 2.0 ** 0.5 / (in_channels * out_channels)
        for i in range(2):
            self.add_module(f"w{i}", _as_parameters(factorized.init_factorized(
                generator, (in_channels, out_channels, modes1, modes2),
                "dense", std=std, dtype=dtype, device=device)))

    def forward(self, x):
        return fourier.spectral_conv_nd(
            x, [_as_weight(self.w0), _as_weight(self.w1)], self.modes,
            fft_norm=self.norm, backend=self.conv_backend)


class FourierLayer2d(nn.Module):
    """Spectral conv + pointwise linear skip (rno.py:215-228)."""

    def __init__(self, modes1: int, modes2: int, width: int,
                 conv_backend: str = "auto", generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        self.spec_conv = RNOSpectralConv2d(width, width, modes1, modes2,
                                           conv_backend=conv_backend,
                                           generator=generator, **factory)
        self.pointwise = layers.dense(width, width, generator, **factory)

    def forward(self, x):
        return self.spec_conv(x) + self.pointwise(x)


class RNOCell(nn.Module):
    """GRU cell whose gates are Fourier layers (rno.py:231-260):
    z = sig(f1(x)+f2(h)+b1); z2 = sig(f7(x)+f8(h)+b4);
    r = sig(f3(x)+f4(h)+b2); h_hat = selu(f5(x)+f6(r*h)+b3);
    h' = (1-z)*h + z2*h_hat.  Eight spectral convs per step."""

    def __init__(self, modes1: int, modes2: int, width: int,
                 conv_backend: str = "auto", generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        for i in range(1, 5):
            setattr(self, f"b{i}", _normal_scalar(generator, **factory))
        for i in range(1, 9):
            self.add_module(f"f{i}", FourierLayer2d(
                modes1, modes2, width, conv_backend, generator, **factory))

    def forward(self, x, h):
        z = torch.sigmoid(self.f1(x) + self.f2(h) + self.b1)
        z2 = torch.sigmoid(self.f7(x) + self.f8(h) + self.b4)
        r = torch.sigmoid(self.f3(x) + self.f4(h) + self.b2)
        h_hat = F.selu(self.f5(x) + self.f6(r * h) + self.b3)
        return (1.0 - z) * h + z2 * h_hat


class _RNOScanStep(nn.Module):
    """The scanned step of the JAX package (holds the cell; the name keeps
    the flax path `scan.cell`)."""

    def __init__(self, modes1, modes2, width, conv_backend="auto",
                 generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        self.cell = RNOCell(modes1, modes2, width, conv_backend, generator,
                            **factory)


class RNOLayer(nn.Module):
    """An RNOCell run over time (rno.py:263-290).

    x: (B, T, H, W, C) -> (B, T, H, W, C) with `return_sequences`, else
    the final hidden state (B, H, W, C).  `remat` recomputes each cell in
    the backward pass (activation memory O(1) in T per layer)."""

    def __init__(self, modes1: int, modes2: int, width: int,
                 return_sequences: bool = False, remat: bool = False,
                 conv_backend: str = "auto", generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        self.width = width
        self.return_sequences = return_sequences
        self.remat = remat
        self.bias_h = _normal_scalar(generator, **factory)
        self.scan = _RNOScanStep(modes1, modes2, width, conv_backend,
                                 generator, **factory)

    def forward(self, x, h: Optional[torch.Tensor] = None):
        B, T, H, W, _ = x.shape
        if h is None:
            h = x.new_zeros((B, H, W, self.width)) + self.bias_h
        cell = self.scan.cell
        ys = []
        for t in range(T):
            if self.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint
                h = checkpoint(cell, x[:, t], h, use_reentrant=False)
            else:
                h = cell(x[:, t], h)
            ys.append(h)
        return torch.stack(ys, 1) if self.return_sequences else h


class SpectralConvWithFC(nn.Module):
    """Linear residual + spectral conv + activation (rno.py:80-106)."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int,
                 modes2: int, dropout: float = 0.1, activation: str = "silu",
                 last_activation: bool = True, conv_backend: str = "auto",
                 generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        self.dropout = dropout
        self.act = _activation(activation) if last_activation else None
        self.linear = layers.dense(in_channels, out_channels, generator,
                                   **factory)
        self.spec_conv = RNOSpectralConv2d(
            in_channels, out_channels, modes1, modes2,
            conv_backend=conv_backend, generator=generator, **factory)

    def forward(self, x, deterministic: bool = True):
        res = self.linear(x)
        if self.dropout > 0 and not deterministic:
            x = F.dropout(x, self.dropout, training=True)
        out = self.spec_conv(x) + res
        return out if self.act is None else self.act(out)


class SpectralRegressor(nn.Module):
    """FNO-style regression head (rno.py:109-212): an optional spatial fc
    (`spacial_fc`: the input concatenated with a grid of `spacial_dim`
    channels), `num_spectral_layers` SpectralConvWithFC blocks, then a
    two-layer MLP."""

    def __init__(self, n_hidden: int, freq_dim: int, out_dim: int,
                 modes: int, num_spectral_layers: int = 2,
                 dim_feedforward: Optional[int] = None,
                 spacial_fc: bool = False, spacial_dim: int = 2,
                 activation: str = "silu", last_activation: bool = True,
                 dropout: float = 0.1, conv_backend: str = "auto",
                 generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        self.spacial_fc = spacial_fc
        self.num_spectral_layers = num_spectral_layers
        self.act = _activation(activation)
        if spacial_fc:
            self.fc = layers.dense(n_hidden + spacial_dim, n_hidden,
                                   generator, **factory)
        for i in range(num_spectral_layers):
            last = i == num_spectral_layers - 1
            self.add_module(f"spec{i}", SpectralConvWithFC(
                n_hidden if i == 0 else freq_dim, freq_dim, modes, modes,
                dropout=dropout, activation=activation,
                last_activation=(last_activation or not last),
                conv_backend=conv_backend, generator=generator, **factory))
        dim_ff = dim_feedforward or 2 * spacial_dim * freq_dim
        self.reg0 = layers.dense(freq_dim, dim_ff, generator, **factory)
        self.reg1 = layers.dense(dim_ff, out_dim, generator, **factory)

    def forward(self, x, grid=None, deterministic: bool = True):
        if self.spacial_fc:
            x = self.fc(torch.cat([x, grid], dim=-1))
        for i in range(self.num_spectral_layers):
            x = getattr(self, f"spec{i}")(x, deterministic=deterministic)
        return self.reg1(self.act(self.reg0(x)))


class RNO2d(nn.Module):
    """Stacked RNO layers with residual connections between them and a
    spectral regression head (rno.py:293-379).

    `forward(x)` runs `timestep` autoregressive steps (the input's length
    unless given) and returns the prediction at `recurrent_index`, as the
    reference's `forward` does.  x: (B, T, H, W, in_dim).  Per predict
    step the layers run 8 spectral convs per timestep they consume (T on
    the first step, 1 on each later one) and the regressor 2."""

    def __init__(self, modes1: int, modes2: int, width: int,
                 recurrent_index: int = 0, layer_num: int = 3,
                 in_dim: int = 1, out_dim: int = 1,
                 pad_amount: Optional[Sequence[int]] = None,
                 pad_dim: str = "1", remat: bool = False,
                 conv_backend: str = "auto",
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.recurrent_index = recurrent_index
        self.layer_num = layer_num
        self.pad_amount = pad_amount
        self.pad_dim = pad_dim
        self.input_projection = layers.dense(in_dim, width, generator,
                                             std=1.0, **factory)
        for i in range(layer_num):
            self.add_module(f"layer{i}", RNOLayer(
                modes1, modes2, width, return_sequences=(i < layer_num - 1),
                remat=remat, conv_backend=conv_backend, generator=generator,
                **factory))
        self.regressor = SpectralRegressor(
            n_hidden=width, freq_dim=width, out_dim=out_dim, modes=modes2,
            activation="relu", dropout=0.3, conv_backend=conv_backend,
            generator=generator, **factory)

    def _pad(self, x):
        if not self.pad_amount:
            return x
        # channels-last: H at -3, W at -2
        if self.pad_dim in ("1", "both"):
            x = F.pad(x, (0, 0, 0, 0, 0, self.pad_amount[0]))
        if self.pad_dim in ("2", "both"):
            x = F.pad(x, (0, 0, 0, self.pad_amount[1]))
        return x

    def _unpad(self, h):
        if not self.pad_amount:
            return h
        if self.pad_dim in ("1", "both"):
            h = h[:, :-self.pad_amount[0], :, :]
        if self.pad_dim in ("2", "both"):
            h = h[:, :, :-self.pad_amount[1], :]
        return h

    def forward_one_step(self, x, init_hidden_states=None,
                         deterministic: bool = True):
        """x: (B, T, H, W, in_dim) -> (pred (B, H, W, out_dim), the final
        hidden state of each layer)."""
        if init_hidden_states is None:
            init_hidden_states = [None] * self.layer_num
        x = self._pad(self.input_projection(x))
        final_states = []
        for i in range(self.layer_num):
            pred = getattr(self, f"layer{i}")(x, init_hidden_states[i])
            if i < self.layer_num - 1:
                x = x + pred          # residual over the sequence (rno.py:344)
                final_states.append(x[:, -1])
            else:
                x = pred
                final_states.append(x)
        pred = self.regressor(self._unpad(x), deterministic=deterministic)
        return pred, final_states

    def predict(self, x, num_steps: int, deterministic: bool = True):
        """Autoregressive rollout (rno.py:370-379): the first step consumes
        the whole input sequence, each later one the previous prediction
        as a one-step sequence.  Returns (B, num_steps, H, W, out_dim)."""
        outputs, states = [], None
        for _ in range(num_steps):
            pred, states = self.forward_one_step(x, states, deterministic)
            outputs.append(pred)
            x = pred[:, None]
        return torch.stack(outputs, 1)

    def forward(self, x, v_plane=None, timestep: Optional[int] = None,
                deterministic: bool = True):
        """timestep None is the reference's behaviour (rno.py:365 shadows
        its default with the input's length): x.shape[1] steps."""
        if timestep is None:
            timestep = x.shape[1]
        preds = self.predict(x, timestep, deterministic)
        return preds[:, self.recurrent_index]
