"""PINO models: physics-informed neural operator observers and policies.

Counterpart of `pde_policylearning_tpu/models/pino.py` (reference:
libs/models/pino_models/pinobserver.py (PINObserver2d :129, PlanePredHead
:236, PINObserverFullField :276, PolicyModel2D :378), basics.py
(SpectralConv3d :99, FourierBlock :148), FCN.py (DenseNet :30),
lowrank2d.py (LowRank2d :8)).

Layout: channels-last (B, X, Y, T, C); the trunk is a 3-D spectral conv
plus a pointwise linear skip per layer.  The 3-D convs never reach the
corner kernel (it takes 2-D convs, as the JAX package's Pallas route
does): they run as `torch.fft` and a complex `einsum` per corner, by the
truncated-DFT route's rule for time modes past the spectrum
(`ops.fourier.spectral_conv_nd_dft_rule`).  The parameters keep the flax
tree's names and layouts (`head.trunk.sp0.w0.mm2`, `head.trunk.w0`,
`mnet1.A`, `fc0`), so `utils.transplant.load_jax_params` fills them.
Every module takes `generator` (None: torch's global generator), `device`
(None: the card) and `dtype`; the spectral weights are drawn normal with
std 1 / (in x out), the Dense layers at flax's default scale.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import factorized, fourier
from . import layers as _layers
from .mfn import MFNFourierLayer, MultiplicativeNet
from .spectral_layers import _as_parameters, _as_weight


def get_act(name: str) -> Callable:
    """flax's activations by name (`gelu` is flax's tanh form)."""
    return {"tanh": torch.tanh, "gelu": _layers.gelu, "relu": F.relu,
            "leaky_relu": F.leaky_relu, "none": lambda x: x}[name]


class SpectralConvND(nn.Module):
    """Dense N-D spectral conv (pino basics.py SpectralConv1d/2d/3d): the
    corner-truncated complex contraction, backward norm; weights `w{i}`,
    one per corner, each {'mm2': (2, m1..mN, in, out)}."""

    def __init__(self, in_channels: int, out_channels: int,
                 modes: Sequence[int], generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = _layers.factory(device, dtype)["device"]
        self.modes = tuple(int(m) for m in modes)
        shape = (in_channels, out_channels, *self.modes)
        for i in range(2 ** (len(self.modes) - 1)):
            self.add_module(f"w{i}", _as_parameters(factorized.init_factorized(
                generator, shape, "dense",
                std=1.0 / (in_channels * out_channels), dtype=dtype,
                device=device)))

    def forward(self, x):
        ws = [_as_weight(getattr(self, f"w{i}"))
              for i in range(2 ** (len(self.modes) - 1))]
        return fourier.spectral_conv_nd_dft_rule(x, ws, self.modes)


class PINOTrunk(nn.Module):
    """`len(layers) - 1` x (3-D spectral conv `sp{i}` + pointwise skip
    `w{i}`) with the activation between layers (pinobserver.py:178-183,
    259-266).  `remat` recomputes each module's activations in the
    backward pass (`torch.utils.checkpoint`, flax's `nn.remat`)."""

    def __init__(self, layers: Sequence[int], modes1: Sequence[int],
                 modes2: Sequence[int], modes3: Sequence[int],
                 act: str = "gelu", remat: bool = False, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        f = _layers.factory(device, dtype)
        self.n = len(layers) - 1
        self.act = get_act(act)
        self.remat = remat
        for i in range(self.n):
            a, b = layers[i], layers[i + 1]
            self.add_module(f"sp{i}", SpectralConvND(
                a, b, (modes1[i], modes2[i], modes3[i]), generator, **f))
            self.add_module(f"w{i}", _layers.dense(a, b, generator, **f))

    def forward(self, x):
        for i in range(self.n):
            sp, w = getattr(self, f"sp{i}"), getattr(self, f"w{i}")
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(sp, x, use_reentrant=False) \
                    + checkpoint(w, x, use_reentrant=False)
            else:
                x = sp(x) + w(x)
            if i != self.n - 1:
                x = self.act(x)
        return x


def _pad_t(x, num_pad):
    """Zeros on both ends of the T axis (-2) (pino utils.py add_padding)."""
    if max(num_pad) == 0:
        return x
    return F.pad(x, (0, 0, num_pad[0], num_pad[1]))


def _unpad_t(x, num_pad):
    if max(num_pad) == 0:
        return x
    return x[..., num_pad[0]:x.shape[-2] - num_pad[1], :]


def _num_pad(size_t: int, pad_ratio) -> list:
    return [round(size_t * r) for r in pad_ratio]


def _dense(a: int, b: int, kw: dict) -> nn.Linear:
    """A flax `Dense` from `kw` = {generator, device, dtype}."""
    return _layers.dense(a, b, kw["generator"],
                         **_layers.factory(kw["device"], kw["dtype"]))


class PINObserver2d(nn.Module):
    """lift -> MultiplicativeNet(Re) -> 3-D FNO trunk -> MultiplicativeNet
    -> MLP head (pinobserver.py:129-234).  x: (B, X, Y, T, in_dim), re:
    (B,) -> (B, X, Y, T, out_dim)."""

    def __init__(self, modes1, modes2, modes3, width: int = 16,
                 fc_dim: int = 128, layers: Optional[Sequence[int]] = None,
                 in_dim: int = 4, out_dim: int = 1, act: str = "gelu",
                 pad_ratio: Sequence[float] = (0.0, 0.0),
                 use_fourier_layer: bool = False, remat: bool = False,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        widths = list(layers or [width] * 4)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.act = get_act(act)
        self.pad_ratio = tuple(pad_ratio)
        code = 1
        if use_fourier_layer:
            self.fourier_re = MFNFourierLayer(1, 8, 1.0, **kw)
            code = 8
        self.use_fourier_layer = use_fourier_layer
        self.fc0 = _dense(in_dim, widths[0], kw)
        self.mnet1 = MultiplicativeNet(widths[0], code, widths[0], **kw)
        self.trunk = PINOTrunk(widths, modes1, modes2, modes3, act, remat,
                               **kw)
        self.mnet2 = MultiplicativeNet(widths[-1], code, widths[-1], **kw)
        self.fc1 = _dense(widths[-1], fc_dim, kw)
        self.fc2 = _dense(fc_dim, out_dim, kw)

    def forward(self, x, re):
        num_pad = _num_pad(x.shape[-2], self.pad_ratio)
        code = self.fourier_re(re.reshape(-1, 1)) \
            if self.use_fourier_layer else re
        x = self.mnet1(self.fc0(x), code)
        x = _unpad_t(self.trunk(_pad_t(x, num_pad)), num_pad)
        x = self.mnet2(x, code)
        return self.fc2(self.act(self.fc1(x)))


class PlanePredHead(nn.Module):
    """Shared prediction head: trunk -> unpad -> the parent's mnet2 -> MLP
    (pinobserver.py:236-274)."""

    def __init__(self, layers, modes1, modes2, modes3, fc_dim: int,
                 out_dim: int, act: str = "gelu", generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.act = get_act(act)
        self.trunk = PINOTrunk(layers, modes1, modes2, modes3, act,
                               **kw)
        self.fc1 = _dense(layers[-1], fc_dim, kw)
        self.fc2 = _dense(fc_dim, out_dim, kw)

    def forward(self, x, num_pad, code, mnet2):
        x = mnet2(_unpad_t(self.trunk(x), num_pad), code)
        return self.fc2(self.act(self.fc1(x)))


class _PlaneModel(nn.Module):
    """fc0 -> mnet1(Re / max_re) -> pad T -> `PlanePredHead` (with the
    model's own mnet2), the body `PINObserverFullField` and
    `PolicyModel2D` share (pinobserver.py:276-433)."""

    def __init__(self, head_out: int, modes1, modes2, modes3,
                 width: int = 16, fc_dim: int = 128,
                 layers: Optional[Sequence[int]] = None, in_dim: int = 4,
                 act: str = "gelu", pad_ratio: Sequence[float] = (0.0, 0.0),
                 max_re: float = 1000.0, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        widths = list(layers or [width] * 4)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.pad_ratio = tuple(pad_ratio)
        self.max_re = max_re
        self.fc0 = _dense(in_dim, widths[0], kw)
        self.mnet1 = MultiplicativeNet(widths[0], 1, widths[0], **kw)
        self.mnet2 = MultiplicativeNet(widths[-1], 1, widths[-1], **kw)
        self.head = PlanePredHead(widths, modes1, modes2, modes3, fc_dim,
                                  head_out, act, **kw)

    def planes(self, x, re):
        """x: (B, X, Y, T, in_dim), re: (B,) -> (B, X, Y, T, head_out)."""
        re = re / self.max_re
        num_pad = _num_pad(x.shape[-2], self.pad_ratio)
        x = _pad_t(self.mnet1(self.fc0(x), re), num_pad)
        return self.head(x, num_pad, re, self.mnet2)


class PINObserverFullField(_PlaneModel):
    """Predict `plane_num` planes at once through a shared head
    (pinobserver.py:276-375).  x: (B, X, Y, T, in_dim), re: (B,) ->
    (B, plane_num * out_dim, X, Y, T)."""

    def __init__(self, plane_num: int, modes1, modes2, modes3,
                 out_dim: int = 1, **kw):
        super().__init__(out_dim * plane_num, modes1, modes2, modes3, **kw)

    def forward(self, x, re):
        return torch.movedim(self.planes(x, re), -1, 1)


class PolicyModel2D(_PlaneModel):
    """Residual actuation policy, zeroed so that it starts as a no-op
    (pinobserver.py:378-433).  x: (B, X, Y, T, in_dim), re: (B,) ->
    (B, X, Y, T, out_dim)."""

    def __init__(self, modes1, modes2, modes3, out_dim: int = 1, **kw):
        super().__init__(out_dim, modes1, modes2, modes3, **kw)

    def forward(self, x, re):
        return self.planes(x, re)

    def zero_init_params(self) -> "PolicyModel2D":
        """Zero every parameter in place (the reference zero-inits the whole
        policy so that the residual actuation starts at 0,
        pinobserver.py:432-433); returns the module."""
        with torch.no_grad():
            for p in self.parameters():
                p.zero_()
        return self


class DenseNet(nn.Module):
    """Plain MLP (pino FCN.py:30, libs/utilities3.py:408): Dense `fc{i}`
    with the non-linearity between them."""

    def __init__(self, layers: Sequence[int],
                 nonlinearity: str = "relu",
                 out_nonlinearity: Optional[str] = None, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.n = len(layers) - 1
        self.act = get_act(nonlinearity)
        self.out_act = get_act(out_nonlinearity) \
            if out_nonlinearity is not None else None
        for i in range(self.n):
            self.add_module(f"fc{i}", _dense(layers[i],
                                             layers[i + 1], kw))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            if i != self.n - 1:
                x = self.act(x)
        return self.out_act(x) if self.out_act is not None else x


class LowRank2d(nn.Module):
    """Low-rank integral kernel layer (pino lowrank2d.py:8): psi / phi nets
    on the coordinates, a rank-r contraction over the grid."""

    def __init__(self, width: int, rank: int, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.width, self.rank = width, rank
        self.psi = DenseNet([2, 64, 128, width * rank], **kw)
        self.phi = DenseNet([2, 64, 128, width * rank], **kw)

    def forward(self, v, a):
        """v: (B, N, width) values; a: (B, N, 2) coordinates."""
        b, n, _ = v.shape
        psi = self.psi(a).reshape(b, n, self.width, self.rank)
        phi = self.phi(a).reshape(b, n, self.width, self.rank)
        coeff = torch.einsum("bnwr,bnw->br", psi, v) / n
        return torch.einsum("bnwr,br->bnw", phi, coeff)
