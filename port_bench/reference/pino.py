"""Plain reference of the PINO plane models and of Adam, independent of
the program.

The body of `PINObserverFullField` and `PolicyModel2D` (pinobserver.py of
the paper's code, :276-433): a pointwise lift, a multiplicative net of the
Reynolds number over max_re, zero padding of the time axis, L layers of a
3-D spectral conv (real FFT over X, Y, T; four corners of m1 x m2 x m3
modes, each a dense complex contraction over the channels; the inverse
FFT) plus a pointwise skip, with flax's tanh GELU between them, the
padding cut off, a second multiplicative net and a two-layer head.  A time
axis whose spectrum holds fewer than m3 modes keeps the modes it holds.

Weights are a dict by the flax tree's names (the layout the program also
keeps): `fc0.weight` (w, in), `mnet1.A` (w, 1), `mnet1.B` (w, w),
`mnet1.bias`, `head.trunk.sp{i}.w{c}.mm2` (2, m1, m2, m3, in, out) real and
imaginary parts, `head.trunk.w{i}.weight`, `head.fc1`, `head.fc2`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import precision


def gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def linear(x, p, name):
    return precision.matmul(x, p[f"{name}.weight"].T) + p[f"{name}.bias"]


def mnet(x, code, p, name):
    """x @ B^T + code @ A^T + bias, the code broadcast over the grid."""
    c = precision.matmul(code[:, None], p[f"{name}.A"].T).reshape(
        code.shape[0], *([1] * (x.ndim - 2)), -1)
    return precision.matmul(x, p[f"{name}.B"].T) + c + p[f"{name}.bias"]


def spectral_conv(x, ws, modes):
    """x (B, X, Y, T, I) real; ws four (2, m1, m2, m3, I, O) weights in the
    corner order (low x, low y), (low x, high y), (high x, low y), (high x,
    high y)."""
    B, X, Y, T, _ = x.shape
    m1, m2, m3 = modes
    m3 = min(m3, T // 2 + 1)
    xf = torch.fft.rfftn(x, dim=(1, 2, 3))
    out = xf.new_zeros((*xf.shape[:-1], ws[0].shape[-1]))
    cx = (slice(None, m1), slice(X - m1, None))
    cy = (slice(None, m2), slice(Y - m2, None))
    corners = [(a, b) for a in cx for b in cy]
    for w, (sx, sy) in zip(ws, corners):
        wc = torch.complex(w[0, :, :, :m3], w[1, :, :, :m3])   # (m1,m2,m3,I,O)
        blk = xf[:, sx, sy, :m3]
        out[:, sx, sy, :m3] = precision.einsum("bxyti,xytio->bxyto", blk, wc)
    return torch.fft.irfftn(out, s=(X, Y, T), dim=(1, 2, 3))


def plane_model(p, x, re, *, n_layers, modes, pad_ratio, max_re=1000.0):
    """x (B, X, Y, T, in) and re (B,) -> (B, X, Y, T, out)."""
    code = re / max_re
    T = x.shape[-2]
    pad = [round(T * r) for r in pad_ratio]
    h = mnet(linear(x, p, "fc0"), code, p, "mnet1")
    if max(pad):
        h = F.pad(h, (0, 0, pad[0], pad[1]))
    for i in range(n_layers):
        ws = [p[f"head.trunk.sp{i}.w{c}.mm2"] for c in range(4)]
        h = spectral_conv(h, ws, modes) + linear(h, p, f"head.trunk.w{i}")
        if i != n_layers - 1:
            h = gelu(h)
    if max(pad):
        h = h[..., pad[0]:h.shape[-2] - pad[1], :]
    h = mnet(h, code, p, "mnet2")
    return linear(gelu(linear(h, p, "head.fc1")), p, "head.fc2")


def adam_step(params: dict, grads: dict, m: dict, v: dict, t: int, lr: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam step (Kingma and Ba, no weight decay) in place; `t` counts
    from 1."""
    with torch.no_grad():
        for k, g in grads.items():
            m[k].mul_(b1).add_((1 - b1) * g)
            v[k].mul_(b2).add_((1 - b2) * g * g)
            mh = m[k] / (1 - b1 ** t)
            vh = v[k] / (1 - b2 ** t)
            params[k].sub_(lr * mh / (vh.sqrt() + eps))
