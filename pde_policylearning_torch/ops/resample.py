"""Fourier / interpolation resampling of fields.

Counterpart of `pde_policylearning_tpu/ops/resample.py` (reference:
neuralop/models/resample.py:7, :58): 1 axis -> linear interpolation,
2 axes -> cubic, >= 3 axes -> spectral truncation / zero-padding with
'forward' norm.

The interpolation is a separable resize with half-pixel centres, the
triangle or Keys cubic (a = -0.5) kernel, widened when downsampling
(antialiasing), weights normalised per output sample: what the JAX
package's resize computes, so the two agree to rounding.
`torch.nn.functional.interpolate` differs (a = -0.75, no antialiasing by
default) and is not used.

Layout: channels-last (B, d1..dN, C); `axes` indexes into the tensor.
"""
from __future__ import annotations

import itertools
from typing import Sequence

import torch

from .fourier import irfftn, rfftn


def _triangle(x):
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _weight_mat(in_size: int, out_size: int, kernel, dtype, device):
    """(in_size, out_size) interpolation weights of one axis."""
    f64 = dict(dtype=torch.float64, device=device)
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, **f64) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, **f64)[:, None]).abs() \
        / kernel_scale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(dtype)


def _interp_resize(x, new_size, axes, kernel):
    for a, s in zip(axes, new_size):
        if x.shape[a] == s:
            continue
        w = _weight_mat(x.shape[a], s, kernel, x.dtype, x.device)
        x = torch.movedim(torch.tensordot(x, w, dims=([a], [0])), -1, a)
    return x


def resample(x: torch.Tensor, res_scale,
             axes: Sequence[int] | int | None = None) -> torch.Tensor:
    """Resample `x` along `axes` by factor(s) `res_scale`."""
    if isinstance(res_scale, (float, int)):
        if axes is None:
            axes = list(range(1, x.ndim - 1))  # all spatial (channels-last)
        elif isinstance(axes, int):
            axes = [axes]
        res_scale = [res_scale] * len(axes)
    else:
        axes = list(axes)
        if len(res_scale) != len(axes):
            raise ValueError("one res_scale per axis expected")

    new_size = [int(round(x.shape[a] * r)) for a, r in zip(axes, res_scale)]
    if len(axes) == 1:
        return _interp_resize(x, new_size, axes, _triangle)
    if len(axes) == 2:
        return _interp_resize(x, new_size, axes, _keys_cubic)
    return _spectral_resample(x, tuple(axes), tuple(new_size))


def _spectral_resample(x, axes, new_size):
    """Spectral resampling (resample.py:31-52): copy the retained corner
    spectrum into a new-size spectrum, zero elsewhere."""
    X = rfftn(x, axes=axes, norm="forward")
    new_fft_size = list(new_size)
    new_fft_size[-1] = new_fft_size[-1] // 2 + 1
    old_fft_size = [X.shape[a] for a in axes]
    kept = [min(i, j) for i, j in zip(new_fft_size, old_fft_size)]

    mode_indexing = [((None, m // 2), (-(m // 2), None)) for m in kept[:-1]] \
        + [((None, kept[-1]),)]
    out_shape = list(X.shape)
    for a, s in zip(axes, new_fft_size):
        out_shape[a] = s
    out = X.new_zeros(out_shape)
    for boundaries in itertools.product(*mode_indexing):
        idx = [slice(None)] * x.ndim
        for a, b in zip(axes, boundaries):
            idx[a] = slice(*b)
        out[tuple(idx)] = X[tuple(idx)]
    return irfftn(out, s=new_size, axes=axes, norm="forward")


def iterative_resample(x, res_scale, axes):
    if isinstance(axes, list) and isinstance(res_scale, (float, int)):
        res_scale = [res_scale] * len(axes)
    if isinstance(axes, list):
        for rs, a in zip(res_scale, axes):
            x = _spectral_1d(x, rs, a)
        return x
    return _spectral_1d(x, res_scale, axes)


def _spectral_1d(x, res_scale, axis):
    """1-axis spectral resample (resample.py:74-90)."""
    old_res = x.shape[axis]
    new_res = int(round(res_scale * old_res))
    X = torch.fft.rfft(x, dim=axis, norm="forward")
    keep = min(new_res, old_res) // 2 + 1
    out_shape = list(x.shape)
    out_shape[axis] = new_res // 2 + 1
    out = X.new_zeros(out_shape)
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, keep)
    out[tuple(sl)] = X[tuple(sl)]
    return torch.fft.irfft(out, n=new_res, dim=axis, norm="forward")
