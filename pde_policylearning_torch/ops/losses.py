"""Loss functions: relative/absolute Lp, Sobolev H1/Hs, dissipative reg.

Counterpart of `pde_policylearning_tpu/ops/losses.py` (reference:
neuralop/training/losses.py (LpLoss :62, H1Loss :138, DissipativeLoss
:280, central_diff_{1,2,3}d :8-58) and libs/utilities3.py (LpLoss :295,
HsLoss :341)).  Pure functions of tensors -> scalar (or per-sample
vector), differentiable, layout-agnostic (they flatten the trailing `d`
dims).
"""
from __future__ import annotations

import math

import torch


# ---------------------------------------------------------------------------
# central differences (periodic roll; optionally one-sided at boundaries)
# ---------------------------------------------------------------------------

def _diff(x, h, axis, fix_bnd):
    d = (torch.roll(x, -1, axis) - torch.roll(x, 1, axis)) / (2.0 * h)
    if fix_bnd:
        d = d.clone()
        n = x.shape[axis]
        first = (x.narrow(axis, 1, 1) - x.narrow(axis, 0, 1)) / h
        last = (x.narrow(axis, n - 1, 1) - x.narrow(axis, n - 2, 1)) / h
        d.narrow(axis, 0, 1).copy_(first)
        d.narrow(axis, n - 1, 1).copy_(last)
    return d


def central_diff_1d(x, h, fix_x_bnd=False):
    return _diff(x, h, -1, fix_x_bnd)


def central_diff_2d(x, h, fix_x_bnd=False, fix_y_bnd=False):
    if isinstance(h, float):
        h = [h, h]
    return (_diff(x, h[0], -2, fix_x_bnd), _diff(x, h[1], -1, fix_y_bnd))


def central_diff_3d(x, h, fix_x_bnd=False, fix_y_bnd=False, fix_z_bnd=False):
    if isinstance(h, float):
        h = [h, h, h]
    return (_diff(x, h[0], -3, fix_x_bnd), _diff(x, h[1], -2, fix_y_bnd),
            _diff(x, h[2], -1, fix_z_bnd))


# ---------------------------------------------------------------------------
# Lp losses
# ---------------------------------------------------------------------------

def _flat_norm(x, d, p):
    flat = x.reshape(*x.shape[:x.ndim - d], -1)
    if p == 2:
        return torch.sqrt(torch.sum(flat * flat, dim=-1))
    return torch.sum(torch.abs(flat) ** p, dim=-1) ** (1.0 / p)


class _Reduced:
    """The reduction over the leading (batch) dims shared by LpLoss and
    H1Loss: `reductions` ('sum' or 'mean') over `reduce_dims`, then
    squeezed."""

    def _setup(self, d, L, reduce_dims, reductions):
        self.d = d
        if isinstance(reduce_dims, int):
            reduce_dims = [reduce_dims]
        self.reduce_dims = reduce_dims
        if reduce_dims is not None:
            if isinstance(reductions, str):
                reductions = [reductions] * len(reduce_dims)
            self.reductions = reductions
        if isinstance(L, float):
            L = [L] * d
        self.L = L

    def uniform_h(self, x):
        return [self.L[-j] / x.shape[-j] for j in range(self.d, 0, -1)]

    def reduce_all(self, x):
        for dim, red in zip(self.reduce_dims, self.reductions):
            x = (torch.sum if red == "sum" else torch.mean)(x, dim=dim,
                                                             keepdim=True)
        return x

    def _reduce(self, x):
        return x if self.reduce_dims is None else self.reduce_all(x).squeeze()

    def _h(self, x, h):
        if h is None:
            return self.uniform_h(x)
        return [h] * self.d if isinstance(h, float) else h


class LpLoss(_Reduced):
    """Relative / absolute Lp loss over the last `d` dims
    (neuralop/training/losses.py:62).  Calling the object computes the
    relative loss; the reduction over the remaining (batch) dims follows
    `reductions`."""

    def __init__(self, d=1, p=2, L=2 * math.pi, reduce_dims=0,
                 reductions="sum"):
        self.p = p
        self._setup(d, L, reduce_dims, reductions)

    def abs(self, x, y, h=None):
        const = math.prod(self._h(x, h)) ** (1.0 / self.p)
        return self._reduce(const * _flat_norm(x - y, self.d, self.p))

    def rel(self, x, y):
        return self._reduce(_flat_norm(x - y, self.d, self.p)
                            / _flat_norm(y, self.d, self.p))

    def __call__(self, x, y):
        return self.rel(x, y)


class SimpleLpLoss:
    """The libs/utilities3.py:295 LpLoss: flattens all but the batch dim;
    `size_average` picks mean or sum over the batch."""

    def __init__(self, d=2, p=2, size_average=True, reduction=True):
        self.d, self.p = d, p
        self.size_average = size_average
        self.reduction = reduction

    def _reduce(self, v):
        if self.reduction:
            return torch.mean(v) if self.size_average else torch.sum(v)
        return v

    def abs(self, x, y):
        num = x.shape[0]
        h = 1.0 / (x.shape[1] - 1.0)
        return self._reduce((h ** (self.d / self.p)) * torch.linalg.norm(
            (x - y).reshape(num, -1), self.p, dim=1))

    def rel(self, x, y):
        num = x.shape[0]
        diff = torch.linalg.norm(x.reshape(num, -1) - y.reshape(num, -1),
                                 self.p, dim=1)
        return self._reduce(diff / torch.linalg.norm(y.reshape(num, -1),
                                                     self.p, dim=1))

    def __call__(self, x, y):
        return self.rel(x, y)


def relative_l2(pred, target, axis=None):
    """Plain relative L2, the libs/env_util.py:13 `relative_loss`."""
    return torch.linalg.vector_norm(pred - target) \
        / torch.linalg.vector_norm(target)


class H1Loss(_Reduced):
    """Sobolev H1 loss through central differences over the last `d` dims
    (neuralop/training/losses.py:138)."""

    def __init__(self, d=1, L=2 * math.pi, reduce_dims=0, reductions="sum",
                 fix_x_bnd=False, fix_y_bnd=False, fix_z_bnd=False):
        if not 1 <= d <= 3:
            raise ValueError(f"H1Loss: d must be 1, 2 or 3, got {d}")
        self.fix_bnd = [fix_x_bnd, fix_y_bnd, fix_z_bnd]
        self._setup(d, L, reduce_dims, reductions)

    def _derivs(self, x, h):
        if self.d == 1:
            return [central_diff_1d(x, h[0], fix_x_bnd=self.fix_bnd[0])]
        if self.d == 2:
            return list(central_diff_2d(x, h, *self.fix_bnd[:2]))
        return list(central_diff_3d(x, h, *self.fix_bnd))

    def _sq(self, x):
        flat = x.reshape(*x.shape[:x.ndim - self.d], -1)
        return torch.sum(flat * flat, dim=-1)

    def _parts(self, x, y, h):
        dxs, dys = self._derivs(x, h), self._derivs(y, h)
        diff = self._sq(x - y) + sum(self._sq(a - b)
                                     for a, b in zip(dxs, dys))
        return diff, self._sq(y) + sum(self._sq(b) for b in dys)

    def rel(self, x, y, h=None):
        diff, ynorm = self._parts(x, y, self._h(x, h))
        return self._reduce(torch.sqrt(diff) / torch.sqrt(ynorm))

    def abs(self, x, y, h=None):
        h = self._h(x, h)
        diff, _ = self._parts(x, y, h)
        return self._reduce(torch.sqrt(math.prod(h) * diff))

    def __call__(self, x, y, h=None):
        return self.rel(x, y, h=h)


class HsLoss:
    """Spectral Sobolev loss (libs/utilities3.py:341): the FFT difference
    weighted by sqrt(1 + a1^2 k^2 + a2^2 k^4)."""

    def __init__(self, d=2, p=2, k=1, a=None, group=False, size_average=True,
                 reduction=True):
        self.d, self.p, self.k = d, p, k
        self.balanced = group
        self.size_average = size_average
        self.reduction = reduction
        self.a = [1.0] * k if a is None else a

    def __call__(self, x, y):
        nx, ny = x.shape[1], x.shape[2]
        kw = dict(dtype=x.dtype, device=x.device)
        k_x = torch.fft.fftfreq(nx, d=1.0 / nx, **kw).reshape(nx, 1)
        k_y = torch.fft.fftfreq(ny, d=1.0 / ny, **kw).reshape(1, ny)
        x_ft = torch.fft.fftn(x, dim=(1, 2))
        y_ft = torch.fft.fftn(y, dim=(1, 2))
        bshape = (1, nx, ny) + (1,) * (x.ndim - 3)
        ones = torch.ones((nx, ny), **kw)
        kx = torch.reshape(k_x * ones, bshape)
        ky = torch.reshape(k_y * ones, bshape)
        weight = torch.ones_like(kx)
        if self.k >= 1:
            weight = weight + self.a[0] ** 2 * (kx ** 2 + ky ** 2)
        if self.k >= 2:
            weight = weight + self.a[1] ** 2 * (kx ** 2 + ky ** 2) ** 2
        weight = torch.sqrt(weight)
        num = x.shape[0]
        diff = torch.linalg.norm((weight * (x_ft - y_ft)).reshape(num, -1),
                                 self.p, dim=1)
        ynorm = torch.linalg.norm((weight * y_ft).reshape(num, -1), self.p,
                                  dim=1)
        out = diff / ynorm
        if self.reduction:
            return torch.mean(out) if self.size_average else torch.sum(out)
        return out


def dissipative_loss(model_pred_norms, x_norms, scale_down, loss_weight=1.0):
    """Dissipativity regularization core (losses.py:280): pushes
    ||model(x)|| towards scale_down * ||x|| for inputs sampled on an outer
    shell; the caller samples the shell and passes the norms."""
    return loss_weight * torch.mean(
        (model_pred_norms - scale_down * x_norms) ** 2)
