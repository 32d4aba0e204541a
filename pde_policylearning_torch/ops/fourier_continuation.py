"""Fourier continuation: a Legendre-based periodic extension of signals
that are not periodic.

Counterpart of `pde_policylearning_tpu/ops/fourier_continuation.py`
(reference: neuralop/models/fourier_continuation.py:7, FCLegendre).  The
extension matrix is fitted in float64 numpy (cached per (n, d)) and
applied as a product on the tensors' device.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from numpy.polynomial.legendre import Legendre
from torch import nn

from ..utils.device import resolve_device


@lru_cache(maxsize=8)
def _extension_matrix(n: int, d: int) -> np.ndarray:
    """(d, 2n) float64: [right n points, left n points] -> the d values
    that make the signal periodic (fourier_continuation.py:15-45)."""
    a, h = 0.0, 0.1
    total = 2 * n + d
    full_grid = a + h * np.arange(total, dtype=np.float64)
    fit_grid = np.concatenate([full_grid[:n], full_grid[-n:]])
    ext_grid = full_grid[n:-n]
    eye = np.eye(2 * n)
    X = np.zeros((2 * n, 2 * n))
    Q = np.zeros((d, 2 * n))
    for j in range(2 * n):
        poly = Legendre(eye[j], domain=[full_grid[0], full_grid[-1]])
        X[:, j] = poly(fit_grid)
        Q[:, j] = poly(ext_grid)
    return Q @ np.linalg.pinv(X, rcond=1e-31)


class FCLegendre(nn.Module):
    """Extend the last one or two axes of a field by d values each, so
    that it is periodic; `ext_mat` (d, 2n) is a buffer in `dtype` on
    `device` (None: the card)."""

    def __init__(self, n: int, d: int, device=None, dtype=torch.float32):
        super().__init__()
        self.n, self.d = n, d
        self.register_buffer("ext_mat", torch.as_tensor(
            _extension_matrix(n, d), dtype=dtype,
            device=resolve_device(device)))

    def extend_left_right(self, x):
        y = torch.cat([x[..., -self.n:], x[..., :self.n]], dim=-1)
        ext = y @ self.ext_mat.T.to(x.dtype)
        return torch.cat([x, ext], dim=-1)

    def extend_top_bottom(self, x):
        y = torch.cat([x[..., -self.n:, :], x[..., :self.n, :]], dim=-2)
        ext = torch.einsum("dm,...mk->...dk", self.ext_mat.to(x.dtype), y)
        return torch.cat([x, ext], dim=-2)

    def extend2d(self, x):
        return self.extend_top_bottom(self.extend_left_right(x))

    def forward(self, x):
        return self.extend2d(x)
