"""Data normalizers as small classes over tensors.

Counterpart of `pde_policylearning_tpu/ops/normalization.py` (reference:
neuralop/utils.py:6, libs/utilities3.py:74, :150-292).  Each normalizer
holds its statistics as tensors on one device; `.to(device)` returns a
copy on another.  The statistics are population statistics (`jnp.std`
divides by N; `torch.std` would divide by N-1 by default).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class _MeanStd:
    mean: torch.Tensor
    std: torch.Tensor
    eps: float

    def encode(self, x):
        return (x - self.mean) / (self.std + self.eps)

    def decode(self, x):
        return x * (self.std + self.eps) + self.mean

    def to(self, device=None, dtype=None):
        """A copy with the statistics on `device` (and in `dtype`)."""
        return type(self)(self.mean.to(device=device, dtype=dtype),
                          self.std.to(device=device, dtype=dtype), self.eps)


@dataclass
class UnitGaussianNormalizer(_MeanStd):
    """Per-location mean/std computed over the sample axis
    (neuralop/utils.py:6)."""
    eps: float = 1e-5

    @classmethod
    def fit(cls, x, dim=None, eps=1e-5):
        # dim=None: statistics over the first axis (per-location)
        dim = 0 if dim is None else dim
        return cls(torch.mean(x, dim=dim),
                   torch.std(x, dim=dim, correction=0), eps)


@dataclass
class NormalizerGivenMeanStd(_MeanStd):
    """Fixed mean/std from dataset metadata (libs/utilities3.py:74)."""
    eps: float = 1e-8


@dataclass
class GaussianNormalizer(_MeanStd):
    """Scalar mean/std over the whole dataset (libs/utilities3.py:221)."""
    eps: float = 1e-5

    @classmethod
    def fit(cls, x, eps=1e-5):
        return cls(torch.mean(x), torch.std(x, correction=0), eps)


@dataclass
class RangeNormalizer:
    """Affine map to [low, high] (libs/utilities3.py:252)."""
    a: torch.Tensor
    b: torch.Tensor

    @classmethod
    def fit(cls, x, low=0.0, high=1.0):
        flat = x.reshape(x.shape[0], -1)
        mymin = flat.min(dim=0).values
        mymax = flat.max(dim=0).values
        a = (high - low) / (mymax - mymin)
        return cls(a=a, b=-a * mymax + high)

    def encode(self, x):
        flat = x.reshape(x.shape[0], -1)
        return (self.a * flat + self.b).reshape(x.shape)

    def decode(self, x):
        flat = x.reshape(x.shape[0], -1)
        return ((flat - self.b) / self.a).reshape(x.shape)

    def to(self, device=None, dtype=None):
        return RangeNormalizer(self.a.to(device=device, dtype=dtype),
                               self.b.to(device=device, dtype=dtype))


class IdentityNormalizer:
    def encode(self, x):
        return x

    def decode(self, x):
        return x

    def to(self, device=None, dtype=None):
        return self
