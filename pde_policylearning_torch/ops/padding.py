"""Domain padding for non-periodic inputs.

Counterpart of `pde_policylearning_tpu/ops/padding.py` (reference:
neuralop/models/padding.py:4, DomainPadding) as a pure function pair.

Layout: channels-last (B, d1..dN, C); padding applies to the spatial axes.
"""
from __future__ import annotations

import torch


def _fractions(domain_padding, n):
    if isinstance(domain_padding, (float, int)):
        return [float(domain_padding)] * n
    return list(domain_padding)


def pad_domain(x: torch.Tensor, domain_padding, mode: str = "one-sided"
               ) -> torch.Tensor:
    """Zero-pad each spatial axis by a fraction of its resolution."""
    resolution = x.shape[1:-1]
    amounts = [int(round(p * r)) for p, r in zip(
        _fractions(domain_padding, len(resolution)), resolution)]
    mode = mode.lower()
    if mode not in ("symmetric", "one-sided"):
        raise ValueError(f"Got padding mode {mode!r}")
    # F.pad lists (before, after) pairs from the last axis backwards
    pads = [0, 0]
    for p in reversed(amounts):
        pads += [p if mode == "symmetric" else 0, p]
    return torch.nn.functional.pad(x, pads)


def unpad_domain(x: torch.Tensor, domain_padding, mode: str = "one-sided",
                 output_scaling_factor=None) -> torch.Tensor:
    """Inverse of `pad_domain`.

    `output_scaling_factor`: if the model rescaled the (padded) domain, the
    pad amounts to strip scale accordingly (padding.py:57-63).  The unpadded
    original resolution is recovered from the padded input."""
    resolution = x.shape[1:-1]
    mode = mode.lower()
    fractions = _fractions(domain_padding, len(resolution))
    scales = _fractions(1.0 if output_scaling_factor is None
                        else output_scaling_factor, len(resolution))
    # padded_size = (orig + k*pad) * scale  with k=1 (one-sided) or 2
    k = 2 if mode == "symmetric" else 1
    idx = [slice(None)]
    for size, frac, scale in zip(resolution, fractions, scales):
        orig = int(round(size / scale / (1 + k * frac)))
        pad = int(round(frac * orig * scale))
        if pad == 0:
            idx.append(slice(None))
        elif mode == "symmetric":
            idx.append(slice(pad, -pad))
        else:
            idx.append(slice(None, -pad))
    idx.append(slice(None))
    return x[tuple(idx)]
