"""Spectral convolution core ops (channels-last).

Counterpart of `pde_policylearning_tpu/ops/fourier.py` for the FFT route:
rfftn -> truncated-corner complex contraction -> irfftn (reference:
neuralop/models/spectral_convolution.py:143, 303-347), on channels-last
`(B, d1..dN, C)` activations.  The transforms are `torch.fft`; what lies
between them (corner gather, contraction, scatter into the output spectrum)
is, for an eligible 2-D call on the card, one launch of the hand-written
kernel of `ops/spectral_cuda.py`.
"""
from __future__ import annotations

import itertools
from functools import partial
from typing import Optional, Sequence

import torch

from . import factorized


def rfftn(x: torch.Tensor, axes, norm: str = "backward") -> torch.Tensor:
    if norm not in ("backward", "forward", "ortho"):
        raise ValueError(f"Unknown fft norm {norm!r}")
    return torch.fft.rfftn(x, dim=tuple(axes), norm=norm)


def irfftn(x_ft: torch.Tensor, s, axes, norm: str = "backward"
           ) -> torch.Tensor:
    """Inverse of `rfftn` onto spatial sizes `s`: each axis of the spectrum
    is cut or zero-padded at its end to fit `s`, and the imaginary parts of
    the DC and Nyquist bins of the last axis are dropped."""
    if norm not in ("backward", "forward", "ortho"):
        raise ValueError(f"Unknown fft norm {norm!r}")
    return torch.fft.irfftn(x_ft, s=tuple(s), dim=tuple(axes), norm=norm)


def corner_slices(half_modes: Sequence[int]) -> list[tuple[slice, ...]]:
    """Spectral-corner slice tuples over the mode axes, in the reference's
    weight enumeration order (spectral_convolution.py:330-337): the last
    (rfft) axis keeps only low modes; every other axis contributes a
    (low, high) pair, enumerated with itertools.product."""
    per_dim = [
        ((slice(None, m)), (slice(-m, None))) for m in half_modes[:-1]
    ] + [(slice(None, half_modes[-1]),)]
    return [tuple(c) for c in itertools.product(*per_dim)]


def slice_weight_modes(params: dict, half_modes: Sequence[int],
                       separable: bool = False) -> dict:
    """Restrict a factorized weight to its first `half_modes` modes per axis
    (the `incremental_n_modes` mechanism, spectral_convolution.py:286-301)."""
    order = len(half_modes)
    kind = factorized.factorization_of(params)
    if kind == "dense":
        if "tensor" in params:
            t = params["tensor"]  # (2, I[, O], m1..mN)
            idx = (slice(None),) * (t.ndim - order) + tuple(
                slice(None, m) for m in half_modes)
            return {"tensor": t[idx]}
        key, _ = factorized._dense_mm_key(params)
        t = params[key]  # (2, m1..mN, lead...)
        idx = (slice(None),) + tuple(slice(None, m) for m in half_modes)
        return {key: t[idx]}
    factors = list(params["factors"])
    for k, m in enumerate(half_modes):
        f = factors[-order + k]
        factors[-order + k] = f[:, :, :m, :] if kind == "tt" else f[:, :m, :]
    if kind == "tucker":
        return {"core": params["core"], "factors": factors}
    if kind == "cp":
        return {"lambda": params["lambda"], "factors": factors}
    return {"factors": factors}


def kernel_eligible(x: torch.Tensor, weights: Sequence[dict],
                    half_modes: Sequence[int], separable: bool) -> bool:
    """Whether a call can take the corner-contraction kernel: a 2-D,
    non-separable conv of a rank-4 float32 input with two dense weights
    (the JAX package's test for its fused route, fourier.py:506-508; the
    kernel is float32 only).  A Tucker, CP or TT weight is not eligible:
    the kernel contracts a dense weight, and rebuilding one on every call
    would ignore the caller's `implementation`."""
    return (len(half_modes) == 2 and not separable and x.ndim == 4
            and x.dtype == torch.float32 and len(weights) == 2
            and all(factorized.factorization_of(w) == "dense"
                    for w in weights))


def _conv_through(corners, x, weights, half_modes, fft_norm, bias,
                  output_sizes):
    """The one pipeline of every route: rfftn, the spectrum
    `(B, k1..kN, C_in)` handed to `corners(x_ft, weights, half_modes)`, the
    whole output spectrum `(B, k1..kN, C_out)` it returns (the products in
    the corners, zeros elsewhere), irfftn onto the output sizes, bias."""
    order = len(half_modes)
    spatial = x.shape[1:1 + order]
    fft_axes = tuple(range(1, 1 + order))
    in_dtype = x.dtype
    if in_dtype not in (torch.float32, torch.float64):
        # half-precision activations: the FFT needs f32/f64; the result is
        # cast back so a bf16 pipeline stays bf16 between layers
        x = x.float()
    x_ft = rfftn(x, axes=fft_axes, norm=fft_norm)
    out_ft = corners(x_ft, weights, half_modes)
    out_sizes = tuple(output_sizes) if output_sizes is not None else spatial
    out = irfftn(out_ft, s=out_sizes, axes=fft_axes, norm=fft_norm)
    if bias is not None:
        out = out + bias
    if out.dtype != in_dtype and in_dtype not in (torch.float32,
                                                  torch.float64):
        out = out.to(in_dtype)
    return out


def spectral_conv_nd(
    x: torch.Tensor,
    weights: Sequence[dict],
    half_modes: Sequence[int],
    *,
    fft_norm: str = "backward",
    separable: bool = False,
    implementation: str = "reconstructed",
    bias: Optional[torch.Tensor] = None,
    output_sizes: Optional[Sequence[int]] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """N-D spectral convolution.

    x: (B, d1, ..., dN, C_in) real.
    weights: list of 2^(N-1) factorized weight dicts (corner order as in
        `corner_slices`).
    half_modes: modes kept per corner per axis.
    output_sizes: spatial sizes of the output (for up/down-scaling layers);
        defaults to the input sizes.
    backend: 'auto' (default) | 'plain' | 'kernel'.  'kernel' goes from
        spectrum to spectrum through the hand-written kernel
        (`spectral_cuda.spectral_corners`: corner gather, contraction and
        scatter in one launch) and raises where the call is not eligible
        (`kernel_eligible`); 'auto' takes the kernel for an eligible call
        on a CUDA tensor and the plain version (complex einsum per corner,
        placed into a zero spectrum) otherwise; a CPU tensor always takes
        the plain version.  Only that step differs between the routes.
    Returns (B, e1, ..., eN, C_out) real.
    """
    order = len(half_modes)
    if backend not in ("auto", "plain", "kernel"):
        raise ValueError(f"Unknown spectral backend {backend!r}")
    spatial = x.shape[1:1 + order]
    for k, (m, size) in enumerate(zip(half_modes, spatial)):
        limit = size // 2 + 1 if k == order - 1 else size // 2
        if m > limit:
            raise ValueError(
                f"half_modes[{k}]={m} exceeds the available spectrum for "
                f"spatial size {size} (max {limit}); lower n_modes or raise "
                "the resolution")
    eligible = kernel_eligible(x, weights, half_modes, separable)
    if backend == "kernel" and not eligible:
        raise ValueError(
            "backend='kernel' requires a 2-D, non-separable, "
            "unbatched-rank-4 float32 spectral conv with dense weights")
    from . import spectral_cuda
    if backend == "kernel" or (backend == "auto" and eligible and x.is_cuda):
        corners = spectral_cuda.spectral_corners
    else:
        corners = partial(spectral_cuda.spectral_corners_plain,
                          separable=separable, implementation=implementation)
    return _conv_through(corners, x, weights, half_modes, fft_norm, bias,
                         output_sizes)


def spectral_conv_nd_dft_rule(x: torch.Tensor, weights: Sequence[dict],
                              half_modes: Sequence[int], **kw
                              ) -> torch.Tensor:
    """`spectral_conv_nd` where the last (rfft) axis may keep more modes
    than its spectrum holds, with the result the JAX package computes on
    its TPU route for such a call: the truncated-DFT route
    (`truncated_dft_conv_nd`), whose inverse drops every frequency row at
    or past that axis's budget (`_idft_mats`: size // 2 + 1), so that the
    modes past it feed nothing and their weights get an exactly zero
    gradient.  That is this conv with that axis's modes cut to the budget
    and the weights sliced to them (a view of the stored leaf, so only the
    kept modes are ever made complex).  The other axes are held to their
    spectrum as `spectral_conv_nd` holds them.  The PINO layers need it:
    the full-field observer keeps 12 modes on a time axis of length 1."""
    size = x.shape[len(half_modes)]
    budget = size // 2 + 1
    if half_modes[-1] > budget:
        half_modes = (*half_modes[:-1], budget)
        weights = [slice_weight_modes(w, half_modes) for w in weights]
    return spectral_conv_nd(x, weights, half_modes, **kw)


def spectral_conv_1d(x, weight, modes, **kw):
    """1-D special case: keep only low modes (spectral_convolution.py:382)."""
    return spectral_conv_nd(x, [weight], [modes], **kw)


def dft_matmul_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         half_modes: Sequence[int],
                         fft_norm: str = "backward"):
    """Slow, obviously-correct oracle used by the tests: dense complex
    weights `(I, O, m1..mN)` and explicit corner writes."""
    order = len(half_modes)
    fft_axes = tuple(range(1, 1 + order))
    x_ft = rfftn(x, axes=fft_axes, norm=fft_norm)
    out_shape = list(x_ft.shape)
    out_shape[-1] = weights[0].shape[1]
    out_ft = x_ft.new_zeros(out_shape)
    for w, corner in zip(weights, corner_slices(half_modes)):
        idx = (slice(None),) + corner + (slice(None),)
        out_ft[idx] = factorized.contract_dense(x_ft[idx], w)
    return irfftn(out_ft, s=x.shape[1:1 + order], axes=fft_axes,
                  norm=fft_norm)
