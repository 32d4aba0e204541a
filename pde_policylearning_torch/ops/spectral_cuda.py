"""The FNO corner contraction: the plain torch version, the CUDA kernel
that replaces `pde_policylearning_tpu/ops/pallas_kernels.py:
_corner_contract_kernel`, the differentiable `corner_contract` over both,
and the 2-D spectral convolution that runs through it.

`out[b,kx,ky,o] = sum_i x[b,kx,ky,i] w[i,o,kx,ky]` is a per-mode complex
(B, I) x (I, O) product.  Complex data rides as separate real and
imaginary float arrays, as in the JAX package: xr, xi (R, B, M2, I) stacked
corner rows (R = the kx modes of both corners), wr, wi (R, M2, I, O),
outputs (R, B, M2, O).

On a CUDA tensor `corner_contract` launches the kernel
(csrc/corner_contract.cu), forward and backward; on a CPU tensor it is the
plain version and its transposes.  The raw wrapper
`corner_contract_kernel` takes float32 CUDA tensors only, raises on
anything else and on an input that needs a gradient, and never falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..native import cuda_build
from . import factorized
from . import fourier

_EQ = "rbmi,rmio->rbmo"


def corner_contract_plain(xr, xi, wr, wi):
    """The contraction in plain torch, any float dtype: four real einsums
    and two combinations.  Returns (or_, oi_)."""
    return (torch.einsum(_EQ, xr, wr) - torch.einsum(_EQ, xi, wi),
            torch.einsum(_EQ, xr, wi) + torch.einsum(_EQ, xi, wr))


def _check_pair(name, re, im, shape):
    """Both parts float32 CUDA tensors of `shape` that need no gradient,
    read through one set of strides."""
    for part, a in (("r", re), ("i", im)):
        cuda_build.check_cuda_f32(name + part, a, shape, contiguous=False)
    if re.stride() != im.stride() or re.device != im.device:
        raise ValueError(f"{name}r and {name}i must share strides and "
                         "device (two views of one layout)")


def corner_contract_kernel(xr, xi, wr, wi, conj_x: bool = False,
                           conj_w: bool = False):
    """The contraction on the card (csrc/corner_contract.cu) for float32
    CUDA tensors of any strides: xr, xi (R, B, M2, I), wr, wi
    (R, M2, I, O) -> contiguous (or_, oi_) (R, B, M2, O).  `conj_x` /
    `conj_w` negate xi / wi as they are read (the gradient's transposed
    products).  One launch, on the current stream."""
    if xr.ndim != 4 or wr.ndim != 4:
        raise ValueError("corner_contract: xr (R, B, M2, I) and wr "
                         f"(R, M2, I, O) expected, got {tuple(xr.shape)} "
                         f"and {tuple(wr.shape)}")
    R, B, M2, I = xr.shape
    O = wr.shape[-1]
    _check_pair("x", xr, xi, (R, B, M2, I))
    _check_pair("w", wr, wi, (R, M2, I, O))
    if wr.device != xr.device:
        raise ValueError("corner_contract: x and w on different devices")
    if min(R, B, M2, I, O) < 1 or R * M2 >= 2 ** 31 \
            or B > 8 * 65535 or O > 32 * 65535:
        raise ValueError(f"corner_contract: shape R {R}, B {B}, M2 {M2}, "
                         f"I {I}, O {O} outside the kernel's launch grid")
    outr = torch.empty((R, B, M2, O), dtype=torch.float32, device=xr.device)
    outi = torch.empty_like(outr)
    dims = cuda_build.CornerDims(
        R=R, B=B, M2=M2, I=I, O=O, xs=tuple(xr.stride()),
        ws=tuple(wr.stride()), sgn_xi=-1.0 if conj_x else 1.0,
        sgn_wi=-1.0 if conj_w else 1.0)
    err = cuda_build.load().pde_corner_contract(
        ctypes.byref(dims), xr.data_ptr(), xi.data_ptr(), wr.data_ptr(),
        wi.data_ptr(), outr.data_ptr(), outi.data_ptr(),
        torch.cuda.current_stream(xr.device).cuda_stream)
    cuda_build.check(err, "pde_corner_contract")
    corner_contract_kernel.launches += 1
    return outr, outi


corner_contract_kernel.launches = 0


def _contract(xr, xi, wr, wi, conj_x=False, conj_w=False):
    """Kernel for CUDA operands, plain version for CPU operands.  The
    kernel reads a real and an imaginary part through one set of strides;
    a pair that does not share its layout (a broadcast gradient beside a
    dense one) is copied first."""
    if xr.is_cuda:
        if xr.stride() != xi.stride():
            xr, xi = xr.contiguous(), xi.contiguous()
        if wr.stride() != wi.stride():
            wr, wi = wr.contiguous(), wi.contiguous()
        return corner_contract_kernel(xr, xi, wr, wi, conj_x, conj_w)
    return corner_contract_plain(xr, -xi if conj_x else xi, wr,
                                 -wi if conj_w else wi)


class _CornerContract(torch.autograd.Function):
    """`corner_contract`: forward one contraction, backward the two
    transposed ones, `dx = dout conj(w)^T` and `dw = conj(x)^T dout`, each
    run only where an input asks for its gradient, through the same kernel
    on views of the saved tensors (as the JAX custom VJP reuses its kernel,
    pallas_kernels.py:96-113)."""

    @staticmethod
    def forward(ctx, xr, xi, wr, wi):
        ctx.save_for_backward(xr, xi, wr, wi)
        return _contract(xr, xi, wr, wi)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dor, doi):
        xr, xi, wr, wi = ctx.saved_tensors
        dxr = dxi = dwr = dwi = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            # per mode (B, O) @ (O, I)
            dxr, dxi = _contract(dor, doi, wr.transpose(-1, -2),
                                 wi.transpose(-1, -2), conj_w=True)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            # per mode (I, B) @ (B, O): the channel axis in the batch role;
            # the kernel emits (R, I, M2, O), the weights live (R, M2, I, O)
            dwr, dwi = _contract(xr.permute(0, 3, 2, 1),
                                 xi.permute(0, 3, 2, 1),
                                 dor.permute(0, 2, 1, 3),
                                 doi.permute(0, 2, 1, 3), conj_x=True)
            dwr, dwi = dwr.transpose(1, 2), dwi.transpose(1, 2)
        return dxr, dxi, dwr, dwi


def corner_contract(xr, xi, wr, wi):
    """Fused per-mode complex contraction (differentiable).

    xr, xi: (R, B, M2, I); wr, wi: (R, M2, I, O).  Returns (or_, oi_)
    (R, B, M2, O)."""
    return _CornerContract.apply(xr, xi, wr, wi)


def _corner_weights(weights: Sequence[dict]):
    """[low, high] dense weight dicts -> (wr, wi), each (R = 2*m1, M2, I,
    O).  A mode-major leaf (2, m1, m2, I, O) is already in that layout per
    corner; the legacy leaf (2, I, O, m1, m2) is read through a permuted
    view.  Redone on every call (two concatenations), so a weight update
    is never missed."""
    parts = []
    for w in weights:
        key, lead = factorized._dense_mm_key(w)
        leaf = w.get("tensor") if key is None else w[key]
        if leaf is None or leaf.ndim != 5 or lead not in (None, 2):
            raise ValueError(
                "the corner contraction takes dense weights, "
                "{'mm2': (2, m1, m2, I, O)} or {'tensor': (2, I, O, m1, "
                f"m2)}}; got {factorized.factorization_of(w)} leaves "
                f"{sorted(w)}")
        parts.append(leaf if key is not None else leaf.permute(0, 3, 4, 1, 2))
    return (torch.cat([p[0] for p in parts], 0),
            torch.cat([p[1] for p in parts], 0))


def contract_corners(blocks, weights: Sequence[dict]):
    """The [low, high] corner blocks (B, m1, M2, I) of a 2-D spectrum
    against their dense weights, in one `corner_contract` over the stacked
    rows; returns the two (B, m1, M2, O) complex blocks."""
    # low rows then high rows, (B, R = 2*m1, M2, I); the kernel reads the
    # (R, B, M2, I) views of the real and imaginary parts in place
    corners = torch.cat(list(blocks), dim=1)
    wr, wi = _corner_weights(weights)
    real = corners.real
    or_, oi_ = corner_contract(real.transpose(0, 1),
                               corners.imag.transpose(0, 1),
                               wr.to(real.dtype), wi.to(real.dtype))
    out_c = torch.complex(or_, oi_).transpose(0, 1)         # (B, R, M2, O)
    return out_c.split(blocks[0].shape[1], dim=1)


def spectral_conv_2d_kernel(x, weights: Sequence[dict],
                            half_modes: Sequence[int],
                            fft_norm: str = "backward", bias=None,
                            output_sizes: Optional[Sequence[int]] = None):
    """2-D spectral convolution through `corner_contract` (the counterpart
    of `spectral_conv_2d_pallas`): `ops.fourier.spectral_conv_nd`'s
    pipeline with `contract_corners` as its contraction, with no test of
    eligibility.  x: (B, H, W, C_in); weights: [low, high] dense weight
    dicts."""
    return fourier._conv_through(contract_corners, x, weights, half_modes,
                                 fft_norm, bias, output_sizes)
