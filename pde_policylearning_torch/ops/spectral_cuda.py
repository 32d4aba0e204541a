"""The FNO corner contraction: the plain torch versions, the CUDA kernels
that replace `pde_policylearning_tpu/ops/pallas_kernels.py:
_corner_contract_kernel` and the glue of `spectral_conv_2d_pallas` around
it, the differentiable entries over both, and the 2-D spectral convolution
that runs through them.

Two entries.  `spectral_corners` is what a spectral conv calls between
`rfftn` and `irfftn`: it takes the complex spectrum and the two corners'
stored weights and returns the whole output spectrum (products in the
corners, zeros elsewhere); on a CUDA tensor that is one allocation and one
launch of `pde_spectral_corners`, forward and for the gradient to x.
`corner_contract` is the JAX function of that name, on stacked corner rows
with split real and imaginary parts (below); the weight gradient of
`spectral_corners` runs through its kernel.

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
from functools import lru_cache
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


def _dense_views(weights: Sequence[dict]):
    """[low, high] dense weight dicts -> their leaves as (2, m1, m2, I, O)
    views, read where they are stored: a mode-major leaf
    `{'mm2': (2, m1, m2, I, O)}` as it is, the legacy
    `{'tensor': (2, I, O, m1, m2)}` through a permuted view.  No copy, so
    nothing that a weight update could leave stale."""
    views = []
    for w in weights:
        key, lead = factorized._dense_mm_key(w)
        leaf = w.get("tensor") if key is None else w[key]
        if leaf is None or leaf.ndim != 5 or lead not in (None, 2):
            raise ValueError(
                "the corner contraction takes dense weights, "
                "{'mm2': (2, m1, m2, I, O)} or {'tensor': (2, I, O, m1, "
                f"m2)}}; got {factorized.factorization_of(w)} leaves "
                f"{sorted(w)}")
        views.append(leaf if key is not None else leaf.permute(0, 3, 4, 1, 2))
    if len(views) != 2 or views[0].shape != views[1].shape:
        raise ValueError("the corner contraction takes the [low, high] "
                         "weights of one 2-D conv, of one shape")
    return views


def spectral_corners_plain(x_ft, weights: Sequence[dict],
                           half_modes: Sequence[int], separable: bool = False,
                           implementation: str = "reconstructed"):
    """The step between `rfftn` and `irfftn` in plain torch, any rank, any
    factorization, any float dtype: each corner block
    `x_ft[:, corner]` (B, m1..mN, C_in) against its weight (a complex
    einsum, `factorized.contract`), placed into a zero spectrum of the
    input's spatial shape.  x_ft: (B, k1..kN, C_in) complex; returns
    (B, k1..kN, C_out) complex.  The plain version of
    `spectral_corners_kernel`, and what factorized weights,
    `backend='plain'` and CPU tensors take."""
    idxs = [(slice(None),) + corner + (slice(None),)
            for corner in fourier.corner_slices(half_modes)]
    blocks = [factorized.contract(x_ft[idx], w, separable=separable,
                                  implementation=implementation)
              for idx, w in zip(idxs, weights)]
    out_ft = blocks[0].new_zeros((*x_ft.shape[:-1], blocks[0].shape[-1]))
    # the corners are disjoint (half_modes checked by the caller), so
    # placing them is the reference's pad-and-sum
    for idx, block in zip(idxs, blocks):
        out_ft[idx] = block
    return out_ft


@lru_cache(maxsize=256)
def _spectral_plan(x_shape, w_shape, w_shape_high, ws_low, ws_high, adjoint):
    """Shape checks and the C struct of one call signature, done once and
    kept (there is no pointer in it): returns (struct, its byref, the
    output spectrum's shape)."""
    if len(x_shape) != 4 or len(w_shape) != 5 or w_shape != w_shape_high \
            or w_shape[0] != 2:
        raise ValueError(
            "spectral_corners: x_ft (B, H, Wh, I) and two weight views "
            f"(2, m1, m2, I, O) expected, got {tuple(x_shape)}, "
            f"{tuple(w_shape)} and {tuple(w_shape_high)}")
    B, H, Wh, C = x_shape
    _, m1, m2, I, O = w_shape
    strides = [ws_low[1:], ws_high[1:]]
    if adjoint:
        I, O = O, I
        strides = [(a, b, o, i) for a, b, i, o in strides]
    if C != I or min(B, I, O, m1, m2) < 1 or 2 * m1 > H or m2 > Wh:
        raise ValueError(
            f"spectral_corners: expected a spectrum of {I} channels with "
            f"room for two {m1} x {m2} corners, got {tuple(x_shape)} "
            f"against weights {tuple(w_shape)} (adjoint={adjoint})")
    d = cuda_build.SpectralDims(B, H, Wh, I, O, m1, m2,
                                sgn_wi=-1.0 if adjoint else 1.0)
    d.ws[0][:] = strides[0]
    d.ws[1][:] = strides[1]
    return d, ctypes.byref(d), (B, H, Wh, O)


def spectral_corners_kernel(x_ft, w_low, w_high, adjoint: bool = False):
    """Corner gather, contraction and scatter on the card in one launch
    (csrc/corner_contract.cu, `pde_spectral_corners`).

    x_ft: contiguous complex64 CUDA spectrum (B, H, Wh, I) as `rfftn`
    leaves it; w_low, w_high: float32 CUDA views (2, m1, m2, I, O) of the
    two corners' stored weights, any strides.  Returns the complex64
    output spectrum (B, H, Wh, O), the products in the corners (rows
    [0, m1) and [H - m1, H), columns [0, m2)) and zeros elsewhere: one
    `torch.empty`, one launch on the current stream.  `adjoint` contracts
    with the conjugate transpose of the weights instead ((B, H, Wh, O) ->
    (B, H, Wh, I), the gradient to x).  Raises on anything else, and on an
    input that needs a gradient; it never falls back.  The checks are kept
    short: the observer serves four of these calls per step and the host
    is what its loop waits for.  `launches` counts every launch,
    `adjoint_launches` those with `adjoint`."""
    if torch.is_grad_enabled() and (x_ft.requires_grad or w_low.requires_grad
                                    or w_high.requires_grad):
        raise RuntimeError(
            "spectral_corners: a CUDA kernel passes no gradient; detach the "
            "inputs or use the differentiable entry "
            "(spectral_cuda.spectral_corners)")
    dev = x_ft.device
    if not (x_ft.is_cuda and x_ft.dtype is torch.complex64
            and w_low.dtype is torch.float32 and w_high.dtype is torch.float32
            and w_low.device == dev and w_high.device == dev):
        raise ValueError(
            "spectral_corners: the CUDA kernel takes a complex64 spectrum "
            "and float32 CUDA tensors for the weights, all on one card; got "
            f"{x_ft.dtype} on {dev}, {w_low.dtype} on {w_low.device} and "
            f"{w_high.dtype} on {w_high.device}")
    _, dims_ref, out_shape = _spectral_plan(
        x_ft.shape, w_low.shape, w_high.shape, w_low.stride(),
        w_high.stride(), adjoint)
    if not x_ft.is_contiguous() or x_ft.is_conj():
        raise ValueError("spectral_corners: expected a contiguous spectrum")
    out_ft = torch.empty(out_shape, dtype=torch.complex64, device=dev)
    # real leaf at the view's pointer, imaginary leaf one stride(0) further
    p_low, p_high = w_low.data_ptr(), w_high.data_ptr()
    err = cuda_build.load().pde_spectral_corners(
        dims_ref, x_ft.data_ptr(), p_low, p_low + 4 * w_low.stride(0),
        p_high, p_high + 4 * w_high.stride(0), out_ft.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        cuda_build.check(err, "pde_spectral_corners")
    spectral_corners_kernel.launches += 1
    spectral_corners_kernel.adjoint_launches += adjoint
    return out_ft


spectral_corners_kernel.launches = 0
spectral_corners_kernel.adjoint_launches = 0


def _adjoint_weight(view):
    """The (2, m1, m2, I, O) view of a weight as the dict of its conjugate
    transpose (2, m1, m2, O, I)."""
    t = view.transpose(-1, -2)
    return {"mm2": torch.stack([t[0], -t[1]])}


def _corners(x_ft, w_low, w_high, adjoint=False):
    """Kernel for a CUDA spectrum, plain version for a CPU one."""
    if x_ft.is_cuda:
        return spectral_corners_kernel(x_ft.contiguous(), w_low, w_high,
                                       adjoint)
    ws = [_adjoint_weight(w) if adjoint else {"mm2": w}
          for w in (w_low, w_high)]
    return spectral_corners_plain(x_ft, ws, w_low.shape[1:3])


class _SpectralCorners(torch.autograd.Function):
    """`spectral_corners` on the (2, m1, m2, I, O) views of the two
    corners' weights.  Forward: one launch.  Backward: `dx_ft` is the same
    entry on `dout_ft` with the weights read transposed and conjugated (it
    gathers the corners of `dout_ft` and writes `dx_ft` whole); `dw` of
    each corner is `conj(x)^T dout` over that corner's blocks through the
    strided entry behind `corner_contract`, the channel axis in the batch
    role.  Each runs only where an input asks for its gradient."""

    @staticmethod
    def forward(ctx, x_ft, w_low, w_high):
        ctx.save_for_backward(x_ft, w_low, w_high)
        return _corners(x_ft, w_low, w_high)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        x_ft, w_low, w_high = ctx.saved_tensors
        dout = dout.resolve_conj()
        m1, m2 = w_low.shape[1:3]
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _corners(dout, w_low, w_high, adjoint=True)
        dws = [None, None]
        for c, rows in enumerate((slice(None, m1), slice(-m1, None))):
            if not ctx.needs_input_grad[1 + c]:
                continue
            xb, db = x_ft[:, rows, :m2], dout[:, rows, :m2]  # (B, m1, m2, .)
            # per mode (I, B) @ (B, O); the kernel emits (m1, I, m2, O)
            dwr, dwi = _contract(xb.real.permute(1, 3, 2, 0),
                                 xb.imag.permute(1, 3, 2, 0),
                                 db.real.permute(1, 2, 0, 3),
                                 db.imag.permute(1, 2, 0, 3), conj_x=True)
            dws[c] = torch.stack([dwr, dwi]).transpose(2, 3)
        return dx, dws[0], dws[1]


def spectral_corners(x_ft, weights: Sequence[dict],
                     half_modes: Optional[Sequence[int]] = None):
    """The step between `rfftn` and `irfftn` of a 2-D conv with dense
    weights, differentiable: x_ft (B, H, Wh, C_in) complex against the
    [low, high] weight dicts -> the whole output spectrum (B, H, Wh, C_out)
    (see `spectral_corners_kernel`; on a CPU tensor the plain version and
    its transposes).  `half_modes`, when given, must be the weights' mode
    counts (the caller slices the weights)."""
    w_low, w_high = _dense_views(weights)
    if half_modes is not None and tuple(half_modes) != tuple(w_low.shape[1:3]):
        raise ValueError(f"half_modes {tuple(half_modes)} against weights "
                         f"of {tuple(w_low.shape[1:3])} modes")
    real = torch.float32 if x_ft.dtype == torch.complex64 else torch.float64
    if w_low.dtype != real or w_high.dtype != real:
        w_low, w_high = w_low.to(real), w_high.to(real)
    if torch.is_grad_enabled() and (x_ft.requires_grad or w_low.requires_grad
                                    or w_high.requires_grad):
        return _SpectralCorners.apply(x_ft, w_low, w_high)
    return _corners(x_ft, w_low, w_high)       # serving: no graph to build


def spectral_conv_2d_kernel(x, weights: Sequence[dict],
                            half_modes: Sequence[int],
                            fft_norm: str = "backward", bias=None,
                            output_sizes: Optional[Sequence[int]] = None):
    """2-D spectral convolution through `spectral_corners` (the counterpart
    of `spectral_conv_2d_pallas`): `ops.fourier.spectral_conv_nd`'s
    pipeline with `spectral_corners` between its transforms, with no test
    of eligibility.  x: (B, H, W, C_in); weights: [low, high] dense weight
    dicts."""
    return fourier._conv_through(spectral_corners, x, weights, half_modes,
                                 fft_norm, bias, output_sizes)
