"""The products of the references, with TF32 emulated where asked.

TF32 is how an H100 runs a float32 product on its tensor cores when the
process allows it: each operand rounded to 10 bits of mantissa, products
accumulated in float32.  `tf32()` makes every product of the references
(`einsum`, `matmul`) round its float32 operands so, whatever kernel the
library picks for the shape (a skinny product may not reach the tensor
cores at all): that is the control, the reference in the nearest
precision below the configurations' float32 with TF32 off.  FFTs keep
float32, as cuFFT does under TF32.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

_ON = [False]


@contextmanager
def tf32(on: bool = True):
    old = _ON[0]
    _ON[0] = on
    try:
        yield
    finally:
        _ON[0] = old


def _round(t: torch.Tensor) -> torch.Tensor:
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32).reshape(t.shape)


class _RoundTF32(torch.autograd.Function):
    """Round to TF32 going forward, and the gradient likewise going back,
    so that the products of the backward pass see TF32 operands too."""

    @staticmethod
    def forward(ctx, t):
        return _round(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g)


def rnd(t: torch.Tensor) -> torch.Tensor:
    """`t` with its float32 values rounded to TF32 (to nearest, ties away
    from zero on the magnitude), where TF32 is on; anything else as it
    is."""
    if not _ON[0]:
        return t
    if t.is_complex():
        return torch.complex(rnd(t.real), rnd(t.imag))
    if t.dtype != torch.float32:
        return t
    return _RoundTF32.apply(t)


def einsum(eq: str, *ops):
    return torch.einsum(eq, *(rnd(o) for o in ops))


def matmul(a, b):
    return rnd(a) @ rnd(b)
