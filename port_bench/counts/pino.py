"""Operations of the PINO plane models (`PINObserverFullField`,
`PolicyModel2D`) and of Adam, from their shapes.

A forward at B samples of an X x Y x T grid (N = B X Y T points) counts
the products: the lift (2 N in w), the two multiplicative nets (2 N w w
each), per trunk layer the real 3-D FFT of w channels and its inverse
(2.5 P log2 P operations per channel and direction, P = X Y Tp points of
the padded grid), the four corners' complex contraction (8 operations a
complex multiply-add, m1 m2 m3' modes a corner, m3' the time modes the
spectrum holds) and the pointwise skip (2 N w w), then the head (2 N w f
+ 2 N f o).  Element-wise work (activations, additions) is not counted.
A backward that gives the inputs' gradient alone costs one forward; one
that also gives the parameters' gradients, two.
"""
from __future__ import annotations

import math

# Adam as torch runs it, per parameter and step: the two moment updates,
# the bias-corrected denominator and the parameter update
ADAM_FLOPS_PER_PARAM = 12
# bytes Adam needs per parameter and step in float32: the parameter, its
# gradient and both moments read, the parameter and both moments written
ADAM_BYTES_PER_PARAM = 7 * 4


def forward_flops(B: int, X: int, Y: int, T: int, *, width: int,
                  n_layers: int, modes: tuple, fc_dim: int, in_dim: int,
                  out_dim: int, pad_ratio=(0.0, 0.0)) -> float:
    Tp = T + sum(round(T * r) for r in pad_ratio)
    N, P = B * X * Y * T, B * X * Y * Tp
    w = width
    m1, m2, m3 = modes
    m3 = min(m3, Tp // 2 + 1)
    fft = 2 * 2.5 * P * math.log2(max(2, X * Y * Tp)) * w
    corners = 4 * B * m1 * m2 * m3 * w * w * 8
    layer = fft + corners + 2 * P * w * w
    return (2 * N * in_dim * w + 2 * 2 * N * w * w + n_layers * layer
            + 2 * N * w * fc_dim + 2 * N * fc_dim * out_dim)


def n_params(*, width: int, n_layers: int, modes: tuple, fc_dim: int,
             in_dim: int, out_dim: int) -> int:
    w = width
    spectral = 4 * 2 * math.prod(modes) * w * w
    return (in_dim * w + w + 2 * (w + w * w + w)
            + n_layers * (spectral + w * w + w)
            + w * fc_dim + fc_dim + fc_dim * out_dim + out_dim)
