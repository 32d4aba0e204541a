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


def padded_t(T: int, pad_ratio=(0.0, 0.0)) -> int:
    """The time samples of the padded grid: T plus its two pads."""
    return T + sum(round(T * r) for r in pad_ratio)


def kept_modes(modes: tuple, Tp: int) -> tuple:
    """(m1, m2, m3'): the corner's modes that a spectrum of Tp time samples
    holds (its real FFT has Tp // 2 + 1 time modes)."""
    m1, m2, m3 = modes
    return m1, m2, min(m3, Tp // 2 + 1)


def forward_flops(B: int, X: int, Y: int, T: int, *, width: int,
                  n_layers: int, modes: tuple, fc_dim: int, in_dim: int,
                  out_dim: int, pad_ratio=(0.0, 0.0)) -> float:
    Tp = padded_t(T, pad_ratio)
    N, P = B * X * Y * T, B * X * Y * Tp
    w = width
    m1, m2, m3 = kept_modes(modes, Tp)
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


def n_live_params(*, width: int, n_layers: int, modes: tuple, fc_dim: int,
                  in_dim: int, out_dim: int, T: int,
                  pad_ratio=(0.0, 0.0)) -> int:
    """The parameters that can get a gradient at T time samples: those of
    `n_params` with each spectral corner counted at the m1 x m2 x m3' modes
    that the padded spectrum holds (`kept_modes`), less the imaginary part
    of each layer's modes whose spectrum is real: the mean (0, 0, 0) and,
    where Tp is even and kept, (0, 0, Tp / 2).  The weights of the other
    time modes never meet a non-zero spectrum, so Adam leaves them as they
    are.  It takes the corners to hold no Nyquist mode of X or Y (m1 < X / 2,
    m2 < Y / 2), as at the loop's 32 x 32 grid with 12 modes."""
    Tp = padded_t(T, pad_ratio)
    kept = kept_modes(modes, Tp)
    real = 1 + (Tp % 2 == 0 and Tp // 2 < kept[2])
    return (n_params(width=width, n_layers=n_layers, modes=kept,
                     fc_dim=fc_dim, in_dim=in_dim, out_dim=out_dim)
            - n_layers * real * width * width)
