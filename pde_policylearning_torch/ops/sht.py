"""Real spherical harmonic transforms (SHT) for spherical FNOs.

Counterpart of `pde_policylearning_tpu/ops/sht.py` (reference: the
vendored neuralop's spherical convolution depends on
torch_harmonics.RealSHT / InverseRealSHT, neuralop/models/
spherical_convolution.py:4):

  forward:  f(theta, phi) --rfft_phi--> f_m(theta) --Legendre--> f_{l,m}
  inverse:  f_{l,m} --Legendre--> f_m(theta) --irfft_phi--> f(theta, phi)

The associated Legendre matrices (orthonormal, Condon-Shortley-free) and
the quadrature weights are computed in float64 numpy per (nlat, nlon,
lmax, mmax, grid) and cached: the port's own copy of the JAX module's
numpy code.  Grids: 'equiangular' (Driscoll-Healy weights) and
'legendre-gauss'.

The Legendre step is a product of the complex spectrum with a real
matrix.  torch's `einsum` takes operands of one dtype, so it runs on the
real view of the spectrum (`view_as_real`: real and imaginary parts on a
trailing axis of 2), which is the two real products in one call; the
matrix is cast to the spectrum's real dtype, as the JAX module casts it.
These are solver-grade products: on the card they run with TF32 off
(`utils.set_solver_precision`).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _legendre_assoc(lmax: int, mmax: int, x: np.ndarray) -> np.ndarray:
    """Orthonormalized associated Legendre P_l^m(x), shape (lmax, mmax,
    len(x)); normalized so that the spherical harmonics are orthonormal on
    the sphere (4 pi normalization absorbed)."""
    nlat = len(x)
    P = np.zeros((lmax, mmax, nlat))
    P[0, 0] = 1.0 / np.sqrt(4.0 * np.pi)
    sin_t = np.sqrt(np.clip(1.0 - x * x, 0.0, None))
    # diagonal recurrence P_m^m
    for m in range(1, mmax):
        P[m, m] = -np.sqrt((2 * m + 1) / (2.0 * m)) * sin_t * P[m - 1, m - 1]
    # P_{m+1}^m
    for m in range(mmax):
        if m + 1 < lmax:
            P[m + 1, m] = np.sqrt(2 * m + 3) * x * P[m, m]
    # upward recurrence in l
    for m in range(mmax):
        for l in range(m + 2, lmax):
            a = np.sqrt((4 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2
                                                    - 1.0))
            P[l, m] = a * (x * P[l - 1, m] - b * P[l - 2, m])
    return P


def _quadrature(nlat: int, grid: str):
    if grid == "legendre-gauss":
        x, w = np.polynomial.legendre.leggauss(nlat)
        # colatitude decreasing in cos: sorted descending, as equiangular
        order = np.argsort(-x)
        return x[order], w[order]
    if grid == "equiangular":
        # Driscoll-Healy / Clenshaw-Curtis-type weights on
        # theta_j = pi (j + 0.5) / nlat
        theta = np.pi * (np.arange(nlat) + 0.5) / nlat
        x = np.cos(theta)
        w = np.zeros(nlat)
        ks = np.arange(nlat // 2)
        for j, t in enumerate(theta):
            w[j] = (4.0 / nlat) * np.sin(t) * np.sum(
                np.sin((2 * ks + 1) * t) / (2 * ks + 1))
        return x, w
    raise ValueError(f"Unknown grid {grid!r}")


@lru_cache(maxsize=16)
def sht_matrices(nlat: int, nlon: int, lmax: int | None = None,
                 mmax: int | None = None, grid: str = "equiangular"):
    """(Pw, P): the analysis matrix (quadrature weights folded in) and the
    synthesis matrix, float64 numpy of shape (lmax, mmax, nlat)."""
    lmax = lmax or nlat
    mmax = mmax or min(lmax, nlon // 2 + 1)
    x, w = _quadrature(nlat, grid)
    P = _legendre_assoc(lmax, mmax, x)
    return P * w[None, None, :], P


def _legendre(spectrum: torch.Tensor, mat: np.ndarray, eq: str):
    """`einsum(eq)` of a complex spectrum with a real float64 numpy matrix,
    on the spectrum's real view (trailing axis of 2, letter z)."""
    re = torch.view_as_real(spectrum)
    m = torch.as_tensor(mat, dtype=re.dtype, device=re.device)
    return torch.view_as_complex(torch.einsum(eq, re, m).contiguous())


def rsht(f: torch.Tensor, lmax: int | None = None, mmax: int | None = None,
         grid: str = "equiangular") -> torch.Tensor:
    """Real SHT.  f: (..., nlat, nlon, C) real -> (..., lmax, mmax, C)
    complex."""
    nlat, nlon = f.shape[-3], f.shape[-2]
    Pw, _ = sht_matrices(nlat, nlon, lmax, mmax, grid)
    fm = torch.fft.rfft(f, dim=-2)[..., :Pw.shape[1], :]
    fm = fm * (2 * np.pi / nlon)
    return _legendre(fm, Pw, "...tmcz,lmt->...lmcz")


def irsht(flm: torch.Tensor, nlat: int, nlon: int,
          grid: str = "equiangular") -> torch.Tensor:
    """Inverse real SHT.  flm: (..., lmax, mmax, C) complex ->
    (..., nlat, nlon, C) real."""
    lmax, mmax = flm.shape[-3], flm.shape[-2]
    _, P = sht_matrices(nlat, nlon, lmax, mmax, grid)
    fm = _legendre(flm, P, "...lmcz,lmt->...tmcz")
    # pad the m axis to nlon // 2 + 1; irfft's 1 / nlon is undone, and the
    # conjugate symmetry of a real field supplies the doubling for m > 0
    pad = nlon // 2 + 1 - mmax
    if pad > 0:
        fm = torch.nn.functional.pad(fm, (0, 0, 0, pad))
    return torch.fft.irfft(fm, n=nlon, dim=-2) * nlon
