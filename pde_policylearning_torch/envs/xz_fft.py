"""Host side of the in-kernel x/z FFTs (csrc/common.cuh, "x/z transforms"):
the rule that sends a grid to the FFT kernels or to the DFT products, the
twiddle tables the kernels read, and the kernels' shared memory and
operation counts.

Spectrum layout (per plane): `F2 = 2 * Nx * (Nz//2 + 1)` floats, real parts
in `[0, F)`, imaginary parts in `[F, F2)`, column `kx * (Nz//2 + 1) + f`, as
the `T2` / `Ti2` products of `rk3_cuda._kron_mats2` give and take it.
"""
from __future__ import annotations

import numpy as np

MAX_DYNAMIC_SMEM = 232448   # bytes one block of an H100 can ask for


def smem_bytes(Nx: int, Nz: int) -> int:
    """Shared memory of one plane's block: the z arrays (Nx/2, Nz) and the
    x arrays (Nz/2+1, Nx+1), re and im, float32."""
    return 4 * (Nx * Nz + 2 * (Nx + 1) * (Nz // 2 + 1))


def _is_pow2(v: int) -> bool:
    return v >= 2 and v & (v - 1) == 0


def fft_route(Nx: int, Nz: int) -> bool:
    """Whether an (Nx, Nz) plane takes the FFT kernels: both sizes powers of
    two (>= 2) and the block's arrays within an SM's shared memory.  Any
    other grid keeps the DFT products through the GEMM.  `kernel_args`
    uploads the constants of the route this picks, and the C entries run
    the route whose constants they find."""
    return (_is_pow2(Nx) and _is_pow2(Nz)
            and smem_bytes(Nx, Nz) <= MAX_DYNAMIC_SMEM)


def twiddles(N: int) -> np.ndarray:
    """(N/2, 2) float64: (cos, -sin)(2 pi k / N) = exp(-2 pi i k / N)."""
    a = 2.0 * np.pi * np.arange(N // 2) / N
    return np.stack([np.cos(a), -np.sin(a)], axis=1)


def fft_flops(Nx: int, Nz: int) -> int:
    """Operations of one plane's transform as the kernels run it (either
    direction): 10 per butterfly, 8 per separated or packed pair of bins."""
    Nzr = Nz // 2 + 1
    lx, lz = Nx.bit_length() - 1, Nz.bit_length() - 1
    return (10 * (Nx // 2) * (Nz // 2) * lz + 10 * Nzr * (Nx // 2) * lx
            + 8 * (Nx // 2) * Nzr)
