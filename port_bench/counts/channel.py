"""Operations and bytes of the channel DNS kernels at their shapes: what
the function needs, not what a kernel spends.

Frozen from the port's own count (`chip_smoke.py:work`, the bound routes),
so that a later change to the program cannot move the yardstick.  The x/z
transforms are 2-D real FFTs of Nx x Nz planes, 2.5 N log2 N operations
each for N = Nx Nz points; the eigen-solve products are counted exactly;
the stencil passes by the operations per point of the program's kernels
(momentum RHS of three fields 175, RK update 8, divergence 8, correction
10, residual 6).  Bytes: every input (state, actuation, the solve's
constants) read once and every output written once, 4 bytes each (float32);
scratch does not count.  The wall solve is counted by the cheaper of its
two routes (folded through G, or the two products).
"""
from __future__ import annotations

import math

from .peaks import bound_s


def _gemm(M, N, K):
    return 2 * M * N * K


def work(name: str, B: int = 1, Nx: int = 32, Ny: int = 130, Nz: int = 32,
         refine: int = 1, route=None) -> tuple[float, float]:
    """(operations, bytes) of one call of `name` for B envs:
    'poisson', 'boundary_fwd', 'boundary_solve', 'rk3_substage' (kernel A),
    'rk3_solve_correct' (kernel B), 'rk3_fullstep' (kernel D: one env step
    with its wall pressures), 'boundary_batched' (kernel C) or 'eig_solve'
    (the eigen-solve of one projection alone)."""
    C = Nx * Nz
    n, m = Ny - 1, Ny - 2
    F2 = 2 * Nx * (Nz // 2 + 1)
    field = (Ny + 1) * C
    walled = name in ("boundary_solve", "boundary_batched", "rk3_fullstep")
    if route is None and walled:
        return min((work(name, B, Nx, Ny, Nz, refine, r)
                    for r in ("folded", "two_product")),
                   key=lambda fb: bound_s(*fb))
    mode00 = 2 * _gemm(n, 1, n)

    def fft2(rows):
        return rows * 2.5 * C * math.log2(C)

    def solve(k):
        return ((1 + refine) * (2 * _gemm(k, F2, k) + mode00)
                + refine * 6 * n * F2)

    def spectral(k):
        return fft2(n) + solve(k) + fft2(n)

    if name == "eig_solve":
        return (B * ((1 + refine) * (2 * _gemm(m, F2, m) + 2 * _gemm(n, 1, n))
                     + refine * 6 * n * F2),
                4 * (2 * B * n * F2 + 2 * m * m + 2 * m * F2 + n * n))
    state = 2 * field + Ny * C
    bordered = 2 * m * m + 2 * m * F2 + n * n
    fwd = (175 + 8) * field + fft2(n)
    if route == "two_product":
        walls = 3 * m + 3 * F2
        wall_shared = m * m + m * F2 + n * n
        bsolve = (mode00 + _gemm(m, F2, m) + _gemm(3, F2, m) + 12 * F2
                  + fft2(2))
    else:
        walls = 3 * m * F2 + 4 * F2 + 5 * n
        wall_shared = 0
        bsolve = _gemm(3, F2, m) + 12 * F2 + _gemm(4, 1, n) + n + fft2(2)
    sub = (175 + 8) * field + 8 * n * C
    cor = spectral(m) + 10 * field
    flops, per_env, shared = {
        "poisson": (spectral(n), 2 * n * C, 3 * n * n + n * F2),
        "boundary_fwd": (fwd, state + n * F2, 0),
        "boundary_solve": (bsolve, n * F2 + 2 * C, walls + wall_shared),
        "rk3_substage": (sub, state + 2 * C + 2 * state + n * C, 0),
        "rk3_solve_correct": (cor, n * C + 2 * state + 2 * C, bordered),
        "rk3_fullstep": (3 * (sub + cor) + 3 * n * C + fwd + bsolve,
                         2 * state + 4 * C, bordered + walls),
        "boundary_batched": (fwd + bsolve, state + 2 * C,
                             walls + wall_shared),
    }[name]
    return B * flops, 4 * (B * per_env + shared)
