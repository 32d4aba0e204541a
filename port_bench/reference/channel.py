"""Plain reference of the channel DNS step, independent of the program.

The same semantics as the MATLAB solver of the paper (`main.m`, its
`compute_rhs` / `time_advance_RK3` / `compute_projection_step`): the
staggered second-order stencils on a tanh-stretched wall-normal grid,
three RK3 substages each ending in a pressure projection, the constant
mass-flux correction that sets dPdx, and the wall pressures of the new
state as the observation.  The Poisson problem of every (kx, kz) wave
pair is solved with the dense inverse of its wall-normal operator,
formed once in float64 with numpy: no eigenbasis, no bordering and no
refinement, unlike the program.

Layout: U, W (B, Nx, Ny + 1, Nz) with one ghost row at each wall, V
(B, Nx, Ny, Nz) on the wall-normal faces; dPdx and meanU0 (B,).  Every
function computes in the dtype of its inputs; the operators follow.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import precision

# (weight of the current stage's RHS, weight of the first stage's RHS);
# the first stage takes its own RHS once
RK3 = ((8 / 15, 0.0), (5 / 12, 1 / 4), (3 / 4, 1 / 4))


@dataclass
class Grid:
    Nx: int
    Ny: int
    Nz: int
    dx: float
    dz: float
    dt: float
    nu: float
    y: np.ndarray
    ym: np.ndarray
    yg: np.ndarray
    minv: np.ndarray      # (Nx, Nz // 2 + 1, Ny - 1, Ny - 1) float64
    cache: dict


def make_grid(Nx=32, Ny=130, Nz=32, Lx=2 * math.pi, Lz=2 * math.pi,
              stretch=2.6, nu=1.0 / 3250.0, dt=1e-3) -> Grid:
    """The grid of `main.m` and the inverse wall-normal operators: for each
    wave pair, (DD + kk I)^-1 with the second-order modified wavenumbers;
    the (0, 0) pair, singular under the Neumann walls, takes the solver's
    regularized operator (its first diagonal entry scaled by 1.5)."""
    y = 1.0 + np.tanh(stretch * np.linspace(-1, 1, Ny)) / np.tanh(stretch)
    ym = 0.5 * (y[:-1] + y[1:])
    yg = np.concatenate([[-ym[0]], ym, [2.0 + ym[0]]])
    dx, dz = Lx / Nx, Lz / Nz
    n = Ny - 1
    DD = np.zeros((n, n))
    for j in range(n):
        up = 1.0 / (yg[j + 2] - yg[j + 1]) / (y[j + 1] - y[j])
        lo = 1.0 / (yg[j + 1] - yg[j]) / (y[j + 1] - y[j])
        if j + 1 < n:
            DD[j, j + 1] = up
            DD[j, j] -= up
        if j > 0:
            DD[j, j - 1] = lo
            DD[j, j] -= lo
    kx = np.arange(Nx)
    kx = np.where(kx <= Nx // 2, kx, kx - Nx)
    kxx = 2.0 * (np.cos(2 * np.pi * kx / Nx) - 1.0) / dx ** 2
    kzr = np.arange(Nz // 2 + 1)
    kzz = 2.0 * (np.cos(2 * np.pi * kzr / Nz) - 1.0) / dz ** 2
    mats = DD[None, None] + (kxx[:, None] + kzz[None, :])[..., None, None] \
        * np.eye(n)[None, None]
    mats[0, 0] = DD
    mats[0, 0, 0, 0] *= 1.5
    return Grid(Nx, Ny, Nz, dx, dz, dt, nu, y, ym, yg, np.linalg.inv(mats),
                {})


def _const(grid: Grid, name: str, like: torch.Tensor) -> torch.Tensor:
    key = (name, like.device, like.dtype)
    if key not in grid.cache:
        grid.cache[key] = torch.as_tensor(
            np.ascontiguousarray(getattr(grid, name)), dtype=like.dtype,
            device=like.device)
    return grid.cache[key]


def _xp(a):
    return torch.roll(a, -1, dims=-3)


def _xm(a):
    return torch.roll(a, 1, dims=-3)


def _zp(a):
    return torch.roll(a, -1, dims=-1)


def _zm(a):
    return torch.roll(a, 1, dims=-1)


def _pad_y(a):
    """Zero the first and last wall-normal rows around interior values."""
    z = torch.zeros_like(a[..., :1, :])
    return torch.cat([z, a, z], -2)


def rhs(grid: Grid, U, V, W, dPdx):
    """Convection, diffusion and the mean pressure gradient (main.m's
    compute_rhs), term by term; dPdx (B,)."""
    y, ym, yg = (_const(grid, k, U)[:, None] for k in ("y", "ym", "yg"))
    dyf, dyg, dym = y[1:] - y[:-1], yg[1:] - yg[:-1], ym[1:] - ym[:-1]
    dx, dz, nu = grid.dx, grid.dz, grid.nu
    UU = (0.5 * (U + _xp(U))) ** 2
    UV = (0.5 * (V + _xm(V))) * (0.5 * (U[..., :-1, :] + U[..., 1:, :]))
    UW = (0.5 * (W + _xm(W))) * (0.5 * (U + _zm(U)))
    VV = (0.5 * (V[..., :-1, :] + V[..., 1:, :])) ** 2
    VW = (0.5 * (V + _zm(V))) * (0.5 * (W[..., :-1, :] + W[..., 1:, :]))
    WW = (0.5 * (W + _zp(W))) ** 2

    def lap(A, d_c, d_f):
        dA = (A[..., 1:, :] - A[..., :-1, :]) / d_c
        return (nu * (_xp(A) - 2 * A + _xm(A)) / dx ** 2
                + _pad_y(nu * (dA[..., 1:, :] - dA[..., :-1, :]) / d_f)
                + nu * (_zp(A) - 2 * A + _zm(A)) / dz ** 2)

    Fu = (-(UU - _xm(UU)) / dx
          - _pad_y((UV[..., 1:, :] - UV[..., :-1, :]) / dyf)
          - (_zp(UW) - UW) / dz + lap(U, dyg, dyf)
          + dPdx.reshape(-1, 1, 1, 1) / 2)
    Fv = (-(_xp(UV) - UV) / dx
          - _pad_y((VV[..., 1:, :] - VV[..., :-1, :]) / dym)
          - (_zp(VW) - VW) / dz + lap(V, dyf, dym))
    Fw = (-(_xp(UW) - UW) / dx
          - _pad_y((VW[..., 1:, :] - VW[..., :-1, :]) / dyf)
          - (WW - _zm(WW)) / dz + lap(W, dyg, dyf))
    return Fu, Fv, Fw


def divergence(grid: Grid, U, V, W):
    dyf = (_const(grid, "y", U)[1:] - _const(grid, "y", U)[:-1])[:, None]
    Ui, Wi = U[..., 1:-1, :], W[..., 1:-1, :]
    return ((_xp(Ui) - Ui) / grid.dx + (V[..., 1:, :] - V[..., :-1, :]) / dyf
            + (_zp(Wi) - Wi) / grid.dz)


def poisson(grid: Grid, r):
    """Solve (d_yy + d_xx + d_zz) p = r, r (B, Nx, Ny - 1, Nz), through the
    dense inverse of every wave pair's operator."""
    R = torch.fft.fft(torch.fft.rfft(r, dim=-1), dim=-3)   # (B, Nx, n, Nzr)
    minv = _const(grid, "minv", r)                          # (Nx, Nzr, n, n)
    P = torch.complex(precision.einsum("xzij,bxjz->bxiz", minv, R.real),
                      precision.einsum("xzij,bxjz->bxiz", minv, R.imag))
    return torch.fft.irfft(torch.fft.ifft(P, dim=-3), n=grid.Nz, dim=-1)


def walls(U, V, W, op1, op2):
    """No slip through antisymmetric ghost rows; op1 / op2 (B, Nx, Nz) are
    the wall-normal velocities blown at the bottom / top wall."""
    U = torch.cat([-U[..., 1:2, :], U[..., 1:-1, :], -U[..., -2:-1, :]], -2)
    W = torch.cat([-W[..., 1:2, :], W[..., 1:-1, :], -W[..., -2:-1, :]], -2)
    V = torch.cat([op1[..., None, :], V[..., 1:-1, :], op2[..., None, :]], -2)
    return U, V, W


def project(grid: Grid, U, V, W):
    p = poisson(grid, divergence(grid, U, V, W))
    dym = (_const(grid, "ym", U)[1:] - _const(grid, "ym", U)[:-1])[:, None]
    U = torch.cat([U[..., :1, :], U[..., 1:-1, :] - (p - _xm(p)) / grid.dx,
                   U[..., -1:, :]], -2)
    V = torch.cat([V[..., :1, :],
                   V[..., 1:-1, :] - (p[..., 1:, :] - p[..., :-1, :]) / dym,
                   V[..., -1:, :]], -2)
    W = torch.cat([W[..., :1, :], W[..., 1:-1, :] - (p - _zm(p)) / grid.dz,
                   W[..., -1:, :]], -2)
    return U, V, W


def bulk(grid: Grid, U):
    """Bulk velocity of the plane-mean profile by the trapezoid over
    [0, ym, 2], halved; (B,)."""
    prof = U[..., 1:-1, :].mean(dim=(-3, -1))
    z = prof.new_zeros(prof.shape[:-1] + (1,))
    vals = torch.cat([z, prof, z], -1)
    ym = _const(grid, "ym", U)
    ys = torch.cat([ym.new_zeros(1), ym, ym.new_full((1,), 2.0)])
    return ((vals[..., 1:] + vals[..., :-1]) * 0.5 * (ys[1:] - ys[:-1])
            ).sum(-1) * 0.5


def wall_pressures(grid: Grid, U, V, W, dPdx):
    """(p1, p2): the pressure at the bottom and top wall, each (B, Nx, Nz),
    from the divergence of the momentum RHS (the solver's pressure sign)."""
    p = poisson(grid, divergence(grid, *rhs(grid, U, V, W, dPdx)))
    return -0.5 * (p[..., 0, :] + p[..., 1, :]), \
        -0.5 * (p[..., -1, :] + p[..., -2, :])


def step(grid: Grid, U, V, W, dPdx, meanU0, op1, op2):
    """One RK3 step with the mass-flux correction, then the wall pressures:
    returns (U, V, W, dPdx, p2)."""
    U0, V0, W0 = U, V, W
    F0 = None
    for c_cur, c_first in RK3:
        F = rhs(grid, U, V, W, dPdx)
        if F0 is None:
            F0 = F
        U, V, W = (A0 + grid.dt * (c_cur * Fk + c_first * F0k)
                   for A0, Fk, F0k in zip((U0, V0, W0), F, F0))
        U, V, W = walls(U, V, W, op1, op2)
        U, V, W = project(grid, U, V, W)
        U, V, W = walls(U, V, W, op1, op2)
    d_new = 2.0 * (meanU0 - bulk(grid, U))
    U = torch.cat([U[..., :1, :], U[..., 1:-1, :] + (d_new / 2)[:, None, None,
                                                                  None],
                   U[..., -1:, :]], -2)
    dPdx = 0.5 * (dPdx + d_new / grid.dt)
    _, p2 = wall_pressures(grid, U, V, W, dPdx)
    return U, V, W, dPdx, p2


def opposition(V, detect_plane: int):
    """Opposition control: minus V at the detection planes, (op1, op2)."""
    return -V[..., detect_plane, :], -V[..., V.shape[-2] - detect_plane, :]


def admitted_state(grid: Grid, U, V, W):
    """Fields made valid for the solver: walls at rest, one projection,
    walls again."""
    z = torch.zeros_like(V[..., 0, :])
    U, V, W = walls(U, V, W, z, z)
    U, V, W = project(grid, U, V, W)
    return walls(U, V, W, z, z)
