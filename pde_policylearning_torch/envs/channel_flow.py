"""Turbulent channel-flow DNS core in PyTorch: staggered-grid RK3 with an
eigen-factorized FFT-Poisson projection.

Counterpart of `pde_policylearning_tpu/envs/channel_flow.py`; the same
layouts at every public function:
  U, W: (Nx, Ny+1, Nz) at cell centres plus two ghost rows;
  V: (Nx, Ny, Nz) at the wall-normal faces;
x and z are periodic.  Leading batch dimensions broadcast through the
stencil functions.

The Poisson solve (`poisson_solve`), the wall pressures
(`boundary_pressures`), the RK3 step (`rk3_step`) and the rollouts
dispatch on the tensor's device: a CPU tensor takes the plain torch
version, a CUDA tensor the hand-written kernels (see `poisson_cuda.py`,
`rk3_cuda.py`).  The first three are differentiable, with the plain
versions' gradients on both devices.

reference: libs/envs/control_env.py of pde-policylearning (compute_rhs_py,
time_advance_RK3_py, compute_projection_step, compute_pressure_py) and
main.m for the grid and the wall-normal operator.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from ..utils.profiling import span

_GRID_TENSORS = ("y", "ym", "yg", "kxx", "kzz", "eig_A", "eig_B", "eig_lam",
                 "Pinv00_eq", "s00", "DD_diag", "DD_lower", "DD_upper",
                 "eig_A1", "eig_B1", "eig_lam1", "schur_g", "schur_s")


@dataclass(eq=False)
class ChannelGrid:
    """Grid geometry and the precomputed solver operators, on one device.

    The eigen factors, the equilibrated (0,0)-mode inverse and the bordered
    (Schur) factors are documented on the JAX `ChannelGrid`.  `cache` holds
    what is derived from the grid once per grid: the kernels' constants and
    their scratch workspaces (see `rk3_cuda.solve_consts`)."""
    y: torch.Tensor          # (Ny,)
    ym: torch.Tensor         # (Ny-1,)
    yg: torch.Tensor         # (Ny+1,)
    kxx: torch.Tensor        # (Nx,)
    kzz: torch.Tensor        # (Nz,)
    eig_A: torch.Tensor      # (n, n), n = Ny-1
    eig_B: torch.Tensor      # (n, n)
    eig_lam: torch.Tensor    # (n,)
    Pinv00_eq: torch.Tensor  # (n, n)
    s00: torch.Tensor        # (n,)
    DD_diag: torch.Tensor    # (n,)
    DD_lower: torch.Tensor   # (n-1,)
    DD_upper: torch.Tensor   # (n-1,)
    eig_A1: torch.Tensor     # (m, m), m = n-1
    eig_B1: torch.Tensor     # (m, m)
    eig_lam1: torch.Tensor   # (m,)
    schur_g: torch.Tensor    # (m, F), F = Nx*(Nz//2+1)
    schur_s: torch.Tensor    # (1, F)
    dx: float
    dz: float
    dt: float
    nu: float
    Nx: int
    Ny: int
    Nz: int
    refine_steps: int = 0
    cache: dict = field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.y.device

    @property
    def dtype(self) -> torch.dtype:
        return self.y.dtype


@dataclass(eq=False)
class ChannelState:
    U: torch.Tensor       # (Nx, Ny+1, Nz), or (Ny+1, C) in kernel layout
    V: torch.Tensor       # (Nx, Ny, Nz),   or (Ny, C)
    W: torch.Tensor       # (Nx, Ny+1, Nz), or (Ny+1, C)
    dPdx: torch.Tensor    # 0-d: running reverse-calculated pressure gradient
    meanU0: torch.Tensor  # 0-d: target bulk velocity for mass-flow control

    def replace(self, **kw) -> "ChannelState":
        return dataclasses.replace(self, **kw)


DEFAULT_NU = 1.0 / 3250.0          # main.m:11
DEFAULT_DPDX = 0.57231059e-1 ** 2  # main.m:12 (utau^2)


def grid_from_arrays(d: dict, device=None, dtype=torch.float32) -> ChannelGrid:
    """ChannelGrid from a dict keyed by the JAX `ChannelGrid` field names
    (array fields as numpy arrays, plus the static dx, dz, dt, nu, Nx, Ny,
    Nz, refine_steps)."""
    dev = resolve_device(device)
    tensors = {k: torch.as_tensor(np.array(d[k], np.float64)).to(dev, dtype)
               for k in _GRID_TENSORS}
    return ChannelGrid(
        **tensors, dx=float(d["dx"]), dz=float(d["dz"]), dt=float(d["dt"]),
        nu=float(d["nu"]), Nx=int(d["Nx"]), Ny=int(d["Ny"]), Nz=int(d["Nz"]),
        refine_steps=int(d.get("refine_steps", 0)))


def state_from_arrays(d: dict, device=None, dtype=torch.float32
                      ) -> ChannelState:
    """ChannelState from a dict of numpy arrays keyed U, V, W, dPdx,
    meanU0 (the JAX `ChannelState` field names)."""
    dev = resolve_device(device)
    return ChannelState(**{
        k: torch.as_tensor(np.array(d[k], np.float64)).to(dev, dtype)
        for k in ("U", "V", "W", "dPdx", "meanU0")})


def make_channel_grid(Nx: int = 32, Ny: int = 130, Nz: int = 32,
                      Lx: float = 2 * math.pi, Lz: float = 2 * math.pi,
                      stretch: float = 2.6,
                      nu: float = DEFAULT_NU, dt: float = 1e-3,
                      y: Optional[np.ndarray] = None,
                      dtype=torch.float32,
                      refine_steps: Optional[int] = None,
                      device=None) -> ChannelGrid:
    """Build the grid and its solver operators in numpy float64, then move
    them to `device` in `dtype` (the JAX `make_channel_grid`, same math).

    Default geometry: uniform periodic x/z, tanh-stretched y,
    ``y = 1 + tanh(s * linspace(-1,1,Ny)) / tanh(s)`` (main.m:20-24)."""
    dx = Lx / Nx
    dz = Lz / Nz
    if y is None:
        y = 1.0 + np.tanh(stretch * np.linspace(-1, 1, Ny)) / np.tanh(stretch)
    y = np.asarray(y, np.float64).reshape(-1)
    Ny = len(y)
    ym = 0.5 * (y[:-1] + y[1:])
    yg = np.concatenate([[-ym[0]], ym, [2.0 + ym[0]]])

    # modified wavenumbers (main.m:43-57)
    k = np.arange(Nx)
    k = np.where(k <= Nx // 2, k, k - Nx)
    kxx = 2.0 * (np.cos(2 * np.pi * k / Nx) - 1.0) / dx ** 2
    kz = np.arange(Nz)
    kz = np.where(kz <= Nz // 2, kz, kz - Nz)
    kzz = 2.0 * (np.cos(2 * np.pi * kz / Nz) - 1.0) / dz ** 2

    # wall-normal Poisson operator DD (main.m:60-72)
    n = Ny - 1
    diag = np.zeros(n)
    for j in range(n):
        diag[j] = -1.0 / (y[j + 1] - y[j]) * (
            1.0 / (yg[j + 2] - yg[j + 1]) + 1.0 / (yg[j + 1] - yg[j]))
    lower = np.zeros(n - 1)
    upper = np.zeros(n - 1)
    for j in range(n - 1):
        lower[j] = 1.0 / (y[j + 2] - y[j + 1]) / (yg[j + 2] - yg[j + 1])
        upper[j] = 1.0 / (y[j + 1] - y[j]) / (yg[j + 2] - yg[j + 1])
    diag[0] += 1.0 / (y[1] - y[0]) / (yg[1] - yg[0])
    diag[-1] += 1.0 / (y[n] - y[n - 1]) / (yg[n + 1] - yg[n])
    DD = np.diag(diag) + np.diag(lower, -1) + np.diag(upper, 1)

    # DD = S^-1 Q diag(lam) Q^T S through a diagonal symmetrization S, so
    # (DD + kk I)^-1 r = A [(B r) / (lam + kk)], A = S^-1 Q, B = Q^T S
    s = np.ones(n)
    for j in range(1, n):
        s[j] = s[j - 1] * np.sqrt(upper[j - 1] / lower[j - 1])
    s /= np.exp(np.mean(np.log(np.abs(s))))
    off_sym = np.sqrt(lower * upper)
    T = np.diag(diag) + np.diag(off_sym, -1) + np.diag(off_sym, 1)
    lam, Q = np.linalg.eigh(T)
    eig_A = Q / s[:, None]
    eig_B = Q.T * s[None, :]
    # regularized (0,0) mode (1.5*D[0,0], control_env.py:598-599),
    # diagonally equilibrated for f32
    D00 = DD.copy()
    D00[0, 0] *= 1.5
    s00 = 1.0 / np.sqrt(np.abs(np.diag(D00)))
    Pinv00_eq = np.linalg.inv((s00[:, None] * D00) * s00[None, :])

    # bordered (Schur) factors: the leading m = n-1 block in its own
    # eigenbasis, the last row through a per-wavenumber Schur scalar
    m = n - 1
    lam1, Q1 = np.linalg.eigh(T[:m, :m])
    eig_A1 = Q1 / s[:m, None]
    eig_B1 = Q1.T * s[None, :m]
    Nzr = Nz // 2 + 1
    kkF = (kxx[:, None] + kzz[None, :Nzr]).reshape(1, -1)     # (1, F)
    denom1 = lam1[:, None] + kkF                              # (m, F)
    schur_g = upper[m - 1] * (eig_A1 @ (eig_B1[:, m - 1:m] / denom1))
    schur_s = (diag[m] + kkF) - lower[m - 1] * schur_g[m - 1:m]
    # the Neumann null mode sits in the Schur scalar at kk = 0: guard it
    # (that column is solved through Pinv00_eq)
    tiny = 1e-9 * np.max(np.abs(schur_s))
    schur_s = np.where(np.abs(schur_s) < tiny, 1.0, schur_s)

    if refine_steps is None:
        refine_steps = 0 if dtype == torch.float64 else 1
    arrays = dict(y=y, ym=ym, yg=yg, kxx=kxx, kzz=kzz, eig_A=eig_A,
                  eig_B=eig_B, eig_lam=lam, Pinv00_eq=Pinv00_eq, s00=s00,
                  DD_diag=diag, DD_lower=lower, DD_upper=upper,
                  eig_A1=eig_A1, eig_B1=eig_B1, eig_lam1=lam1,
                  schur_g=schur_g, schur_s=schur_s,
                  dx=dx, dz=dz, dt=dt, nu=nu, Nx=Nx, Ny=Ny, Nz=Nz,
                  refine_steps=refine_steps)
    return grid_from_arrays(arrays, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# periodic shifts along x (dim -3) and z (dim -1)
# ---------------------------------------------------------------------------

def _xm(a):  # a[i-1] in x
    return torch.roll(a, 1, dims=-3)


def _xp(a):  # a[i+1] in x
    return torch.roll(a, -1, dims=-3)


def _zm(a):
    return torch.roll(a, 1, dims=-1)


def _zp(a):
    return torch.roll(a, -1, dims=-1)


def _pad_y(a):
    """One zero row before and after along y (dim -2)."""
    return F.pad(a, (0, 0, 1, 1))


def _col(v):
    """(R,) y-metric -> (R, 1) so it broadcasts over (..., R, Nz)."""
    return v[:, None]


def apply_boundary_condition(U, V, W, Vw1, Vw2):
    """No-slip walls through antisymmetric ghost rows for U/W; wall-normal
    actuation Vw1/Vw2 on the V wall faces (control_env.py:10-19)."""
    U = torch.cat([-U[..., 1:2, :], U[..., 1:-1, :], -U[..., -2:-1, :]], -2)
    W = torch.cat([-W[..., 1:2, :], W[..., 1:-1, :], -W[..., -2:-1, :]], -2)
    V = torch.cat([Vw1.to(V.dtype)[..., None, :], V[..., 1:-1, :],
                   Vw2.to(V.dtype)[..., None, :]], -2)
    return U, V, W


def _steps(grid: ChannelGrid):
    """(dx, dz, dx**2, dz**2) as 0-d tensors on the grid's device, cached.
    Dividing by them is an IEEE division on every device: torch divides a
    CUDA tensor by a Python scalar as a product with the float reciprocal,
    a bit off the quotient, and the divergence's cancellation amplifies
    that bit past the kernels' 1e-6 parity bound."""
    if "steps" not in grid.cache:
        grid.cache["steps"] = tuple(
            torch.tensor(v, dtype=grid.dtype, device=grid.device)
            for v in (grid.dx, grid.dz, grid.dx ** 2, grid.dz ** 2))
    return grid.cache["steps"]


def compute_rhs(grid: ChannelGrid, U, V, W, dPdx):
    """Momentum RHS Fu, Fv, Fw (convection + diffusion + forcing); the JAX
    `_compute_rhs_unfused` term by term (control_env.py:429-530)."""
    dx, dz, dx2, dz2 = _steps(grid)
    nu = grid.nu
    y, ym, yg = grid.y, grid.ym, grid.yg
    dyf = _col(y[1:] - y[:-1])       # (Ny-1, 1) face spacing
    dyg = _col(yg[1:] - yg[:-1])     # (Ny, 1) centre spacing
    dym = _col(ym[1:] - ym[:-1])     # (Ny-2, 1)

    UU = (0.5 * (U + _xp(U))) ** 2
    Fu = -(UU - _xm(UU)) / dx
    UV = (0.5 * (V + _xm(V))) * (0.5 * (U[..., :-1, :] + U[..., 1:, :]))
    Fu = Fu - _pad_y((UV[..., 1:, :] - UV[..., :-1, :]) / dyf)
    UW = (0.5 * (W + _xm(W))) * (0.5 * (U + _zm(U)))
    Fu = Fu - (_zp(UW) - UW) / dz
    Fu = Fu + nu * (_xp(U) - 2 * U + _xm(U)) / dx2
    dU = (U[..., 1:, :] - U[..., :-1, :]) / dyg
    Fu = Fu + _pad_y(nu * (dU[..., 1:, :] - dU[..., :-1, :]) / dyf)
    Fu = Fu + nu * (_zp(U) - 2 * U + _zm(U)) / dz2
    Fu = Fu + dPdx / 2

    Fv = -(_xp(UV) - UV) / dx
    VV = (0.5 * (V[..., :-1, :] + V[..., 1:, :])) ** 2
    Fv = Fv - _pad_y((VV[..., 1:, :] - VV[..., :-1, :]) / dym)
    VW = (0.5 * (V + _zm(V))) * (0.5 * (W[..., :-1, :] + W[..., 1:, :]))
    Fv = Fv - (_zp(VW) - VW) / dz
    Fv = Fv + nu * (_xp(V) - 2 * V + _xm(V)) / dx2
    dV = (V[..., 1:, :] - V[..., :-1, :]) / dyf
    Fv = Fv + _pad_y(nu * (dV[..., 1:, :] - dV[..., :-1, :]) / dym)
    Fv = Fv + nu * (_zp(V) - 2 * V + _zm(V)) / dz2

    Fw = -(_xp(UW) - UW) / dx
    Fw = Fw - _pad_y((VW[..., 1:, :] - VW[..., :-1, :]) / dyf)
    WW = (0.5 * (W + _zp(W))) ** 2
    Fw = Fw - (WW - _zm(WW)) / dz
    Fw = Fw + nu * (_xp(W) - 2 * W + _xm(W)) / dx2
    dW = (W[..., 1:, :] - W[..., :-1, :]) / dyg
    Fw = Fw + _pad_y(nu * (dW[..., 1:, :] - dW[..., :-1, :]) / dyf)
    Fw = Fw + nu * (_zp(W) - 2 * W + _zm(W)) / dz2
    return Fu, Fv, Fw


def divergence(grid: ChannelGrid, U, V, W):
    """Cell-centred divergence, shape (Nx, Ny-1, Nz)
    (control_env.py:186-194)."""
    dyf = _col(grid.y[1:] - grid.y[:-1])
    dx, dz = _steps(grid)[:2]
    Ui = U[..., 1:-1, :]
    Wi = W[..., 1:-1, :]
    return ((_xp(Ui) - Ui) / dx + (V[..., 1:, :] - V[..., :-1, :]) / dyf
            + (_zp(Wi) - Wi) / dz)


def trap_weights(grid: ChannelGrid):
    """Segment widths diff([0, ym, 2]) of the bulk-velocity trapezoid."""
    ym = grid.ym
    ys = torch.cat([ym.new_zeros(1), ym, ym.new_full((1,), 2.0)])
    return ys[1:] - ys[:-1]                                     # (Ny,)


def bulk_velocity(grid: ChannelGrid, profile):
    """Trapezoid of [0, profile, 0] over [0, ym, 2], halved.  One fixed term
    order, shared by every layout and by the CUDA step: the mass-flow
    update amplifies this value's rounding by 1/dt."""
    z = profile.new_zeros(profile.shape[:-1] + (1,))
    vals = torch.cat([z, profile, z], -1)
    terms = (vals[..., 1:] + vals[..., :-1]) * 0.5 * trap_weights(grid)
    return terms.sum(-1) * 0.5


def calculate_mean_u(grid: ChannelGrid, U):
    """Bulk velocity of the mean profile (control_env.py:249-259)."""
    return bulk_velocity(grid, U[..., 1:-1, :].mean(dim=(-3, -1)))


def _pressure_rhs(grid: ChannelGrid, state: ChannelState):
    Fu, Fv, Fw = compute_rhs(grid, state.U, state.V, state.W, state.dPdx)
    return divergence(grid, Fu, Fv, Fw)


def poisson_solve(grid: ChannelGrid, rhs):
    """Solve (d_yy + kxx + kzz) p = rhs for rhs (Nx, Ny-1, Nz): the plain
    torch solve for a CPU tensor, the CUDA kernel for a CUDA tensor; the
    gradient is the plain solve's on both (`poisson_cuda._PoissonSolve`)."""
    from . import poisson_cuda
    return poisson_cuda.poisson_solve(grid, rhs)


def projection_step(grid: ChannelGrid, U, V, W):
    """Pressure projection onto divergence-free fields
    (control_env.py:582-613)."""
    p = poisson_solve(grid, divergence(grid, U, V, W))
    return pressure_correction(grid, U, V, W, p)


def pressure_correction(grid: ChannelGrid, U, V, W, p):
    """U, V, W -= grad p on the interior rows; the ghost and wall rows stay
    as they are."""
    dym = _col(grid.ym[1:] - grid.ym[:-1])
    dx, dz = _steps(grid)[:2]
    U = torch.cat([U[..., :1, :], U[..., 1:-1, :] - (p - _xm(p)) / dx,
                   U[..., -1:, :]], -2)
    V = torch.cat([V[..., :1, :],
                   V[..., 1:-1, :] - (p[..., 1:, :] - p[..., :-1, :]) / dym,
                   V[..., -1:, :]], -2)
    W = torch.cat([W[..., :1, :], W[..., 1:-1, :] - (p - _zm(p)) / dz,
                   W[..., -1:, :]], -2)
    return U, V, W


def compute_pressure(grid: ChannelGrid, state: ChannelState):
    """Full pressure field from the RHS divergence
    (control_env.py:196-229)."""
    return poisson_solve(grid, _pressure_rhs(grid, state))


def boundary_pressures(grid: ChannelGrid, state: ChannelState):
    """(p1, p2) bottom/top wall pressures, each (Nx, Nz)
    (control_env.py:423-427): the 4 wall-adjacent rows of the bordered
    solve, through `rk3_cuda.boundary_pressures_k` (plain on the CPU, the
    CUDA kernel pair on a card; the gradient is the plain version's on
    both)."""
    from . import rk3_cuda as rk
    U, V, W = (rk.to_k(a) for a in (state.U, state.V, state.W))
    p1, p2 = rk.boundary_pressures_k(grid, U, V, W, state.dPdx.reshape(1))
    return (p1.reshape(grid.Nx, grid.Nz), p2.reshape(grid.Nx, grid.Nz))


def _rk3_substages(grid: ChannelGrid, state: ChannelState, opV1, opV2,
                   project=None):
    """The three RK3 substages of `_rk3_step_unfused` (no mass flow): each
    the RHS, the RK update, the BCs, `project(U, V, W)` (default
    `projection_step`) and the BCs again.  Returns (U, V, W).  The x-sharded
    step (`parallel/sharded_env.py`) runs it on slabs with halo planes and
    its distributed projection."""
    if project is None:
        def project(U, V, W):
            return projection_step(grid, U, V, W)
    dt = grid.dt
    U0, V0, W0 = state.U, state.V, state.W
    # actuation may arrive in another dtype than the state's
    opV1 = opV1.to(V0.dtype)
    opV2 = opV2.to(V0.dtype)
    dPdx = state.dPdx

    def substage(U, V, W, coeffs, Fus):
        Fu, Fv, Fw = compute_rhs(grid, U, V, W, dPdx)
        Fus_new = Fus + [(Fu, Fv, Fw)]
        Un = U0 + dt * sum(c * f[0] for c, f in zip(coeffs, Fus_new))
        Vn = V0 + dt * sum(c * f[1] for c, f in zip(coeffs, Fus_new))
        Wn = W0 + dt * sum(c * f[2] for c, f in zip(coeffs, Fus_new))
        Un, Vn, Wn = apply_boundary_condition(Un, Vn, Wn, opV1, opV2)
        Un, Vn, Wn = project(Un, Vn, Wn)
        Un, Vn, Wn = apply_boundary_condition(Un, Vn, Wn, opV1, opV2)
        return Un, Vn, Wn, Fus_new

    U, V, W, fs = substage(U0, V0, W0, [8 / 15], [])
    U, V, W, fs = substage(U, V, W, [1 / 4, 5 / 12], fs[:1])
    U, V, W, fs = substage(U, V, W, [1 / 4, 0.0, 3 / 4], fs[:1] + [fs[0]])
    return U, V, W


def _rk3_step_unfused(grid: ChannelGrid, state: ChannelState, opV1, opV2
                      ) -> ChannelState:
    """One RK3 step (three substages) + mass-flow correction in the
    (x, y, z) layout, projecting through `projection_step`
    (control_env.py:533-580): the JAX `_rk3_step_unfused` term by term.
    The reference of the staged kernels and the backward of `rk3_step`."""
    dt = grid.dt
    dPdx = state.dPdx
    U, V, W = _rk3_substages(grid, state, opV1, opV2)

    # mass-flow correction (control_env.py:574-579)
    d_new = 2.0 * (state.meanU0 - calculate_mean_u(grid, U))
    U = torch.cat([U[..., :1, :], U[..., 1:-1, :] + d_new / 2.0,
                   U[..., -1:, :]], -2)
    return state.replace(U=U, V=V, W=W, dPdx=0.5 * (dPdx + d_new / dt))


class _RK3Step(torch.autograd.Function):
    """One RK3 step of (x, y, z)-layout fields.  The forward runs the
    staged kernels (`rk3_cuda.rk3_step_k`) on a float32 CUDA tensor and
    `_rk3_step_unfused` on anything else, as the JAX dispatch does; the
    backward is the VJP of `_rk3_step_unfused`, recomputed (the JAX
    `rk3_pallas._rk3_bwd`).  The grid's constants get no gradient."""

    @staticmethod
    def forward(ctx, grid, U, V, W, dPdx, meanU0, opV1, opV2):
        ctx.grid = grid
        ctx.save_for_backward(U, V, W, dPdx, meanU0, opV1, opV2)
        state = ChannelState(U=U, V=V, W=W, dPdx=dPdx, meanU0=meanU0)
        if U.is_cuda and U.dtype == torch.float32:
            from . import rk3_cuda as rk
            C = grid.Nx * grid.Nz
            kst = rk.state_to_kstate(state)
            Uk, Vk, Wk, dP = rk.rk3_step_k(
                grid, kst.U, kst.V, kst.W, dPdx, meanU0,
                opV1.reshape(1, C).to(U.dtype).contiguous(),
                opV2.reshape(1, C).to(U.dtype).contiguous())
            state = rk.kstate_to_state(grid, kst.replace(U=Uk, V=Vk, W=Wk,
                                                         dPdx=dP))
        else:
            state = _rk3_step_unfused(grid, state, opV1, opV2)
        return state.U, state.V, state.W, state.dPdx

    @staticmethod
    def backward(ctx, gU, gV, gW, gdPdx):
        inputs = [a.detach().requires_grad_() for a in ctx.saved_tensors]
        with torch.enable_grad():
            out = _rk3_step_unfused(ctx.grid, ChannelState(*inputs[:5]),
                                    *inputs[5:])
            grads = torch.autograd.grad(
                (out.U, out.V, out.W, out.dPdx), inputs,
                (gU, gV, gW, gdPdx), allow_unused=True)
        return (None, *grads)


def rk3_step(grid: ChannelGrid, state: ChannelState, opV1, opV2
             ) -> ChannelState:
    """One RK3 substep triple + mass-flow correction
    (control_env.py:533-580): the staged CUDA kernels for a float32 CUDA
    state, `_rk3_step_unfused` otherwise; differentiable on both (the
    gradient is the unfused step's)."""
    U, V, W, dPdx = _RK3Step.apply(grid, state.U, state.V, state.W,
                                   state.dPdx, state.meanU0, opV1, opV2)
    return state.replace(U=U, V=V, W=W, dPdx=dPdx)


def env_step(grid: ChannelGrid, state: ChannelState, opV1, opV2):
    """Full environment step: advance + observe + score
    (control_env.py:639-664).  Returns (state', p2, div_reward, info).

    A float32 CUDA state steps in the kernel layout (`rk3_cuda.env_step_k`:
    kernel D, or the staged kernels when `rk3_cuda.FULLSTEP` is off);
    anything else, and a state or action that needs a gradient, through
    the differentiable `rk3_step`, `boundary_pressures` and `step_metrics`
    (on a card their forward runs the staged kernels and the wall pair).
    For repeated stepping use `rollout` or `control.loop.closed_loop_chunk`,
    which keep the kernel layout across steps and, on a card, refuse inputs
    that need a gradient."""
    wants_grad = torch.is_grad_enabled() and any(
        torch.is_tensor(a) and a.requires_grad
        for a in (state.U, state.V, state.W, state.dPdx, state.meanU0, opV1,
                  opV2))
    if state.U.is_cuda and state.U.dtype == torch.float32 and not wants_grad:
        from . import rk3_cuda as rk
        kst, p2, info = rk.env_step_k(grid, rk.state_to_kstate(state), opV1,
                                      opV2)
        state = rk.kstate_to_state(grid, kst)
    else:
        state = rk3_step(grid, state, opV1, opV2)
        _, p2 = boundary_pressures(grid, state)
        info = step_metrics(grid, state, p2)
    return state, p2, info["drag_reduction/4_1_-|divergence|"], info


def init_state(grid: ChannelGrid, generator: Optional[torch.Generator] = None,
               noise: float = 0.0, dPdx: float = DEFAULT_DPDX,
               U=None, V=None, W=None, dtype=None) -> ChannelState:
    """Initial condition: the laminar Poiseuille profile matching the
    forcing (plus noise drawn from `generator`, made a valid state by the
    BCs and a projection), or explicit fields."""
    dtype = dtype or grid.dtype
    dev = grid.device
    Nx, Ny, Nz = grid.Nx, grid.Ny, grid.Nz
    if U is None:
        yg = grid.yg.double().cpu().numpy()
        u_prof = dPdx / (2 * grid.nu) * yg * (2.0 - yg) / 2.0
        U = torch.as_tensor(u_prof, dtype=dtype, device=dev)[None, :, None]
        U = U.expand(Nx, Ny + 1, Nz).clone()
        V = torch.zeros((Nx, Ny, Nz), dtype=dtype, device=dev)
        W = torch.zeros((Nx, Ny + 1, Nz), dtype=dtype, device=dev)
        if noise > 0 and generator is not None:
            def draw(a):
                return torch.randn(a.shape, generator=generator, dtype=dtype,
                                   device=dev)
            U = U + noise * draw(U)
            V = V + noise * draw(V)
            W = W + noise * draw(W)
            zeros = torch.zeros((Nx, Nz), dtype=dtype, device=dev)
            U, V, W = apply_boundary_condition(U, V, W, zeros, zeros)
            U, V, W = projection_step(grid, U, V, W)
            U, V, W = apply_boundary_condition(U, V, W, zeros, zeros)
    else:
        U, V, W = (torch.as_tensor(np.array(a)).to(dev, dtype)
                   for a in (U, V, W))
    return ChannelState(U=U, V=V, W=W,
                        dPdx=torch.tensor(dPdx, dtype=dtype, device=dev),
                        meanU0=calculate_mean_u(grid, U))


# ---------------------------------------------------------------------------
# scores / metrics (control_env.py:182-340)
# ---------------------------------------------------------------------------

def shear_stress(grid: ChannelGrid, state: ChannelState):
    """|mean(-u_wall v_wall + nu dU/dy)| at the top wall
    (control_env.py:292-303)."""
    U, V = state.U, state.V
    dudy = (U[:, -1, :] - U[:, -2, :]) / (grid.y[-1] - grid.y[-2])
    tau = -U[:, -1, :] * V[:, -1, :] + grid.nu * dudy
    return torch.abs(torch.mean(tau))


def speed_norm(state: ChannelState):
    return (torch.linalg.vector_norm(state.U)
            + torch.linalg.vector_norm(state.V)
            + torch.linalg.vector_norm(state.W))


def dpdx_finite_difference(grid: ChannelGrid, p2):
    """Mean |dp/dx| of the top-wall pressure p2 (Nx, Nz)
    (control_env.py:240-247)."""
    grad = (p2[1:, :] - p2[:-1, :]) / grid.dx
    return torch.abs(torch.mean(torch.abs(grad), dim=1).sum()
                     / (p2.shape[0] - 1))


def reward_divergence(grid: ChannelGrid, state: ChannelState,
                      bound: float = -100.0):
    div = divergence(grid, state.U, state.V, state.W)
    return torch.clamp(-torch.abs(torch.sum(div)), min=bound)


def step_metrics(grid: ChannelGrid, state: ChannelState, p2):
    """The drag-reduction scoreboard (control_env.py:651-661)."""
    return {
        "drag_reduction/1_shear_stress": shear_stress(grid, state),
        "drag_reduction/2_1_mass_flow": calculate_mean_u(grid, state.U),
        "drag_reduction/2_2_v_velocity": torch.mean(torch.abs(state.V)),
        "drag_reduction/2_3_w_velocity": torch.mean(torch.abs(state.W)),
        "drag_reduction/3_1_pressure_mean": torch.mean(p2),
        "drag_reduction/3_2_dPdx_finite_difference":
            dpdx_finite_difference(grid, p2),
        "drag_reduction/3_3_dPdx_reverse_cal": state.dPdx,
        "drag_reduction/4_1_-|divergence|": reward_divergence(grid, state),
        "drag_reduction/4_4_speed_norm": speed_norm(state),
    }


def gt_control(state: ChannelState, detect_plane: int):
    """Opposition control: negate V at the detection planes
    (control_env.py:416-421).  Takes the (Nx, Ny, Nz) layout or the
    kernel layout (rows = y, cols = x*Nz + z), whose planes come out
    (C,)."""
    V = state.V
    if V.ndim == 2:
        return -V[detect_plane], -V[V.shape[0] - detect_plane]
    return -V[:, detect_plane, :], -V[:, -detect_plane, :]


def rand_control(generator: torch.Generator, shape, scale: float = 0.01,
                 dtype=torch.float32, device=None):
    """Random actuation (matlab compute_opposition.m: 0.01*rand), on
    `device` or, by default, on the generator's device."""
    return scale * torch.rand(
        shape, generator=generator, dtype=dtype,
        device=generator.device if device is None else device)


# ---------------------------------------------------------------------------
# rollouts: the data-collection engines (run_control.py:135-296)
# ---------------------------------------------------------------------------

def _rollout_packed(grid, B, kst, n_steps, detect_plane, policy, generator,
                    collect_fields, boundary, batch_of=None):
    """`n_steps` closed-loop steps of B packed envs in the kernel layout,
    with the policy inside the loop and the per-step outputs written into
    preallocated tensors on the state's device (no host sync).  Each step
    is kernel D (`rk3_cuda.FULLSTEP`) or the staged step followed by
    `boundary(U, V, W, dPdx)`; the dispatchers pick the kernels for a CUDA
    state and the plain versions for a CPU one.  `batch_of` = (start, n):
    these B envs are envs start .. start + B - 1 of a batch of n, and the
    `rand` draws are made for all n and this block kept (None: (0, B)).
    The call is the span `rollout.chunk`, each step (all B envs) the span
    `rollout.step`.  Returns (kst', (p2 (T, B*C), v_plane (T, B*C), dPdx
    (T, B)[, U, V, W (T, R, B*C)]))."""
    from . import rk3_cuda as rk
    with span("rollout.chunk"):
        dtype, dev = kst.U.dtype, kst.U.device
        C = grid.Nx * grid.Nz
        BC = B * C
        start, n_all = batch_of or (0, B)
        p2s = torch.empty((n_steps, BC), dtype=dtype, device=dev)
        vps = torch.empty((n_steps, BC), dtype=dtype, device=dev)
        dps = torch.empty((n_steps, B), dtype=dtype, device=dev)
        fields = [torch.empty((n_steps,) + a.shape, dtype=dtype, device=dev)
                  for a in (kst.U, kst.V, kst.W)] if collect_fields else []
        zero = torch.zeros((1, BC), dtype=dtype, device=dev)
        for i in range(n_steps):
            with span("rollout.step"):
                if policy == "gt":
                    o1, o2 = gt_control(kst, detect_plane)
                    op1, op2 = o1[None], o2[None]
                elif policy == "rand":
                    op1, op2 = (rand_control(generator, (1, n_all * C),
                                             dtype=dtype, device=dev)
                                [:, start * C:start * C + BC]
                                for _ in range(2))
                else:
                    op1 = op2 = zero
                if rk.FULLSTEP:
                    U, V, W, dPdx, p = rk.env_step_full_kb(
                        grid, B, kst.U, kst.V, kst.W, kst.dPdx, kst.meanU0,
                        op1, op2)
                    p2 = p[1]
                else:
                    U, V, W, dPdx = rk.rk3_step_kb(
                        grid, B, kst.U, kst.V, kst.W, kst.dPdx, kst.meanU0,
                        op1, op2)
                    _, p2 = boundary(U, V, W, dPdx)
                kst = kst.replace(U=U, V=V, W=W, dPdx=dPdx)
                p2s[i] = p2.reshape(BC)
                vps[i] = V[V.shape[0] - detect_plane]
                dps[i] = dPdx
                for buf, a in zip(fields, (U, V, W)):
                    buf[i] = a
        return kst, (p2s, vps, dps, *fields)


def _generator(generator, device):
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return generator


def rollout(grid: ChannelGrid, state: ChannelState, n_steps: int,
            detect_plane: int = 25, policy: str = "gt",
            generator: Optional[torch.Generator] = None,
            collect_fields: bool = False):
    """Closed-loop rollout of one env with the policy (`gt` opposition,
    `rand` 0.01*uniform on both walls, anything else none) inside the
    loop: no per-step host sync.  The state stays in the kernel layout
    throughout; on a CUDA state each step is kernel D, or with
    `rk3_cuda.FULLSTEP` off the staged kernels and the wall-pressure pair.
    On a card it passes no gradient: a state that needs one raises.

    Returns (state', outs): outs stacks per step (p2 (T, Nx, Nz),
    v_plane (T, Nx, Nz), dPdx (T,) [, U, V, W (T, Nx, R, Nz)]).  The data-
    collection engine replacing the reference's loop
    (run_control.py:135-296)."""
    from . import rk3_cuda as rk
    Nx, Nz = grid.Nx, grid.Nz
    kst = rk.state_to_kstate(state)
    kst = kst.replace(dPdx=kst.dPdx.reshape(1), meanU0=kst.meanU0.reshape(1))
    kst, outs = _rollout_packed(
        grid, 1, kst, n_steps, detect_plane, policy,
        _generator(generator, state.U.device), collect_fields,
        lambda U, V, W, dPdx: rk.boundary_pressures_k(grid, U, V, W, dPdx))
    state = rk.kstate_to_state(grid, kst).replace(
        dPdx=kst.dPdx.reshape(state.dPdx.shape), meanU0=state.meanU0)
    p2s, vps, dps = outs[:3]
    conv = (p2s.reshape(n_steps, Nx, Nz), vps.reshape(n_steps, Nx, Nz),
            dps[:, 0])
    for a in outs[3:]:   # (T, R, C) -> (T, Nx, R, Nz)
        conv += (a.reshape(n_steps, a.shape[1], Nx, Nz).permute(0, 2, 1, 3),)
    return state, conv


def batched_rollout(grid: ChannelGrid, states: ChannelState, n_steps: int,
                    detect_plane: int = 25, policy: str = "gt",
                    generator: Optional[torch.Generator] = None,
                    collect_fields: bool = False, batch_of=None):
    """Closed-loop rollout of B independent envs (leading batch axis on
    every ChannelState leaf), packed env-major into the kernels' columns,
    (rows, B*C): each step is one kernel D call for the whole batch, or
    with `rk3_cuda.FULLSTEP` off 3 x (kernel A, kernel B), the mass-flow
    kernels and kernel C, for any B.  Random-policy draws come from one
    generator for all envs (independent across envs and steps); with
    `batch_of` = (start, n) the B envs are envs start .. start + B - 1 of a
    batch of n, whose draws are made whole and sliced, so that a block of
    a batch steps as it does in the whole (`parallel.data_parallel_rollout`).
    On a card it passes no gradient: states that need one raise.

    Returns (states', outs): (p2 (B, T, Nx, Nz), v_plane (B, T, Nx, Nz),
    dPdx (B, T) [, U, V, W (B, T, Nx, R, Nz)])."""
    from . import rk3_cuda as rk
    B = states.U.shape[0]
    Nx, Nz = grid.Nx, grid.Nz
    kst, outs = _rollout_packed(
        grid, B, rk.batch_states(states), n_steps, detect_plane, policy,
        _generator(generator, states.U.device), collect_fields,
        lambda U, V, W, dPdx: rk.boundary_pressures_kb(grid, B, U, V, W,
                                                       dPdx), batch_of)
    states = rk.unbatch_states(grid, kst, B).replace(meanU0=states.meanU0)
    p2s, vps, dps = outs[:3]

    def planes(a):   # (T, B*C) -> (B, T, Nx, Nz)
        return a.reshape(n_steps, B, Nx, Nz).permute(1, 0, 2, 3)

    conv = (planes(p2s), planes(vps), dps.T)
    for a in outs[3:]:   # (T, R, B*C) -> (B, T, Nx, R, Nz)
        conv += (a.reshape(n_steps, a.shape[1], B, Nx, Nz)
                 .permute(2, 0, 3, 1, 4),)
    return states, conv


def init_batched_states(grid: ChannelGrid, n_envs: int,
                        generator: torch.Generator, noise: float = 0.05,
                        dPdx: float = DEFAULT_DPDX) -> ChannelState:
    """n_envs noisy laminar states (`init_state`), drawn one after another
    from `generator`, stacked on a leading batch axis."""
    states = [init_state(grid, generator=generator, noise=noise, dPdx=dPdx)
              for _ in range(n_envs)]
    return ChannelState(**{k: torch.stack([getattr(s, k) for s in states])
                           for k in ("U", "V", "W", "dPdx", "meanU0")})


# ---------------------------------------------------------------------------
# Developed-turbulence initial condition (the JAX module's notes): a
# turbulent mean profile, so the constant-mass-flux constraint locks onto
# the turbulent bulk velocity, plus streamwise vortices to trip transition;
# `spinup_chunk` then runs the DNS until the wall-shear statistics settle
# near Re_tau ~ 180.
# ---------------------------------------------------------------------------

def reichardt_profile(y_plus, kappa: float = 0.41):
    """Reichardt's composite law-of-the-wall mean profile u+(y+), numpy
    float64."""
    y_plus = np.asarray(y_plus, np.float64)
    return (np.log1p(kappa * y_plus) / kappa
            + 7.8 * (1.0 - np.exp(-y_plus / 11.0)
                     - (y_plus / 11.0) * np.exp(-y_plus / 3.0)))


def init_turbulent_state(grid: ChannelGrid, generator: torch.Generator,
                         dPdx: float = DEFAULT_DPDX,
                         vortex_amp: float = 3.0,
                         noise: float = 0.02,
                         n_vortex_pairs: int = 2) -> ChannelState:
    """Tripped turbulent-transition IC: Reichardt mean profile + pairs of
    counter-rotating streamwise vortices (amplitude `vortex_amp` in wall
    units) + broadband noise from `generator`, wall-corrected and
    projected divergence-free.  The geometry is built in numpy float64;
    meanU0 is the Reichardt profile's bulk velocity."""
    utau = math.sqrt(dPdx)
    dtype, dev = grid.dtype, grid.device
    Nx, Ny, Nz = grid.Nx, grid.Ny, grid.Nz
    yg = grid.yg.double().cpu().numpy()            # (Ny+1,) U/W centres
    y_faces = grid.y.double().cpu().numpy()        # (Ny,) V faces

    # mean profile on U's y-points: distance to the nearest wall
    d_wall = np.minimum(np.abs(yg), np.abs(2.0 - yg))
    u_mean = utau * reichardt_profile(d_wall * utau / grid.nu)

    # streamwise vortices psi(y, z) = A sin(pi y / 2) sin(kz z):
    # V' = dpsi/dz, W' = -dpsi/dy
    A = vortex_amp * utau
    kz = 2 * math.pi * n_vortex_pairs / (grid.dz * Nz)
    z_c = (np.arange(Nz) + 0.5) * grid.dz          # cell centres
    z_f = np.arange(Nz) * grid.dz                  # faces (for W)
    Vp = (A * kz * np.sin(math.pi * y_faces / 2.0)[None, :, None]
          * np.cos(kz * z_c)[None, None, :])
    Wp = (-A * (math.pi / 2.0) * np.cos(math.pi * yg / 2.0)[None, :, None]
          * np.sin(kz * z_f)[None, None, :])

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def draw(shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=dev)

    U = t(u_mean)[None, :, None].expand(Nx, Ny + 1, Nz)
    V = t(Vp).expand(Nx, Ny, Nz)
    W = t(Wp).expand(Nx, Ny + 1, Nz)
    damp = t(np.minimum(d_wall, 0.3) / 0.3)[None, :, None]  # clean walls
    U = U + noise * draw(U.shape) * damp
    V = V + noise * draw(V.shape) * t(np.sin(math.pi * y_faces / 2.0)
                                      )[None, :, None]
    W = W + noise * draw(W.shape) * damp

    zeros = torch.zeros((Nx, Nz), dtype=dtype, device=dev)
    U, V, W = apply_boundary_condition(U, V, W, zeros, zeros)
    U, V, W = projection_step(grid, U, V, W)
    U, V, W = apply_boundary_condition(U, V, W, zeros, zeros)
    return ChannelState(U=U, V=V, W=W,
                        dPdx=torch.tensor(dPdx, dtype=dtype, device=dev),
                        meanU0=calculate_mean_u(grid, U))


def spinup_chunk(grid: ChannelGrid, state: ChannelState, n_steps: int):
    """Advance `n_steps` with zero actuation (`rk3_step`), collecting per
    step the bottom and top wall shear, the bulk velocity and dPdx into
    one (n_steps, 4) tensor on the state's device: the signals that tell
    a developed state.  Returns (state', stats)."""
    dtype, dev = state.U.dtype, state.U.device
    zeros = torch.zeros((grid.Nx, grid.Nz), dtype=dtype, device=dev)
    stats = torch.empty((n_steps, 4), dtype=dtype, device=dev)
    for i in range(n_steps):
        state = rk3_step(grid, state, zeros, zeros)
        U, V = state.U, state.V
        dudy_b = (U[:, 1, :] - U[:, 0, :]) / (grid.y[1] - grid.y[0])
        dudy_t = (U[:, -1, :] - U[:, -2, :]) / (grid.y[-1] - grid.y[-2])
        tau_b = torch.mean(grid.nu * dudy_b)
        tau_t = torch.mean(-U[:, -1, :] * V[:, -1, :] + grid.nu * dudy_t)
        stats[i] = torch.stack([tau_b, torch.abs(tau_t),
                                calculate_mean_u(grid, U), state.dPdx])
    return state, stats
