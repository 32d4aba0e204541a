"""The env step in the (y, x*z) kernel layout: plain torch versions and
the CUDA kernels that replace the Pallas kernels of
`pde_policylearning_tpu/envs/rk3_pallas.py`.

Layout: rows = wall-normal y, columns = x*Nz + z; B environments pack
env-major along the columns, (rows, B*C) with C = Nx*Nz, as
`rk3_pallas.batch_states` packs them.

Kernels (csrc/):
  * `substage_kernel` (rk3_staged.cu) <- `_substage_kernel` ("kernel A"):
    one RK3 substage up to its projection (RHS, RK update, BCs,
    divergence).
  * `solve_correct_kernel` (rk3_staged.cu) <- `_solve_correct_kernel`
    ("kernel B"): the bordered eigen-solve of the divergence, the pressure
    correction and the BCs.
  * `env_step_full_kb_kernel` (rk3_fullstep.cu) <- `_rk3_full_kernel`
    ("kernel D"): the whole env step, 3 x (A + B), the mass-flow
    correction and the wall pressures of the new state, in one C entry.
  * `boundary_fwd_kernel` / `boundary_solve_kernel` (boundary.cu) <-
    `_boundary_fwd_kernel` / `_boundary_solve_kernel`: the pressure RHS
    and its forward transform, then the 4-row bordered solve and the
    synthesis of (p1, p2).
  * `boundary_kernel` (boundary.cu, both phases in one call) <-
    `_boundary_kernel` ("kernel C"), the batched wall pressures.
  * `mass_flow_kernel` (rk3_staged.cu): the staged step's mass-flow
    correction, float64 in one fixed order (XLA glue in the JAX step).
  * `xz_forward_kernel` / `xz_inverse_kernel` (xz_transforms.cu): the x/z
    transforms every solve above runs, on their own.  On a power-of-two
    grid they are FFTs in shared memory, on any other the products with
    `T2` / `Ti2` through the hand-written GEMM (`xz_fft.fft_route`).  The
    plain versions are the products.
Between its two transforms each solve is one launch (csrc/common.cuh, "The
eigen-solve, one launch per solve": both eigenbasis products, the Schur
finish, the (0,0) mode and the refinement passes out of shared memory), of
one of two kernels by the host rule `tile_plan.eig_plan`; kernel A is one
launch on whole x-z planes in shared memory, its rows per block by
`tile_plan.substage_rows`.

`FULLSTEP` selects kernel D or the staged path for the env step and the
rollouts, exactly as `rk3_pallas.FULLSTEP` does (`PDE_RK3_FULLSTEP`, read
once at import; "1", the default, is kernel D).

Each `*_kernel` takes float32 CUDA tensors only and raises otherwise; the
dispatchers (`rk3_step_kb`, `env_step_full_kb`, `boundary_pressures_k`,
`boundary_pressures_kb`) send a CPU tensor to the plain version and a CUDA
tensor to the kernel.  The kernels' constants and scratch are built once
per grid (and per B) and cached on `grid.cache`; calls that share a grid
must run on one CUDA stream.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..native import cuda_build
from . import channel_flow as cf
from . import tile_plan, xz_fft
from .poisson_cuda import check_cuda_f32, _kron_mats, poisson_consts

# (c_cur, c_prev on F1): the RK3 coefficient triples [8/15],
# [1/4, 5/12], [1/4, 0, 3/4] as (current, first-stage) pairs
_RK3_STAGES = ((8 / 15, 0.0), (5 / 12, 1 / 4), (3 / 4, 1 / 4))

# kernel D (1, the default) or the staged 3 x (A + B) path (0) for the env
# step and the rollouts; scripts/drag_study.py pins 0
FULLSTEP = os.environ.get("PDE_RK3_FULLSTEP", "1") == "1"


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def to_k(a):
    """(Nx, R, Nz) -> (R, Nx*Nz)."""
    Nx, R, Nz = a.shape
    return a.permute(1, 0, 2).reshape(R, Nx * Nz)


def from_k(a, Nx, Nz):
    """(R, Nx*Nz) -> (Nx, R, Nz)."""
    return a.reshape(a.shape[0], Nx, Nz).permute(1, 0, 2)


def state_to_kstate(state):
    """ChannelState (x, y, z) -> ChannelState with kernel-layout leaves."""
    return state.replace(U=to_k(state.U).contiguous(),
                         V=to_k(state.V).contiguous(),
                         W=to_k(state.W).contiguous())


def kstate_to_state(grid, kstate):
    return kstate.replace(U=from_k(kstate.U, grid.Nx, grid.Nz).contiguous(),
                          V=from_k(kstate.V, grid.Nx, grid.Nz).contiguous(),
                          W=from_k(kstate.W, grid.Nx, grid.Nz).contiguous())


def _unpack(a, grid, B):
    """Packed (R, B*C) -> (B, Nx, R, Nz) view."""
    return a.reshape(a.shape[0], B, grid.Nx, grid.Nz).permute(1, 2, 0, 3)


def _pack(a):
    """(B, Nx, R, Nz) -> packed (R, B*C)."""
    B, Nx, R, Nz = a.shape
    return a.permute(2, 0, 1, 3).reshape(R, B * Nx * Nz)


def batch_states(states):
    """Batched ChannelState (leaves (B, Nx, R, Nz), dPdx and meanU0 (B,))
    -> packed kernel layout: leaves (R, B*C), columns b*C + x*Nz + z."""
    return states.replace(U=_pack(states.U).contiguous(),
                          V=_pack(states.V).contiguous(),
                          W=_pack(states.W).contiguous(),
                          dPdx=states.dPdx.reshape(-1),
                          meanU0=states.meanU0.reshape(-1))


def unbatch_states(grid, kstates, B: int):
    """Inverse of `batch_states`."""
    return kstates.replace(U=_unpack(kstates.U, grid, B).contiguous(),
                           V=_unpack(kstates.V, grid, B).contiguous(),
                           W=_unpack(kstates.W, grid, B).contiguous())


def _spec(a):
    """(B, Nx, R, Nz) -> per-env kernel layout (B, R, C)."""
    B, Nx, R, Nz = a.shape
    return a.permute(0, 2, 1, 3).reshape(B, R, Nx * Nz)


# ---------------------------------------------------------------------------
# constants (built once per grid)
# ---------------------------------------------------------------------------

def _row_consts(grid):
    """y-metric vectors dyf (Ny-1,), dyg (Ny,), dym (Ny-2,)."""
    y, ym, yg = grid.y, grid.ym, grid.yg
    return y[1:] - y[:-1], yg[1:] - yg[:-1], ym[1:] - ym[:-1]


def _kron_mats2(grid):
    """T2 = [TR | TI] (C, 2F) and Ti2 = [TiR ; -TiI] (2F, C) in the grid's
    dtype and device: the forward transform and the real-part inverse
    synthesis are one product each.  Float32 grids round each factor to
    float32 first, as the reference kernels' constants are."""
    TR, TI, TiR, TiI = _kron_mats(grid.Nx, grid.Nz)
    if grid.dtype == torch.float32:
        TR, TI, TiR, TiI = (a.astype(np.float32) for a in (TR, TI, TiR, TiI))
    return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(grid.device,
                                                             grid.dtype)
                 for a in (np.concatenate([TR, TI], axis=1),
                           np.concatenate([TiR, -TiI], axis=0)))


def _solve_consts(grid):
    """Bordered-solve constants in the re|im layout: every (*, F)
    per-wavenumber array doubled to (*, 2F).  Returns (kk2, denom1_2, g2,
    ss2, dlm, dl, du, dd0h)."""
    Nzr = grid.Nz // 2 + 1
    F = grid.Nx * Nzr
    n = grid.Ny - 1
    kk = (grid.kxx[:, None] + grid.kzz[None, :Nzr]).reshape(1, F)
    denom1 = grid.eig_lam1[:, None] + kk
    denom1 = torch.where(denom1.abs() < 1e-12, torch.ones_like(denom1),
                         denom1)

    def double(a):
        return torch.cat([a, a], 1).contiguous()

    zero = grid.DD_lower.new_zeros(1)
    dl = torch.cat([zero, grid.DD_lower])
    du = torch.cat([grid.DD_upper, zero])
    dlm = grid.DD_lower[n - 2]
    dd0h = 0.5 * grid.DD_diag[0]
    return (double(kk)[0], double(denom1), double(grid.schur_g),
            double(grid.schur_s.reshape(1, F))[0], dlm, dl, du, dd0h)


def _boundary_consts(grid):
    """(A13, g3_2): rows [0, 1, m-1] of the bordered eigenbasis and of the
    Schur coupling, the rows the wall-pressure synthesis needs."""
    m = grid.Ny - 2
    rows = [0, 1, m - 1]
    g3 = grid.schur_g[rows]
    return grid.eig_A1[rows].contiguous(), torch.cat([g3, g3], 1).contiguous()


@dataclass
class SolveConsts:
    grid: object           # T2, Ti2 are built from it at first use
    A1: torch.Tensor
    B1: torch.Tensor
    denom1: torch.Tensor   # (m, 2F)
    g: torch.Tensor        # (m, 2F)
    ss: torch.Tensor       # (2F,)
    kk: torch.Tensor       # (2F,)
    dd: torch.Tensor       # (n,)
    dl: torch.Tensor       # (n,), row 0 zero
    du: torch.Tensor       # (n,), row n-1 zero
    dlm: torch.Tensor      # 0-d: DD[m, m-1]
    dd0h: torch.Tensor     # 0-d: DD[0, 0] / 2
    A13: torch.Tensor      # (3, m)
    g3: torch.Tensor       # (3, 2F)
    Pinv00: torch.Tensor
    s00: torch.Tensor
    dyf: torch.Tensor
    dyg: torch.Tensor
    dym: torch.Tensor
    trapw: torch.Tensor

    @cached_property
    def _kron(self):
        return _kron_mats2(self.grid)

    @property
    def T2(self) -> torch.Tensor:
        """(C, 2F) forward DFT matrix: the plain versions' transform, and
        the kernels' on a grid that takes no FFT."""
        return self._kron[0]

    @property
    def Ti2(self) -> torch.Tensor:
        """(2F, C) real-part inverse synthesis."""
        return self._kron[1]


def solve_consts(grid) -> SolveConsts:
    """All constants of the kernel-layout step, once per grid."""
    key = "solve"
    if key not in grid.cache:
        kk2, denom1, g2, ss2, dlm, dl, du, dd0h = _solve_consts(grid)
        A13, g3 = _boundary_consts(grid)
        dyf, dyg, dym = _row_consts(grid)
        grid.cache[key] = SolveConsts(
            grid=grid, A1=grid.eig_A1.contiguous(),
            B1=grid.eig_B1.contiguous(), denom1=denom1, g=g2, ss=ss2, kk=kk2,
            dd=grid.DD_diag, dl=dl, du=du, dlm=dlm, dd0h=dd0h, A13=A13,
            g3=g3, Pinv00=grid.Pinv00_eq.contiguous(), s00=grid.s00,
            dyf=dyf.contiguous(), dyg=dyg.contiguous(), dym=dym.contiguous(),
            trapw=cf.trap_weights(grid).contiguous())
    return grid.cache[key]


# ---------------------------------------------------------------------------
# metrics on kernel-layout state (plain torch glue, no host sync)
# ---------------------------------------------------------------------------

def divergence_k(grid, U, V, W):
    """channel_flow.divergence on kernel-layout fields -> (Ny-1, C)."""
    Nx, Nz = grid.Nx, grid.Nz
    return to_k(cf.divergence(grid, from_k(U, Nx, Nz), from_k(V, Nx, Nz),
                              from_k(W, Nx, Nz)))


def mean_u_k(grid, U):
    """channel_flow.calculate_mean_u on a kernel-layout U."""
    return cf.bulk_velocity(grid, U[1:-1].mean(dim=1))


def step_metrics_k(grid, state, p2):
    """channel_flow.step_metrics with kernel-layout state; p2 (Nx, Nz)."""
    U, V, W = state.U, state.V, state.W
    dudy = (U[-1] - U[-2]) / (grid.y[-1] - grid.y[-2])
    shear = torch.abs(torch.mean(-U[-1] * V[-1] + grid.nu * dudy))
    div = divergence_k(grid, U, V, W)
    return {
        "drag_reduction/1_shear_stress": shear,
        "drag_reduction/2_1_mass_flow": mean_u_k(grid, U),
        "drag_reduction/2_2_v_velocity": torch.mean(torch.abs(V)),
        "drag_reduction/2_3_w_velocity": torch.mean(torch.abs(W)),
        "drag_reduction/3_1_pressure_mean": torch.mean(p2),
        "drag_reduction/3_2_dPdx_finite_difference":
            cf.dpdx_finite_difference(grid, p2),
        "drag_reduction/3_3_dPdx_reverse_cal": state.dPdx,
        "drag_reduction/4_1_-|divergence|":
            torch.clamp(-torch.abs(torch.sum(div)), min=-100.0),
        "drag_reduction/4_4_speed_norm":
            torch.linalg.vector_norm(U) + torch.linalg.vector_norm(V)
            + torch.linalg.vector_norm(W),
    }


# ---------------------------------------------------------------------------
# plain versions (any float dtype; the references of the kernels)
# ---------------------------------------------------------------------------

def _bordered_solve_plain(c: SolveConsts, r):
    """(DD + kk I)^-1 r for r (B, n, 2F): the leading m = n-1 block in its
    own eigenbasis, the last row by Schur, and the (0,0) columns (0 = re,
    F = im) through the equilibrated regularized solve."""
    n = r.shape[1]
    m = n - 1
    F = r.shape[2] // 2
    y = c.A1 @ ((c.B1 @ r[:, :m]) / c.denom1)
    P_last = (r[:, m:] - c.dlm * y[:, m - 1:m]) / c.ss
    P = torch.cat([y - c.g * P_last, P_last], 1)
    s = c.s00[:, None]
    p00 = s * (c.Pinv00 @ (s * r[:, :, [0, F]]))              # (B, n, 2)
    P[:, :, 0] = p00[..., 0]
    P[:, :, F] = p00[..., 1]
    return P


def _refine_residual_plain(c: SolveConsts, t, P):
    """t - (DD + kk I) P - the (0,0,0) regularization term."""
    zero = torch.zeros_like(P[:, :1])
    app = (c.dd[:, None] + c.kk) * P
    app = app + c.dl[:, None] * torch.cat([zero, P[:, :-1]], 1)
    app = app + c.du[:, None] * torch.cat([P[:, 1:], zero], 1)
    r = t - app
    F = P.shape[2] // 2
    r[:, 0, [0, F]] -= c.dd0h * P[:, 0, [0, F]]
    return r


def _poisson_bordered_plain(grid, c: SolveConsts, Y):
    """Kernel D's projection solve of Y (B, Nx, n, Nz) -> p, same layout."""
    t = _spec(Y) @ c.T2                                       # (B, n, 2F)
    P = _bordered_solve_plain(c, t)
    for _ in range(grid.refine_steps):
        P = P + _bordered_solve_plain(c, _refine_residual_plain(c, t, P))
    p = P @ c.Ti2                                             # (B, n, C)
    B, n = p.shape[:2]
    return p.reshape(B, n, grid.Nx, grid.Nz).permute(0, 2, 1, 3)


def boundary_fwd_plain(grid, U, V, W, dPdx):
    """Pressure RHS of packed state (rows, B*C) and its forward transform
    -> t (B, n, 2F)."""
    B = dPdx.shape[0]
    c = solve_consts(grid)
    Fu, Fv, Fw = cf.compute_rhs(grid, _unpack(U, grid, B),
                                _unpack(V, grid, B), _unpack(W, grid, B),
                                dPdx.reshape(B, 1, 1, 1))
    return _spec(cf.divergence(grid, Fu, Fv, Fw)) @ c.T2


def boundary_solve_plain(grid, t):
    """4-row bordered solve of t (B, n, 2F) and the synthesis of the wall
    rows -> p (2, B*C) = (p1; p2)."""
    c = solve_consts(grid)
    B, n, F2 = t.shape
    m = n - 1
    F = F2 // 2
    u = (c.B1 @ t[:, :m]) / c.denom1
    y3 = c.A13 @ u                                            # (B, 3, 2F)
    P_last = (t[:, m:] - c.dlm * y3[:, 2:3]) / c.ss
    P4 = torch.cat([y3 - c.g3 * P_last, P_last], 1)      # rows 0,1,n-2,n-1
    s = c.s00[:, None]
    full00 = s * (c.Pinv00 @ (s * t[:, :, 0:1]))              # (B, n, 1)
    P4[:, :, 0] = full00[:, [0, 1, n - 2, n - 1], 0]
    P4[:, :, F] = 0.0                     # the imaginary (0,0) column
    P4 = P4 @ c.Ti2                                           # (B, 4, C)
    p1 = -0.5 * (P4[:, 0] + P4[:, 1])
    p2 = -0.5 * (P4[:, 3] + P4[:, 2])
    return torch.stack([p1, p2]).reshape(2, -1)


def _mass_flow(grid, U, meanU0, dPdx):
    """(d_new / 2, new dPdx) of the mass-flow correction for U (B, Nx, R,
    Nz), both in U's dtype.

    d_new = 2 (meanU0 - meanU_now) is a small difference amplified by 1/dt:
    one float32 ulp of the bulk velocity moves dPdx by several percent.  So
    the row means, the trapezoid and d_new are taken in float64, in one
    fixed term order, here and in the kernel alike."""
    profile = U[..., 1:-1, :].double().mean(dim=(-3, -1))       # (B, Ny-1)
    z = profile.new_zeros(profile.shape[:-1] + (1,))
    vals = torch.cat([z, profile, z], -1)
    w = cf.trap_weights(grid).double()
    mean_now = ((vals[..., 1:] + vals[..., :-1]) * 0.5 * w).sum(-1) * 0.5
    d_new = 2.0 * (meanU0.double() - mean_now)
    return ((0.5 * d_new).to(U.dtype),
            (0.5 * (dPdx.double() + d_new / grid.dt)).to(U.dtype))


def substage_plain(grid, B, U, V, W, U0, V0, W0, F1, op1, op2, dPdx, c_cur,
                   c_prev, out_f):
    """Kernel A's function in plain torch, for B packed envs: the momentum
    RHS of (U, V, W), the RK update from the step's initial fields
    (U0, V0, W0) with dt*c_cur on that RHS and, when c_prev, dt*c_prev on
    the first stage's RHS F1 = (F1u, F1v, F1w), the wall BCs, and the cell
    divergence of the result.

    U/W: (Ny+1, B*C), V: (Ny, B*C), op1/op2: (1, B*C), dPdx: (B,).
    Returns packed (Un, Vn, Wn, div (Ny-1, B*C), Fu, Fv, Fw); the RHS
    fields are None unless out_f."""
    dt = grid.dt

    def unpack(a):
        return _unpack(a, grid, B)

    Fu, Fv, Fw = cf.compute_rhs(grid, unpack(U), unpack(V), unpack(W),
                                dPdx.reshape(B, 1, 1, 1))
    Un = unpack(U0) + dt * c_cur * Fu
    Vn = unpack(V0) + dt * c_cur * Fv
    Wn = unpack(W0) + dt * c_cur * Fw
    if c_prev:
        F1u, F1v, F1w = (unpack(a) for a in F1)
        Un = Un + dt * c_prev * F1u
        Vn = Vn + dt * c_prev * F1v
        Wn = Wn + dt * c_prev * F1w
    Un, Vn, Wn = cf.apply_boundary_condition(
        Un, Vn, Wn, op1.reshape(B, grid.Nx, grid.Nz),
        op2.reshape(B, grid.Nx, grid.Nz))
    div = cf.divergence(grid, Un, Vn, Wn)
    F = tuple(map(_pack, (Fu, Fv, Fw))) if out_f else (None, None, None)
    return (*map(_pack, (Un, Vn, Wn, div)), *F)


def solve_correct_plain(grid, B, div, U, V, W, op1, op2):
    """Kernel B's function in plain torch, for B packed envs: the bordered
    eigen-solve of div (Ny-1, B*C) with `grid.refine_steps` refinement
    passes, U, V, W -= grad p on the interior rows, then the wall BCs.
    Returns packed (U, V, W)."""
    p = _poisson_bordered_plain(grid, solve_consts(grid),
                                _unpack(div, grid, B))
    U, V, W = cf.pressure_correction(grid, _unpack(U, grid, B),
                                     _unpack(V, grid, B),
                                     _unpack(W, grid, B), p)
    U, V, W = cf.apply_boundary_condition(
        U, V, W, op1.reshape(B, grid.Nx, grid.Nz),
        op2.reshape(B, grid.Nx, grid.Nz))
    return _pack(U), _pack(V), _pack(W)


def mass_flow_plain(grid, B, U, meanU0, dPdx):
    """The mass-flow correction of packed U (interior rows + d_new / 2 per
    env, ghost rows untouched) -> (U', dPdx')."""
    half_d, dPdx_new = _mass_flow(grid, _unpack(U, grid, B), meanU0, dPdx)
    C = grid.Nx * grid.Nz
    U = torch.cat([U[:1], U[1:-1] + half_d.repeat_interleave(C)[None],
                   U[-1:]])
    return U, dPdx_new


def _rk3_step(substage, solve_correct, mass_flow, grid, B, U, V, W, dPdx,
              meanU0, op1, op2):
    """Three substages of (substage, solve_correct), then mass_flow: the
    one body of the staged step and of kernel D's plain version."""
    U0, V0, W0 = U, V, W
    F1 = None
    for i, (c_cur, c_prev) in enumerate(_RK3_STAGES):
        Un, Vn, Wn, div, *F = substage(grid, B, U, V, W, U0, V0, W0, F1,
                                       op1, op2, dPdx, c_cur, c_prev, i == 0)
        if i == 0:
            F1 = F
        U, V, W = solve_correct(grid, B, div, Un, Vn, Wn, op1, op2)
    U, dPdx = mass_flow(grid, B, U, meanU0, dPdx)
    return U, V, W, dPdx


def rk3_step_kb_plain(grid, B, U, V, W, dPdx, meanU0, op1, op2):
    """The staged RK3 step in plain torch for B packed envs: 3 x (kernel
    A, kernel B), then the mass-flow correction.

    U/W: (Ny+1, B*C), V: (Ny, B*C), dPdx/meanU0: (B,), op1/op2: (1, B*C).
    Returns (U, V, W, dPdx' (B,))."""
    return _rk3_step(substage_plain, solve_correct_plain, mass_flow_plain,
                     grid, B, U, V, W, dPdx, meanU0, op1, op2)


def env_step_full_kb_plain(grid, B, U, V, W, dPdx, meanU0, op1, op2):
    """Kernel D's function in plain torch: the staged step
    (`rk3_step_kb_plain`), then the wall pressures of the new state.

    Same arguments as `rk3_step_kb_plain`.  Returns
    (U, V, W, dPdx' (B,), p (2, B*C))."""
    U, V, W, dPdx = rk3_step_kb_plain(grid, B, U, V, W, dPdx, meanU0, op1,
                                      op2)
    p = boundary_solve_plain(grid, boundary_fwd_plain(grid, U, V, W, dPdx))
    return U, V, W, dPdx, p


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_SPLIT_SLICES = 8   # kMaxSplit in csrc/common.cuh


@dataclass
class KernelArgs:
    """The C structs a kernel call passes, and the tensors they point at
    (held here so the pointers stay valid)."""
    dims: cuda_build.Dims
    ops: cuda_build.Ops
    work: cuda_build.Work
    tensors: dict

    @property
    def dims_ref(self):
        return ctypes.byref(self.dims)

    @property
    def ops_ref(self):
        return ctypes.byref(self.ops)

    @property
    def work_ref(self):
        return ctypes.byref(self.work)


def kernel_args(grid, B: int, fft: bool | None = None) -> KernelArgs:
    """Constants and the scratch workspace for B packed envs, built once
    per (grid, B) with `torch.empty`; the kernels allocate nothing.  The
    x/z transforms' route is `xz_fft.fft_route` of the grid: the twiddle
    tables (float64 rounded once to float32) go to the card for a grid
    that takes the FFTs, the DFT matrices for any other, and the kernels
    run the route whose constants they find.  `fft=False` builds (and
    caches, in place of what was cached) the constants of the DFT products
    for a grid that would take the FFTs, so that a measurement can time
    both routes on one grid."""
    key = ("kernel_args", B)
    if fft is None:
        if key in grid.cache:
            return grid.cache[key]
        fft = xz_fft.fft_route(grid.Nx, grid.Nz)
    elif fft and not xz_fft.fft_route(grid.Nx, grid.Nz):
        raise ValueError(f"a {grid.Nx} x {grid.Nz} plane cannot take the "
                         "FFT kernels (xz_fft.fft_route)")
    if grid.device.type != "cuda" or grid.dtype != torch.float32:
        raise ValueError("the CUDA kernels need a float32 grid on a CUDA "
                         f"device, got {grid.dtype} on {grid.device}")
    c = solve_consts(grid)
    pc = poisson_consts(grid)
    Nx, Ny, Nz = grid.Nx, grid.Ny, grid.Nz
    C, n = Nx * Nz, Ny - 1
    F2 = 2 * Nx * (Nz // 2 + 1)
    # the host rules of the shared-memory kernels (tile_plan): the
    # eigen-solve's plan for the full and for the bordered basis (raises
    # where neither kernel's tiles fit a block: Ny > 3257 at most), and
    # kernel A's rows per block
    sms = torch.cuda.get_device_properties(grid.device).multi_processor_count
    plans = [tile_plan.eig_plan(n, K, B, F2, sms) for K in (n, n - 1)]

    steps = dict(dx=grid.dx, dz=grid.dz, dx2=grid.dx ** 2, dz2=grid.dz ** 2)
    dims = cuda_build.Dims(
        B=B, Nx=Nx, Ny=Ny, Nz=Nz, refine_steps=grid.refine_steps,
        nu=grid.nu, dt=grid.dt, dlm=float(c.dlm), dd0h=float(c.dd0h),
        **steps, **{"r" + k: float(tile_plan.reciprocals(v))
                    for k, v in steps.items()},
        sub_rows=tile_plan.substage_rows(B, Ny, C, sms),
        eig=(cuda_build.EigPlan * 2)(*(
            cuda_build.EigPlan(**dataclasses.asdict(p)) for p in plans)))

    def table(N):
        return torch.as_tensor(xz_fft.twiddles(N).astype(np.float32),
                               device=grid.device)

    xz = (dict(twx=table(Nx), twz=table(Nz)) if fft
          else dict(T2=c.T2, Ti2=c.Ti2))

    ops_t = {k: v.contiguous() for k, v in dict(
        dyf=c.dyf, dyg=c.dyg, dym=c.dym, trapw=c.trapw, **xz,
        **{"r" + k: torch.as_tensor(tile_plan.reciprocals(getattr(c, k)),
                                    device=grid.device)
           for k in ("dyf", "dyg", "dym")},
        B1=c.B1, denom1=c.denom1, g=c.g, ss=c.ss, kk=c.kk,
        A13=c.A13, g3=c.g3, denom=pc["denom"],
        Pinv00=tile_plan.padded_rows(c.Pinv00),
        s00=c.s00, dd=c.dd, dl=c.dl, du=c.du,
        nbr=tile_plan.plane_neighbours(Nx, Nz).to(grid.device),
        **{k + "T": tile_plan.padded_basis(v) for k, v in dict(
            A1=c.A1, B1=c.B1, A=pc["A"], Bf=pc["Bf"]).items()}).items()}
    ops = cuda_build.Ops(**{k: v.data_ptr() for k, v in ops_t.items()})

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=grid.device)

    work_t = dict(
        Fu=empty(Ny + 1, B * C), Fv=empty(Ny, B * C), Fw=empty(Ny + 1, B * C),
        F1u=empty(Ny + 1, B * C), F1v=empty(Ny, B * C),
        F1w=empty(Ny + 1, B * C),
        Un=empty(Ny + 1, B * C), Vn=empty(Ny, B * C), Wn=empty(Ny + 1, B * C),
        Y=empty(n, B * C), t=empty(B, n, F2), u=empty(B, n, F2),
        y=empty(B, n, F2), P=empty(B, n, F2),
        p=empty(n, B * C), p00=empty(B, n, 2), q=empty(B, 2, F2),
        dnew=empty(B),
        # split-K partial products of the solve GEMMs (csrc/common.cuh)
        part=empty(_SPLIT_SLICES * n * max(F2, C)))
    work = cuda_build.Work(**{k: v.data_ptr() for k, v in work_t.items()},
                           part_cap=work_t["part"].numel())
    args = KernelArgs(dims, ops, work, {**ops_t, **work_t})
    grid.cache[key] = args
    return args


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(a):
    return None if a is None else a.data_ptr()


def _check_packed(grid, B, **fields):
    """check_cuda_f32 on packed fields, each shape known from its name:
    U*, W*, F1u, F1w (Ny+1, B*C); V*, F1v (Ny, B*C); div (Ny-1, B*C);
    op1, op2 (1, B*C); dPdx, meanU0 (B,)."""
    Ny, BC = grid.Ny, B * grid.Nx * grid.Nz
    rows = {"U": Ny + 1, "W": Ny + 1, "V": Ny, "d": Ny - 1, "o": 1}
    for name, a in fields.items():
        key = name[-1].upper() if name.startswith("F1") else name[0]
        shape = (B,) if name in ("dPdx", "meanU0") else (rows[key], BC)
        check_cuda_f32(name, a, shape)


def substage_kernel(grid, B, U, V, W, U0, V0, W0, F1, op1, op2, dPdx, c_cur,
                    c_prev, out_f):
    """Kernel A on the card (csrc/rk3_staged.cu); same contract as
    `substage_plain`, float32 CUDA tensors only."""
    F1u, F1v, F1w = F1 if c_prev else (None, None, None)
    _check_packed(grid, B, U=U, V=V, W=W, U0=U0, V0=V0, W0=W0, op1=op1,
                  op2=op2, dPdx=dPdx,
                  **(dict(F1u=F1u, F1v=F1v, F1w=F1w) if c_prev else {}))
    args = kernel_args(grid, B)
    Un, Vn, Wn = torch.empty_like(U), torch.empty_like(V), torch.empty_like(W)
    div = torch.empty((grid.Ny - 1, U.shape[1]), dtype=torch.float32,
                      device=U.device)
    F = ((torch.empty_like(U), torch.empty_like(V), torch.empty_like(W))
         if out_f else (None, None, None))
    err = cuda_build.load().pde_rk3_substage(
        args.dims_ref, args.ops_ref, args.work_ref, U.data_ptr(),
        V.data_ptr(), W.data_ptr(), U0.data_ptr(), V0.data_ptr(),
        W0.data_ptr(), _ptr(F1u), _ptr(F1v), _ptr(F1w), op1.data_ptr(),
        op2.data_ptr(), dPdx.data_ptr(), grid.dt * c_cur, grid.dt * c_prev,
        int(out_f), Un.data_ptr(), Vn.data_ptr(), Wn.data_ptr(),
        div.data_ptr(), *map(_ptr, F), _stream(U))
    cuda_build.check(err, "pde_rk3_substage")
    substage_kernel.launches += 1
    return Un, Vn, Wn, div, *F


substage_kernel.launches = 0


def solve_correct_kernel(grid, B, div, U, V, W, op1, op2):
    """Kernel B on the card (csrc/rk3_staged.cu); same contract as
    `solve_correct_plain`, float32 CUDA tensors only."""
    _check_packed(grid, B, div=div, U=U, V=V, W=W, op1=op1, op2=op2)
    args = kernel_args(grid, B)
    Uo, Vo, Wo = torch.empty_like(U), torch.empty_like(V), torch.empty_like(W)
    err = cuda_build.load().pde_rk3_solve_correct(
        args.dims_ref, args.ops_ref, args.work_ref, div.data_ptr(),
        U.data_ptr(), V.data_ptr(), W.data_ptr(), op1.data_ptr(),
        op2.data_ptr(), Uo.data_ptr(), Vo.data_ptr(), Wo.data_ptr(),
        _stream(U))
    cuda_build.check(err, "pde_rk3_solve_correct")
    solve_correct_kernel.launches += 1
    return Uo, Vo, Wo


solve_correct_kernel.launches = 0


def mass_flow_kernel(grid, B, U, meanU0, dPdx):
    """The mass-flow correction on the card (csrc/rk3_staged.cu): same
    contract as `mass_flow_plain`, but U is updated in place (the staged
    step hands it the fresh output of kernel B)."""
    _check_packed(grid, B, U=U, meanU0=meanU0, dPdx=dPdx)
    args = kernel_args(grid, B)
    dPo = torch.empty_like(dPdx)
    err = cuda_build.load().pde_rk3_massflow(
        args.dims_ref, args.ops_ref, args.work_ref, U.data_ptr(),
        meanU0.data_ptr(), dPdx.data_ptr(), dPo.data_ptr(), _stream(U))
    cuda_build.check(err, "pde_rk3_massflow")
    mass_flow_kernel.launches += 1
    return U, dPo


mass_flow_kernel.launches = 0


def env_step_full_kb_kernel(grid, B, U, V, W, dPdx, meanU0, op1, op2):
    """Kernel D on the card (csrc/rk3_fullstep.cu); same contract as
    `env_step_full_kb_plain`, float32 CUDA tensors only."""
    _check_packed(grid, B, U=U, V=V, W=W, dPdx=dPdx, meanU0=meanU0, op1=op1,
                  op2=op2)
    args = kernel_args(grid, B)
    Uo, Vo, Wo = torch.empty_like(U), torch.empty_like(V), torch.empty_like(W)
    dPo = torch.empty_like(dPdx)
    p = torch.empty((2, U.shape[1]), dtype=torch.float32, device=U.device)
    err = cuda_build.load().pde_rk3_fullstep(
        args.dims_ref, args.ops_ref, args.work_ref,
        U.data_ptr(), V.data_ptr(), W.data_ptr(), op1.data_ptr(),
        op2.data_ptr(), dPdx.data_ptr(), meanU0.data_ptr(),
        Uo.data_ptr(), Vo.data_ptr(), Wo.data_ptr(), dPo.data_ptr(),
        p.data_ptr(), _stream(U))
    cuda_build.check(err, "pde_rk3_fullstep")
    env_step_full_kb_kernel.launches += 1
    return Uo, Vo, Wo, dPo, p


env_step_full_kb_kernel.launches = 0


def xz_forward_plain(grid, B, Y):
    """The forward x/z transform of the rows of a packed field Y
    (rows, B*C) -> per-env spectra (B, rows, 2F): the product with `T2`."""
    rows = Y.shape[0]
    return Y.reshape(rows, B, -1).permute(1, 0, 2) @ solve_consts(grid).T2


def xz_inverse_plain(grid, P):
    """The real-part inverse synthesis of spectra P (B, rows, 2F) -> packed
    rows (rows, B*C): the product with `Ti2`."""
    B, rows, _ = P.shape
    return (P @ solve_consts(grid).Ti2).permute(1, 0, 2).reshape(rows, -1)


def xz_forward_kernel(grid, B, Y):
    """`xz_forward_plain` on the card (csrc/xz_transforms.cu), float32 CUDA
    only: FFTs in shared memory or DFT products, by `xz_fft.fft_route`."""
    rows = Y.shape[0]
    check_cuda_f32("Y", Y, (rows, B * grid.Nx * grid.Nz))
    args = kernel_args(grid, B)
    t = torch.empty((B, rows, 2 * grid.Nx * (grid.Nz // 2 + 1)),
                    dtype=torch.float32, device=Y.device)
    err = cuda_build.load().pde_xz_forward(
        args.dims_ref, args.ops_ref, args.work_ref, Y.data_ptr(), rows,
        t.data_ptr(), _stream(Y))
    cuda_build.check(err, "pde_xz_forward")
    xz_forward_kernel.launches += 1
    return t


xz_forward_kernel.launches = 0


def xz_inverse_kernel(grid, P):
    """`xz_inverse_plain` on the card (csrc/xz_transforms.cu), float32 CUDA
    only."""
    B, rows = P.shape[:2]
    check_cuda_f32("P", P, (B, rows, 2 * grid.Nx * (grid.Nz // 2 + 1)))
    args = kernel_args(grid, B)
    out = torch.empty((rows, B * grid.Nx * grid.Nz), dtype=torch.float32,
                      device=P.device)
    err = cuda_build.load().pde_xz_inverse(
        args.dims_ref, args.ops_ref, args.work_ref, P.data_ptr(), rows,
        out.data_ptr(), _stream(P))
    cuda_build.check(err, "pde_xz_inverse")
    xz_inverse_kernel.launches += 1
    return out


xz_inverse_kernel.launches = 0


_FWD, _SOLVE = 1, 2


def boundary_fwd_kernel(grid, U, V, W, dPdx):
    """Pressure RHS + forward transform on the card (csrc/boundary.cu,
    first phase) -> t (B, n, 2F)."""
    B = dPdx.shape[0]
    _check_packed(grid, B, U=U, V=V, W=W, dPdx=dPdx)
    args = kernel_args(grid, B)
    t = torch.empty((B, grid.Ny - 1, 2 * grid.Nx * (grid.Nz // 2 + 1)),
                    dtype=torch.float32, device=U.device)
    err = cuda_build.load().pde_boundary_pressures(
        args.dims_ref, args.ops_ref, args.work_ref, _FWD, U.data_ptr(),
        V.data_ptr(), W.data_ptr(), dPdx.data_ptr(), t.data_ptr(), None,
        _stream(U))
    cuda_build.check(err, "pde_boundary_pressures (forward)")
    boundary_fwd_kernel.launches += 1
    return t


boundary_fwd_kernel.launches = 0


def boundary_solve_kernel(grid, t):
    """4-row bordered solve + synthesis on the card (csrc/boundary.cu,
    second phase) -> p (2, B*C)."""
    B = t.shape[0]
    check_cuda_f32("t", t, (B, grid.Ny - 1,
                             2 * grid.Nx * (grid.Nz // 2 + 1)))
    args = kernel_args(grid, B)
    p = torch.empty((2, B * grid.Nx * grid.Nz), dtype=torch.float32,
                    device=t.device)
    err = cuda_build.load().pde_boundary_pressures(
        args.dims_ref, args.ops_ref, args.work_ref, _SOLVE, None, None, None,
        None, t.data_ptr(), p.data_ptr(), _stream(t))
    cuda_build.check(err, "pde_boundary_pressures (solve)")
    boundary_solve_kernel.launches += 1
    return p


boundary_solve_kernel.launches = 0


def boundary_kernel(grid, U, V, W, dPdx):
    """Kernel C on the card: both phases of csrc/boundary.cu in one call
    (the pressure RHS and its transform into the cached scratch, then the
    4-row solve and synthesis) -> p (2, B*C) = (p1; p2).  The TPU split
    this kernel in two only for its 16 MB scoped-VMEM budget
    (rk3_pallas.py:356-360); the plain version is the pair's."""
    B = dPdx.shape[0]
    _check_packed(grid, B, U=U, V=V, W=W, dPdx=dPdx)
    args = kernel_args(grid, B)
    p = torch.empty((2, U.shape[1]), dtype=torch.float32, device=U.device)
    err = cuda_build.load().pde_boundary_pressures(
        args.dims_ref, args.ops_ref, args.work_ref, _FWD | _SOLVE,
        U.data_ptr(), V.data_ptr(), W.data_ptr(), dPdx.data_ptr(),
        args.tensors["t"].data_ptr(), p.data_ptr(), _stream(U))
    cuda_build.check(err, "pde_boundary_pressures (both phases)")
    boundary_kernel.launches += 1
    return p


boundary_kernel.launches = 0


# ---------------------------------------------------------------------------
# dispatchers: CPU tensor -> plain, CUDA tensor -> kernel
# ---------------------------------------------------------------------------

def rk3_step_kb(grid, B, U, V, W, dPdx, meanU0, op1, op2):
    """The staged RK3 step for B packed envs (see `rk3_step_kb_plain`): on
    the card 3 x (kernel A, kernel B) and the mass-flow kernels."""
    if U.is_cuda:
        return _rk3_step(substage_kernel, solve_correct_kernel,
                         mass_flow_kernel, grid, B, U, V, W, dPdx, meanU0,
                         op1, op2)
    return rk3_step_kb_plain(grid, B, U, V, W, dPdx, meanU0, op1, op2)


def rk3_step_k(grid, U, V, W, dPdx, meanU0, op1, op2):
    """The staged RK3 step of one env in kernel layout; dPdx and meanU0
    of any single-element shape, op1/op2 (1, C).  Returns
    (U, V, W, dPdx') with dPdx' in dPdx's shape."""
    U, V, W, dP = rk3_step_kb(grid, 1, U, V, W, dPdx.reshape(1),
                              meanU0.reshape(1), op1, op2)
    return U, V, W, dP.reshape(dPdx.shape)


def env_step_full_kb(grid, B, U, V, W, dPdx, meanU0, op1, op2):
    """One env step for B packed envs (see `env_step_full_kb_plain`)."""
    step = env_step_full_kb_kernel if U.is_cuda else env_step_full_kb_plain
    return step(grid, B, U, V, W, dPdx, meanU0, op1, op2)


class _BoundaryPressures(torch.autograd.Function):
    """The wall-pressure pair of packed state -> p (2, B*C).  The forward
    runs the kernel pair on a CUDA tensor and the plain version on a CPU
    tensor; the backward is the VJP of the plain version, recomputed (as
    `rk3_pallas.boundary_pressures_fused`'s rule delegates to XLA).  The
    grid's constants get no gradient."""

    @staticmethod
    def forward(ctx, grid, U, V, W, dPdx):
        ctx.grid = grid
        ctx.save_for_backward(U, V, W, dPdx)
        if U.is_cuda:
            return boundary_solve_kernel(grid, boundary_fwd_kernel(
                grid, U, V, W, dPdx))
        return boundary_solve_plain(grid, boundary_fwd_plain(grid, U, V, W,
                                                             dPdx))

    @staticmethod
    def backward(ctx, g):
        inputs = [a.detach().requires_grad_() for a in ctx.saved_tensors]
        with torch.enable_grad():
            p = boundary_solve_plain(ctx.grid,
                                     boundary_fwd_plain(ctx.grid, *inputs))
        return (None, *torch.autograd.grad(p, inputs, g, allow_unused=True))


def boundary_pressures_k(grid, U, V, W, dPdx):
    """(p1, p2) rows, each (1, B*C), of packed kernel-layout state;
    dPdx (B,).  Differentiable (see `_BoundaryPressures`)."""
    p = _BoundaryPressures.apply(grid, U, V, W, dPdx)
    return p[0:1], p[1:2]


def boundary_pressures_kb(grid, B, U, V, W, dPdx):
    """(p1, p2) rows, each (1, B*C), of B packed envs: kernel C on the
    card, the plain pair on the CPU (the staged batched rollout's
    observation; not differentiable)."""
    if U.is_cuda:
        p = boundary_kernel(grid, U, V, W, dPdx)
    else:
        p = boundary_solve_plain(grid, boundary_fwd_plain(grid, U, V, W,
                                                          dPdx))
    return p[0:1], p[1:2]


def _action_rows(grid, kstate, opV1, opV2):
    """Actuation planes ((Nx, Nz) or (C,), any dtype) -> (1, C) rows in
    the state's dtype."""
    C = grid.Nx * grid.Nz
    dtype = kstate.U.dtype
    return (opV1.reshape(1, C).to(dtype).contiguous(),
            opV2.reshape(1, C).to(dtype).contiguous())


def env_step_full_k(grid, kstate, opV1, opV2):
    """Single-env step through kernel D on a kernel-layout ChannelState:
    advance, wall pressures and scoreboard.  opV1/opV2 arrive (Nx, Nz) or
    (C,) from the policies.  Returns (kstate', p2 (Nx, Nz), info)."""
    op1, op2 = _action_rows(grid, kstate, opV1, opV2)
    U, V, W, dPdx, p = env_step_full_kb(
        grid, 1, kstate.U, kstate.V, kstate.W, kstate.dPdx.reshape(1),
        kstate.meanU0.reshape(1), op1, op2)
    kstate = kstate.replace(U=U, V=V, W=W,
                            dPdx=dPdx.reshape(kstate.dPdx.shape))
    p2 = p[1].reshape(grid.Nx, grid.Nz)
    return kstate, p2, step_metrics_k(grid, kstate, p2)


def env_step_k(grid, kstate, opV1, opV2):
    """Single-env step on a kernel-layout ChannelState (the closed loop's
    body): kernel D when `FULLSTEP`, else the staged step, the wall-
    pressure pair and the scoreboard.  Returns (kstate', p2 (Nx, Nz),
    info)."""
    if FULLSTEP:
        return env_step_full_k(grid, kstate, opV1, opV2)
    op1, op2 = _action_rows(grid, kstate, opV1, opV2)
    U, V, W, dPdx = rk3_step_k(grid, kstate.U, kstate.V, kstate.W,
                               kstate.dPdx, kstate.meanU0, op1, op2)
    kstate = kstate.replace(U=U, V=V, W=W, dPdx=dPdx)
    _, p2 = boundary_pressures_k(grid, U, V, W, dPdx.reshape(1))
    p2 = p2.reshape(grid.Nx, grid.Nz)
    return kstate, p2, step_metrics_k(grid, kstate, p2)
