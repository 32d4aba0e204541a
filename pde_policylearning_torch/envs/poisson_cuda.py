"""Full-field channel Poisson solve: the plain torch version and the CUDA
kernel that replaces `pde_policylearning_tpu/envs/poisson_pallas.py:_kernel`.

Both solve (d_yy + kxx + kzz) p = rhs for rhs (Nx, n, Nz), n = Ny-1: a
forward x/z transform, the n-row eigen-solve A [(B r) / (lam + kk)], the
regularized and equilibrated (0,0) mean mode through Pinv00_eq,
`grid.refine_steps` refinement passes with the tridiagonal operator, and
the inverse transform.  The plain version transforms with `torch.fft`; the
kernel (csrc/poisson.cu) on the (y, x*z) layout, re|im side by side, with
FFTs in shared memory on a power-of-two grid and Kronecker DFT products on
any other (`envs/xz_fft.py`).  `poisson_solve` dispatches between them and is
differentiable on both devices (see `_PoissonSolve`).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..native import cuda_build
from ..native.cuda_build import check_cuda_f32


@lru_cache(maxsize=8)
def _kron_mats(Nx: int, Nz: int):
    """Float64 Kronecker DFT factors (TR, TI, TiR, TiI).

    Forward T (Nx*Nz, Nx*Nzr) = kron(Fx, Fz), row x*Nz + z, column
    kx*Nzr + f.  The inverse Ti (Nx*Nzr, Nx*Nz) carries the conjugate
    kernels, the conjugate-pair doubling c_f and the 1/(Nx*Nz)
    normalization (poisson_pallas.py:44-73)."""
    Nzr = Nz // 2 + 1
    z = np.arange(Nz)
    f = np.arange(Nzr)
    x = np.arange(Nx)
    Fz = np.exp(-2j * np.pi * np.outer(z, f) / Nz)
    Fx = np.exp(-2j * np.pi * np.outer(x, x) / Nx)
    T = np.kron(Fx, Fz)
    c = np.full(Nzr, 2.0)
    c[0] = 1.0
    if Nz % 2 == 0:
        c[-1] = 1.0
    Fzi = c[:, None] * np.exp(2j * np.pi * np.outer(f, z) / Nz) / (Nx * Nz)
    Fxi = np.exp(2j * np.pi * np.outer(x, x) / Nx)
    Ti = np.kron(Fxi, Fzi)
    return T.real, T.imag, Ti.real, Ti.imag


def _tridiag_residual(grid, R, P, kk, mode00=True):
    """R - (DD + kk I) P - the (0,0,0) regularization term (where the
    spectra hold the (0,0) mode, `mode00`), for real-stacked (2, Nx, n, k)
    spectra."""
    d = grid.DD_diag[:, None] + kk
    out = d * P
    out = out + torch.nn.functional.pad(
        grid.DD_lower[:, None] * P[..., :-1, :], (0, 0, 1, 0))
    out = out + torch.nn.functional.pad(
        grid.DD_upper[:, None] * P[..., 1:, :], (0, 0, 0, 1))
    r = R - out
    if mode00:
        r[:, 0, 0, 0] -= (0.5 * grid.DD_diag[0]) * P[:, 0, 0, 0]
    return r


def _eig_solve(grid, R, denom, mode00=True):
    """(DD + kk)^-1 R on real-stacked spectra, with the (0,0) column (the
    last axis' first, where it holds kz = 0: `mode00`) replaced by the
    equilibrated regularized solve."""
    P = grid.eig_A @ ((grid.eig_B @ R) / denom)
    if mode00:
        s = grid.s00
        p00 = s * ((s * R[:, 0, :, 0]) @ grid.Pinv00_eq.T)   # (2, n)
        P[:, 0, :, 0] = p00
    return P


def spectral_solve(grid, R, kz0: int = 0):
    """(DD + kk)^-1 of real-stacked spectra R (2, Nx, n, k) whose last axis
    holds the z wavenumbers kz0 .. kz0 + k - 1 (all Nz // 2 + 1 of them in
    the plain solve, a block of them on one rank of the x-sharded solve,
    `parallel/sharded_env.py`), with `grid.refine_steps` refinement
    passes."""
    k = R.shape[-1]
    kk = (grid.kxx[:, None, None] + grid.kzz[None, None, kz0:kz0 + k])
    denom = grid.eig_lam[None, :, None] + kk
    # the Neumann null eigenvalue at kk = 0 would give inf; that column is
    # overwritten by the (0,0) solve but must stay finite
    denom = torch.where(denom.abs() < 1e-12, torch.ones_like(denom), denom)
    mode00 = kz0 == 0
    P = _eig_solve(grid, R, denom, mode00)
    for _ in range(grid.refine_steps):
        P = P + _eig_solve(grid, _tridiag_residual(grid, R, P, kk, mode00),
                           denom, mode00)
    return P


def poisson_solve_plain(grid, rhs):
    """Plain torch solve for rhs (Nx, n, Nz) in any float dtype."""
    Rc = torch.fft.fft(torch.fft.rfft(rhs, dim=-1), dim=-3)   # (Nx, n, Nzr)
    P = spectral_solve(grid, torch.stack([Rc.real, Rc.imag]))
    Pc = torch.complex(P[0], P[1])
    return torch.fft.irfft(torch.fft.ifft(Pc, dim=-3), n=grid.Nz, dim=-1)


def poisson_consts(grid):
    """Device constants of the kernel, built once per grid: the full
    n-row eigenbasis with the per-wavenumber denominators doubled to the
    re|im layout (n, 2F), guarded as in `poisson_solve_plain`."""
    key = "poisson"
    if key not in grid.cache:
        Nzr = grid.Nz // 2 + 1
        F = grid.Nx * Nzr
        kk = (grid.kxx[:, None] + grid.kzz[None, :Nzr]).reshape(1, F)
        denom = grid.eig_lam[:, None] + kk
        denom = torch.where(denom.abs() < 1e-12, torch.ones_like(denom),
                            denom)
        grid.cache[key] = {
            "A": grid.eig_A.contiguous(), "Bf": grid.eig_B.contiguous(),
            "denom": torch.cat([denom, denom], 1).contiguous()}
    return grid.cache[key]


def poisson_solve_kernel(grid, rhs):
    """CUDA solve (csrc/poisson.cu) for a float32 rhs (Nx, n, Nz) on the
    card.  Raises for anything else; it never falls back to the plain
    version."""
    Nx, n, Nz = grid.Nx, grid.Ny - 1, grid.Nz
    check_cuda_f32("rhs", rhs, (Nx, n, Nz), contiguous=False)
    from . import rk3_cuda
    args = rk3_cuda.kernel_args(grid, 1)
    Y = rhs.permute(1, 0, 2).reshape(n, Nx * Nz).contiguous()
    out = torch.empty_like(Y)
    err = cuda_build.load().pde_poisson_solve(
        args.dims_ref, args.ops_ref, args.work_ref, Y.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(rhs.device).cuda_stream)
    cuda_build.check(err, "pde_poisson_solve")
    poisson_solve_kernel.launches += 1
    return out.reshape(n, Nx, Nz).permute(1, 0, 2)


poisson_solve_kernel.launches = 0


class _PoissonSolve(torch.autograd.Function):
    """The solve of rhs (Nx, n, Nz): the kernel on a CUDA tensor, the plain
    version on a CPU tensor.  The backward is the VJP of the plain version,
    recomputed (as `poisson_pallas.poisson_solve_fused`'s rule delegates to
    XLA).  The grid's constants get no gradient."""

    @staticmethod
    def forward(ctx, grid, rhs):
        ctx.grid = grid
        ctx.save_for_backward(rhs)
        if rhs.is_cuda:
            return poisson_solve_kernel(grid, rhs)
        return poisson_solve_plain(grid, rhs)

    @staticmethod
    def backward(ctx, g):
        rhs = ctx.saved_tensors[0].detach().requires_grad_()
        with torch.enable_grad():
            p = poisson_solve_plain(ctx.grid, rhs)
        return None, torch.autograd.grad(p, rhs, g)[0]


def poisson_solve(grid, rhs):
    """Solve for rhs (Nx, n, Nz): the plain torch solve for a CPU tensor,
    the CUDA kernel for a CUDA tensor; differentiable on both."""
    return _PoissonSolve.apply(grid, rhs)
