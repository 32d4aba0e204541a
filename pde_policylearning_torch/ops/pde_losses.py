"""Physics-informed PDE residual losses (spectral finite differences).

Counterpart of `pde_policylearning_tpu/ops/pde_losses.py` (reference:
libs/pino_utils/losses.py (FDM_Darcy:6, darcy_loss:39,
FDM_NS_vorticity:71, FDM_Burgers:200, PINO_loss:223, PINO_loss3d:246,
get_forcing:288) and libs/envs/diff_control_env.py:5-60), on the FFT
route.  The JAX package's `_fdm_ns_vorticity_dft` (DFT products for a TPU
whose FFT was slow) has no counterpart here.

The inverse transforms of the residuals act on spectra that are not
Hermitian (`1j * k * f_h` holds the Nyquist wavenumber -N/2 on one side
only).  pocketfft, on the CPU, gives such a spectrum one meaning: a
complex inverse along the leading axis, then the imaginary parts of the
DC and Nyquist bins of the last axis dropped.  cuFFT's C2R leaves it
undefined; on the H100 it computes the same (`chip_smoke.py` phase 10
holds the card's residuals against the CPU's in float64).
"""
from __future__ import annotations

import math

import torch

from .losses import SimpleLpLoss


def fdm_darcy(u, a, D: float = 1.0):
    """Darcy flow residual -div(a grad u) by central differences
    (losses.py:6-37).  u, a: (B, S, S) -> (B, S - 4, S - 4)."""
    b, size = u.shape[0], u.shape[1]
    u = u.reshape(b, size, size)
    a = a.reshape(b, size, size)
    dx = D / (size - 1)
    ux = (u[:, 2:, 1:-1] - u[:, :-2, 1:-1]) / (2 * dx)
    uy = (u[:, 1:-1, 2:] - u[:, 1:-1, :-2]) / (2 * dx)
    ai = a[:, 1:-1, 1:-1]
    aux = ai * ux
    auy = ai * uy
    auxx = (aux[:, 2:, 1:-1] - aux[:, :-2, 1:-1]) / (2 * dx)
    auyy = (auy[:, 1:-1, 2:] - auy[:, 1:-1, :-2]) / (2 * dx)
    return -(auxx + auyy)


def darcy_loss(u, a):
    Du = fdm_darcy(u, a)
    return SimpleLpLoss(size_average=True).rel(Du, torch.ones_like(Du))


def _wavenumbers(n: int, like: torch.Tensor) -> torch.Tensor:
    """[0, 1, .., n/2 - 1, -n/2, .., -1] in `like`'s real dtype."""
    k_max = n // 2
    k = torch.cat([torch.arange(0, k_max), torch.arange(-k_max, 0)])
    return k.to(device=like.device, dtype=like.real.dtype)


def fdm_ns_vorticity(w, v=1.0 / 40, t_interval: float = 1.0):
    """2-D NS vorticity-form residual by streamfunction spectral
    derivatives and a central time difference (losses.py:71-107).

    w: (B, N, N, T) vorticity trajectory; v: viscosity, a number or (B,)
    -> residual (B, N, N, T - 2).  The Laplacian's zero mode is set to 1
    before it divides and before it multiplies (`wlap`), as the reference
    does, so the mean of w reaches `wlap`."""
    b, nx, ny, nt = w.shape
    w_h = torch.fft.fft2(w, dim=(1, 2))
    k_max = nx // 2
    k = _wavenumbers(nx, w)
    k_x = k.reshape(1, nx, 1, 1)
    k_y = k.reshape(1, 1, nx, 1)
    lap = k_x ** 2 + k_y ** 2
    lap[0, 0, 0, 0] = 1.0
    f_h = w_h / lap

    def inv(a_h):
        return torch.fft.irfft2(a_h[:, :, :k_max + 1], s=(nx, ny),
                                dim=(1, 2))

    ux = inv(1j * k_y * f_h)
    uy = inv(-1j * k_x * f_h)
    wx = inv(1j * k_x * w_h)
    wy = inv(1j * k_y * w_h)
    wlap = inv(-lap * w_h)

    dt = t_interval / (nt - 1)
    wt = (w[..., 2:] - w[..., :-2]) / (2 * dt)
    v = torch.as_tensor(v, dtype=w.dtype, device=w.device).reshape(-1, 1, 1,
                                                                    1)
    return wt + (ux * wx + uy * wy - v * wlap)[..., 1:-1]


def pino_loss_3d(u, u0, forcing, v=1.0 / 40, t_interval: float = 1.0):
    """(loss_ic, loss_f) for the Kolmogorov-flow vorticity trajectory
    (losses.py:246-262; diff_control_env.py:44-60 is the same math)."""
    lp = SimpleLpLoss(size_average=True)
    loss_ic = lp(u[..., 0], u0)
    Du = fdm_ns_vorticity(u, v, t_interval)
    loss_f = lp(Du, forcing.expand(Du.shape))
    return loss_ic, loss_f


channelflow_pino_loss = pino_loss_3d


def fdm_burgers(u, v, D: float = 1.0):
    """Burgers residual by spectral x-derivatives (losses.py:200-221).
    u: (B, T, N) -> (B, T - 2, N)."""
    b, nt, nx = u.shape
    dt = D / (nt - 1)
    u_h = torch.fft.fft(u, dim=2)
    k_x = _wavenumbers(nx, u).reshape(1, 1, nx)
    ux_h = 2j * math.pi * k_x * u_h
    uxx_h = 2j * math.pi * k_x * ux_h
    k_max = nx // 2
    ux = torch.fft.irfft(ux_h[:, :, :k_max + 1], n=nx, dim=2)
    uxx = torch.fft.irfft(uxx_h[:, :, :k_max + 1], n=nx, dim=2)
    ut = (u[:, 2:, :] - u[:, :-2, :]) / (2 * dt)
    return ut + (ux * u - v * uxx)[:, 1:-1, :]


def pino_loss_burgers(u, u0, v):
    """(loss_ic, loss_f) for Burgers (losses.py:223-243)."""
    loss_u = torch.mean((u[:, 0, :] - u0) ** 2)
    Du = fdm_burgers(u, v)
    return loss_u, torch.mean(Du ** 2)


def get_forcing(S: int, device=None, dtype=torch.float32):
    """Kolmogorov forcing -4 cos(4 y) on [0, 2pi)^2 (losses.py:288):
    (1, S, S, 1), constant along x."""
    from ..utils.device import resolve_device
    x2 = torch.linspace(0, 2 * math.pi, S + 1, dtype=torch.float64)[:-1]
    f = (-4 * torch.cos(4 * x2)).reshape(1, 1, S, 1).expand(1, S, S, 1)
    return f.to(device=resolve_device(device), dtype=dtype).contiguous()
