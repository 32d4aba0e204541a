"""Synthetic PDE data: Gaussian random fields and a pseudo-spectral 2-D
Navier-Stokes solver (vorticity form).

Counterpart of `pde_policylearning_tpu/data/synthetic.py` (reference:
libs/DINo/data_pdes.py:161 (GaussianRF), :211-290 (the pseudo-spectral
Crank-Nicolson solver behind the DINo datasets and the Kolmogorov-flow
archives of libs/pino_utils/datasets.py:448)).  The solver is a Python
loop of torch FFTs on the device; the random field is its deterministic
spectrum (`grf_sqrt_eig`) times one complex normal draw from an explicit
generator.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.pde_losses import get_forcing
from ..utils.device import resolve_device


def grf_sqrt_eig(size: int, alpha: float = 2.5, tau: float = 7.0,
                 sigma: Optional[float] = None, device=None,
                 dtype=torch.float32) -> torch.Tensor:
    """The square root of the covariance's spectrum, sigma^2 (-Lap +
    tau^2)^(-alpha), on the (size, size) FFT grid, zero mode 0
    (data_pdes.py:161-209).  The `size ** 2` factor is the eigenvalue
    scale of dimension 2, which the backward-norm inverse FFT's
    1 / size ** 2 cancels, so a field's amplitude does not depend on the
    resolution."""
    if sigma is None:
        sigma = tau ** (0.5 * (2 * alpha - 2.0))
    k = torch.fft.fftfreq(size, d=1.0 / size, dtype=dtype,
                          device=resolve_device(device))
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    sqrt_eig = (size ** 2 * math.sqrt(2.0) * sigma
                * ((4 * math.pi ** 2 * k2 + tau ** 2) ** (-alpha / 2.0)))
    sqrt_eig[0, 0] = 0.0
    return sqrt_eig


def grf_from_noise(sqrt_eig: torch.Tensor, noise: torch.Tensor
                   ) -> torch.Tensor:
    """Fields (B, S, S) from complex noise (B, S, S): Re ifft2(sqrt_eig *
    noise)."""
    return torch.fft.ifft2(sqrt_eig[None] * noise, dim=(1, 2)).real


def gaussian_rf_2d(size: int, batch: int = 1, alpha: float = 2.5,
                   tau: float = 7.0, sigma: Optional[float] = None,
                   generator: Optional[torch.Generator] = None, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    """Periodic Gaussian random fields (batch, size, size).  The noise is
    complex normal with variance 1/2 per component (torch.randn of
    cfloat, as the reference draws it): the real part, then the imaginary
    part, each (batch, size, size), from `generator`."""
    device = resolve_device(device)
    sqrt_eig = grf_sqrt_eig(size, alpha, tau, sigma, device, dtype)
    shape = (batch, size, size)
    re = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    im = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return grf_from_noise(sqrt_eig, torch.complex(re, im)
                          * (1.0 / math.sqrt(2.0)))


def ns_vorticity_rollout(w0, forcing, visc: float, dt: float, n_steps: int,
                         record_every: int = 1, deriv_scale: float = 1.0):
    """Pseudo-spectral 2-D NS in vorticity form: Crank-Nicolson diffusion,
    explicit advection and forcing, 2/3 dealiasing (data_pdes.py:211-290).

    deriv_scale fixes the domain: d/dx = deriv_scale * i k and the
    Laplacian -(deriv_scale k)^2; 1.0 is [0, 2pi)^2 (Kolmogorov flow, the
    PINO loss), 2 pi is [0, 1)^2 (the DINo solver).
    w0: (B, N, N); forcing: (N, N) or None.  Returns (B, N, N, n_records),
    a record every `record_every` steps, w0 not included."""
    B, N, _ = w0.shape
    k = torch.fft.fftfreq(N, d=1.0 / N, dtype=w0.dtype, device=w0.device)
    k_x = deriv_scale * k[:, None]
    k_y = deriv_scale * k[None, :]
    lap = k_x ** 2 + k_y ** 2
    lap_safe = lap.clone()
    lap_safe[0, 0] = 1.0
    kcut = (2.0 / 3.0) * (N // 2) * deriv_scale
    dealias = ((k_x.abs() <= kcut) & (k_y.abs() <= kcut)).to(w0.dtype)
    f_h = torch.fft.fft2(forcing) if forcing is not None else 0.0
    den = 1.0 + 0.5 * dt * visc * lap
    decay = 1.0 - 0.5 * dt * visc * lap

    def nonlinear(w_h):
        psi_h = w_h / lap_safe
        u = torch.fft.ifft2(1j * k_y * psi_h).real
        v = torch.fft.ifft2(-1j * k_x * psi_h).real
        wx = torch.fft.ifft2(1j * k_x * w_h).real
        wy = torch.fft.ifft2(1j * k_y * w_h).real
        return dealias * torch.fft.fft2(u * wx + v * wy)

    w_h = torch.fft.fft2(w0)
    frames = []
    for _ in range(n_steps // record_every):
        for _ in range(record_every):
            w_h = (decay * w_h - dt * nonlinear(w_h) + dt * f_h) / den
        frames.append(torch.fft.ifft2(w_h).real)
    return torch.stack(frames, dim=-1)


def generate_kolmogorov_data(n_traj: int, size: int, nt: int,
                             visc: float = 1.0 / 40, t_interval: float = 1.0,
                             substeps: int = 32,
                             generator: Optional[torch.Generator] = None,
                             device=None, dtype=torch.float32):
    """Kolmogorov-flow vorticity trajectories under the forcing -4 cos(4y)
    (pino_utils/losses.py:288), shaped like KFDataset samples: (n_traj,
    size, size, nt), frame 0 the random-field initial condition."""
    w0 = gaussian_rf_2d(size, n_traj, generator=generator,
                        device=resolve_device(device), dtype=dtype)
    return kolmogorov_from_field(w0, nt, visc, t_interval, substeps)


def kolmogorov_from_field(w0: torch.Tensor, nt: int, visc: float = 1.0 / 40,
                          t_interval: float = 1.0, substeps: int = 32
                          ) -> torch.Tensor:
    """`generate_kolmogorov_data` after its draw: (B, size, size, nt)
    trajectories from the initial vorticity w0 (B, size, size)."""
    dt = t_interval / ((nt - 1) * substeps)
    forcing = get_forcing(w0.shape[-1], w0.device, w0.dtype)[0, :, :, 0]
    frames = ns_vorticity_rollout(w0, forcing, visc, dt,
                                  n_steps=(nt - 1) * substeps,
                                  record_every=substeps)
    return torch.cat([w0[..., None], frames], dim=-1)
