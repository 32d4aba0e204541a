"""DINo datasets: wave and Navier-Stokes trajectories generated on the
fly, observation masks, the spherical shallow-water and the SST sets.

Counterpart of `pde_policylearning_tpu/data/dino_datasets.py` (reference:
libs/DINo/data_pdes.py:54-466 (the Wave, NavierStokes, ShallowWater and
SST datasets with GaussianRF initial conditions), libs/DINo/utils.py
:173-197 (irregular-grid masks)).  The solvers are Python loops of torch
FFTs on the tensors' device; each random field comes from an explicit
generator, and the part after the draw (`wave_data_from_field`,
`navier_stokes_data_from_field`) takes a given field.  The shallow-water
and SST sets draw with numpy from their seeds, as the JAX package does.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from ..ops.sht import irsht
from ..utils.device import resolve_device
from .synthetic import gaussian_rf_2d, ns_vorticity_rollout


def wave_rollout(u0, v0, speed: float, dt: float, n_steps: int,
                 record_every: int = 1) -> torch.Tensor:
    """The 2-D periodic wave equation u_tt = c^2 Lap(u), pseudo-spectral,
    symplectic Euler in time (v first, then u; data_pdes.py's Wave
    dataset).  u0, v0: (B, N, N).  Returns (B, N, N, n_steps //
    record_every), a record every `record_every` steps, u0 not
    included."""
    N = u0.shape[-1]
    k = torch.fft.fftfreq(N, d=1.0 / N, dtype=u0.dtype,
                          device=u0.device) * 2 * math.pi
    lap = -(k[:, None] ** 2 + k[None, :] ** 2)
    c2lap = speed ** 2 * lap
    u, v = u0, v0
    frames = []
    for _ in range(n_steps // record_every):
        for _ in range(record_every):
            v = v + dt * torch.fft.ifft2(c2lap * torch.fft.fft2(u)).real
            u = u + dt * v
        frames.append(u)
    return torch.stack(frames, dim=-1)


def wave_data_from_field(u0: torch.Tensor, nt: int, speed: float = 0.5,
                         t_total: float = 1.0, substeps: int = 8
                         ) -> torch.Tensor:
    """(B, nt, N, N, 1) wave trajectories from the initial field u0 (B, N,
    N) at rest, u0 the first frame."""
    dt = t_total / ((nt - 1) * substeps)
    frames = wave_rollout(u0, torch.zeros_like(u0), speed, dt,
                          n_steps=(nt - 1) * substeps,
                          record_every=substeps)
    traj = torch.cat([u0[..., None], frames], dim=-1)
    return torch.movedim(traj, -1, 1)[..., None]


def generate_wave_data(n_traj: int, size: int, nt: int, speed: float = 0.5,
                       t_total: float = 1.0, substeps: int = 8,
                       generator: Optional[torch.Generator] = None,
                       device=None, dtype=torch.float32) -> torch.Tensor:
    """(n_traj, nt, size, size, 1) wave trajectories from random fields
    (alpha 3, tau 5) drawn from `generator`."""
    u0 = gaussian_rf_2d(size, n_traj, alpha=3.0, tau=5.0,
                        generator=generator, device=device, dtype=dtype)
    return wave_data_from_field(u0, nt, speed, t_total, substeps)


def dino_ns_forcing(size: int, device=None, dtype=torch.float32
                    ) -> torch.Tensor:
    """0.1 (sin 2 pi (x + y) + cos 2 pi (x + y)) on [0, 1)^2 (data_pdes.py
    NavierStokes), computed in float64 numpy."""
    xs = np.linspace(0, 1, size, endpoint=False)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    f = 0.1 * (np.sin(2 * np.pi * (X + Y)) + np.cos(2 * np.pi * (X + Y)))
    return torch.as_tensor(f, dtype=dtype, device=resolve_device(device))


def navier_stokes_data_from_field(w0: torch.Tensor, nt: int,
                                  visc: float = 1e-3, t_total: float = 1.0,
                                  substeps: int = 16, forcing=None
                                  ) -> torch.Tensor:
    """(B, nt, N, N, 1) vorticity trajectories on [0, 1)^2 from w0 (B, N,
    N), w0 the first frame (data_pdes.py:211-290)."""
    if forcing is None:
        forcing = dino_ns_forcing(w0.shape[-1], w0.device, w0.dtype)
    dt = t_total / ((nt - 1) * substeps)
    frames = ns_vorticity_rollout(w0, forcing, visc, dt,
                                  n_steps=(nt - 1) * substeps,
                                  record_every=substeps,
                                  deriv_scale=2.0 * np.pi)
    traj = torch.cat([w0[..., None], frames], dim=-1)
    return torch.movedim(traj, -1, 1)[..., None]


def generate_navier_stokes_data(n_traj: int, size: int, nt: int,
                                visc: float = 1e-3, t_total: float = 1.0,
                                substeps: int = 16, forcing=None,
                                generator: Optional[torch.Generator] = None,
                                device=None, dtype=torch.float32
                                ) -> torch.Tensor:
    """(n_traj, nt, size, size, 1) NS vorticity trajectories from random
    fields (alpha 2.5, tau 7) drawn from `generator`."""
    w0 = gaussian_rf_2d(size, n_traj, generator=generator, device=device,
                        dtype=dtype)
    return navier_stokes_data_from_field(w0, nt, visc, t_total, substeps,
                                         forcing)


def generate_mask(h_size: int, w_size: int, mask_data: float = 0.0,
                  generator: Optional[torch.Generator] = None, device=None,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A random observation mask (DINo/utils.py:191-197) keeping the
    points whose uniform draw `u` (h_size, w_size), from `generator`
    unless given, is >= mask_data: about (1 - mask_data) of the grid.
    All points for mask_data <= 0."""
    device = resolve_device(device)
    if mask_data <= 0:
        return torch.ones((h_size, w_size), dtype=torch.bool, device=device)
    if u is None:
        u = torch.rand((h_size, w_size), generator=generator, device=device)
    return u >= mask_data


def generate_skipped_lat_lon_mask(h_size: int, w_size: int,
                                  base_jump: int = 0, device=None
                                  ) -> torch.Tensor:
    """A regular lat-lon subsampling mask (DINo/utils.py:173-189), sparser
    towards the poles (rows)."""
    mask = np.zeros((h_size, w_size), bool)
    for i in range(h_size):
        d = min(i, h_size - 1 - i) / (h_size / 2)
        jump = 2 ** (base_jump + int(np.ceil(2 * (1 - d))))
        mask[i, ::jump] = True
    return torch.as_tensor(mask, device=resolve_device(device))


# -- shallow water on the sphere (data_pdes.py:341-385) ----------------------

def spherical_xyz_coords(nlat: int, nlon: int) -> np.ndarray:
    """(nlat, nlon, 3) float32 xyz on the unit sphere at the cell centres
    in colatitude and the grid's longitudes (data_pdes.py:352-365)."""
    theta = (np.arange(nlat) + 0.5) * np.pi / nlat
    phi = np.arange(nlon) * 2 * np.pi / nlon
    T, P = np.meshgrid(theta, phi, indexing="ij")
    return np.stack([np.cos(P) * np.sin(T), np.sin(P) * np.sin(T),
                     np.cos(T)], axis=-1).astype(np.float32)


def generate_shallow_water_data(n_traj: int, nlat: int, nlon: int, nt: int,
                                seed_offset: int = 0, device=None,
                                dtype=torch.float32) -> torch.Tensor:
    """(n_traj, nt, nlat, nlon, 2) [height, vorticity] trajectories:
    random band-limited spherical fields (numpy's default_rng(1234 +
    seed_offset)) turned at each degree l by the gravity-wave frequency
    sqrt(l (l + 1)), the vorticity the spherical Laplacian of the height
    scaled by 1 / max(lmax^2 / 4, 1); each frame through `ops.sht.irsht`
    from the spectrum's float32 parts, as the JAX package synthesizes
    it."""
    device = resolve_device(device)
    rng = np.random.default_rng(1234 + seed_offset)
    lmax = nlat // 2
    ls = np.arange(lmax)
    flm = (rng.normal(size=(n_traj, lmax, lmax, 1))
           + 1j * rng.normal(size=(n_traj, lmax, lmax, 1)))
    for l in range(lmax):
        flm[:, l, l + 1:, :] = 0
    flm[:, :, 0, :] = flm[:, :, 0, :].real
    flm = flm / (1.0 + ls[:, None] ** 2)[None, :, :, None]
    omega = np.sqrt(ls * (ls + 1.0))
    lap = -(ls * (ls + 1.0))

    def synth(spec):
        parts = [torch.as_tensor(a.astype(np.float32), device=device)
                 .to(dtype) for a in (spec.real, spec.imag)]
        return irsht(torch.complex(*parts), nlat, nlon)

    frames = []
    for k in range(nt):
        t = k / max(nt - 1, 1)
        fh = flm * np.exp(1j * omega * t)[None, :, None, None]
        fw = fh * lap[None, :, None, None]
        frames.append(torch.cat([synth(fh), synth(fw)
                                 / max(lmax ** 2 / 4.0, 1.0)], dim=-1))
    return torch.stack(frames, dim=1)


class ShallowWaterDataset:
    """The DINo spherical SWE dataset (data_pdes.py:341-405).

    Where `root` holds the reference's dedalus HDF5 layout
    (shallow_water_{train,test}/traj_%04d.h5, tasks/height and
    tasks/vorticity), trajectories are read with the reference's scalings
    (height x 3000, vorticity x 2, every second grid point); otherwise
    they are generated on `device` (`generate_shallow_water_data`, seed
    offset 0 for train, 10000 otherwise).  `data` is numpy on the host."""

    def __init__(self, n_seq: int, nt: int, nlat: int = 32, nlon: int = 64,
                 root=None, group: str = "train", device=None):
        self.n_seq, self.nt = n_seq, nt
        self.group = group
        self._h5_dir = None
        if root is not None:
            split = "test" if group == "test" else "train"
            d = os.path.join(root, f"shallow_water_{split}")
            if os.path.isdir(d):
                self._h5_dir = d
        if self._h5_dir is None:
            self.data = generate_shallow_water_data(
                n_seq, nlat, nlon, nt,
                seed_offset=0 if group == "train" else 10_000,
                device=device).cpu().numpy()
        else:
            trajs = [self._load_h5(i) for i in range(n_seq)]
            self.data = np.stack(trajs)[:, :nt]
        self.coords = spherical_xyz_coords(self.data.shape[2],
                                           self.data.shape[3])
        self.coord_dim = 3

    def _load_h5(self, traj_id: int):
        import h5py
        with h5py.File(os.path.join(self._h5_dir,
                                    f"traj_{traj_id:04d}.h5"), "r") as f:
            h = np.asarray(f["tasks/height"][:, ::2, ::2]) * 3000.0
            w = np.asarray(f["tasks/vorticity"][:, ::2, ::2]) * 2.0
        return np.stack([h, w], axis=-1)

    def __len__(self):
        return self.n_seq

    def __getitem__(self, index: int):
        return {"data": self.data[index],
                "t": np.linspace(0.0, 1.0, self.nt, dtype=np.float32),
                "traj": index, "index": index, "coords": self.coords}

    def arrays(self, device=None, dtype=torch.float32):
        """(data, coords) as tensors on `device` (None: the card)."""
        device = resolve_device(device)
        return (torch.as_tensor(self.data, dtype=dtype, device=device),
                torch.as_tensor(self.coords, dtype=dtype, device=device))


# -- SST (data_pdes.py:389-466) -----------------------------------------------

class SSTDataset:
    """The sea-surface-temperature forecasting set (data_pdes.py SST).

    With `data_dir` holding the reference's netCDF layout (data_{zone}.nc
    with thetao / daily_mean / daily_std) and `netCDF4` importable, the
    fields are read; otherwise each zone is synthesized with numpy
    (seed * 1000 + zone): a seasonal climatology plus slowly drifting
    random-field anomalies.  Both go through the reference's two
    normalizations (by the climatology, then per frame).  Host numpy."""
    var_names = ["thetao", "daily_mean", "daily_std"]
    zone_size = 64

    def __init__(self, nt_cond: int, nt_pred: int, train: bool = True,
                 data_dir=None, zones=range(1, 5), n_days: int = 120,
                 seed: int = 0):
        self.nt_cond, self.nt_pred = nt_cond, nt_pred
        self.train = train
        self.zones = list(zones)
        self.data, self.climato, self.cst = {}, {}, {}
        for zone in self.zones:
            raw = None
            if data_dir is not None:
                raw = self._try_load_zone(data_dir, zone)
            if raw is None:
                raw = self._synthesize_zone(zone, n_days, seed)
            theta, mu_c, sd_c = raw
            theta = (theta - mu_c) / sd_c
            mu = theta.mean(axis=(1, 2)).reshape(-1, 1, 1)
            sd = theta.std(axis=(1, 2)).reshape(-1, 1, 1) + 1e-8
            self.data[zone] = (theta - mu) / sd
            self.climato[zone] = (mu_c, sd_c)
            self.cst[zone] = (mu, sd)
            self.len_ = len(theta)
        first = 0 if train else int(0.8 * self.len_)
        usable = int(0.8 * self.len_) if train \
            else self.len_ - int(0.8 * self.len_)
        self.first = first
        self.len_ = max(1, int(usable * 0.1) - nt_pred - nt_cond - 1)
        self._total_len = len(self.zones) * self.len_
        xs = np.linspace(-1.0, 1.0, self.zone_size, dtype=np.float32)
        X, Y = np.meshgrid(xs, xs, indexing="ij")
        self.coords = np.stack([X, Y], axis=-1)
        self.coord_dim = 2

    @staticmethod
    def _try_load_zone(data_dir, zone):
        path = os.path.join(data_dir, f"data_{zone}.nc")
        if not os.path.exists(path):
            return None
        try:
            from netCDF4 import Dataset as NC
        except ImportError:
            return None
        f = NC(path, "r")
        theta = np.asarray(f.variables["thetao"][:].data)
        mu = np.asarray(f.variables["daily_mean"][:].data).reshape(-1, 1, 1)
        sd = np.asarray(f.variables["daily_std"][:].data).reshape(-1, 1, 1)
        return theta, mu, sd

    def _synthesize_zone(self, zone, n_days, seed):
        rng = np.random.default_rng(seed * 1000 + zone)
        S = self.zone_size
        days = np.arange(n_days)
        mu_c = (15.0 + 8.0 * np.sin(2 * np.pi * days / 365.0
                                    + zone)).reshape(-1, 1, 1)
        sd_c = np.full((n_days, 1, 1), 2.0)
        k = np.fft.fftfreq(S)[:, None] ** 2 + np.fft.fftfreq(S)[None, :] ** 2
        spec_decay = 1.0 / (1.0 + 400.0 * k)
        a = np.fft.ifft2(np.fft.fft2(rng.normal(size=(S, S)))
                         * spec_decay).real
        b = np.fft.ifft2(np.fft.fft2(rng.normal(size=(S, S)))
                         * spec_decay).real
        fields = []
        for d in days:
            w = 2 * np.pi * d / 60.0
            anom = np.cos(w) * a + np.sin(w) * b \
                + 0.1 * rng.normal(size=(S, S))
            anom = 4.0 * anom / (np.abs(anom).max() + 1e-8)
            fields.append(mu_c[d, 0, 0] + anom * sd_c[d, 0, 0])
        return np.asarray(fields, np.float32), mu_c, sd_c

    def __len__(self):
        return self._total_len

    def __getitem__(self, idx: int):
        zone = self.zones[idx // self.len_]
        # a stride of 10 through the archive (data_pdes.py:447)
        i = (idx % self.len_) * 10 + self.nt_cond + 1 + self.first
        seq = self.data[zone][i - self.nt_cond + 1:i + self.nt_pred + 1]
        sl = slice(i + 1, i + self.nt_pred + 1)
        return {"data": seq[..., None],
                "t": np.arange(self.nt_cond + self.nt_pred, dtype=np.float32),
                "index": idx, "coords": self.coords,
                "mu_clim": self.climato[zone][0][sl],
                "std_clim": self.climato[zone][1][sl],
                "mu_norm": self.cst[zone][0][sl],
                "std_norm": self.cst[zone][1][sl]}
