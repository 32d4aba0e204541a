"""Library datasets: file readers, grid positional encodings, the
multigrid patch transform, tensor / zarr / HDF5 datasets, and the Darcy,
Navier-Stokes, Burgers and spherical shallow-water loaders.

Counterpart of `pde_policylearning_tpu/data/library.py` (reference:
neuralop/datasets/ darcy.py:9,61; navier_stokes.py:13,80,147;
burgers.py:4; pt_dataset.py:8; tensor_dataset.py:4; zarr_dataset.py:6;
hdf5_dataset.py:6; positional_encoding.py:3,21; transforms.py:39
(RandomMGPatch); spherical_swe.py:7,27).

Layout: channels last.  The loaders read .mat / .npz / .npy / .pt files
or, without one, generate the data on `device` (None: the card): the
random field from `generator` (a generator seeded `seed` on `device` by
default), then the part after the draw (`darcy_from_field`,
`kolmogorov_from_field`, `burgers_from_field`), which a test can feed
another field.  The datasets hold host numpy arrays.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.sht import irsht
from ..utils.device import resolve_device
from .synthetic import gaussian_rf_2d, kolmogorov_from_field


class MatReader:
    """Read a .mat file (scipy for v5, h5py for v7.3), .npz, .npy or .pt
    (utilities3.py:19-71)."""

    def __init__(self, file_path: str):
        self.file_path = file_path
        self._data = None
        self._load()

    def _load(self):
        path = self.file_path
        if path.endswith((".npz", ".npy")):
            self._data = np.load(path, allow_pickle=True)
            return
        if path.endswith(".pt"):
            self._data = torch.load(path, map_location="cpu",
                                    weights_only=True)
            return
        try:
            import scipy.io
            self._data = scipy.io.loadmat(path)
        except (NotImplementedError, ValueError):
            import h5py
            self._data = h5py.File(path, "r")

    def read_field(self, field: str) -> np.ndarray:
        """The field as float32 numpy (a v7.3 file's, which h5py reads
        transposed, transposed back)."""
        x = self._data[field]
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        import h5py
        if isinstance(self._data, h5py.File):
            x = x.T
        return x.astype(np.float32)


# -- positional encodings and transforms -------------------------------------

def grid_positional_encoding(height: int, width: int,
                             grid_boundaries=((0, 1), (0, 1)), device=None
                             ) -> torch.Tensor:
    """(height, width, 2) float32 coordinate channels, the cells' left
    edges (positional_encoding.py:21)."""
    xt = np.linspace(*grid_boundaries[0], height + 1)[:-1]
    yt = np.linspace(*grid_boundaries[1], width + 1)[:-1]
    gx, gy = np.meshgrid(xt, yt, indexing="ij")
    return torch.as_tensor(np.stack([gx, gy], axis=-1), dtype=torch.float32,
                           device=resolve_device(device))


def append_2d_grid_positional_encoding(x: torch.Tensor,
                                       grid_boundaries=((0, 1), (0, 1))
                                       ) -> torch.Tensor:
    """x (N, H, W, C) -> (N, H, W, C + 2) (positional_encoding.py:3)."""
    n, h, w, _ = x.shape
    grid = grid_positional_encoding(h, w, grid_boundaries, x.device)
    return torch.cat([x, grid.to(x.dtype)[None].expand(n, h, w, 2)], dim=-1)


class PositionalEmbedding2D:
    """A transform appending the grid channels to (H, W, C) or (N, H, W,
    C) (transforms.py:20-36)."""

    def __init__(self, grid_boundaries=((0, 1), (0, 1))):
        self.grid_boundaries = grid_boundaries

    def __call__(self, data):
        if data.ndim == 3:
            return append_2d_grid_positional_encoding(
                data[None], self.grid_boundaries)[0]
        return append_2d_grid_positional_encoding(data, self.grid_boundaries)


class RandomMGPatch:
    """The random-shift multigrid patch transform (transforms.py:39-80):
    roll a random centre (numpy's default_rng(seed)) to the middle, then
    take nested centre crops subsampled per level; x gets every level
    stacked on the channels, y the finest patch."""

    def __init__(self, levels: int = 2, seed: int = 0):
        self.levels = levels
        self.step = 2 ** levels
        self.rng = np.random.default_rng(seed)

    def _patches(self, img, step, height, width):
        if step == 1:
            return (img,)
        sh, sw = height // 4, width // 4
        inner = self._patches(img[sh:-sh, sw:-sw], step // 2,
                              height // 2, width // 2)
        return (img[::step, ::step], *inner)

    def __call__(self, data):
        x, y = data  # (H, W, C) each
        h, w = x.shape[0], x.shape[1]
        pos_h = int(self.rng.integers(0, h))
        pos_w = int(self.rng.integers(0, w))
        shift = (h // 2 - pos_h, w // 2 - pos_w)
        xs = torch.roll(torch.as_tensor(x), shift, dims=(0, 1))
        ys = torch.roll(torch.as_tensor(y), shift, dims=(0, 1))
        px = self._patches(xs, self.step, h, w)
        py = self._patches(ys, self.step, h, w)
        return torch.cat(px, dim=-1), py[-1]


# -- generic datasets ---------------------------------------------------------

@dataclass
class TensorDataset:
    """An (x, y) pair of host arrays (tensor_dataset.py:4)."""
    x: np.ndarray
    y: np.ndarray
    transform_x: Optional[object] = None
    transform_y: Optional[object] = None

    def __len__(self):
        return len(self.x)

    def __getitem__(self, idx):
        x, y = self.x[idx], self.y[idx]
        if self.transform_x is not None:
            x = self.transform_x(x)
        if self.transform_y is not None:
            y = self.transform_y(y)
        return {"x": x, "y": y}

    def arrays(self, device=None, dtype=torch.float32):
        """(x, y) as tensors on `device` (None: the card)."""
        device = resolve_device(device)
        return (torch.as_tensor(self.x, dtype=dtype, device=device),
                torch.as_tensor(self.y, dtype=dtype, device=device))


class ZarrDataset:
    """A lazy zarr-backed PDE dataset (zarr_dataset.py:6-125): the
    resolution -> subsample-step map {128: 8, 256: 4, 512: 2, 1024: 1},
    one store handle opened at first use, x at the subsampled resolution,
    y with a leading channel axis, optional transforms.  `zarr` is
    imported when the dataset is built, and its absence raises there."""

    _RES_TO_STEP = {128: 8, 256: 4, 512: 2, 1024: 1}

    def __init__(self, filename, resolution: int = 128, transform_x=None,
                 transform_y=None, n_samples=None):
        try:
            import zarr
        except ImportError as e:
            raise ImportError(
                "ZarrDataset requires the `zarr` package "
                "(reference: neuralop/datasets/zarr_dataset.py:6)") from e
        if resolution not in self._RES_TO_STEP:
            raise ValueError(
                f"Got resolution={resolution}, expected one of "
                f"{sorted(self._RES_TO_STEP)}")
        self._zarr = zarr
        self.subsample_step = self._RES_TO_STEP[resolution]
        self.filename = str(filename)
        self._data = None
        self.transform_x = transform_x
        self.transform_y = transform_y
        if n_samples is not None:
            self.n_samples = n_samples
        else:
            data = zarr.open(self.filename, mode="r")
            self.n_samples = data["x"].shape[0] if hasattr(data, "keys") \
                else data.shape[0]

    def attrs(self, array_name: str, name: str):
        return self._zarr.open(self.filename, mode="r")[array_name] \
            .attrs[name]

    @property
    def data(self):
        if self._data is None:
            self._data = self._zarr.open(self.filename, mode="r")
        return self._data

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        for i in ([idx] if isinstance(idx, int) else idx):
            assert i < self.n_samples, (
                f"Trying to access sample {i} of dataset with "
                f"{self.n_samples} samples")
        s = self.subsample_step
        x = np.asarray(self.data["x"][idx, ::s, ::s], np.float32)
        y = np.asarray(self.data["y"][idx, ::s, ::s], np.float32)[None]
        if self.transform_x is not None:
            x = self.transform_x(x)
        if self.transform_y is not None:
            y = self.transform_y(y)
        return {"x": x, "y": y}


class H5pyDataset:
    """A lazy HDF5-backed dataset (hdf5_dataset.py:6), subsampled to
    `resolution` where given."""

    def __init__(self, path, x_key="x", y_key="y", n_samples=None,
                 resolution=None):
        import h5py
        self.f = h5py.File(path, "r")
        self.x = self.f[x_key]
        self.y = self.f[y_key]
        self.n = n_samples or self.x.shape[0]
        self.sub = 1
        if resolution is not None and self.x.shape[1] != resolution:
            self.sub = self.x.shape[1] // resolution

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        s = self.sub
        return {"x": np.asarray(self.x[idx, ::s, ::s]),
                "y": np.asarray(self.y[idx, ::s, ::s])}


# -- the loaders --------------------------------------------------------------

def _generator(generator, seed, device):
    return generator if generator is not None else \
        torch.Generator(device=device).manual_seed(seed)


def _solve_darcy(a: torch.Tensor, f: float = 1.0, n_iter: int = 2000
                 ) -> torch.Tensor:
    """Damped Jacobi sweeps (weight 1/2) of -div(a grad u) = f, u = 0 on
    the boundary, from zero: enough for consistent (a, u) pairs."""
    n = a.shape[-1]
    h2 = (1.0 / (n - 1)) ** 2
    ae = 0.5 * (a + torch.roll(a, -1, -1))
    aw = 0.5 * (a + torch.roll(a, 1, -1))
    an = 0.5 * (a + torch.roll(a, -1, -2))
    asth = 0.5 * (a + torch.roll(a, 1, -2))
    diag = ae + aw + an + asth
    u = torch.zeros_like(a)
    for _ in range(n_iter):
        nbr = (ae * torch.roll(u, -1, -1) + aw * torch.roll(u, 1, -1)
               + an * torch.roll(u, -1, -2) + asth * torch.roll(u, 1, -2))
        u_new = (nbr + f * h2) / diag
        u_new[..., 0, :] = 0
        u_new[..., -1, :] = 0
        u_new[..., :, 0] = 0
        u_new[..., :, -1] = 0
        u = 0.5 * u + 0.5 * u_new
    return u


def darcy_from_field(grf: torch.Tensor):
    """(a, u) from a random field: the permeability 12 where grf >= 0 and
    3 elsewhere (the standard Darcy construction), u its 2000-sweep
    solve."""
    a = torch.where(grf >= 0, 12.0, 3.0).to(grf.dtype)
    return a, _solve_darcy(a)


def _split(x, y, n_train, n_test):
    return (TensorDataset(x[:n_train], y[:n_train]),
            TensorDataset(x[n_train:n_train + n_test],
                          y[n_train:n_train + n_test]))


def load_darcy_flow(path: Optional[str] = None, n_train=100, n_test=20,
                    resolution=32, seed=0, generator=None, device=None):
    """Darcy a -> u (darcy.py:9,61): read from a file with 'coeff' and
    'sol', or generated from random fields (alpha 2, tau 3)."""
    if path is not None and os.path.exists(path):
        reader = MatReader(path)
        a, u = reader.read_field("coeff"), reader.read_field("sol")
    else:
        device = resolve_device(device)
        grf = gaussian_rf_2d(resolution, n_train + n_test, alpha=2.0,
                             tau=3.0, device=device,
                             generator=_generator(generator, seed, device))
        a, u = (t.cpu().numpy() for t in darcy_from_field(grf))
    return _split(a[..., None].astype(np.float32),
                  u[..., None].astype(np.float32), n_train, n_test)


def load_navier_stokes(path: Optional[str] = None, n_train=100, n_test=20,
                       resolution=32, nt=10, seed=0,
                       test_resolutions: Optional[Sequence[int]] = None,
                       generator=None, device=None):
    """NS vorticity w0 -> w(T) (navier_stokes.py:13-147): read from a file
    ('u'), or Kolmogorov-flow trajectories generated by the
    pseudo-spectral solver.  With `test_resolutions`, returns (train,
    {str(r): TensorDataset}), the test set subsampled to each."""
    if path is not None and os.path.exists(path):
        w = MatReader(path).read_field("u")
    else:
        device = resolve_device(device)
        w0 = gaussian_rf_2d(resolution, n_train + n_test, device=device,
                            generator=_generator(generator, seed, device))
        w = kolmogorov_from_field(w0, nt).cpu().numpy()
    train, test = _split(w[..., :1], w[..., -1:], n_train, n_test)
    if test_resolutions is None:
        return train, test
    full = test.x.shape[1]
    return train, {str(r): TensorDataset(
        test.x[:, ::max(1, full // r), ::max(1, full // r)],
        test.y[:, ::max(1, full // r), ::max(1, full // r)])
        for r in test_resolutions}


def _burgers_rollout(u0: torch.Tensor, visc: float, t_total: float,
                     n_steps: int = 500) -> torch.Tensor:
    """Explicit Euler on u_t = -u u_x + visc u_xx, derivatives spectral,
    on [0, 2 pi)."""
    n = u0.shape[-1]
    k = torch.fft.fftfreq(n, d=1.0 / n, dtype=u0.dtype,
                          device=u0.device) * 2 * np.pi
    dt = t_total / n_steps
    u = u0
    for _ in range(n_steps):
        u_h = torch.fft.fft(u)
        ux = torch.fft.ifft(1j * k * u_h).real
        uxx = torch.fft.ifft(-(k ** 2) * u_h).real
        u = u + dt * (-u * ux + visc * uxx)
    return u


def burgers_from_field(u0: torch.Tensor, visc: float = 0.01,
                       t_total: float = 0.5) -> torch.Tensor:
    """u(T) from u0 (N, n) by `_burgers_rollout`."""
    return _burgers_rollout(u0, visc, t_total)


def load_burgers(path: Optional[str] = None, n_train=100, n_test=20,
                 resolution=128, seed=0, visc=0.01, generator=None,
                 device=None):
    """Burgers u0 -> u(T) (burgers.py:4): read from a file ('input',
    'output'), or u0 a row of a 2-D random field, u(T) its spectral
    rollout to T = 0.5."""
    if path is not None and os.path.exists(path):
        reader = MatReader(path)
        u0 = reader.read_field("input")
        uT = reader.read_field("output")[:, -1]
    else:
        device = resolve_device(device)
        u0 = gaussian_rf_2d(resolution, n_train + n_test, device=device,
                            generator=_generator(generator, seed,
                                                 device))[:, :, 0]
        uT = burgers_from_field(u0, visc).cpu().numpy()
        u0 = u0.cpu().numpy()
    return _split(u0[..., None], uT[..., None], n_train, n_test)


def load_spherical_swe(n_train=20, n_test=4, nlat=32, nlon=64, nt=5,
                       seed=0, device=None):
    """A spherical shallow-water set generated on the fly (spherical_swe.py
    :7,27; the reference wraps torch_harmonics' solver): random
    band-limited heights (numpy's default_rng(seed)) and the same after
    each degree l turns by cos(sqrt(l (l + 1))), through `ops.sht.irsht`
    from the spectra's float32 parts."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    lmax = nlat // 2
    flm = (rng.normal(size=(n, lmax, lmax, 1))
           + 1j * rng.normal(size=(n, lmax, lmax, 1)))
    ls = np.arange(lmax)
    for l in range(lmax):
        flm[:, l, l + 1:, :] = 0
    flm[:, :, 0, :] = flm[:, :, 0, :].real
    flm = flm * (1.0 / (1 + ls[:, None] ** 2))[None, :, :, None]

    def synth(spec):
        parts = [torch.as_tensor(a.astype(np.float32), device=device)
                 for a in (spec.real, spec.imag)]
        return irsht(torch.complex(*parts), nlat, nlon).cpu().numpy()

    x = synth(flm)
    y = synth(flm * np.cos(np.sqrt(ls * (ls + 1.0)))[None, :, None, None])
    return _split(x, y, n_train, n_test)
