"""PINO datasets: Kolmogorov flow (one or several Reynolds numbers),
Burgers, Darcy.

Counterpart of `pde_policylearning_tpu/data/pino_datasets.py` (reference:
libs/pino_utils/datasets.py (KFDataset:448, MultipleReynoldsKFaDataset:548,
BurgersLoader:213, DarcyFlow:296), get_grid3d of utils.py:72-124).  The
arrays stay in numpy on the host until `arrays()` hands them to the
device.  Missing Kolmogorov-flow archives are generated by the
pseudo-spectral solver of `synthetic.py`.
"""
from __future__ import annotations

import os
import re as _re
import tempfile
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device


def get_grid3d(S: int, T: int, time_scale: float = 1.0):
    """(1, S, S, T, 1) coordinate grids x, y, t (pino_utils/utils.py:
    72-124)."""
    gridx = np.linspace(0, 1, S + 1)[:-1].reshape(1, S, 1, 1, 1)
    gridy = np.linspace(0, 1, S + 1)[:-1].reshape(1, 1, S, 1, 1)
    gridt = np.linspace(0, 1 * time_scale, T).reshape(1, 1, 1, T, 1)
    shape = (1, S, S, T, 1)
    return (np.broadcast_to(gridx, shape), np.broadcast_to(gridy, shape),
            np.broadcast_to(gridt, shape))


def _partition_time(data: np.ndarray, t_duration: float):
    """Split trajectories (N, T, S, S) into K = 1 / t_duration overlapping
    chunks (datasets.py:513-529) -> (N * K, step + 1, S, S), K."""
    N, T, S = data.shape[:3]
    K = int(1 / t_duration)
    step = (T - 1) // K
    chunks = [data[:, j * step:(j + 1) * step + 1] for j in range(K)]
    out = np.stack(chunks, axis=1).reshape(N * K, step + 1, S, S)
    return out, K


@dataclass
class KFDataset:
    """Kolmogorov-flow trajectories: u (N, S, S, T) and the conditioning
    input a (N, S, S, T, 4) = (x, y, t, w0); re (N,) where known."""
    u: np.ndarray
    a: np.ndarray
    re: Optional[np.ndarray] = None

    @classmethod
    def from_file(cls, paths: Sequence[str], data_res, pde_res, raw_res,
                  n_samples=None, offset=0, t_duration=1.0,
                  total_samples=None, idx=0, with_re=False):
        """Read a (N, T, S, S) `.npy` archive (the Reynolds number from
        `Re<n>` in its name, 40 otherwise) or a multi-Reynolds `.npz`
        (`data1`, `data2`), subsampled to `data_res` and `pde_res`."""
        path = paths[0] if isinstance(paths, (list, tuple)) else paths
        re_arr = None
        if path.endswith(".npz") or "multi_reynolds" in path:
            loaded = np.load(path)
            raw, re_arr = loaded["data1"], loaded["data2"]
        else:
            raw = np.load(path, mmap_mode="r")
            if with_re:
                m = _re.search(r"Re(\d+)", path)
                re_val = int(m.group(1)) if m else 40
                re_arr = np.full((raw.shape[0],), float(re_val))
        n_samples = n_samples or raw.shape[0]
        sub_x = raw_res[0] // data_res[0]
        sub_t = (raw_res[2] - 1) // (data_res[2] - 1)
        a_sub_x = raw_res[0] // pde_res[0]
        data = np.asarray(raw[offset:offset + n_samples, ::sub_t,
                              ::sub_x, ::sub_x])
        T = pde_res[2] if t_duration == 1.0 else \
            int(pde_res[2] * t_duration) + 1
        if t_duration != 0.0:
            end_t = raw_res[2] - 1
            K = int(1 / t_duration)
            step = end_t // K
            data, K = _partition_time(data, t_duration)
            a0 = np.asarray(raw[offset:offset + n_samples, 0:end_t:step,
                                ::a_sub_x, ::a_sub_x])
            a0 = a0.reshape(n_samples * K, 1, pde_res[0], pde_res[1])
            if re_arr is not None:
                re_arr = np.repeat(re_arr[:n_samples], K)
        else:
            a0 = np.asarray(raw[offset:offset + n_samples, 0:1,
                                ::a_sub_x, ::a_sub_x])
        u = np.transpose(data, (0, 2, 3, 1)).astype(np.float32)
        a0 = np.transpose(a0, (0, 2, 3, 1))[..., None]  # (N, S, S, 1, 1)
        S = pde_res[1]
        gx, gy, gt = get_grid3d(S, T)
        grid = np.concatenate([gx[0], gy[0], gt[0]], axis=-1)  # (S, S, T, 3)
        a = np.concatenate(
            [np.broadcast_to(grid[None], (len(u), S, S, T, 3)),
             np.broadcast_to(a0, (len(u), S, S, T, 1))],
            axis=-1).astype(np.float32)
        if total_samples is not None:
            u = u[idx:idx + total_samples]
            a = a[idx:idx + total_samples]
            if re_arr is not None:
                re_arr = re_arr[idx:idx + total_samples]
        return cls(u=u, a=a, re=re_arr)

    @classmethod
    def generate(cls, n_traj: int, S: int, T: int, re: float = 40.0,
                 t_interval: float = 1.0, with_re=True, save_path=None,
                 seed: int = 0, device=None):
        """Generate `n_traj` trajectories with the pseudo-spectral solver
        on `device` (None: the card), in chunks of at most 8 (at 128x128x65
        a rollout keeps every substep's spectra), all from one generator
        seeded with `seed`; save them as (N, T, S, S) to `save_path` (the
        temporary directory by default) and read them back."""
        from .synthetic import generate_kolmogorov_data
        device = resolve_device(device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        chunks = []
        for i in range(0, n_traj, 8):
            chunks.append(generate_kolmogorov_data(
                min(8, n_traj - i), S, T, visc=1.0 / re,
                t_interval=t_interval, generator=generator,
                device=device).cpu().numpy())
        traj = np.transpose(np.concatenate(chunks, axis=0), (0, 3, 1, 2))
        path = save_path or os.path.join(
            tempfile.gettempdir(), f"kf_Re{int(re)}_{n_traj}x{S}x{T}.npy")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.save(path, traj)
        return cls.from_file([path], (S, S, T), (S, S, T), (S, S, T),
                             n_samples=n_traj, with_re=with_re)

    def __len__(self):
        return len(self.u)

    def arrays(self, dtype=torch.float32, device=None):
        """(u, a[, re]) as tensors on `device` (None: the card)."""
        device = resolve_device(device)
        out = [torch.as_tensor(x).to(device=device, dtype=dtype)
               for x in (self.u, self.a)]
        if self.re is not None:
            out.append(torch.as_tensor(self.re).to(device=device,
                                                   dtype=dtype))
        return tuple(out)


MultipleReynoldsKFaDataset = KFDataset  # with_re=True (datasets.py:548)


@dataclass
class BurgersDataset:
    """Burgers (u0 -> trajectory) loader (datasets.py:213)."""
    u0: np.ndarray   # (N, nx)
    u: np.ndarray    # (N, nt, nx)
    v: float = 1.0 / 100

    @classmethod
    def from_mat(cls, path, nx=128, nt=100, sub=1, sub_t=1, n=None):
        from scipy.io import loadmat
        raw = loadmat(path)
        u0 = raw["input"][:, ::sub]
        u = raw["output"][:, ::sub_t, ::sub]
        if n is not None:
            u0, u = u0[:n], u[:n]
        return cls(u0=u0.astype(np.float32), u=u.astype(np.float32))

    def arrays(self, dtype=torch.float32, device=None):
        device = resolve_device(device)
        return tuple(torch.as_tensor(x).to(device=device, dtype=dtype)
                     for x in (self.u0, self.u))


@dataclass
class DarcyDataset:
    """Darcy flow (a -> u) loader (datasets.py:296)."""
    a: np.ndarray
    u: np.ndarray

    @classmethod
    def from_mat(cls, path, sub=1, n=None):
        from scipy.io import loadmat
        raw = loadmat(path)
        a = raw["coeff"][:, ::sub, ::sub]
        u = raw["sol"][:, ::sub, ::sub]
        if n is not None:
            a, u = a[:n], u[:n]
        return cls(a=a.astype(np.float32), u=u.astype(np.float32))

    def arrays(self, dtype=torch.float32, device=None):
        device = resolve_device(device)
        return tuple(torch.as_tensor(x).to(device=device, dtype=dtype)
                     for x in (self.a, self.u))
