"""Channel-flow plane datasets in the reference's on-disk format: one .npy
per step (P_planes_<i>.npy, V_planes_<i>.npy, optionally U/V/W_field_<i>.npy)
and a metadata.npy dict of mean/std, Re and the dPdx history.

Counterpart of `pde_policylearning_tpu/data/channel.py`:
`generate_channel_dataset` writes that format by rolling out the port's
env (replacing the reference's collection loop, run_control.py:236-293);
`PDEDataset`, `SequentialPDEDataset` and `FullFieldNSDataset` read it back
with their normalizers (pde_data_loader.py:8, :72, :135), each split
stacked into arrays at once through the parallel .npy loader
(`native/loader.py`); `batch_arrays` cuts arrays into batches.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..native.loader import load_npy_batch
from ..ops.normalization import NormalizerGivenMeanStd
from ..utils.device import resolve_device


def _load_sorted(folder, tag):
    return [os.path.join(folder, f)
            for f in sorted(f for f in os.listdir(folder) if tag in f)]


def _stack(files, indices):
    """The files `indices` as one (N, ...) array, read in parallel."""
    return load_npy_batch([files[i] for i in indices])


def _normalizer(mean, std, device, dtype):
    return NormalizerGivenMeanStd(*(torch.as_tensor(np.asarray(a)).to(
        device, dtype) for a in (mean, std)))


@dataclass
class PDEDataset:
    """(p_plane, v_plane) pairs as host arrays (N, H, W) with the
    normalizers of the folder's metadata on `device`
    (pde_data_loader.py:8-69 semantics)."""
    p: np.ndarray
    v: np.ndarray
    p_norm: NormalizerGivenMeanStd
    v_norm: NormalizerGivenMeanStd

    @classmethod
    def from_folder(cls, data_folder, data_index, downsample_rate=1,
                    x_range=32, y_range=32, use_patch=False, device=None,
                    dtype=torch.float32):
        """Load the planes `data_index` of a folder written by
        `generate_channel_dataset` or `save_collected_dataset`.  The
        normalizers' statistics go to `device` (None: the card) in
        `dtype`."""
        device = resolve_device(device)
        meta = np.load(os.path.join(data_folder, "metadata.npy"),
                       allow_pickle=True).tolist()
        if "P_planes" in meta:
            p_name, v_name = "P_planes", "V_planes"
        elif "P_plane" in meta:
            p_name, v_name = "P_plane", "V_plane"
        else:
            raise RuntimeError("Not recognized key name!")
        p_files = _load_sorted(data_folder, p_name)
        v_files = _load_sorted(data_folder, v_name)
        if use_patch:
            # each plane becomes a stack of (x_range, y_range) patches
            # folded into the sample axis; the normalizer statistics are
            # the patch mean (pde_data_loader.py:33-41)
            def ds(a):
                return a.reshape(-1, x_range, y_range)

            def ds_stat(a):
                return ds(a).mean(0)
        else:
            def ds(a):
                return a[::downsample_rate,
                         ::downsample_rate][:x_range, :y_range]
            ds_stat = ds

        def norm(name):
            return _normalizer(*(ds_stat(np.asarray(meta[name][k]))
                                 for k in ("mean", "std")), device, dtype)

        p = np.stack([ds(a) for a in _stack(p_files, data_index)])
        v = np.stack([ds(a) for a in _stack(v_files, data_index)])
        if use_patch:  # fold the patch axis into the sample axis
            p = p.reshape(-1, x_range, y_range)
            v = v.reshape(-1, x_range, y_range)
        return cls(p=p, v=v, p_norm=norm(p_name), v_norm=norm(v_name))

    def __len__(self):
        return len(self.p)

    def arrays(self, dtype=None):
        """The whole split as normalized tensors (N, H, W, 1) on the
        normalizers' device (in their dtype unless `dtype` is given)."""
        dev = self.p_norm.mean.device
        dtype = dtype or self.p_norm.mean.dtype
        p = self.p_norm.encode(torch.as_tensor(self.p).to(dev, dtype))
        v = self.v_norm.encode(torch.as_tensor(self.v).to(dev, dtype))
        return p[..., None], v[..., None]


@dataclass
class SequentialPDEDataset(PDEDataset):
    """Length-`timestep` (p, v) sequences (pde_data_loader.py:72-132): the
    planes in `data_index` order, cut into consecutive runs of
    `timestep`."""
    timestep: int = 2

    @classmethod
    def from_folder(cls, data_folder, data_index, downsample_rate=1,
                    x_range=32, y_range=32, timestep=2, device=None,
                    dtype=torch.float32):
        base = PDEDataset.from_folder(data_folder, data_index,
                                      downsample_rate, x_range, y_range,
                                      device=device, dtype=dtype)
        return cls(p=base.p, v=base.v, p_norm=base.p_norm,
                   v_norm=base.v_norm, timestep=timestep)

    def __len__(self):
        return len(self.p) // self.timestep

    def arrays(self, dtype=None):
        """(N, T, H, W, 1) normalized sequence tensors on the normalizers'
        device; a remainder of fewer than `timestep` planes is dropped."""
        n = len(self) * self.timestep
        p, v = (a[:n] for a in super().arrays(dtype))
        shape = (len(self), self.timestep, *p.shape[1:])
        return p.reshape(shape), v.reshape(shape)


@dataclass
class FullFieldNSDataset:
    """Boundary v-plane -> multi-plane v-field, with the full U/V/W, Re and
    dPdx for the physics-informed loss (pde_data_loader.py:135-198).  The
    arrays stay on the host (numpy); `bound_v_norm` (the V field's
    statistics on its last wall-normal row) lies on `device`."""
    v_plane: np.ndarray   # (N, T, X, Z), normalized
    v_field: np.ndarray   # (N, T, P, X, Z), normalized
    U: np.ndarray
    V: np.ndarray
    W: np.ndarray
    re: float
    dpdx: np.ndarray
    bound_v_norm: NormalizerGivenMeanStd
    p_plane_norm: Optional[NormalizerGivenMeanStd] = None

    @classmethod
    def from_folder(cls, data_folder, data_index, plane_indexs, timestep=1,
                    device=None, dtype=torch.float32, **_):
        device = resolve_device(device)
        meta = np.load(os.path.join(data_folder, "metadata.npy"),
                       allow_pickle=True).tolist()
        u_files, v_files, w_files = (_load_sorted(data_folder, f"{c}_field")
                                     for c in "UVW")
        v_mean = np.asarray(meta["V_field"]["mean"])
        v_std = np.asarray(meta["V_field"]["std"])
        # encoded on the host in the statistics' own precision
        host = _normalizer(v_mean[:, -1, :], v_std[:, -1, :], "cpu",
                           torch.from_numpy(v_mean).dtype)

        def encode(a):
            return host.encode(torch.as_tensor(a)).numpy()

        n_seq = len(data_index) // timestep
        idx = np.asarray(data_index)[:n_seq * timestep].reshape(n_seq,
                                                                timestep)
        V = np.stack([_stack(v_files, row) for row in idx])
        U = np.stack([_stack(u_files, row) for row in idx])
        W = np.stack([_stack(w_files, row) for row in idx])
        v_field = np.stack([encode(V[..., pid, :]) for pid in plane_indexs],
                           axis=2)
        return cls(v_plane=encode(V[..., -1, :]), v_field=v_field, U=U, V=V,
                   W=W, re=float(np.asarray(meta["re"])),
                   dpdx=np.asarray(meta["U_field"]["dpdx"])[idx],
                   bound_v_norm=host.to(device, dtype))

    def __len__(self):
        return len(self.v_plane)


def batch_arrays(arrays, batch_size, generator=None, drop_remainder=True):
    """(N, ...) tensors -> (n_batches, batch_size, ...) tensors, the
    samples first permuted by `generator` (on the tensors' device) where
    one is given; the remainder past the last whole batch is dropped."""
    n = arrays[0].shape[0]
    n_batches = n // batch_size
    if generator is not None:
        perm = torch.randperm(n, generator=generator,
                              device=arrays[0].device)
        arrays = [a[perm] for a in arrays]
    return [a[:n_batches * batch_size].reshape(n_batches, batch_size,
                                               *a.shape[1:])
            for a in arrays]


def generate_channel_dataset(out_folder: str, n_steps: int,
                             env=None, policy: str = "gt",
                             detect_plane: int = 25,
                             save_fields: bool = False,
                             seed: int = 0,
                             env_kwargs: Optional[dict] = None):
    """Roll out the channel env (`channel_flow.rollout`, all steps on the
    env's device, one host copy at the end) and write P_planes_<i>.npy /
    V_planes_<i>.npy (+ U/V/W_field_<i>.npy with `save_fields`) and
    metadata.npy into `out_folder`.  Without `env`, an
    `NSControlEnv(detect_plane, seed, noise_scale=0.05, **env_kwargs)` is
    built; the `rand` policy draws from a generator seeded with `seed`."""
    from ..control.loop import save_collected_dataset
    from ..envs import NSControlEnv
    from ..envs import channel_flow as cf

    os.makedirs(out_folder, exist_ok=True)
    if env is None:
        kw = {"detect_plane": detect_plane, "seed": seed,
              "noise_scale": 0.05}
        kw.update(env_kwargs or {})
        env = NSControlEnv(**kw)
    generator = torch.Generator(device=env.device)
    generator.manual_seed(seed)
    env.state, outs = cf.rollout(
        env.grid, env.state, n_steps, detect_plane=detect_plane,
        policy=policy, generator=generator, collect_fields=save_fields)
    outs = [o.cpu().numpy() for o in outs]
    save_collected_dataset({"p2": outs[0], "v_plane": outs[1]}, out_folder)
    if save_fields:
        meta_path = os.path.join(out_folder, "metadata.npy")
        meta = np.load(meta_path, allow_pickle=True).item()
        for name, a in zip(("U", "V", "W"), outs[3:]):
            for i in range(n_steps):
                np.save(os.path.join(out_folder, f"{name}_field_{i:06d}.npy"),
                        a[i])
            meta[f"{name}_field"] = {"mean": a.mean(0),
                                     "std": a.std(0) + 1e-8}
        meta["U_field"]["dpdx"] = outs[2]
        np.save(meta_path, meta)
    return out_folder
