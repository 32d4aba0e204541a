"""Channel-flow plane datasets in the reference's on-disk format: one .npy
per step (P_planes_<i>.npy, V_planes_<i>.npy, optionally U/V/W_field_<i>.npy)
and a metadata.npy dict of mean/std, Re and the dPdx history.

Counterpart of `pde_policylearning_tpu/data/channel.py` for
`generate_channel_dataset`, which writes that format by rolling out the
port's env (replacing the reference's collection loop,
run_control.py:236-293), and for `PDEDataset`, which reads it back with
its normalizers.  The sequence and full-field datasets and the batch
loader come with the observer-training slice.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.normalization import NormalizerGivenMeanStd
from ..utils.device import resolve_device


def _load_sorted(folder, tag):
    return [os.path.join(folder, f)
            for f in sorted(f for f in os.listdir(folder) if tag in f)]


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
            return NormalizerGivenMeanStd(*(
                torch.as_tensor(ds_stat(np.asarray(meta[name][k]))).to(
                    device, dtype) for k in ("mean", "std")))

        p = np.stack([ds(np.load(p_files[i])) for i in data_index])
        v = np.stack([ds(np.load(v_files[i])) for i in data_index])
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
