"""Channel-flow plane datasets in the reference's on-disk format: one .npy
per step (P_planes_<i>.npy, V_planes_<i>.npy, optionally U/V/W_field_<i>.npy)
and a metadata.npy dict of mean/std, Re and the dPdx history.

Counterpart of `pde_policylearning_tpu/data/channel.py` for
`generate_channel_dataset`, which writes that format by rolling out the
port's env (replacing the reference's collection loop,
run_control.py:236-293).  The dataset classes and loaders come with the
observer-training slice.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


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
