"""Data preprocessing: .mat to per-field .npy files, energy spectra of a
folder, merging trajectory sets.

Counterpart of `pde_policylearning_tpu/data/preprocess.py` (reference:
libs/mat2npy_minchan.py, libs/parse_npy.py / parse_npy_pino.py,
libs/merge_npy_pino.py).  Host numpy throughout; the spectra go through
`utils.misc.spectrum2` / `spectrum3` on the CPU.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..utils.misc import spectrum2, spectrum3


def mat_to_npy(mat_path: str, out_folder: str,
               fields: Sequence[str] = ("U", "V", "W", "P"),
               re: float = 178.1899):
    """Split a .mat dump into one .npy a step and field, with a
    metadata.npy of each field's mean and std over the steps
    (mat2npy_minchan.py)."""
    import scipy.io
    os.makedirs(out_folder, exist_ok=True)
    data = scipy.io.loadmat(mat_path, mat_dtype=True)
    meta = {"re": re}
    for field in fields:
        if field not in data:
            continue
        arr = np.asarray(data[field])
        for i in range(arr.shape[0]):
            np.save(os.path.join(out_folder, f"{field}_field_{i:06d}.npy"),
                    arr[i])
        meta[f"{field}_field"] = {"mean": arr.mean(0),
                                  "std": arr.std(0) + 1e-8}
    np.save(os.path.join(out_folder, "metadata.npy"), meta)
    return out_folder


def parse_energy_spectra(folder: str, field_tag: str = "V_planes",
                         three_d: bool = False) -> np.ndarray:
    """The radial energy spectrum of every .npy in `folder` whose name
    holds `field_tag`, in name order (parse_npy.py:26)."""
    files = sorted(f for f in os.listdir(folder)
                   if field_tag in f and f.endswith(".npy"))
    fn = spectrum3 if three_d else spectrum2
    spectra = [fn(np.load(os.path.join(folder, f))).numpy() for f in files]
    return np.stack(spectra) if spectra else np.zeros((0,))


def merge_datasets(folders: Sequence[str], out_path: str,
                   res: Sequence[float] = ()):
    """Merge trajectory archives (folders of .npy or .npy files) into one
    multi-Reynolds npz (merge_npy_pino.py): data1 the stacked
    trajectories, data2 each sample's Reynolds number (40 where `res`
    gives none)."""
    datas, res_all = [], []
    for i, folder in enumerate(folders):
        if os.path.isdir(folder):
            files = sorted(f for f in os.listdir(folder)
                           if f.endswith(".npy") and "metadata" not in f)
            arr = np.stack([np.load(os.path.join(folder, f))
                            for f in files])
        else:
            arr = np.load(folder)
        datas.append(arr)
        res_all.append(np.full((len(arr),), res[i] if i < len(res) else 40.0))
    np.savez(out_path, data1=np.concatenate(datas),
             data2=np.concatenate(res_all))
    return out_path
