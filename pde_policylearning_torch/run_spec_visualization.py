"""Energy spectra of an observer's predictions against the ground truth.

Counterpart of the repository's `run_spec_visualization.py` (reference:
run_spec_visualization.py, which imports a missing `utilities4`): the
radial energy spectra of a channel dataset's decoded V planes and, given a
checkpoint of `FNO2dObserver` (the port's `.pt` or the JAX package's
`.msgpack`, `training.checkpoint.load_checkpoint`), of its predictions,
averaged over the samples and plotted on log-log axes.  Where matplotlib
fails, the spectra go to an `.npz` beside the requested image, as the
repository's script does.

    python -m pde_policylearning_torch.run_spec_visualization \\
        --data_folder ./data/... [--ckpt outputs/model.msgpack --modes 12 \\
        --width 32] [--out spectra.png] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .data.channel import PDEDataset
from .models.observers import FNO2dObserver
from .training.checkpoint import load_checkpoint
from .utils.device import resolve_device
from .utils.misc import spectrum2


def main(argv=None):
    """The script's run; returns the curves {name: mean spectrum}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_folder", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--modes", type=int, default=12)
    parser.add_argument("--width", type=int, default=32)
    parser.add_argument("--x_range", type=int, default=32)
    parser.add_argument("--y_range", type=int, default=32)
    parser.add_argument("--n_samples", type=int, default=64)
    parser.add_argument("--out", default="./outputs/spectra.png")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    total = len([f for f in os.listdir(args.data_folder)
                 if f.startswith("P_plane")])
    idx = np.arange(min(args.n_samples, total))
    ds = PDEDataset.from_folder(args.data_folder, idx, x_range=args.x_range,
                                y_range=args.y_range, device=device)
    x, y = ds.arrays()

    def curve(v):
        return spectrum2(ds.v_norm.decode(v)).mean(0).cpu().numpy()

    curves = {"ground truth": curve(y[..., 0])}
    if args.ckpt:
        model = FNO2dObserver(args.modes, args.modes, args.width,
                              device=device)
        load_checkpoint(args.ckpt, model)
        with torch.no_grad():
            curves["prediction"] = curve(model(x)[..., 0])

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(5, 4), dpi=100)
        for name, spec in curves.items():
            k = np.arange(1, len(spec) // 2)
            ax.loglog(k, spec[1:len(spec) // 2], label=name)
        ax.set_xlabel("wavenumber")
        ax.set_ylabel("E(k)")
        ax.legend()
        fig.savefig(args.out, bbox_inches="tight")
        plt.close(fig)
        print(f"saved {args.out}")
    except Exception as e:
        out_npz = args.out.rsplit(".", 1)[0] + ".npz"
        np.savez(out_npz, **curves)
        print(f"matplotlib unavailable ({e}); saved raw spectra {out_npz}")
    return curves


if __name__ == "__main__":
    main()
