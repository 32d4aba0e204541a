"""DINo training entry of the port.

Counterpart of the repository's `train_dino.py` (reference: train_dino.py,
its getopt CLI `-d dataset -r subsampling`): trains the INR decoder and
the latent dynamics on trajectories generated on the fly (Navier-Stokes
vorticity, waves, or the spherical shallow water with xyz coordinates and
two state channels), reports the forecast MSE on the first 8, and writes
`{"dec", "dyn", "states_params"}` as a flax `.msgpack`
(`training.checkpoint.save_msgpack`, the decoder's and the dynamics'
parameters in the flax layout), which the JAX `test_dino.py` reads as it
reads its own.

    python -m pde_policylearning_torch.train_dino -d navier -r 1.0 \\
        [--epochs N] [--device cpu]

The data, the mask, the initial parameters and the permutations come from
one `torch.Generator` seeded `--seed`, on the run's device (the card
unless `--device` names another).
"""
from __future__ import annotations

import argparse

import torch

from .data.dino_datasets import (ShallowWaterDataset, generate_mask,
                                 generate_navier_stokes_data,
                                 generate_wave_data)
from .models.dino import Decoder, Derivative
from .training.checkpoint import save_msgpack
from .training.dino_train import eval_dino, train_dino
from .utils.device import resolve_device, set_solver_precision
from .utils.transplant import jax_params


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-d", "--dataset", default="navier",
                        choices=["navier", "wave", "shallow_water"])
    parser.add_argument("-r", "--subsampling", type=float, default=1.0,
                        help="fraction of grid points observed")
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--n_traj", type=int, default=64)
    parser.add_argument("--size", type=int, default=32)
    parser.add_argument("--n_frames", type=int, default=10)
    parser.add_argument("--code_dim", type=int, default=50)
    parser.add_argument("--hidden_c", type=int, default=64)
    parser.add_argument("--hidden_c_dyn", type=int, default=512)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="./outputs/dino.msgpack")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    return parser.parse_args(argv)


def make_data(args, generator, device):
    """(data (N, T, H, W, S), coords or None, state channels)."""
    if args.dataset in ("navier", "wave"):
        generate = generate_navier_stokes_data if args.dataset == "navier" \
            else generate_wave_data
        return generate(args.n_traj, args.size, args.n_frames,
                        generator=generator, device=device), None, 1
    ds = ShallowWaterDataset(args.n_traj, args.n_frames, nlat=args.size,
                             nlon=2 * args.size, device=device)
    data, coords = ds.arrays(device)
    return data, coords, 2


def main(argv=None):
    """The script's run.  Returns a dict: the trained `dec` and `dyn`, the
    `states`, the training `history`, the `eval` result, the `data`,
    `coords`, `t_grid` and `mask` it used, and the `checkpoint` path."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_solver_precision()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    data, coords, state_c = make_data(args, gen, device)
    t_grid = torch.linspace(0, 1.0, args.n_frames, device=device)
    mask = generate_mask(data.shape[2], data.shape[3],
                         max(0.0, 1.0 - args.subsampling), gen, device)

    dec = Decoder(state_c=state_c, hidden_c=args.hidden_c,
                  code_c=args.code_dim,
                  coord_dim=2 if coords is None else coords.shape[-1],
                  generator=gen, device=device)
    dyn = Derivative(state_c=state_c, code_c=args.code_dim,
                     hidden_c=args.hidden_c_dyn, generator=gen, device=device)
    states, hist = train_dino(
        dec, dyn, data, t_grid, code_dim=args.code_dim, state_dim=state_c,
        n_epochs=args.epochs, lr=args.lr, mask=mask, generator=gen,
        coords=coords)

    result = eval_dino(dec, dyn, data[:8], t_grid, code_dim=args.code_dim,
                       state_dim=state_c, n_cond_frames=1, coords=coords)
    print(f"eval: mse {result['mse']:.3e} in-t {result['mse_in_t']:.3e} "
          f"out-t {result['mse_out_t']:.3e}")
    save_msgpack(args.out, {"dec": jax_params(dec)[0],
                            "dyn": jax_params(dyn)[0],
                            "states_params": states})
    print(f"saved {args.out}")
    return {"dec": dec, "dyn": dyn, "states": states, "history": hist,
            "eval": result, "data": data, "coords": coords,
            "t_grid": t_grid, "mask": mask, "checkpoint": args.out}


if __name__ == "__main__":
    main()
