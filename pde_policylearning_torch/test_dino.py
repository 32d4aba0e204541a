"""DINo evaluation entry of the port.

Counterpart of the repository's `test_dino.py` (reference: test_dino.py):
reads a DINo checkpoint `{"dec", "dyn", "states_params"}` written by
`train_dino` of either package (a flax `.msgpack`, through
`training.checkpoint.load_msgpack` and `utils.transplant.load_jax_params`)
and runs the test-time latent adaptation and forecast on fresh
trajectories drawn from a generator seeded `--seed`.

    python -m pde_policylearning_torch.test_dino -d navier \\
        --ckpt outputs/dino.msgpack [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from .data.dino_datasets import generate_navier_stokes_data, \
    generate_wave_data
from .models.dino import Decoder, Derivative
from .training.checkpoint import load_msgpack
from .training.dino_train import eval_dino
from .utils.device import resolve_device, set_solver_precision
from .utils.transplant import load_jax_params


def main(argv=None):
    """The script's run; returns `eval_dino`'s result."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-d", "--dataset", default="navier",
                        choices=["navier", "wave"])
    parser.add_argument("--ckpt", default="./outputs/dino.msgpack")
    parser.add_argument("--n_traj", type=int, default=8)
    parser.add_argument("--size", type=int, default=32)
    parser.add_argument("--n_frames", type=int, default=10)
    parser.add_argument("--code_dim", type=int, default=50)
    parser.add_argument("--hidden_c", type=int, default=64)
    parser.add_argument("--hidden_c_dyn", type=int, default=512)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    set_solver_precision()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    generate = generate_navier_stokes_data if args.dataset == "navier" \
        else generate_wave_data
    data = generate(args.n_traj, args.size, args.n_frames, generator=gen,
                    device=device)
    t_grid = torch.linspace(0, 1.0, args.n_frames, device=device)

    dec = Decoder(state_c=1, hidden_c=args.hidden_c, code_c=args.code_dim,
                  coord_dim=2, device=device)
    dyn = Derivative(state_c=1, code_c=args.code_dim,
                     hidden_c=args.hidden_c_dyn, device=device)
    ckpt = load_msgpack(args.ckpt)
    load_jax_params(dec, ckpt["dec"])
    load_jax_params(dyn, ckpt["dyn"])
    res = eval_dino(dec, dyn, data, t_grid, code_dim=args.code_dim,
                    n_cond_frames=1)
    print(f"test: mse {res['mse']:.3e} in-t {res['mse_in_t']:.3e} "
          f"out-t {res['mse_out_t']:.3e}")
    return res


if __name__ == "__main__":
    main()
