"""Learn PDE-backstepping gain kernels beta -> k with a DeepONet, in the
port.

Counterpart of the repository's `run_learning_beta_to_k.py` (reference:
run_learning_beta_to_k.ipynb, deepxde's DeepONetCartesianProd on (beta,
k) pairs of the reaction-diffusion backstepping problem
u_t = u_xx + beta u).  For a constant beta = lambda the kernel has the
closed form (Krstic & Smyshlyaev, 2008)

    k(x, y) = -lambda * y * I1(z) / z,   z = sqrt(lambda (x^2 - y^2))

on the triangle 0 <= y <= x <= 1.  The data are numpy float64 from
`default_rng(0)`, then float32 on the device; the DeepONet is (128, 128,
latent) on both sides, trained by Adam at 1e-3 (torch's and optax's Adam
share eps = 1e-8) on the whole training set each iteration.  The host
reads the loss only at the five prints.

    python -m pde_policylearning_torch.run_learning_beta_to_k \\
        [--iters 2000] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .models.deeponet import DeepONetCartesianProd
from .utils.device import resolve_device, set_solver_precision


def bessel_i1_over_z(z):
    """I1(z)/z by its power series (converges fast for z < ~30)."""
    z = np.asarray(z, np.float64)
    out = np.zeros_like(z)
    term = np.ones_like(z) * 0.5   # m = 0 term of I1(z)/z = 1/2 sum ...
    out += term
    z2 = (z / 2) ** 2
    for m in range(1, 25):
        term = term * z2 / (m * (m + 1))
        out += term
    return out


def backstepping_kernel(lam, X, Y):
    """k(x, y) for constant beta = lam on the grid."""
    arg = lam * (X ** 2 - Y ** 2)
    z = np.sqrt(np.clip(arg, 0, None))
    return -lam * Y * bessel_i1_over_z(z)


def make_dataset(n_samples, n_grid, rng):
    """(betas (n, n_grid), coords (N_pts, 2), ks (n, N_pts)) float64
    numpy: random lambdas, their constant sensor values and their kernels
    on the triangle of an n_grid x n_grid grid."""
    lams = rng.uniform(1.0, 15.0, n_samples)
    xs = np.linspace(0, 1, n_grid)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    tri = Y <= X
    coords = np.stack([X[tri], Y[tri]], axis=-1)
    betas = np.repeat(lams[:, None], n_grid, axis=1)
    ks = np.stack([backstepping_kernel(l, X, Y)[tri] for l in lams])
    return betas, coords, ks


def train_step(model, opt, b, coords, k):
    """One Adam step on the mean squared error; returns the loss (a 0-d
    tensor, before the step)."""
    opt.zero_grad(set_to_none=True)
    loss = torch.mean((model(b, coords) - k) ** 2)
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv=None, device=None):
    """The script's run.  Returns (model, history), history a list of
    (iteration, train MSE, test rel-L2) at the five prints."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=2000)
    parser.add_argument("--n_train", type=int, default=200)
    parser.add_argument("--n_test", type=int, default=40)
    parser.add_argument("--n_grid", type=int, default=24)
    parser.add_argument("--latent", type=int, default=64)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device(device if device is not None else args.device)
    set_solver_precision()

    rng = np.random.default_rng(0)
    z = dict(dtype=torch.float32, device=device)
    b_tr, coords, k_tr = (torch.tensor(a, **z) for a in
                          make_dataset(args.n_train, args.n_grid, rng))
    b_ts, _, k_ts = (torch.tensor(a, **z) for a in
                     make_dataset(args.n_test, args.n_grid, rng))

    gen = torch.Generator(device=device).manual_seed(0)
    model = DeepONetCartesianProd(
        args.n_grid, 2, branch_layers=(128, 128, args.latent),
        trunk_layers=(128, 128, args.latent), generator=gen, **z)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    history = []
    for i in range(args.iters):
        loss = train_step(model, opt, b_tr, coords, k_tr)
        if (i + 1) % max(1, args.iters // 5) == 0:
            with torch.no_grad():
                pred = model(b_ts, coords)
                rel = torch.linalg.norm(pred - k_ts) / torch.linalg.norm(k_ts)
            mse, rel = (float(a) for a in torch.stack([loss, rel]).cpu())
            history.append((i + 1, mse, rel))
            print(f"iter {i + 1}: train MSE {mse:.4e}, test rel-L2 {rel:.4f}",
                  flush=True)
    return model, history


if __name__ == "__main__":
    main()
