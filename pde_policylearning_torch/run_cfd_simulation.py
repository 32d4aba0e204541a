"""Standalone CFD simulation (Chorin projection, 41 x 41) of the port.

Counterpart of the repository's `run_cfd_simulation.py` (reference:
run_cfd_simulation.py:135-345): a forced channel iterated to steady state
with `envs/channel2d.solve`, or a lid-driven cavity.  The cavity takes
`pressure_poisson_periodic`, periodic in x although the cavity is not,
as the JAX script does.  On the card the cavity's steps are captured as
CUDA graphs of `CAVITY_CHUNK` steps each and replayed with no host read
between them.  float64, as the 2-D env.

    python -m pde_policylearning_torch.run_cfd_simulation \\
        [--case channel|cavity] [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from .envs.channel2d import (Channel2DState, build_up_b, capture, host_read,
                             pressure_poisson_periodic, solve)
from .utils.device import resolve_device

CAVITY_CHUNK = 10   # cavity steps a CUDA graph


def run_channel(steps: int, device=None):
    """The channel from u = 1, v = p = 0 at F = 1, dt 0.01, nu 0.1, at most
    `steps` iterations.  Returns (state, bulk velocity, iterations)."""
    z = dict(dtype=torch.float64, device=resolve_device(device))
    state = Channel2DState(u=torch.ones((41, 41), **z),
                           v=torch.zeros((41, 41), **z),
                           p=torch.zeros((41, 41), **z),
                           F=torch.ones((), **z))
    dx = dy = 2.0 / 40
    state, bulk, n = solve(state, None, dx, dy, 0.01, 1.0, 0.1, 1.0,
                           max_step=steps)
    bulk_h, n_h, umax = host_read(torch.stack([
        bulk, n.to(bulk.dtype), state.u.max()]))
    print(f"channel: {int(n_h)} iters, bulk velocity {bulk_h:.4f}, "
          f"u max {umax:.4f}")
    return state, bulk, n


def cavity_step(u, v, p, dx, dy, dt, rho, nu):
    """One step of the lid-driven cavity: u = 1 on the lid, no slip on
    the other walls; (u, v, p) updated in place."""
    u[-1], u[0] = 1.0, 0.0
    u[:, 0], u[:, -1] = 0.0, 0.0
    v[0], v[-1] = 0.0, 0.0
    v[:, 0], v[:, -1] = 0.0, 0.0
    un, vn = u.clone(), v.clone()
    b = build_up_b(rho, dt, dx, dy, u, v)
    p2 = pressure_poisson_periodic(p, dx, dy, b, 50)
    c = (slice(1, -1), slice(1, -1))
    ui = (un[c]
          - un[c] * dt / dx * (un[c] - un[1:-1, :-2])
          - vn[c] * dt / dy * (un[c] - un[:-2, 1:-1])
          - dt / (2 * rho * dx) * (p2[1:-1, 2:] - p2[1:-1, :-2])
          + nu * (dt / dx ** 2 * (un[1:-1, 2:] - 2 * un[c] + un[1:-1, :-2])
                  + dt / dy ** 2 * (un[2:, 1:-1] - 2 * un[c]
                                    + un[:-2, 1:-1])))
    vi = (vn[c]
          - un[c] * dt / dx * (vn[c] - vn[1:-1, :-2])
          - vn[c] * dt / dy * (vn[c] - vn[:-2, 1:-1])
          - dt / (2 * rho * dy) * (p2[2:, 1:-1] - p2[:-2, 1:-1])
          + nu * (dt / dx ** 2 * (vn[1:-1, 2:] - 2 * vn[c] + vn[1:-1, :-2])
                  + dt / dy ** 2 * (vn[2:, 1:-1] - 2 * vn[c]
                                    + vn[:-2, 1:-1])))
    u[c], v[c] = ui, vi
    p.copy_(p2)


def run_cavity(steps: int, device=None):
    """`steps` cavity steps from rest (dt 0.001, nu 0.1).  Returns (u, v,
    p)."""
    chunk = CAVITY_CHUNK
    z = dict(dtype=torch.float64, device=resolve_device(device))
    nx = ny = 41
    dx = dy = 2.0 / (nx - 1)
    consts = (dx, dy, 0.001, 1.0, 0.1)
    u, v, p = (torch.zeros((ny, nx), **z) for _ in range(3))

    def steps_of(k):
        def body():
            for _ in range(k):
                cavity_step(u, v, p, *consts)
        return body

    if u.is_cuda:
        replay = {k: capture(steps_of(k)) for k in {chunk, steps % chunk}
                  if k}
        for t in (u, v, p):
            t.zero_()
        for _ in range(steps // chunk):
            replay[chunk]()
        if steps % chunk:
            replay[steps % chunk]()
    else:
        steps_of(steps)()
    speed_max, p_mean = host_read(torch.stack([
        torch.sqrt(u ** 2 + v ** 2).max(), p.abs().mean()]))
    print(f"cavity: max speed {speed_max:.4f}, mean |div-proxy| "
          f"{p_mean:.4f}")
    return u, v, p


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--case", default="channel",
                        choices=["channel", "cavity"])
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    if args.case == "channel":
        return run_channel(args.steps, args.device)
    return run_cavity(args.steps, args.device)


if __name__ == "__main__":
    main()
