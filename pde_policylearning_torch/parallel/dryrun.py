"""Dry run of the parallel layer on N ranks.

    python -m pde_policylearning_torch.parallel.dryrun --devices N [--device cpu]

The four parts of the JAX package's `__graft_entry__.py:dryrun_multichip`,
at its shapes, from seeded draws: the data x model parallel training step
of an FNO on multigrid patches (model size 2 when N is even, the patch
batch scattered over it, one Adam step); one x-sharded DNS step on
16x9x8; a data-parallel rollout of N envs for 2 steps; one data-parallel
Adam step of a small PINO.  Each loss and field must come out finite and
the same on every rank; the patched loss within 1e-5 of the same loss
computed unsharded on one rank (0 on gloo ranks), and the sharded step's
fields within 1e-5 of `channel_flow._rk3_step_unfused` on the whole state
(its mass flow is float32, the sharded step's float64: ~1e-7 in U; on
the card its solve is the Poisson kernel).  On the card the
ranks take one card each over NCCL (N at most the card count; 1 on a
one-card machine); with --device cpu, N gloo ranks.  Prints
one JSON line of what rank 0 saw.
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from ..envs import channel_flow as cf
from ..models import FNO, PINObserver2d
from .launch import run_ranks
from .mesh import (DATA_AXIS, all_reduce_gradients, make_mesh, ordered_sum,
                   replicate, shard_batch)
from .patching import MultigridPatching2D
from .sharded_env import (data_parallel_rollout, gather_x,
                          shard_env_state, sharded_step)


def patched_step(model, optimizer, patcher, mesh, x, y):
    """One optimizer step of the patched training on this data rank's
    block (x, y) (B, H, W, C): patch, forward on this model rank's block
    of patches, gather, unpatch, the mean squared error, the gradients
    all-reduced (`all_reduce_gradients`), the update.  Returns the loss of
    the global batch (the same bits on every rank); the reduced gradients
    stay in `.grad`."""
    optimizer.zero_grad(set_to_none=True)
    px, _ = patcher.patch(x, y)
    sx, sy = patcher.unpatch(model(px), y)
    loss = torch.mean((sx - sy) ** 2)
    loss.backward()
    all_reduce_gradients(mesh, [p for p in model.parameters()],
                         patcher.model_split)
    optimizer.step()
    return ordered_sum(mesh, loss.detach(), DATA_AXIS) / mesh.dp


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _finite(name, *tensors):
    for t in tensors:
        if not torch.isfinite(t).all():
            raise AssertionError(f"dry run: {name} is not finite")


def dryrun_rank(rank: int, world: int):
    """The four parts on this rank; returns what it saw."""
    mp = 2 if world % 2 == 0 else 1
    mesh = make_mesh(model_parallel_size=mp)
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(0)
    out = dict(world=world, dp=mesh.dp, mp=mp, backend=mesh.backend,
               device=str(dev))

    # data x model parallel patched FNO step
    patcher = MultigridPatching2D(levels=1, padding_fraction=0.25, mesh=mesh,
                                  stitching=True)
    B, H, W = 2 * mesh.dp, 8, 8
    x = torch.randn((B, H, W, 1), generator=gen, device=dev)
    y = torch.randn((B, H, W, 1), generator=gen, device=dev)
    model = FNO(n_modes=(3, 3), hidden_channels=8, in_channels=2,
                out_channels=1, n_layers=2, lifting_channels=8,
                projection_channels=8, generator=gen, device=dev)
    replicate(mesh, model)
    with torch.no_grad():   # the same loss unsharded, on this rank alone
        whole = MultigridPatching2D(levels=1, padding_fraction=0.25)
        px, _ = whole.patch(x, y)
        sx, sy = whole.unpatch(model(px), y)
        ref = torch.mean((sx - sy) ** 2)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss = patched_step(model, opt, patcher, mesh, *shard_batch(mesh, x, y))
    _finite("the patched FNO step's loss", loss)
    out["fno_loss"] = float(loss)
    out["fno_loss_err"] = float(abs(loss - ref) / ref)

    # x-sharded DNS step
    grid = cf.make_channel_grid(Nx=16, Ny=9, Nz=8, device=dev)
    st = cf.init_state(grid, generator=gen, noise=0.01)
    z = torch.zeros((16, 8), device=dev)
    st2 = sharded_step(mesh, grid, shard_env_state(mesh, st), z, z)
    _finite("the x-sharded step", st2.U, st2.V, st2.W, st2.dPdx)
    out["sharded_dPdx"] = float(st2.dPdx)
    ref = cf._rk3_step_unfused(grid, st, z, z)
    out["sharded_err"] = {k: _rel(gather_x(mesh, getattr(st2, k)),
                                  getattr(ref, k)) for k in "UVW"}

    # data-parallel rollout, world envs over 'data'
    sts = cf.init_batched_states(grid, world, gen, noise=0.01)
    _, traj = data_parallel_rollout(mesh, grid, sts, 2, detect_plane=4)
    _finite("the data-parallel rollout", *traj)
    out["rollout_envs_here"] = int(traj[0].shape[0])

    # PINO data-parallel step: the batch over 'data', parameters replicated
    S, T, Bp = 8, 5, world
    pino = PINObserver2d(modes1=[2, 2], modes2=[2, 2], modes3=[2, 2],
                         width=4, layers=[4, 4], fc_dim=8, generator=gen,
                         device=dev)
    a = torch.randn((Bp, S, S, T, 4), generator=gen, device=dev)
    u = torch.randn((Bp, S, S, T), generator=gen, device=dev)
    re = torch.full((Bp,), 100.0, device=dev)
    replicate(mesh, pino)
    popt = torch.optim.Adam(pino.parameters(), lr=1e-3)
    a, u, re = shard_batch(mesh, a, u, re)
    popt.zero_grad(set_to_none=True)
    ploss = torch.mean((pino(a, re).squeeze(-1) - u) ** 2)
    ploss.backward()
    all_reduce_gradients(mesh, list(pino.parameters()))
    popt.step()
    ploss = ordered_sum(mesh, ploss.detach(), DATA_AXIS) / mesh.dp
    _finite("the PINO step's loss", ploss)
    out["pino_loss"] = float(ploss)
    return out


def dryrun(n_devices: int, device: str = "cuda", timeout: float = 300.0):
    """The dry run on n_devices ranks; returns each rank's report, raising
    where the ranks disagree or a part is off its unsharded value."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun: no CUDA card; pass --device cpu for "
                           "gloo ranks on the CPU")
    reports = run_ranks(dryrun_rank, n_devices, device, timeout=timeout)
    for k in ("fno_loss", "sharded_dPdx", "pino_loss"):
        if len({r[k] for r in reports}) != 1 or not math.isfinite(
                reports[0][k]):
            raise AssertionError(f"dry run: {k} differs between ranks or is "
                                 f"not finite: {[r[k] for r in reports]}")
    worst = max(max(r["fno_loss_err"], *r["sharded_err"].values())
                for r in reports)
    if not worst <= 1e-5:
        raise AssertionError(f"dry run: {worst:.3e} from the unsharded "
                             f"computation: {reports}")
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks (default: the card count, or 4 on the CPU)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    n = args.devices or (torch.cuda.device_count() if args.device == "cuda"
                         else 4)
    print(json.dumps(dryrun(n, args.device)[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
