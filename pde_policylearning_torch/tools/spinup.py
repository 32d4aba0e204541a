"""Spin up developed channel turbulence (Re_tau ~ 180) and write the
snapshot, as scripts/spinup_turbulence.py does for the JAX package: trip
transition from the Reichardt profile and streamwise vortices
(`init_turbulent_state`, drawn from a generator seeded by --seed), advance
chunks of --chunk zero-actuation steps (`spinup_chunk`, the staged RK3
kernels on the card; one host read of each chunk's (chunk, 4) statistics),
and stop once the last three chunks' mean wall shear is in the turbulent
band and flat (`verdict`), after MIN_CHUNKS chunks at least and MAX_CHUNKS
at most.  A chunk with a value that is not finite ends the run with exit
code 1.

    python -m pde_policylearning_torch.tools.spinup [--out NPZ] \\
        [--seed 7] [--chunk 20000] [--grid 32 130 32] [--device cuda]

The .npz has the keys, dtypes and shapes of the packaged snapshot (U, V,
W, dPdx, meanU0, nu, steps, history); `drag_rows --init NPZ` and
`NSControlEnv(init_cond_path=NPZ)` start from it.  Prints one JSON
object: the chunks run, the last chunk's tail means (tau_b, tau_t, bulk)
and the target u_tau^2, with whether the rule was met, steps/s and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

import torch

from ..envs import channel_flow as cf
from ..utils import resolve_device, set_solver_precision
from . import card_name

CHUNK = 20_000
MIN_CHUNKS = 10          # >= 200k steps (~11 turnovers) before the test
MAX_CHUNKS = 30          # 600k steps at most
OUT = os.path.join("outputs", "channel180_minchan_spinup.npz")


def verdict(history, nu: float, utau2: float, min_chunks: int = MIN_CHUNKS,
            max_chunks: int = MAX_CHUNKS) -> str:
    """The spin-up's rule on the chunk means so far, (n, 4) rows of
    (tau_b, tau_t, bulk, dPdx) (scripts/spinup_turbulence.py:60-72):
    'converged' once there are `min_chunks` chunks and the last three
    chunks' mean wall shear is in the turbulent band (above twice the
    laminar 3 nu Ub, within 50% of u_tau^2) and flat (each within 15% of
    their mean); else 'capped' at `max_chunks`, else why not yet: 'too few
    chunks', 'out of band' or 'not flat'."""
    h = np.asarray(history, np.float64).reshape(-1, 4)
    if len(h) >= min_chunks:
        taus = h[-3:, :2].mean(axis=1)
        lam = 3 * nu * h[-1, 2]
        in_band = bool(np.all(taus > 2.0 * lam)
                       and np.all(np.abs(taus / utau2 - 1.0) < 0.5))
        flat = bool(np.abs(taus / taus.mean() - 1.0).max() < 0.15)
        if in_band and flat:
            return "converged"
        why = "not flat" if in_band else "out of band"
    else:
        why = "too few chunks"
    return "capped" if len(h) >= max_chunks else why


class Diverged(RuntimeError):
    """A chunk's statistics hold a value that is not finite."""


def spinup(grid, generator: torch.Generator, chunk: int = CHUNK,
           min_chunks: int = MIN_CHUNKS, max_chunks: int = MAX_CHUNKS,
           state=None, log=None):
    """Run chunks from `state` (default: `init_turbulent_state` drawn from
    `generator`) until `verdict` ends the run.  Returns (state, history as
    an (n, 4) float64 array, the verdict, seconds in the chunks)."""
    utau2 = cf.DEFAULT_DPDX
    if state is None:
        state = cf.init_turbulent_state(grid, generator)
    history, seconds = [], 0.0
    while True:
        t0 = time.perf_counter()
        state, stats = cf.spinup_chunk(grid, state, chunk)
        stats = stats.cpu().numpy()                # one host read a chunk
        dt = time.perf_counter() - t0
        seconds += dt
        if not np.isfinite(stats).all():
            raise Diverged(f"chunk {len(history)}: a statistic is not "
                           "finite")
        history.append(stats[-chunk // 2:].mean(axis=0))
        tau_b, tau_t, bulk, dpdx = history[-1]
        why = verdict(history, grid.nu, utau2, min_chunks, max_chunks)
        if log:
            log(f"chunk {len(history) - 1:2d} ({chunk} steps, "
                f"{chunk / dt:6.0f} steps/s): tau_b={tau_b:.4e} "
                f"tau_t={tau_t:.4e} (target {utau2:.4e}) bulk={bulk:.4f} "
                f"dPdx={dpdx:.4e}: {why}")
        if why in ("converged", "capped"):
            return state, np.asarray(history), why, seconds


def save_snapshot(path: str, grid, state, history, steps: int) -> str:
    """The snapshot in the packaged asset's keys, dtypes and shapes."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def f32(t):
        return np.asarray(t.detach().cpu().numpy(), np.float32)
    np.savez_compressed(
        path, U=f32(state.U), V=f32(state.V), W=f32(state.W),
        dPdx=f32(state.dPdx), meanU0=f32(state.meanU0),
        nu=np.float32(grid.nu), steps=np.int64(steps),
        history=np.asarray(history, np.float32))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--min-chunks", type=int, default=MIN_CHUNKS)
    ap.add_argument("--max-chunks", type=int, default=MAX_CHUNKS)
    ap.add_argument("--grid", type=int, nargs=3, default=(32, 130, 32),
                    metavar=("NX", "NY", "NZ"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_solver_precision()
    grid = cf.make_channel_grid(*args.grid, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
    try:
        state, history, why, seconds = spinup(
            grid, generator, args.chunk, args.min_chunks, args.max_chunks,
            log=log)
    except Diverged as e:
        log(f"DIVERGED: {e}")
        raise SystemExit(1)
    steps = len(history) * args.chunk
    save_snapshot(args.out, grid, state, history, steps)
    log(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB, "
        f"{seconds:.0f} s in the chunks)")
    res = {"chunks": len(history), "tau_b": float(history[-1][0]),
           "tau_t": float(history[-1][1]), "bulk": float(history[-1][2]),
           "target_tau": cf.DEFAULT_DPDX, "converged": why == "converged",
           "steps": steps, "steps_per_s": steps / seconds,
           "seconds": seconds, "out": args.out, "card": card_name()}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
