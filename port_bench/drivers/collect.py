"""Data collection: `envs/channel_flow.py:batched_rollout` of B envs in
chunks, each chunk's planes fetched to the host once (as
`data/channel.py:generate_channel_dataset` fetches its rollout's).

The answers are the planes of every env step (the top wall's pressure,
the v plane the policy reads, dPdx).  The check follows the program from
the states at the start of sampled chunks (chunk 0 starts from the
benchmark's own inputs) for the cell's `check_steps` steps through the
float64 reference, and compares the planes of those steps.
"""
from __future__ import annotations

import time

import numpy as np

from .. import harness
from ..counts import channel as counts
from ..reference import channel as ref
from ..reference import precision


def setup(ctx) -> dict:
    import torch
    from pde_policylearning_torch.envs import channel_flow as cf
    from pde_policylearning_torch.utils.device import set_solver_precision
    cfg, cell, dev = ctx.config, ctx.cell, ctx.device
    set_solver_precision()
    grid = cf.make_channel_grid(**harness.grid_kw(cfg), dtype=torch.float32,
                                device=dev)
    gref = ref.make_grid(**harness.grid_kw(cfg))
    U, V, W, dP, mU = harness.channel_states(
        gref, cell["n_envs"], cell["noise"], ctx.seed, dev, torch.float32)
    S = dict(cf=cf, grid=grid, gref=gref, gen=harness.generator(ctx.seed, dev),
             states=cf.ChannelState(U=U, V=V, W=W, dPdx=dP, meanU0=mU))
    # warm-up from a copy of the inputs: every kernel built, every plan made
    st = cf.ChannelState(U=U.clone(), V=V.clone(), W=W.clone(),
                         dPdx=dP.clone(), meanU0=mU.clone())
    for _ in range(cell["warmup_chunks"]):
        st, _ = _chunk(S, cell, st)
    return S


def _chunk(S, cell, states):
    with harness.span("bench.rollout_chunk"):
        states, outs = S["cf"].batched_rollout(
            S["grid"], states, cell["chunk"], cell["detect_plane"],
            cell["policy"], S["gen"])
    with harness.span("bench.fetch"):
        host = [o.cpu().numpy() for o in outs]
    return states, host


def window(S, ctx, seconds: float) -> dict:
    cell = ctx.cell
    K = cell["check_steps"]
    rng = np.random.default_rng(ctx.seed)
    # chunk 0, one drawn from the seed among those the window should reach,
    # and the last one
    t_chunk = cell["chunk"] * cell.get("est_step_s", 6e-4)
    drawn = int(rng.integers(1, max(2, int(seconds / t_chunk) - 1)))
    samples, last = {}, None
    states, n = S["states"], 0
    t0 = time.perf_counter()
    while True:
        start = states
        states, host = _chunk(S, cell, states)
        if n in (0, drawn):
            samples[n] = (start, [h[..., :K, :, :] if h.ndim == 4
                                  else h[..., :K] for h in host])
        last = (start, host)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    start, host = last
    samples[n - 1] = (start, [h[..., :K, :, :] if h.ndim == 4
                              else h[..., :K] for h in host])
    S["states"] = states
    steps = n * cell["chunk"]
    B = cell["n_envs"]
    return dict(seconds=elapsed, steps=steps, attempted=B * steps,
                samples=[samples[k] for k in sorted(samples)],
                e2e={"env_steps_per_s": B * steps / elapsed})


def trace(S, ctx) -> dict:
    def one():
        S["states"], _ = _chunk(S, ctx.cell, S["states"])
        return ctx.cell["chunk"]
    return harness.traced(one)


def layer_inputs(ctx) -> dict:
    """What the per-layer readers need beside the trace and the window."""
    cfg, B = ctx.config, ctx.cell["n_envs"]
    g = (cfg["Nx"], cfg["Ny"], cfg["Nz"])
    return dict(ops_per_step=counts.work("rk3_fullstep", B, *g)[0],
                eig_solve=counts.work("eig_solve", B, *g),
                substage=counts.work("rk3_substage", B, *g))


def reference_outputs(S, ctx, start, dtype, tf32: bool):
    """The reference's planes for `check_steps` steps from `start`:
    (p2 (B, K, Nx, Nz), v (B, K, Nx, Nz), dPdx (B, K))."""
    import torch
    cell, g = ctx.cell, S["gref"]
    dp = cell["detect_plane"]
    with precision.tf32(tf32):
        U, V, W, dP, mU = (a.to(dtype) for a in (
            start.U, start.V, start.W, start.dPdx, start.meanU0))
        p2s, vs, dps = [], [], []
        for _ in range(cell["check_steps"]):
            op1, op2 = ref.opposition(V, dp)
            if cell["policy"] != "gt":
                op1, op2 = torch.zeros_like(op1), torch.zeros_like(op2)
            U, V, W, dP, p2 = ref.step(g, U, V, W, dP, mU, op1, op2)
            p2s.append(p2)
            vs.append(V[..., V.shape[-2] - dp, :])
            dps.append(dP)
        return [torch.stack(a, 1).double().cpu().numpy()
                for a in (p2s, vs, dps)]


def numbers(prog, refo) -> dict:
    """The compared numbers of one sample: the worst env and step's
    relative L2 gap of the wall pressure and of the v plane, and the worst
    dPdx gap over the RMS of the reference's dPdx."""
    p2, v, dp = prog
    rp2, rv, rdp = refo
    scale = float(np.sqrt(np.mean(rdp ** 2)))
    return dict(p2_rel=harness.worst_rel(p2, rp2, 2),
                v_rel=harness.worst_rel(v, rv, 2),
                dpdx_rel=float(np.max(np.abs(dp - rdp))) / scale)


def check(S, ctx, samples, control: bool = False) -> dict:
    """The worst of each number over the samples: the program's planes
    against the float64 reference, or with `control` the reference in
    float32 with TF32 emulated in the program's place."""
    import torch
    worst: dict = {}
    for start, prog in samples:
        refo = reference_outputs(S, ctx, start, torch.float64, False)
        if control:
            prog = reference_outputs(S, ctx, start, torch.float32, True)
        for k, v in numbers(prog, refo).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def release(S) -> None:
    S.pop("grid", None)
