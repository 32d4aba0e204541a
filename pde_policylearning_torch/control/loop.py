"""Closed-loop control rollout: observe -> policy -> actuate -> score.

Counterpart of `pde_policylearning_tpu/control/loop.py`.  The state rides
in the kernel layout across a chunk, each step is one call of the env step
(`rk3_cuda.env_step_k`: on a card the CUDA kernel D, or the staged kernels
when `PDE_RK3_FULLSTEP=0`), and the 9 scoreboard values of every step
go into one (9, n) device tensor: the host reads it once per chunk, for
logging and the divergence guard (run_control.py:294-295 of the
reference).  No per-step `.item()` or `float()`.  A policy with a carry
(`policies.StatefulPolicy`) has it threaded from step to step and chunk
to chunk, each run starting from the policy's `init_carry()`.  The
spans `loop.run`, `loop.chunk`, `loop.step` (with `loop.policy` and
`loop.env_step` inside it) and `loop.fetch` (`utils.profiling.span`) mark
its layers.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..envs import channel_flow as cf
from ..envs import rk3_cuda as rk
from ..utils.profiling import span

SCOREBOARD_KEYS = (
    "drag_reduction/1_shear_stress",
    "drag_reduction/2_1_mass_flow",
    "drag_reduction/2_2_v_velocity",
    "drag_reduction/2_3_w_velocity",
    "drag_reduction/3_1_pressure_mean",
    "drag_reduction/3_2_dPdx_finite_difference",
    "drag_reduction/3_3_dPdx_reverse_cal",
    "drag_reduction/4_1_-|divergence|",
    "drag_reduction/4_4_speed_norm",
)


def closed_loop_chunk(grid, state, p2, policy_fn: Callable, n_steps: int,
                      generator: torch.Generator,
                      collect_planes: bool = False, policy_carry=None,
                      detect_plane: int = 25):
    """Run `n_steps` control steps from `state` ((x, y, z) layout).  With
    a `policy_carry` (not None) the policy is called as
    `policy_fn(carry, state, p2, generator) -> (opV1, opV2, carry)`.

    Returns ``(state, p2, policy_carry, outs)``: ``outs[0]`` is the
    (9, n_steps) scoreboard on the device in SCOREBOARD_KEYS order; with
    ``collect_planes`` the (n_steps, Nx, Nz) p2, opV2 and v_plane series
    follow."""
    with span("loop.chunk"):
        Nx, Nz = grid.Nx, grid.Nz
        st = rk.state_to_kstate(state)
        dev, dtype = st.U.device, st.U.dtype
        infos = torch.empty((len(SCOREBOARD_KEYS), n_steps), dtype=dtype,
                            device=dev)
        if collect_planes:
            planes = [torch.empty((n_steps, Nx, Nz), dtype=dtype, device=dev)
                      for _ in range(3)]
        for i in range(n_steps):
            with span("loop.step"):
                with span("loop.policy"):
                    if policy_carry is not None:
                        opV1, opV2, policy_carry = policy_fn(
                            policy_carry, st, p2, generator)
                    else:
                        opV1, opV2 = policy_fn(st, p2, generator)
                with span("loop.env_step"):
                    st, p2, info = rk.env_step_k(grid, st, opV1, opV2)
                infos[:, i] = torch.stack([info[k] for k in SCOREBOARD_KEYS])
                if collect_planes:
                    planes[0][i] = p2
                    planes[1][i] = opV2.reshape(Nx, Nz)
                    planes[2][i] = st.V[st.V.shape[0]
                                        - detect_plane].reshape(Nx, Nz)
        outs = (infos,) + (tuple(planes) if collect_planes else ())
        return rk.kstate_to_state(grid, st), p2, policy_carry, outs


def run_closed_loop(env, policy_fn, n_steps: int,
                    log_interval: int = 200,
                    div_guard: float = 10.0,
                    collect_planes: bool = False,
                    detect_plane: int = 25,
                    seed: int = 0,
                    verbose: bool = True,
                    on_chunk=None):
    """Drive `env` with `policy_fn` for n_steps; returns the metric time
    series (and optionally the collected p2/opV2/v_plane planes).

    Raises RuntimeError if |divergence| exceeds `div_guard` or is not
    finite (run_control.py:294-295)."""
    with span("loop.run"):
        generator = torch.Generator(device=env.state.U.device)
        generator.manual_seed(seed)
        _, p2 = cf.boundary_pressures(env.grid, env.state)
        all_infos, all_planes = [], []
        done = 0
        init_carry = getattr(policy_fn, "init_carry", None)
        policy_carry = init_carry() if init_carry is not None else None
        while done < n_steps:
            n = min(log_interval, n_steps - done)
            env.state, p2, policy_carry, outs = closed_loop_chunk(
                env.grid, env.state, p2, policy_fn, n, generator,
                collect_planes=collect_planes, policy_carry=policy_carry,
                detect_plane=detect_plane)
            with span("loop.fetch"):             # one fetch per chunk
                outs = [o.cpu().numpy() for o in outs]
            infos = dict(zip(SCOREBOARD_KEYS, outs[0]))
            all_infos.append(infos)
            if collect_planes:
                all_planes.append(outs[1:])
            done += n
            div = infos["drag_reduction/4_1_-|divergence|"]
            if not np.isfinite(div).all() or np.abs(div).max() > div_guard:
                raise RuntimeError(
                    f"Control diverged: |div| = {np.abs(div).max():.3f} > "
                    f"{div_guard} (or NaN) within steps [{done - n}, {done})")
            if verbose:
                ss = infos["drag_reduction/1_shear_stress"]
                print(f"step {done}/{n_steps}: shear {ss[-1]:.6f} "
                      f"div {div[-1]:.2e}")
            if on_chunk is not None:
                on_chunk(done, infos)

        series = {k: np.concatenate([c[k] for c in all_infos])
                  for k in SCOREBOARD_KEYS}
        if env.info_init:
            for k in SCOREBOARD_KEYS:
                if "divergence" in k:
                    continue
                rel = k.replace("drag_reduction", "drag_reduction_relative")
                series[rel] = series[k] / env.info_init[k]
        result = {"series": series}
        if collect_planes:
            for j, name in enumerate(("p2", "opV2", "v_plane")):
                result[name] = np.concatenate([c[j] for c in all_planes])
        return result


def save_collected_dataset(result: dict, out_folder: str,
                           re: float = 178.1899):
    """Write a collected control run (`run_closed_loop(...,
    collect_planes=True)`) in the trainable on-disk format: P_planes_<i>.npy
    and V_planes_<i>.npy per step plus a metadata.npy dict of their mean
    and std and Re, as `data.channel.generate_channel_dataset` and the
    reference's collection loop write (run_control.py:236-293)."""
    import os
    os.makedirs(out_folder, exist_ok=True)
    p2 = result["p2"]
    v = result["v_plane"]
    for i in range(len(p2)):
        np.save(os.path.join(out_folder, f"P_planes_{i:06d}.npy"), p2[i])
        np.save(os.path.join(out_folder, f"V_planes_{i:06d}.npy"), v[i])
    meta = {
        "P_planes": {"mean": p2.mean(0), "std": p2.std(0) + 1e-8},
        "V_planes": {"mean": v.mean(0), "std": v.std(0) + 1e-8},
        "re": re,
    }
    np.save(os.path.join(out_folder, "metadata.npy"), meta)
    return out_folder
