"""Gym-style adapter of the channel-flow control env.

Counterpart of `pde_policylearning_tpu/control/gym_env.py`: the DNS env as
a (reset, step(action)) RL environment with wall-pressure observations,
zero-net-flux wall actuation and a drag reward, so that `DDPGAgent` trains
on flow control through the host (one read a step; the on-device loop is
`ddpg.train_ddpg_channel_on_device`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..envs import NSControlEnv


class ChannelGymEnv:
    """obs = flattened top-wall pressure x obs_scale; action = the opV2
    wall velocity (mean removed, clipped); reward = -shear stress."""

    def __init__(self, Nx=32, Ny=130, Nz=32, detect_plane=25,
                 action_clip: float = 0.01, episode_steps: int = 200,
                 seed: int = 0, obs_scale: float = 100.0, **env_kwargs):
        self._kw = dict(Nx=Nx, Ny=Ny, Nz=Nz, detect_plane=detect_plane,
                        seed=seed, **env_kwargs)
        self.action_clip = action_clip
        self.episode_steps = episode_steps
        self.obs_scale = obs_scale
        self.Nx, self.Nz = Nx, Nz
        self.state_dim = Nx * Nz
        self.action_dim = Nx * Nz
        self.env: Optional[NSControlEnv] = None
        self._t = 0

    def reset(self):
        self.env = NSControlEnv(**{"noise_scale": 0.05, **self._kw})
        self._t = 0
        _, p2 = self.env.get_boundary_pressures()
        return (np.asarray(p2) * self.obs_scale).ravel().astype(np.float32)

    def step(self, action):
        a = np.asarray(action, np.float32).reshape(self.Nx, self.Nz)
        a = a - a.mean()                       # zero net wall mass flux
        a = np.clip(a, -self.action_clip, self.action_clip)
        p2, div, _, info = self.env.step(np.zeros_like(a), a)
        self._t += 1
        reward = -float(info["drag_reduction/1_shear_stress"])
        done = (self._t >= self.episode_steps
                or not np.isfinite(info["drag_reduction/4_4_speed_norm"]))
        obs = (p2 * self.obs_scale).ravel().astype(np.float32)
        return obs, reward, done, info


def train_ddpg_channel(episodes: int = 2, steps_per_ep: int = 10,
                       batch_size: int = 32, seed: int = 0,
                       env_kwargs: Optional[dict] = None, verbose=True):
    """DDPG on the channel env through the adapter; the agent on the env's
    device.  Returns (agent, episode returns)."""
    from .ddpg import DDPGAgent, ReplayMemory

    env = ChannelGymEnv(episode_steps=steps_per_ep, **(env_kwargs or {}))
    s = env.reset()
    agent = DDPGAgent(state_dim=env.state_dim, action_dim=env.action_dim,
                      max_action=env.action_clip, seed=seed,
                      device=env.env.device, dtype=env.env.dtype)
    memory = ReplayMemory(10_000, env.state_dim, env.action_dim)
    rng = np.random.default_rng(seed)
    returns = []
    for ep in range(episodes):
        s = env.reset()
        total = 0.0
        for _ in range(steps_per_ep):
            a = agent.act(s, noise_scale=0.3 * env.action_clip, rng=rng)
            s2, r, done, _ = env.step(a)
            memory.push(s, a, r, s2, done)
            s = s2
            total += r
            if len(memory) >= batch_size:
                agent.update(memory.sample(rng, batch_size))
            if done:
                break
        returns.append(total)
        if verbose:
            print(f"episode {ep}: return {total:.4f}")
    return agent, returns
