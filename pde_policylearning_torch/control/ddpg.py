"""DDPG: deep deterministic policy gradient, on a pendulum and on the
channel DNS.

Counterpart of `pde_policylearning_tpu/control/ddpg.py` (reference:
libs/ddpg/agent_ddpg.py (Actor:18, Critic:32, ReplayMemory:47,
DDPGAgent.update with soft target updates:83-117) and main_ddpg.py).
`Actor` and `Critic` keep flax's names (`Dense_0..2`) and init scale, so
`utils.transplant.load_jax_params` carries a JAX tree into them.  The
update (`ddpg_update`) is one function: the critic's TD target from the
target nets, the actor loss through the updated critic, Polyak averaging
written `(1 - tau) * t + tau * p` as the JAX function writes it.

`train_ddpg_channel_on_device` trains on the channel DNS with no host read
inside its loop: the env steps (kernel D on the card, one launch a step),
the replay ring, the minibatch indices and both updates stay on the
device, all randomness is drawn up front from one generator, and the
series are read once at the end.
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..models.layers import dense, factory

SHEAR = "drag_reduction/1_shear_stress"


class Actor(nn.Module):
    """state -> max_action * tanh(MLP), two ReLU layers of `hidden`."""

    def __init__(self, state_dim: int, action_dim: int,
                 max_action: float = 1.0, hidden: int = 256,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        f = factory(device, dtype)
        self.max_action = max_action
        self.Dense_0 = dense(state_dim, hidden, generator, **f)
        self.Dense_1 = dense(hidden, hidden, generator, **f)
        self.Dense_2 = dense(hidden, action_dim, generator, **f)

    def forward(self, s):
        x = F.relu(self.Dense_0(s))
        x = F.relu(self.Dense_1(x))
        return self.max_action * torch.tanh(self.Dense_2(x))


class Critic(nn.Module):
    """(state, action) -> Q, two ReLU layers of `hidden`."""

    def __init__(self, state_dim: int, action_dim: int, hidden: int = 256,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        f = factory(device, dtype)
        self.Dense_0 = dense(state_dim + action_dim, hidden, generator, **f)
        self.Dense_1 = dense(hidden, hidden, generator, **f)
        self.Dense_2 = dense(hidden, 1, generator, **f)

    def forward(self, s, a):
        x = F.relu(self.Dense_0(torch.cat([s, a], dim=-1)))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class ReplayMemory:
    """Ring buffer on the host (agent_ddpg.py:47); a numpy generator draws
    the minibatch indices."""

    def __init__(self, capacity: int, state_dim: int, action_dim: int):
        self.capacity = capacity
        self.s = np.zeros((capacity, state_dim), np.float32)
        self.a = np.zeros((capacity, action_dim), np.float32)
        self.r = np.zeros((capacity, 1), np.float32)
        self.s2 = np.zeros((capacity, state_dim), np.float32)
        self.done = np.zeros((capacity, 1), np.float32)
        self.idx = 0
        self.full = False

    def push(self, s, a, r, s2, done):
        i = self.idx
        self.s[i], self.a[i], self.r[i] = s, a, r
        self.s2[i], self.done[i] = s2, float(done)
        self.idx = (i + 1) % self.capacity
        self.full = self.full or self.idx == 0

    def __len__(self):
        return self.capacity if self.full else self.idx

    def sample(self, rng: np.random.Generator, batch: int):
        idx = rng.integers(0, len(self), batch)
        return (self.s[idx], self.a[idx], self.r[idx], self.s2[idx],
                self.done[idx])


def _polyak_(target: nn.Module, source: nn.Module, tau: float) -> None:
    t = list(target.parameters())
    new = torch._foreach_add(torch._foreach_mul(t, 1 - tau),
                             torch._foreach_mul(list(source.parameters()),
                                                tau))
    torch._foreach_copy_(t, new)


def ddpg_update(actor, critic, target_actor, target_critic, actor_opt,
                critic_opt, batch, gamma: float, tau: float):
    """One DDPG update in place (agent_ddpg.py:83-117): the critic towards
    r + gamma (1 - done) Q'(s2, mu'(s2)) (no `done` factor where the
    batch has four entries, as on the channel), then the actor up the
    updated critic, then both targets by Polyak averaging.  Returns the
    (critic loss, actor loss) tensors."""
    s, a, r, s2 = batch[:4]
    with torch.no_grad():
        q_next = target_critic(s2, target_actor(s2))
        if len(batch) == 5:
            q_next = (1 - batch[4]) * q_next
        q_target = r + gamma * q_next
    critic_opt.zero_grad(set_to_none=True)
    cl = torch.mean((critic(s, a) - q_target) ** 2)
    cl.backward()
    critic_opt.step()
    critic.requires_grad_(False)
    actor_opt.zero_grad(set_to_none=True)
    al = -torch.mean(critic(s, actor(s)))
    al.backward()
    actor_opt.step()
    critic.requires_grad_(True)
    with torch.no_grad():
        _polyak_(target_actor, actor, tau)
        _polyak_(target_critic, critic, tau)
    return cl.detach(), al.detach()


class DDPGAgent:
    """Actor, critic, their targets (copies at the start) and two Adams,
    drawn from a generator seeded with `seed` on `device`."""

    def __init__(self, state_dim: int, action_dim: int,
                 max_action: float = 1.0, gamma: float = 0.99,
                 tau: float = 0.005, actor_lr: float = 1e-4,
                 critic_lr: float = 1e-3, seed: int = 0, hidden: int = 256,
                 device=None, dtype=torch.float32):
        self.gamma, self.tau = gamma, tau
        f = factory(device, dtype)
        self.device, self.dtype = f["device"], dtype
        g = torch.Generator(device=self.device).manual_seed(seed)
        self.actor = Actor(state_dim, action_dim, max_action, hidden, g, **f)
        self.critic = Critic(state_dim, action_dim, hidden, g, **f)
        self.target_actor = copy.deepcopy(self.actor)
        self.target_critic = copy.deepcopy(self.critic)
        self.actor_opt = torch.optim.Adam(self.actor.parameters(),
                                          lr=actor_lr)
        self.critic_opt = torch.optim.Adam(self.critic.parameters(),
                                           lr=critic_lr)

    def _update(self, batch):
        return ddpg_update(self.actor, self.critic, self.target_actor,
                           self.target_critic, self.actor_opt,
                           self.critic_opt, batch, self.gamma, self.tau)

    @torch.no_grad()
    def act(self, state, noise_scale: float = 0.0,
            rng: Optional[np.random.Generator] = None):
        s = torch.as_tensor(np.asarray(state), dtype=self.dtype,
                            device=self.device)
        a = self.actor(s[None])[0].cpu().numpy()
        if noise_scale > 0 and rng is not None:
            a = a + noise_scale * rng.standard_normal(a.shape)
        return a

    def update(self, batch):
        batch = tuple(torch.as_tensor(np.asarray(b), dtype=self.dtype,
                                      device=self.device) for b in batch)
        cl, al = self._update(batch)
        return float(cl), float(al)


class PendulumEnv:
    """Pendulum-v1 dynamics, so that the demo needs no gym."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.max_torque = 2.0
        self.dt = 0.05
        self.state = None

    def reset(self):
        th = self.rng.uniform(-np.pi, np.pi)
        thdot = self.rng.uniform(-1, 1)
        self.state = np.array([th, thdot])
        return self._obs()

    def _obs(self):
        th, thdot = self.state
        return np.array([np.cos(th), np.sin(th), thdot], np.float32)

    def step(self, action):
        th, thdot = self.state
        u = float(np.clip(action[0], -self.max_torque, self.max_torque))
        g, m, l, dt = 10.0, 1.0, 1.0, self.dt
        cost = (((th + np.pi) % (2 * np.pi) - np.pi) ** 2
                + 0.1 * thdot ** 2 + 0.001 * u ** 2)
        thdot = thdot + (3 * g / (2 * l) * np.sin(th)
                         + 3.0 / (m * l ** 2) * u) * dt
        thdot = np.clip(thdot, -8, 8)
        th = th + thdot * dt
        self.state = np.array([th, thdot])
        return self._obs(), -cost, False, {}


def train_pendulum(episodes: int = 20, steps_per_ep: int = 200,
                   batch_size: int = 64, seed: int = 0, verbose=True,
                   device=None):
    """The main_ddpg.py demo loop; returns (agent, episode returns)."""
    env = PendulumEnv(seed)
    agent = DDPGAgent(state_dim=3, action_dim=1, max_action=2.0, seed=seed,
                      device=device)
    memory = ReplayMemory(50_000, 3, 1)
    rng = np.random.default_rng(seed)
    returns = []
    for ep in range(episodes):
        s = env.reset()
        total = 0.0
        for _ in range(steps_per_ep):
            a = agent.act(s, noise_scale=0.1, rng=rng)
            s2, r, done, _ = env.step(a)
            memory.push(s, a, r, s2, done)
            s = s2
            total += r
            if len(memory) >= batch_size:
                agent.update(memory.sample(rng, batch_size))
        returns.append(total)
        if verbose:
            print(f"episode {ep}: return {total:.1f}")
    return agent, returns


def _project_action(a, Nx: int, Nz: int, action_clip: float):
    """Zero net wall mass flux, then the clip (the JAX order)."""
    a2 = a.reshape(Nx, Nz)
    return torch.clamp(a2 - torch.mean(a2), -action_clip, action_clip)


def draw_channel_noise(warmup: int, n_steps: int, action_dim: int,
                       batch_size: int, generator: torch.Generator):
    """The loop's randomness, drawn up front: the warm-up and training
    action noise (standard normal, (warmup, A) and (n_steps, A)) and the
    minibatch uniforms (n_steps, batch) (ddpg.py:262-265, 302-303, 316,
    330-336 of the JAX package)."""
    dev = generator.device
    return (torch.randn((warmup, action_dim), generator=generator,
                        device=dev),
            torch.randn((n_steps, action_dim), generator=generator,
                        device=dev),
            torch.rand((n_steps, batch_size), generator=generator,
                       device=dev))


def train_ddpg_channel_on_device(
        n_steps: int = 8192, warmup: int = 256, buffer_size: int = 8192,
        batch_size: int = 64, seed: int = 0, noise_scale: float = 0.3,
        obs_scale: float = 100.0, action_clip: float = 0.01,
        reward_scale: float = 1000.0, gamma: float = 0.99,
        tau: float = 0.005, actor_lr: float = 1e-4,
        critic_lr: float = 1e-3, hidden: int = 256,
        env_kwargs: Optional[dict] = None, verbose: bool = True,
        device=None, draws=None, actor: Optional[Actor] = None,
        critic: Optional[Critic] = None, env=None):
    """DDPG on the channel DNS with everything on the device (the JAX
    package's one `lax.scan`, here a Python loop with no host read).

    `warmup` steps of noise-only actions fill the ring, then one update a
    step (agent_ddpg.py:83-117).  obs = top-wall pressure x obs_scale,
    flattened; action = the opV2 wall transpiration, zero net flux,
    clipped to +-action_clip; reward = -shear stress x reward_scale.  The
    env is `env` where given, else `NSControlEnv(noise_scale=0.05,
    **env_kwargs)` on `device` (None: the card); its state is left at the
    last step's.  `draws`: the three tensors of
    `draw_channel_noise`, drawn here from a generator seeded with `seed`
    when None (the seam through which a test replays the JAX draws);
    `actor`, `critic`: the initial networks, drawn from the same generator
    when None.  Returns (actor, {warmup_shear, shear, critic_loss,
    actor_loss}, numpy series, and the last wall pressure `p2`)."""
    from ..envs import NSControlEnv
    from ..envs import channel_flow as cf
    from ..envs import rk3_cuda as rk

    if warmup > buffer_size:
        raise ValueError(f"warmup {warmup} > buffer_size {buffer_size}")
    if env is None:
        env = NSControlEnv(noise_scale=0.05, device=device,
                           **(env_kwargs or {}))
    grid, dev, dtype = env.grid, env.device, env.dtype
    Nx, Nz = grid.Nx, grid.Nz
    A = Nx * Nz
    generator = torch.Generator(device=dev).manual_seed(seed)
    f = dict(device=dev, dtype=dtype)
    if actor is None:
        actor = Actor(A, A, action_clip, hidden, generator, **f)
    if critic is None:
        critic = Critic(A, A, hidden, generator, **f)
    ta, tc = copy.deepcopy(actor), copy.deepcopy(critic)
    a_opt = torch.optim.Adam(actor.parameters(), lr=actor_lr)
    c_opt = torch.optim.Adam(critic.parameters(), lr=critic_lr)
    if draws is None:
        draws = draw_channel_noise(warmup, n_steps, A, batch_size, generator)
    warm_noise, train_noise, uniforms = (d.to(**f) for d in draws)
    sigma = noise_scale * action_clip

    kstate = rk.state_to_kstate(env.state)
    _, p2 = cf.boundary_pressures(grid, env.state)
    zeros_op = torch.zeros((Nx, Nz), **f)
    ring = [torch.zeros((buffer_size, w), **f) for w in (A, A, 1, A)]
    out = {k: torch.empty(n, **f) for k, n in (
        ("warmup_shear", warmup), ("shear", n_steps),
        ("critic_loss", n_steps), ("actor_loss", n_steps))}

    def transition(i, a2, shear_out):
        """Step the env with opV2 = a2 and write (obs, a2, r, obs2) at
        ring row i."""
        nonlocal kstate, p2
        obs = (p2 * obs_scale).reshape(-1)
        kstate, p2, info = rk.env_step_k(grid, kstate, zeros_op, a2)
        shear = info[SHEAR]
        shear_out.copy_(shear)
        for buf, row in zip(ring, (obs, a2.reshape(-1),
                                   (-shear * reward_scale).reshape(1),
                                   (p2 * obs_scale).reshape(-1))):
            buf[i] = row

    with torch.no_grad():
        for t in range(warmup):
            transition(t, _project_action(sigma * warm_noise[t], Nx, Nz,
                                          action_clip),
                       out["warmup_shear"][t])
    i, count = warmup, warmup
    for t in range(n_steps):
        with torch.no_grad():
            a = actor((p2 * obs_scale).reshape(1, -1))[0] \
                + sigma * train_noise[t]
            transition(i, _project_action(a, Nx, Nz, action_clip),
                       out["shear"][t])
        i = (i + 1) % buffer_size
        count = min(count + 1, buffer_size)
        idx = torch.floor(uniforms[t] * count).long()
        cl, al = ddpg_update(actor, critic, ta, tc, a_opt, c_opt,
                             tuple(b[idx] for b in ring), gamma, tau)
        out["critic_loss"][t] = cl
        out["actor_loss"][t] = al
    env.state = rk.kstate_to_state(grid, kstate)
    out["p2"] = p2
    metrics = {k: v.cpu().numpy() for k, v in out.items()}   # one read
    if verbose:
        n4 = max(1, n_steps // 4)
        for q in range(4):
            seg = metrics["shear"][q * n4:(q + 1) * n4]
            if len(seg):
                crit = metrics["critic_loss"][q * n4:(q + 1) * n4].mean()
                print(f"steps [{q * n4}, {q * n4 + len(seg)}): mean shear "
                      f"{seg.mean():.6e}  critic {crit:.4f}")
    return actor, metrics


def make_ddpg_policy(actor: Actor, Nx: int, Nz: int,
                     action_clip: float = 0.01, obs_scale: float = 100.0):
    """A trained actor as a closed-loop policy (`control.loop`'s
    `policy(state, p2, generator) -> (opV1, opV2)`): deterministic, zero
    net flux, clipped; opV1 zero."""

    @torch.no_grad()
    def policy(state, p2, generator):
        a = actor((p2 * obs_scale).reshape(1, -1))[0]
        a2 = _project_action(a, Nx, Nz, action_clip)
        return torch.zeros_like(a2), a2

    return policy
