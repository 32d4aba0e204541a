"""DDPG of the port (control/ddpg.py, control/gym_env.py, the main_ddpg
entry) against the JAX package's, on the CPU: the networks and the update
in float64 from carried parameters, the host ring and the pendulum
exactly, the gym adapter and the policy in float64 from the same state,
and the whole on-device channel loop in float32 through the JAX kernels
in interpret mode, with JAX's random draws replayed through `draws`."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pde_policylearning_tpu.control import ddpg as jddpg
from pde_policylearning_tpu.control import gym_env as jgym
from pde_policylearning_tpu.envs import NSControlEnv as JEnv
from pde_policylearning_tpu.envs import channel_flow as jcf
from pde_policylearning_tpu.envs import rk3_pallas as jrk
from pde_policylearning_torch import main_ddpg
from pde_policylearning_torch.control import ddpg, gym_env
from pde_policylearning_torch.envs import NSControlEnv
from pde_policylearning_torch.utils.transplant import load_jax_params

F64 = dict(device="cpu", dtype=torch.float64)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def f64_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def jax_nets(state_dim, action_dim, max_action=1.0, hidden=256, seed=0):
    """flax Actor and Critic trees from `seed`, float64 numpy."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    actor = jddpg.Actor(action_dim, max_action, hidden)
    critic = jddpg.Critic(hidden)
    s0, a0 = jnp.zeros((1, state_dim)), jnp.zeros((1, action_dim))
    return (actor, f64_tree(actor.init(k1, s0)["params"]),
            critic, f64_tree(critic.init(k2, s0, a0)["params"]))


def test_actor_critic_match_jax():
    jactor, ap, jcritic, cp = jax_nets(5, 3, max_action=2.0, hidden=16)
    actor = load_jax_params(ddpg.Actor(5, 3, 2.0, 16, **F64), ap)
    critic = load_jax_params(ddpg.Critic(5, 3, 16, **F64), cp)
    rng = np.random.default_rng(0)
    s, a = rng.normal(size=(4, 5)), rng.normal(size=(4, 3))
    assert rel(actor(torch.tensor(s)).detach(),
               jactor.apply({"params": ap}, jnp.asarray(s))) < 1e-13
    assert rel(critic(torch.tensor(s), torch.tensor(a)).detach(),
               jcritic.apply({"params": cp}, jnp.asarray(s),
                             jnp.asarray(a))) < 1e-13
    # flax's names and the lecun scale of the draw
    assert [n for n, _ in actor.named_parameters()] == [
        "Dense_0.weight", "Dense_0.bias", "Dense_1.weight", "Dense_1.bias",
        "Dense_2.weight", "Dense_2.bias"]
    wide = ddpg.Actor(400, 2, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert abs(float(wide.Dense_0.weight.std()) * 20 - 1) < 0.02


def agent_pair(state_dim=3, action_dim=2):
    """A JAX agent and the port's with the same float64 parameters, and
    their optax / torch Adam states at the start."""
    jag = jddpg.DDPGAgent(state_dim, action_dim, max_action=2.0, seed=0)
    ap, cp = f64_tree(jag.actor_params), f64_tree(jag.critic_params)
    ag = ddpg.DDPGAgent(state_dim, action_dim, max_action=2.0, seed=0,
                        **F64)
    for net, tree in ((ag.actor, ap), (ag.target_actor, ap),
                      (ag.critic, cp), (ag.target_critic, cp)):
        load_jax_params(net, tree)
    return jag, ag, ap, cp


def test_update_matches_jax():
    """Three updates from carried parameters on the same batches: the
    losses, all four networks, float64."""
    jag, ag, ap, cp = agent_pair()
    j = [jax.tree.map(jnp.asarray, t) for t in (ap, cp, ap, cp)]
    a_st, c_st = optax.adam(1e-4).init(j[0]), optax.adam(1e-3).init(j[1])
    rng = np.random.default_rng(1)
    for _ in range(3):
        batch = (rng.normal(size=(8, 3)), rng.normal(size=(8, 2)),
                 rng.normal(size=(8, 1)), rng.normal(size=(8, 3)),
                 (rng.random((8, 1)) < 0.3).astype(np.float64))
        *j, a_st, c_st, cl, al = jag._update(
            *j, a_st, c_st, tuple(jnp.asarray(b) for b in batch))
        ours = ag._update(tuple(torch.tensor(b) for b in batch))
        assert abs(float(ours[0]) / float(cl) - 1) < 1e-10
        assert abs(float(ours[1]) / float(al) - 1) < 1e-10
    for net, tree in zip((ag.actor, ag.critic, ag.target_actor,
                          ag.target_critic), j):
        want = load_jax_params(type(net)(*(
            (3, 2, 2.0) if isinstance(net, ddpg.Actor) else (3, 2)), **F64),
            f64_tree(tree))
        for (n, p), q in zip(net.named_parameters(), want.parameters()):
            assert rel(p.detach(), q.detach()) < 1e-9, n


def test_agent_update_from_numpy_and_act():
    jag, ag, _, _ = agent_pair()
    s = np.random.default_rng(2).normal(size=3).astype(np.float32)
    np.testing.assert_allclose(ag.act(s), jag.act(s), rtol=1e-5)
    rng1, rng2 = np.random.default_rng(3), np.random.default_rng(3)
    # the JAX agent acts in float32, the port's here in float64
    np.testing.assert_allclose(ag.act(s, 0.1, rng1), jag.act(s, 0.1, rng2),
                               rtol=1e-5)
    mem = ddpg.ReplayMemory(16, 3, 2)
    for i in range(10):
        mem.push(s * i, [0.1, -0.1], 1.0, s, i % 3 == 0)
    cl, al = ag.update(mem.sample(np.random.default_rng(4), 8))
    assert np.isfinite(cl) and np.isfinite(al)


def test_replay_memory_and_pendulum_are_exact():
    ours, ref = ddpg.ReplayMemory(10, 3, 1), jddpg.ReplayMemory(10, 3, 1)
    for i in range(15):
        for mem in (ours, ref):
            mem.push(np.ones(3) * i, [0.5 * i], float(i), np.ones(3),
                     i % 2 == 0)
    assert len(ours) == len(ref) == 10
    for x, y in zip(ours.sample(np.random.default_rng(0), 6),
                    ref.sample(np.random.default_rng(0), 6)):
        np.testing.assert_array_equal(x, y)
    e1, e2 = ddpg.PendulumEnv(3), jddpg.PendulumEnv(3)
    np.testing.assert_array_equal(e1.reset(), e2.reset())
    for u in (0.5, -3.0, 1.7, 0.0):
        for x, y in zip(e1.step([u])[:2], e2.step([u])[:2]):
            np.testing.assert_array_equal(x, y)


def test_train_pendulum_runs():
    agent, returns = ddpg.train_pendulum(episodes=2, steps_per_ep=40,
                                         batch_size=16, verbose=False,
                                         device="cpu")
    assert len(returns) == 2 and np.isfinite(returns).all()


SMALL = dict(Nx=8, Ny=17, Nz=8, detect_plane=3)


def test_channel_gym_env_matches_jax(tmp_path):
    """Three steps of the adapter from the same state (the JAX env's,
    dumped), float64."""
    jenv = jgym.ChannelGymEnv(**SMALL, action_clip=0.005, dtype=jnp.float64)
    jobs = jenv.reset()
    path = str(tmp_path / "s.npz")
    jenv.env.dump_state(path)
    env = gym_env.ChannelGymEnv(**SMALL, action_clip=0.005, noise_scale=0.0,
                                init_cond_path=path, **F64)
    obs = env.reset()
    assert rel(obs, jobs) < 1e-8
    rng = np.random.default_rng(5)
    for _ in range(3):
        a = 0.01 * rng.normal(size=64)
        o1, r1, d1, i1 = env.step(a)
        o2, r2, d2, i2 = jenv.step(a)
        assert rel(o1, o2) < 1e-8 and abs(r1 / r2 - 1) < 1e-8
        assert d1 == d2
        for k in i2:
            if "divergence" not in k:
                np.testing.assert_allclose(i1[k], i2[k], rtol=1e-8,
                                           err_msg=k)


def test_train_ddpg_channel_through_the_adapter():
    agent, returns = gym_env.train_ddpg_channel(
        episodes=1, steps_per_ep=3, batch_size=2, verbose=False,
        env_kwargs={**SMALL, "dtype": torch.float64, "action_clip": 0.005,
                    "device": "cpu"})
    assert np.isfinite(returns).all()
    assert agent.dtype == torch.float64


def test_ddpg_policy_contract_and_parity():
    jactor, ap, _, _ = jax_nets(64, 64, max_action=0.01, hidden=16)
    actor = load_jax_params(ddpg.Actor(64, 64, 0.01, 16, **F64), ap)
    pol = ddpg.make_ddpg_policy(actor, 8, 8)
    jpol = jddpg.make_ddpg_policy(jax.tree.map(jnp.asarray, ap), 8, 8,
                                  hidden=16)
    p2 = 0.01 * np.random.default_rng(6).normal(size=(8, 8))
    op1, op2 = pol(None, torch.tensor(p2), None)
    jop1, jop2 = jpol(None, jnp.asarray(p2), None)
    assert op2.shape == (8, 8) and float(op1.abs().max()) == 0.0
    assert float(op2.abs().max()) <= 0.01 + 1e-12
    assert abs(float(op2.mean())) < 1e-15
    assert rel(op2, jop2) < 1e-12


def jax_draws(seed, warmup, n_steps, A, batch):
    """The draws of the JAX loop's key splits (ddpg.py:262-265, 302-303,
    316, 330-336): unscaled warm-up and training noise, the minibatch
    uniforms."""
    _, _, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    kw, kt = jax.random.split(k3)
    warm = np.stack([np.asarray(jax.random.normal(k, (A,)))
                     for k in jax.random.split(kw, warmup)])
    noise, unif = [], []
    for k in jax.random.split(kt, n_steps):
        kn, ks = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(kn, (A,))))
        unif.append(np.asarray(jax.random.uniform(ks, (batch,))))
    return tuple(torch.tensor(np.stack(x)) for x in (warm, noise, unif))


def test_on_device_loop_matches_jax(tmp_path, monkeypatch):
    """The whole loop, float32, at 8x33x8 (the smallest grid of the JAX
    kernel-D tests) through the JAX kernels in interpret mode: the same
    state, networks and draws.  The warm-up is the env under noise alone
    and is held at 5e-5, the distance of one float32 step of the port's
    plain env step from the JAX kernel D (tests/test_torch_rk3.py: V, W,
    p2 at 2e-5 a step; the shear reads the wall rows); the updates after
    it start Adam, whose first steps move each weight by about lr whatever
    its gradient's size, so that float32 rounding in a near-zero gradient
    flips a step: the training series are held at 3e-4 (read: 4e-5 at
    most)."""
    monkeypatch.setattr(jrk, "INTERPRET", True)
    monkeypatch.setattr(jcf, "RK3_BACKEND", "fused")
    kw = dict(Nx=8, Ny=33, Nz=8, detect_plane=5)
    n_steps, warmup, buf, batch, hidden, A = 3, 2, 8, 2, 16, 64
    jap, jm = jddpg.train_ddpg_channel_on_device(
        n_steps=n_steps, warmup=warmup, buffer_size=buf, batch_size=batch,
        hidden=hidden, env_kwargs=kw, verbose=False)
    # the loop's env, networks and draws, as the JAX function makes them
    jenv = JEnv(noise_scale=0.05, **kw)
    path = str(tmp_path / "s.npz")
    jenv.dump_state(path)
    env = NSControlEnv(**kw, init_cond_path=path, device="cpu")
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    s0 = jnp.zeros((1, A))
    actor = load_jax_params(ddpg.Actor(A, A, 0.01, hidden, device="cpu"),
                            jddpg.Actor(A, 0.01, hidden).init(k1, s0)
                            ["params"])
    critic = load_jax_params(ddpg.Critic(A, A, hidden, device="cpu"),
                             jddpg.Critic(hidden).init(k2, s0, s0)
                             ["params"])
    trained, m = ddpg.train_ddpg_channel_on_device(
        n_steps=n_steps, warmup=warmup, buffer_size=buf, batch_size=batch,
        hidden=hidden, env=env, actor=actor, critic=critic, verbose=False,
        draws=jax_draws(0, warmup, n_steps, A, batch))
    assert rel(m["warmup_shear"], jm["warmup_shear"]) < 5e-5
    for k in ("shear", "critic_loss", "actor_loss"):
        assert m[k].shape == (n_steps,)
        assert rel(m[k], jm[k]) < 3e-4, k
    want = load_jax_params(ddpg.Actor(A, A, 0.01, hidden, device="cpu"),
                           jax.tree.map(np.asarray, jap))
    for (n, p), q in zip(trained.named_parameters(), want.parameters()):
        assert rel(p.detach(), q.detach()) < 1e-3, n


def test_main_ddpg_entry(tmp_path, capsys):
    """`--channel` on the CPU at a small budget: the actor saved, the
    warm-up / last-quarter line; without a card and without --device the
    entry raises."""
    out = str(tmp_path / "actor.pt")
    actor, metrics = main_ddpg.main(["--channel", "--n_steps", "4",
                                     "--warmup", "4", "--device", "cpu",
                                     "--out", out])
    text = capsys.readouterr().out
    assert "Actor saved at" in text and "last-quarter mean" in text
    from pde_policylearning_torch.training import load_checkpoint
    load_checkpoint(out, ddpg.Actor(1024, 1024, 0.01, device="cpu"))
    assert metrics["shear"].shape == (4,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main_ddpg.main(["--channel"])
