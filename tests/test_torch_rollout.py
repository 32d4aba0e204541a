"""The port's stepping, rollouts, spin-up and data collection
(pde_policylearning_torch/envs/channel_flow.py, control_env.py,
control/loop.py, data/channel.py) against the JAX package's, in float64 on
the CPU from the same numpy inputs; and the physics oracles of
tests/test_channel_env.py run against the port."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.control.loop import \
    save_collected_dataset as jsave_collected
from pde_policylearning_tpu.data.channel import \
    generate_channel_dataset as jgenerate
from pde_policylearning_tpu.envs import NSControlEnv as JEnv
from pde_policylearning_tpu.envs import channel_flow as jcf
from pde_policylearning_torch.control.loop import save_collected_dataset
from pde_policylearning_torch.data import generate_channel_dataset
from pde_policylearning_torch.envs import NSControlEnv
from pde_policylearning_torch.envs import channel_flow as cf
from pde_policylearning_torch.envs import rk3_cuda as rk
from test_channel_env import random_state, rhs_oracle
from test_torch_rk3 import grid_arrays, make_fields, rel

NX, NY, NZ, DP, T = 16, 33, 8, 5, 3
STATE_KEYS = ("U", "V", "W", "dPdx")


def t2n(a):
    return a.detach().cpu().numpy()


@pytest.fixture(scope="module")
def setup():
    """float64 grids (JAX and port) and two valid states with actuation
    planes, from numpy seeds."""
    jgrid = jcf.make_channel_grid(Nx=NX, Ny=NY, Nz=NZ, dtype=jnp.float64)
    grid = cf.grid_from_arrays(grid_arrays(jgrid), dtype=torch.float64,
                               device="cpu")
    made = [make_fields(s, NX, NY, NZ) for s in (0, 1)]
    return jgrid, grid, [f for f, _ in made], made[0][1]


def jstate(fields, batched=False):
    if batched:
        return jcf.ChannelState(**{k: jnp.asarray(np.stack(
            [f[k] for f in fields])) for k in fields[0]})
    return jcf.ChannelState(**{k: jnp.asarray(v) for k, v in fields.items()})


def tstate(fields, batched=False):
    if batched:
        return cf.ChannelState(**{k: torch.as_tensor(np.stack(
            [np.asarray(f[k], np.float64) for f in fields]))
            for k in fields[0]})
    return cf.state_from_arrays(fields, dtype=torch.float64, device="cpu")


def dpdx_atol(state):
    """dPdx = (dPdx + d_new/dt)/2 with d_new = 2 (meanU0 - meanU_now): one
    float64 rounding of the bulk velocity moves it by ~eps * meanU0 / dt
    (1/dt = 1000), above 1e-10 of dPdx itself."""
    return (4 * np.finfo(np.float64).eps
            * float(np.abs(np.asarray(state.meanU0)).max()) / 1e-3)


def assert_states_match(ours, ref, tol):
    for k in STATE_KEYS[:3]:
        assert rel(t2n(getattr(ours, k)), getattr(ref, k)) <= tol, k
    np.testing.assert_allclose(t2n(ours.dPdx), ref.dPdx, rtol=tol,
                               atol=dpdx_atol(ref))


def assert_outs_match(ours, ref, tol):
    assert len(ours) == len(ref)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert tuple(a.shape) == tuple(b.shape), i
        assert rel(t2n(a), b) <= tol, i


# ---------------------------------------------------------------------------
# stepping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["_rk3_step_unfused", "rk3_step"])
def test_rk3_step_matches_jax(setup, fn):
    jgrid, grid, fields, ops = setup
    ref = getattr(jcf, fn)(jgrid, jstate(fields[0]), jnp.asarray(ops[0]),
                           jnp.asarray(ops[1]))
    out = getattr(cf, fn)(grid, tstate(fields[0]), torch.as_tensor(ops[0]),
                          torch.as_tensor(ops[1]))
    assert_states_match(out, ref, 1e-10)


def test_env_step_matches_jax(setup):
    jgrid, grid, fields, ops = setup
    s_ref, p2_ref, div_ref, info_ref = jcf.env_step(
        jgrid, jstate(fields[0]), jnp.asarray(ops[0]), jnp.asarray(ops[1]))
    s, p2, div, info = cf.env_step(grid, tstate(fields[0]),
                                   torch.as_tensor(ops[0]),
                                   torch.as_tensor(ops[1]))
    assert_states_match(s, s_ref, 1e-10)
    assert rel(t2n(p2), p2_ref) <= 1e-10
    for k in info_ref:
        atol = {"drag_reduction/4_1_-|divergence|": 1e-10,
                "drag_reduction/3_3_dPdx_reverse_cal": dpdx_atol(s_ref)
                }.get(k, 0.0)
        np.testing.assert_allclose(float(info[k]), float(info_ref[k]),
                                   rtol=1e-10, atol=atol, err_msg=k)
    assert float(div) == float(info["drag_reduction/4_1_-|divergence|"])


# ---------------------------------------------------------------------------
# rollouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["gt", "unmanipulated"])
def test_rollout_matches_jax(setup, policy):
    jgrid, grid, fields, _ = setup
    s_ref, o_ref = jcf.rollout(jgrid, jstate(fields[0]), T, detect_plane=DP,
                               policy=policy, collect_fields=True)
    s, outs = cf.rollout(grid, tstate(fields[0]), T, detect_plane=DP,
                         policy=policy, collect_fields=True)
    assert_states_match(s, s_ref, 1e-8)
    assert_outs_match(outs, o_ref, 1e-8)


@pytest.mark.parametrize("policy", ["gt", "unmanipulated"])
def test_batched_rollout_matches_jax(setup, policy):
    jgrid, grid, fields, _ = setup
    s_ref, o_ref = jcf.batched_rollout(jgrid, jstate(fields, True), T,
                                       detect_plane=DP, policy=policy,
                                       collect_fields=True)
    s, outs = cf.batched_rollout(grid, tstate(fields, True), T,
                                 detect_plane=DP, policy=policy,
                                 collect_fields=True)
    assert_states_match(s, s_ref, 1e-8)
    assert_outs_match(outs, o_ref, 1e-8)


def test_rand_rollouts_shapes(setup):
    """The random policy draws from a torch generator, the JAX one from a
    key: shapes and finiteness only."""
    jgrid, grid, fields, _ = setup
    gen = torch.Generator()
    gen.manual_seed(0)
    for batched in (False, True):
        f = fields if batched else fields[0]
        jfn, fn = ((jcf.batched_rollout, cf.batched_rollout) if batched
                   else (jcf.rollout, cf.rollout))
        _, o_ref = jfn(jgrid, jstate(f, batched), T, detect_plane=DP,
                       policy="rand")
        s, outs = fn(grid, tstate(f, batched), T, detect_plane=DP,
                     policy="rand", generator=gen)
        assert [tuple(a.shape) for a in outs] == [a.shape for a in o_ref]
        assert all(torch.isfinite(a).all() for a in (*outs, s.U, s.V))


def test_fullstep_switch_gives_same_trajectories(setup, monkeypatch):
    """PDE_RK3_FULLSTEP routing (rk3_cuda.FULLSTEP): kernel D and the staged
    step give the same rollouts and env steps, with the bounds of
    tests/test_rk3_fused.py's routing test; each setting reaches only its
    own path."""
    _, grid, fields, ops = setup
    results = {}
    for fullstep in (False, True):
        with monkeypatch.context() as m:
            m.setattr(rk, "FULLSTEP", fullstep)
            m.setattr(rk, {True: "rk3_step_kb",
                           False: "env_step_full_kb"}[fullstep],
                      lambda *a, **k: pytest.fail("wrong path"))
            kst = rk.state_to_kstate(tstate(fields[0]))
            results[fullstep] = (
                cf.batched_rollout(grid, tstate(fields, True), T,
                                   detect_plane=DP, policy="gt"),
                cf.rollout(grid, tstate(fields[0]), T, detect_plane=DP,
                           policy="gt"),
                rk.env_step_k(grid, kst, torch.as_tensor(ops[0]),
                              torch.as_tensor(ops[1])))
    (bs, bo), (ss, so), (ks, kp, _) = results[True]
    (bs0, bo0), (ss0, so0), (ks0, kp0, _) = results[False]
    for out, ref in ((bs, bs0), (ss, ss0), (ks, ks0)):
        assert rel(t2n(out.U), t2n(ref.U)) <= 1e-5
        assert rel(t2n(out.V), t2n(ref.V)) <= 1e-4
    for a, b in zip(bo[:2] + so[:2], bo0[:2] + so0[:2]):
        assert rel(t2n(a), t2n(b)) <= 1e-4
    np.testing.assert_allclose(t2n(bo[2]), t2n(bo0[2]), rtol=2e-4)
    assert rel(t2n(kp), t2n(kp0)) <= 1e-4


def test_batch_states_roundtrip(setup):
    _, grid, fields, _ = setup
    states = tstate(fields, True)
    k = rk.batch_states(states)
    assert k.U.shape == (NY + 1, 2 * NX * NZ) and k.dPdx.shape == (2,)
    np.testing.assert_array_equal(
        t2n(k.U[:, NX * NZ:]), t2n(rk.state_to_kstate(tstate(fields[1])).U))
    back = rk.unbatch_states(grid, k, 2)
    for name in ("U", "V", "W"):
        np.testing.assert_array_equal(t2n(getattr(back, name)),
                                      t2n(getattr(states, name)))


def test_init_batched_states(setup):
    _, grid, _, _ = setup
    gen = torch.Generator()
    gen.manual_seed(3)
    states = cf.init_batched_states(grid, 3, gen, noise=0.02)
    assert states.U.shape == (3, NX, NY + 1, NZ)
    assert states.dPdx.shape == (3,) and states.meanU0.shape == (3,)
    # independent draws, each a valid (no-slip, projected) state
    assert float((states.U[0] - states.U[1]).abs().max()) > 0
    div = cf.divergence(grid, states.U, states.V, states.W)
    assert float(div.abs().max()) < 1e-8


# ---------------------------------------------------------------------------
# developed turbulence
# ---------------------------------------------------------------------------

def test_init_turbulent_state_matches_jax(setup):
    """Mean profile and vortices (noise 0) to 1e-10; the noise is drawn
    from the generator (seeded: reproducible)."""
    jgrid, grid, _, _ = setup
    ref = jcf.init_turbulent_state(jgrid, jax.random.PRNGKey(0), noise=0.0)
    gen = torch.Generator()
    gen.manual_seed(0)
    out = cf.init_turbulent_state(grid, gen, noise=0.0)
    for k in ("U", "V", "W", "dPdx", "meanU0"):
        assert rel(t2n(getattr(out, k)), getattr(ref, k)) <= 1e-10, k
    noisy = [cf.init_turbulent_state(grid, torch.Generator().manual_seed(5))
             for _ in range(2)]
    np.testing.assert_array_equal(t2n(noisy[0].U), t2n(noisy[1].U))
    assert float((noisy[0].U - out.U).abs().max()) > 0


def test_spinup_chunk_matches_jax(setup):
    jgrid, grid, fields, _ = setup
    s_ref, stats_ref = jcf.spinup_chunk(jgrid, jstate(fields[0]), T)
    s, stats = cf.spinup_chunk(grid, tstate(fields[0]), T)
    assert stats.shape == (T, 4)
    assert_states_match(s, s_ref, 1e-8)
    np.testing.assert_allclose(t2n(stats), np.asarray(stats_ref), rtol=1e-8)


# ---------------------------------------------------------------------------
# NSControlEnv: step_n, spin-up, pde_loss
# ---------------------------------------------------------------------------

SMALL = dict(Nx=8, Ny=17, Nz=8, detect_plane=3)


@pytest.fixture
def env_path(tmp_path):
    """A state file written by the JAX env (its dump_state), so both envs
    start from the same fields."""
    path = str(tmp_path / "state.npz")
    JEnv(**SMALL, dtype=jnp.float64, noise_scale=0.02, seed=1).dump_state(
        path)
    return path


def test_step_n_matches_step(env_path):
    env1 = NSControlEnv(**SMALL, dtype=torch.float64, init_cond_path=env_path,
                        device="cpu")
    env2 = NSControlEnv(**SMALL, dtype=torch.float64, init_cond_path=env_path,
                        device="cpu")
    ops = np.random.default_rng(4).normal(size=(4, 2, 8, 8)) * 1e-3
    ops -= ops.mean(axis=(2, 3), keepdims=True)
    for i in range(4):
        p2_single, _, _, info_single = env1.step(ops[i, 0], ops[i, 1])
    p2_seq, infos = env2.step_n(ops[:, 0], ops[:, 1])
    assert p2_seq.shape == (4, 8, 8)
    np.testing.assert_allclose(p2_seq[-1], p2_single, rtol=1e-9, atol=1e-11)
    for k, v in infos.items():
        assert v.shape == (4,)
        np.testing.assert_allclose(v[-1], info_single[k], rtol=1e-9,
                                   atol=1e-11, err_msg=k)
    np.testing.assert_allclose(env2.U, env1.U, rtol=1e-9, atol=1e-11)


def test_spinup_steps_matches_jax(env_path):
    jenv = JEnv(**SMALL, dtype=jnp.float64, init_cond_path=env_path,
                spinup_steps=3)
    env = NSControlEnv(**SMALL, dtype=torch.float64, init_cond_path=env_path,
                       spinup_steps=3, device="cpu")
    for name in ("U", "V", "W"):
        assert rel(getattr(env, name), getattr(jenv, name)) <= 1e-8, name
    np.testing.assert_allclose(env.dPdx, jenv.dPdx, rtol=1e-8)
    for k, v in jenv.info_init.items():
        np.testing.assert_allclose(env.info_init[k], v, rtol=1e-8,
                                   atol=1e-10, err_msg=k)


def test_pde_loss_matches_jax(env_path):
    jenv = JEnv(**SMALL, dtype=jnp.float64, init_cond_path=env_path)
    env = NSControlEnv(**SMALL, dtype=torch.float64, init_cond_path=env_path,
                       device="cpu")
    assert float(env.pde_loss(env.U, env.V, env.V, env.W, env.dPdx)) == 0.0
    V2 = env.V + 0.01 * np.random.default_rng(5).normal(size=env.V.shape)
    ref = float(jenv.pde_loss(jenv.U, jenv.V, V2, jenv.W, jenv.dPdx))
    out = float(env.pde_loss(env.U, env.V, V2, env.W, env.dPdx))
    assert ref > 0
    np.testing.assert_allclose(out, ref, rtol=1e-10)


# ---------------------------------------------------------------------------
# datasets on disk
# ---------------------------------------------------------------------------

def assert_same_folders(ours, ref, rtol):
    files = sorted(os.listdir(ref))
    assert sorted(os.listdir(ours)) == files
    for f in files:
        a = np.load(os.path.join(ours, f), allow_pickle=True)
        b = np.load(os.path.join(ref, f), allow_pickle=True)
        if f == "metadata.npy":
            a, b = a.item(), b.item()
            assert sorted(a) == sorted(b)
            for k in b:
                if isinstance(b[k], dict):
                    assert sorted(a[k]) == sorted(b[k]), k
                    for kk in b[k]:
                        np.testing.assert_allclose(a[k][kk], b[k][kk],
                                                   rtol=rtol, atol=1e-12,
                                                   err_msg=f"{k}/{kk}")
                else:
                    assert a[k] == b[k], k
        else:
            assert a.shape == b.shape, f
            assert rel(a, b) <= rtol, f


def test_save_collected_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    result = {"p2": rng.normal(size=(5, 8, 8)),
              "v_plane": rng.normal(size=(5, 8, 8))}
    jsave_collected(result, str(tmp_path / "ref"))
    save_collected_dataset(result, str(tmp_path / "ours"))
    assert_same_folders(str(tmp_path / "ours"), str(tmp_path / "ref"), 0.0)


@pytest.mark.parametrize("save_fields", [False, True])
def test_generate_channel_dataset_matches_jax(env_path, tmp_path,
                                              save_fields):
    jenv = JEnv(**SMALL, dtype=jnp.float64, init_cond_path=env_path)
    env = NSControlEnv(**SMALL, dtype=torch.float64, init_cond_path=env_path,
                       device="cpu")
    jgenerate(str(tmp_path / "ref"), 4, env=jenv, detect_plane=3,
              save_fields=save_fields)
    generate_channel_dataset(str(tmp_path / "ours"), 4, env=env,
                             detect_plane=3, save_fields=save_fields)
    assert len(os.listdir(tmp_path / "ours")) == 1 + 4 * (5 if save_fields
                                                          else 2)
    assert_same_folders(str(tmp_path / "ours"), str(tmp_path / "ref"), 1e-8)
    assert rel(env.U, jenv.U) <= 1e-8


# ---------------------------------------------------------------------------
# physics oracles (tests/test_channel_env.py) against the port
# ---------------------------------------------------------------------------

def small_grid(Ny=17):
    return cf.make_channel_grid(Nx=8, Ny=Ny, Nz=8, dtype=torch.float64,
                                device="cpu")


def test_rhs_matches_loop_oracle():
    grid = small_grid()
    U, V, W = (torch.as_tensor(np.array(a)) for a in random_state(grid))
    out = cf.compute_rhs(grid, U, V, W, 0.003)
    for a, b in zip(out, rhs_oracle(grid, U, V, W, 0.003)):
        np.testing.assert_allclose(t2n(a), b, rtol=1e-10, atol=1e-12)


def test_poisson_solver_residual():
    """(DD + kk) p_hat = rhs_hat per wavenumber, with the regularized
    (0,0,0) term."""
    grid = small_grid()
    rhs = np.random.default_rng(1).normal(size=(8, 16, 8))
    p = t2n(cf.poisson_solve(grid, torch.as_tensor(rhs)))
    rhs_hat = np.fft.fft(np.fft.rfft(rhs, axis=2), axis=0)
    p_hat = np.fft.fft(np.fft.rfft(p, axis=2), axis=0)
    kk = (t2n(grid.kxx)[:, None, None] + t2n(grid.kzz)[None, None, :5])
    dd, dl, du = (t2n(a) for a in (grid.DD_diag, grid.DD_lower,
                                   grid.DD_upper))
    applied = (dd[None, :, None] + kk) * p_hat
    applied[:, 1:] += dl[None, :, None] * p_hat[:, :-1]
    applied[:, :-1] += du[None, :, None] * p_hat[:, 1:]
    applied[0, 0, 0] += 0.5 * dd[0] * p_hat[0, 0, 0]
    np.testing.assert_allclose(applied, rhs_hat, rtol=1e-8, atol=1e-8)


def _staged_step(grid, state, o1, o2):
    kst = rk.state_to_kstate(state)
    C = grid.Nx * grid.Nz
    U, V, W, dPdx = rk.rk3_step_k(grid, kst.U, kst.V, kst.W, kst.dPdx,
                                  kst.meanU0, o1.reshape(1, C),
                                  o2.reshape(1, C))
    return rk.kstate_to_state(grid, kst.replace(U=U, V=V, W=W, dPdx=dPdx))


STEPS = {"rk3_step": cf.rk3_step, "staged": _staged_step}


@pytest.mark.parametrize("step", sorted(STEPS))
def test_laminar_flow_is_steady(step):
    grid = small_grid(Ny=33)
    state = cf.init_state(grid, dPdx=cf.DEFAULT_DPDX)
    zeros = torch.zeros((8, 8), dtype=torch.float64)
    U0 = state.U.clone()
    for _ in range(10):
        state = STEPS[step](grid, state, zeros, zeros)
    drift = float((state.U - U0).abs().max())
    assert drift < 1e-4 * float(state.U.abs().max())
    for _ in range(10):
        state = STEPS[step](grid, state, zeros, zeros)
    assert float((state.U - U0).abs().max()) < 4 * drift + 1e-12


@pytest.mark.parametrize("step", sorted(STEPS))
def test_mass_flow_held_constant(step):
    grid = small_grid()
    gen = torch.Generator()
    gen.manual_seed(0)
    state = cf.init_state(grid, generator=gen, noise=0.01)
    target = float(state.meanU0)
    zeros = torch.zeros((8, 8), dtype=torch.float64)
    for _ in range(5):
        state = STEPS[step](grid, state, zeros, zeros)
    now = float(cf.calculate_mean_u(grid, state.U))
    assert abs(now - target) < 1e-4 * max(abs(target), 1e-8)
