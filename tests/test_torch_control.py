"""The port's closed-loop control slice (env, policies, loop) against the
JAX package's, in float64 on the CPU, from the same initial state."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.control import make_policy as jmake_policy
from pde_policylearning_tpu.control import run_closed_loop as jrun
from pde_policylearning_tpu.envs import NSControlEnv as JEnv
from pde_policylearning_torch.control import make_policy, run_closed_loop
from pde_policylearning_torch.control.loop import SCOREBOARD_KEYS
from pde_policylearning_torch.envs import NSControlEnv

SMALL = dict(Nx=8, Ny=17, Nz=8, detect_plane=3)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-300))


def assert_scoreboards_match(ours, ref, rtol):
    for k in SCOREBOARD_KEYS:
        # the divergence reward of a projected field is summed roundoff,
        # so it takes an absolute bound only (a real failure is O(1))
        atol = 1e-10 if "divergence" in k else 0.0
        np.testing.assert_allclose(ours[k], ref[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.fixture
def envs(tmp_path):
    """A JAX env and a port env that start from the same state (the JAX
    env's, handed over through its own dump_state file)."""
    jenv = JEnv(**SMALL, dtype=jnp.float64, noise_scale=0.02, seed=1)
    path = str(tmp_path / "state.npz")
    jenv.dump_state(path)
    env = NSControlEnv(**SMALL, dtype=torch.float64, init_cond_path=path,
                       device="cpu")
    return jenv, env


@pytest.mark.parametrize("policy", ["gt", "unmanipulated"])
def test_closed_loop_matches_jax(envs, policy):
    jenv, env = envs
    ref = jrun(jenv, jmake_policy(policy, jenv.grid, detect_plane=3),
               n_steps=6, log_interval=3, detect_plane=3, verbose=False)
    out = run_closed_loop(env, make_policy(policy, env.grid, detect_plane=3),
                          n_steps=6, log_interval=3, detect_plane=3,
                          verbose=False)
    assert_scoreboards_match(out["series"], ref["series"], 1e-8)
    for name in ("U", "V", "W"):
        assert rel(getattr(env, name), getattr(jenv, name)) < 1e-8, name
    np.testing.assert_allclose(env.dPdx, jenv.dPdx, rtol=1e-8)


def test_rand_policy_runs(envs):
    _, env = envs
    res = run_closed_loop(env, make_policy("rand", env.grid, detect_plane=3,
                                           rand_scale=0.01),
                          n_steps=6, log_interval=3, detect_plane=3,
                          verbose=False, collect_planes=True)
    for k in SCOREBOARD_KEYS:
        assert res["series"][k].shape == (6,)
        assert np.isfinite(res["series"][k]).all()
    assert res["opV2"].shape == (6, 8, 8)
    assert "drag_reduction_relative/1_shear_stress" in res["series"]


def test_unported_policy_names_the_roadmap_item():
    """`optimal-policy-observer` is ported as a factory of its own
    (`make_optimal_policy_observer`), as in the JAX package, whose
    `make_policy` refuses the name as this one does."""
    from pde_policylearning_torch.control import make_optimal_policy_observer
    env_grid = NSControlEnv(**SMALL, dtype=torch.float64, device="cpu").grid
    with pytest.raises(ValueError, match="Not supported policy name"):
        make_policy("optimal-policy-observer", env_grid)
    assert callable(make_optimal_policy_observer)


def test_divergence_guard():
    env = NSControlEnv(**SMALL, dtype=torch.float64, device="cpu")

    def bad_policy(state, p2, generator):
        big = 1e4 * torch.ones((8, 8), dtype=state.U.dtype)
        return big, -big

    with pytest.raises(RuntimeError, match="diverged"):
        run_closed_loop(env, bad_policy, n_steps=40, log_interval=10,
                        verbose=False)


def test_bench_grid_from_snapshot_matches_jax():
    """Two gt steps at 32x130x32 from the packaged snapshot, float64."""
    jenv = JEnv(32, 130, 32, detect_plane=25, dtype=jnp.float64)
    env = NSControlEnv(32, 130, 32, detect_plane=25, dtype=torch.float64,
                       device="cpu")
    np.testing.assert_array_equal(env.U, jenv.U)
    ref = jrun(jenv, jmake_policy("gt", jenv.grid, detect_plane=25),
               n_steps=2, log_interval=2, verbose=False)
    out = run_closed_loop(env, make_policy("gt", env.grid, detect_plane=25),
                          n_steps=2, log_interval=2, verbose=False)
    assert_scoreboards_match(out["series"], ref["series"], 1e-8)
