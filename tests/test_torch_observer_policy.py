"""The observer-policy slice as a whole (dataset -> normalizers -> observer
-> `fno` / `optimal-observer` policy -> closed loop) against the JAX
package's, in float64 on the CPU on the 8x33x8 env.  The observer's
parameters come from `model.init`, perturbed with numpy from a seed, and
go to flax as they are and to the port through `load_jax_params`; the
normalizers' statistics are numpy arrays from the same generator."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.control import make_policy as jmake_policy
from pde_policylearning_tpu.control import run_closed_loop as jrun
from pde_policylearning_tpu.data.channel import PDEDataset as JPDEDataset
from pde_policylearning_tpu.envs import NSControlEnv as JEnv
from pde_policylearning_tpu.models.observers import \
    FNO2dObserver as JFNO2dObserver
from pde_policylearning_tpu.ops.normalization import \
    NormalizerGivenMeanStd as JNorm
from pde_policylearning_torch.control import make_policy, run_closed_loop
from pde_policylearning_torch.control.loop import SCOREBOARD_KEYS
from pde_policylearning_torch.data import PDEDataset, generate_channel_dataset
from pde_policylearning_torch.envs import NSControlEnv
from pde_policylearning_torch.models import FNO2dObserver
from pde_policylearning_torch.ops import spectral_cuda
from pde_policylearning_torch.ops.normalization import NormalizerGivenMeanStd
from pde_policylearning_torch.utils.transplant import load_jax_params

SMALL = dict(Nx=8, Ny=33, Nz=8, detect_plane=5)
DP = SMALL["detect_plane"]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-300))


@pytest.fixture
def setup(tmp_path):
    """JAX env and port env from one state; one observer in both
    frameworks; one pair of normalizers in both."""
    rng = np.random.default_rng(0)
    jenv = JEnv(**SMALL, dtype=jnp.float64, noise_scale=0.02, seed=1)
    path = str(tmp_path / "state.npz")
    jenv.dump_state(path)
    env = NSControlEnv(**SMALL, dtype=torch.float64, init_cond_path=path,
                       device="cpu")

    jmodel = JFNO2dObserver(6, 6, 8)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 1)))
    tree = jax.tree.map(
        lambda a: np.asarray(a, np.float64) + 0.1 * rng.normal(size=a.shape),
        jax.tree.map(np.asarray, variables["params"]))
    model = load_jax_params(
        FNO2dObserver(6, 6, 8, device="cpu", dtype=torch.float64), tree)
    model.requires_grad_(False)

    stats = {k: (rng.normal(size=(8, 8)) * s, 0.5 + rng.random((8, 8)) * s)
             for k, s in (("p", 1e-3), ("v", 1e-2))}
    jnorms = {k: JNorm(jnp.asarray(m), jnp.asarray(s))
              for k, (m, s) in stats.items()}
    norms = {k: NormalizerGivenMeanStd(torch.as_tensor(m), torch.as_tensor(s))
             for k, (m, s) in stats.items()}
    jparams = jax.tree.map(jnp.asarray, tree)
    return jenv, env, (jmodel, jparams, jnorms), (model, norms)


def assert_loops_match(jenv, env, jpolicy, policy, n_steps):
    ref = jrun(jenv, jpolicy, n_steps=n_steps, log_interval=3,
               detect_plane=DP, verbose=False, collect_planes=True)
    out = run_closed_loop(env, policy, n_steps=n_steps, log_interval=3,
                          detect_plane=DP, verbose=False,
                          collect_planes=True)
    # state and action to 1e-8, as tests/test_torch_control.py holds `gt`
    for name in ("U", "V", "W"):
        assert rel(getattr(env, name), getattr(jenv, name)) < 1e-8, name
    assert np.abs(ref["opV2"]).max() > 0
    assert rel(out["opV2"], ref["opV2"]) < 1e-8
    assert rel(out["p2"], ref["p2"]) < 1e-8
    for k in SCOREBOARD_KEYS:
        atol = 1e-10 if "divergence" in k else 0.0
        np.testing.assert_allclose(out["series"][k], ref["series"][k],
                                   rtol=1e-8, atol=atol, err_msg=k)
    return out


@pytest.mark.parametrize("shaping", ["scaled_clipped", "plain", "no_norms"])
def test_fno_closed_loop_matches_jax(setup, shaping):
    """Six closed-loop steps of the `fno` policy: scale, clip, then the
    mean subtraction, with and without normalizers."""
    jenv, env, (jmodel, jparams, jn), (model, n) = setup
    kw = dict(detect_plane=DP)
    if shaping == "scaled_clipped":
        # a clip that bites: the perturbed observer predicts O(1) planes
        kw.update(action_scale=0.3, action_clip=0.01)
    jkw, tkw = dict(kw), dict(kw)
    if shaping != "no_norms":
        jkw.update(p_norm=jn["p"], v_norm=jn["v"])
        tkw.update(p_norm=n["p"], v_norm=n["v"])
    else:
        jkw.update(action_scale=1e-3)
        tkw.update(action_scale=1e-3)
    out = assert_loops_match(
        jenv, env,
        jmake_policy("fno", jenv.grid, model=jmodel, params=jparams, **jkw),
        make_policy("fno", env.grid, model=model, **tkw), 6)
    # zero net flux after all shaping
    assert np.abs(out["opV2"].mean(axis=(1, 2))).max() < 1e-12
    if shaping == "scaled_clipped":
        # the clip bites: many points of a plane sit on one clipped value,
        # shifted by the plane mean
        first = out["opV2"][0]
        assert np.ptp(first) <= 0.02 + 1e-12
        assert (np.abs(first - first.min()) < 1e-12).sum() >= 10


@pytest.mark.parametrize("norms", ["both", "none"])
def test_optimal_observer_closed_loop_matches_jax(setup, norms):
    """Three closed-loop steps of `optimal-observer` with three Adam steps
    each (a fresh optimizer every control step, the mean subtracted after
    the loop)."""
    jenv, env, (jmodel, jparams, jn), (model, n) = setup
    kw = dict(detect_plane=DP, opt_steps=3, opt_lr=1e-3, reg_weight=0.1)
    jkw, tkw = dict(kw), dict(kw)
    if norms == "both":
        jkw.update(bound_v_norm=jn["v"], plane_norm=jn["p"])
        tkw.update(bound_v_norm=n["v"], plane_norm=n["p"])
    out = assert_loops_match(
        jenv, env,
        jmake_policy("optimal-observer", jenv.grid, model=jmodel,
                     params=jparams, **jkw),
        make_policy("optimal-observer", env.grid, model=model, **tkw), 3)
    assert np.abs(out["opV2"].mean(axis=(1, 2))).max() < 1e-12


def test_optimal_observer_moves_the_action(setup):
    """One control step: the action differs from `gt`'s by about
    opt_steps * opt_lr per point (Adam's first steps), and the policy
    leaves no gradient behind."""
    _, env, _, (model, n) = setup
    from pde_policylearning_torch.envs import rk3_cuda as rk
    kst = rk.state_to_kstate(env.state)
    policy = make_policy("optimal-observer", env.grid, model=model,
                         detect_plane=DP, opt_steps=3, opt_lr=1e-3)
    opV1, opV2 = policy(kst, None, None)
    g1, g2 = make_policy("gt", env.grid, detect_plane=DP)(kst, None, None)
    assert torch.equal(opV1, g1)
    assert not opV2.requires_grad and opV2.shape == (8, 8)
    diff = (opV2 - (g2 - g2.mean()).reshape(8, 8)).abs()
    assert 1e-4 < float(diff.max()) < 1e-2
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("name,per_step", [("fno", 4),
                                           ("optimal-observer", 3 * 8)])
def test_contractions_per_control_step(setup, name, per_step, monkeypatch):
    """Through the kernel route in float32, every `fno` step runs 4 corner
    contractions (one per Fourier layer) and every `optimal-observer` step
    opt_steps x (4 forward + 4 backward, dx only: the observer is frozen);
    on the card each is one launch of the fused corner entry, and the
    strided entry (the weight gradient) is never reached."""
    _, _, (_, _, _), (model64, n) = setup
    calls, strided = [], []
    real, real_contract = spectral_cuda._corners, spectral_cuda._contract
    monkeypatch.setattr(
        spectral_cuda, "_corners", lambda *a, adjoint=False:
        calls.append(adjoint) or real(*a, adjoint=adjoint))
    monkeypatch.setattr(
        spectral_cuda, "_contract",
        lambda *a, **k: strided.append(k) or real_contract(*a, **k))
    env = NSControlEnv(**SMALL, noise_scale=0.02, seed=1, device="cpu")
    model = FNO2dObserver(6, 6, 8, device="cpu", conv_backend="kernel")
    model.load_state_dict(model64.state_dict())
    model.requires_grad_(False)
    policy = make_policy(name, env.grid, model=model, detect_plane=DP,
                         opt_steps=3, action_scale=0.3, action_clip=0.01)
    res = run_closed_loop(env, policy, n_steps=2, log_interval=2,
                          detect_plane=DP, verbose=False)
    assert len(calls) == 2 * per_step and not strided
    assert sum(calls) == (0 if name == "fno" else 2 * per_step // 2)
    for k in SCOREBOARD_KEYS:
        assert np.isfinite(res["series"][k]).all()


def test_policy_needs_its_model_and_unported_names_say_so():
    """The observer policies need their model; the two flagship policies
    are factories, not names, in both packages (`make_policy` refuses
    them as the JAX one does), and an unknown name is refused."""
    grid = NSControlEnv(**SMALL, dtype=torch.float64, device="cpu").grid
    jgrid = JEnv(**SMALL, dtype=jnp.float64).grid
    for name in ("fno", "rno", "transformer", "optimal-observer"):
        with pytest.raises(ValueError, match="needs the observer"):
            make_policy(name, grid)
    for name in ("optimal-policy-observer", "fullfield-optimal-observer",
                 "pid"):
        with pytest.raises(ValueError, match="Not supported policy name"):
            jmake_policy(name, jgrid)
        with pytest.raises(ValueError, match="Not supported policy name"):
            make_policy(name, grid)


@pytest.mark.parametrize("kw", [dict(), dict(downsample_rate=2, x_range=3,
                                             y_range=4),
                                dict(use_patch=True, x_range=4, y_range=4)])
def test_pde_dataset_matches_jax(tmp_path, kw):
    """The folder that `generate_channel_dataset` writes, read back by
    both packages' `PDEDataset.from_folder`."""
    env = NSControlEnv(**SMALL, dtype=torch.float64, noise_scale=0.02,
                       seed=1, device="cpu")
    folder = generate_channel_dataset(str(tmp_path / "ds"), 7, env=env,
                                      detect_plane=DP)
    index = [0, 2, 3, 6]
    if not kw:
        kw = dict(x_range=8, y_range=8)
    ref = JPDEDataset.from_folder(folder, index, **kw)
    ours = PDEDataset.from_folder(folder, index, **kw, device="cpu",
                                  dtype=torch.float64)
    assert len(ours) == len(ref)
    np.testing.assert_array_equal(ours.p, ref.p)
    np.testing.assert_array_equal(ours.v, ref.v)
    for a, b in ((ours.p_norm, ref.p_norm), (ours.v_norm, ref.v_norm)):
        np.testing.assert_array_equal(a.mean.numpy(), np.asarray(b.mean))
        np.testing.assert_array_equal(a.std.numpy(), np.asarray(b.std))
        assert a.eps == b.eps
    for a, b in zip(ours.arrays(), ref.arrays(jnp.float64)):
        assert tuple(a.shape) == b.shape and a.shape[-1] == 1
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)


def test_slice_end_to_end_float32(tmp_path):
    """What a user runs, in float32 with the plain versions on the CPU:
    collect planes, read them back, build the seeded observer, serve it
    through both policies."""
    env = NSControlEnv(**SMALL, noise_scale=0.05, seed=0, device="cpu")
    folder = generate_channel_dataset(str(tmp_path / "ds"), 12, env=env,
                                      detect_plane=DP)
    ds = PDEDataset.from_folder(folder, range(12), x_range=8, y_range=8,
                                device="cpu")
    p, v = ds.arrays()
    assert p.shape == (12, 8, 8, 1) and v.dtype == torch.float32
    assert torch.isfinite(p).all() and torch.isfinite(v).all()
    model = FNO2dObserver(6, 6, 8, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    for name in ("fno", "optimal-observer"):
        policy = make_policy(name, env.grid, model=model, detect_plane=DP,
                             p_norm=ds.p_norm, v_norm=ds.v_norm,
                             action_scale=0.3, action_clip=0.01, opt_steps=2)
        res = run_closed_loop(env, policy, n_steps=4, log_interval=2,
                              detect_plane=DP, verbose=False)
        for k in SCOREBOARD_KEYS:
            assert res["series"][k].shape == (4,)
            assert np.isfinite(res["series"][k]).all()


def _sequence_observer(name, rng):
    """A flax observer of (B, T, 8, 8, 1) sequences with numpy parameters
    on the shapes of its tree, and the port's with the same ones."""
    from pde_policylearning_tpu.models.observers import \
        RNO2dObserver as JRNO2dObserver
    from pde_policylearning_tpu.models.transformer import \
        SimpleTransformer as JSimpleTransformer
    from pde_policylearning_torch.models import (RNO2dObserver,
                                                 SimpleTransformer)
    if name == "rno":
        jmodel = JRNO2dObserver(3, 3, 6)
        model = RNO2dObserver(3, 3, 6, device="cpu", dtype=torch.float64)
    else:
        kw = dict(n_hidden=8, n_head=2, freq_dim=6, fourier_modes=3,
                  num_encoder_layers=2, num_regressor_layers=2)
        jmodel = JSimpleTransformer(**kw)
        model = SimpleTransformer(**kw, device="cpu", dtype=torch.float64)
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x),
        jnp.zeros((1, 2, 8, 8, 1)))["params"]
    tree = jax.tree.map(lambda s: 0.2 * rng.normal(size=s.shape), shapes)
    load_jax_params(model, tree)
    model.requires_grad_(False)
    return jmodel, jax.tree.map(jnp.asarray, tree), model


@pytest.mark.parametrize("name", ["rno", "transformer"])
def test_sequence_observer_closed_loops_match_jax(setup, name):
    """Six closed-loop steps of the `rno` and `transformer` policies: the
    plane repeated over model_timestep = 2 steps, the transformer's last
    step, then scale, clip and the mean subtraction; float64, 1e-8, zero
    net flux after the clip."""
    jenv, env, (_, _, jn), (_, n) = setup
    rng = np.random.default_rng(12)
    jmodel, jparams, model = _sequence_observer(name, rng)
    # the seeded observers predict nearly flat planes: a velocity
    # normalizer that varies over the plane makes the clip bite on a part
    m, sd = 0.05 * rng.normal(size=(8, 8)), 0.5 + rng.random((8, 8))
    jv, v = JNorm(jnp.asarray(m), jnp.asarray(sd)), \
        NormalizerGivenMeanStd(torch.as_tensor(m), torch.as_tensor(sd))
    kw = dict(detect_plane=DP, model_timestep=2, action_scale=0.3,
              action_clip=0.1)
    out = assert_loops_match(
        jenv, env,
        jmake_policy(name, jenv.grid, model=jmodel, params=jparams,
                     p_norm=jn["p"], v_norm=jv, **kw),
        make_policy(name, env.grid, model=model, p_norm=n["p"], v_norm=v,
                    **kw), 6)
    assert np.abs(out["opV2"].mean(axis=(1, 2))).max() < 1e-12
    first = out["opV2"][0]
    on_clip = max((np.abs(first - e) < 1e-12).sum()
                  for e in (first.min(), first.max()))
    assert np.ptp(first) <= 0.2 + 1e-12 and 4 <= on_clip <= 60


@pytest.mark.parametrize("name,per_step", [("rno", 28), ("transformer", 2)])
def test_sequence_observer_contractions_per_step(name, per_step,
                                                 monkeypatch):
    """Through the kernel route in float32: every `rno` step runs 28
    corner contractions (8 per cell step over 2 + 1 scanned steps, 2 of
    the regressor per predict step), every `transformer` step one per
    regressor layer; all forward, no weight gradient."""
    calls, strided = [], []
    real, real_contract = spectral_cuda._corners, spectral_cuda._contract
    monkeypatch.setattr(
        spectral_cuda, "_corners", lambda *a, adjoint=False:
        calls.append(adjoint) or real(*a, adjoint=adjoint))
    monkeypatch.setattr(
        spectral_cuda, "_contract",
        lambda *a, **k: strided.append(k) or real_contract(*a, **k))
    _, _, model64 = _sequence_observer(name, np.random.default_rng(13))
    model = model64.float()
    for m in model.modules():
        if hasattr(m, "conv_backend"):
            m.conv_backend = "kernel"
    env = NSControlEnv(**SMALL, noise_scale=0.02, seed=1, device="cpu")
    policy = make_policy(name, env.grid, model=model, detect_plane=DP,
                         model_timestep=2, action_scale=0.3,
                         action_clip=0.01)
    res = run_closed_loop(env, policy, n_steps=2, log_interval=2,
                          detect_plane=DP, verbose=False)
    assert calls == [False] * (2 * per_step) and not strided
    for k in SCOREBOARD_KEYS:
        assert np.isfinite(res["series"][k]).all()
