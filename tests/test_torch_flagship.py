"""The flagship gradient-control slice of the port against the JAX
package's, float64 on the CPU on the 8x33x8 env: the physics-informed loss
and full-field training, the two policies through the frozen full-field
observer in the closed loop, and both entries (`run_pde_observers`'
full-field branch and `run_control`) end to end.

The JAX functions of this slice cast their inputs to float32 (for the
TPU); these tests run them with that name bound to float64 in their own
modules (`F64`), so that both packages compute in float64, as the port
computes in the data's dtype.  The flax parameters are numpy draws on the
shapes of `model.init`'s tree, handed to flax as they are and to the port
through `load_jax_params`."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pde_policylearning_tpu.control import loop as jloop
from pde_policylearning_tpu.control import policies as jpolicies
from pde_policylearning_tpu.data import channel as jchannel
from pde_policylearning_tpu.envs import NSControlEnv as JEnv
from pde_policylearning_tpu.envs import channel_flow as jcf
from pde_policylearning_tpu.models import pino as jpino
from pde_policylearning_tpu.ops.normalization import \
    NormalizerGivenMeanStd as JNorm
from pde_policylearning_tpu.training import observer_fullfield as jff
from pde_policylearning_torch import run_control as rc
from pde_policylearning_torch import run_pde_observers as rpo
from pde_policylearning_torch.control import (
    StatefulPolicy, make_fullfield_optimal_observer,
    make_optimal_policy_observer, run_closed_loop)
from pde_policylearning_torch.control.loop import SCOREBOARD_KEYS
from pde_policylearning_torch.data import (FullFieldNSDataset,
                                           generate_channel_dataset)
from pde_policylearning_torch.envs import NSControlEnv
from pde_policylearning_torch.envs import channel_flow as cf
from pde_policylearning_torch.models import (FNO2dObserver,
                                             PINObserverFullField,
                                             PolicyModel2D)
from pde_policylearning_torch.ops.normalization import NormalizerGivenMeanStd
from pde_policylearning_torch.training import (pde_loss_fields,
                                               save_checkpoint,
                                               train_fullfield_observer)
from pde_policylearning_torch.utils import DotDict, load_yaml, transplant
from pde_policylearning_torch.utils.transplant import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(Nx=8, Ny=33, Nz=8, detect_plane=5)
DP = SMALL["detect_plane"]
CPU64 = dict(device="cpu", dtype=torch.float64)
# the shapes of tests/test_control.py and tests/test_fullfield_observer.py
MODEL = dict(modes1=(2, 2), modes2=(2, 2), modes3=(1, 1), layers=(8, 8, 8),
             fc_dim=8, in_dim=1)


class F64:
    """`jax.numpy` with `float32` naming float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den else \
        float(np.linalg.norm(a))


def tree_for(jmodel, rng, x_shape, scale=0.3):
    shapes = jax.eval_shape(
        lambda x, r: jmodel.init(jax.random.PRNGKey(0), x, r),
        jnp.zeros(x_shape), jnp.ones((x_shape[0],)))["params"]
    return jax.tree.map(lambda s: scale * rng.normal(size=s.shape), shapes)


def carried(model, tree):
    """A flax tree in the port's names and layouts, {name: array}."""
    owners = dict(model.named_modules())
    out = {}
    for name, v in transplant._flatten(jax.tree.map(np.asarray,
                                                    tree)).items():
        prefix, _, leaf = name.rpartition(".")
        leaf, v = transplant._carry(owners.get(prefix), leaf, v)
        out[f"{prefix}.{leaf}"] = v
    return out


# ---------------------------------------------------------------------------
# the physics-informed loss and full-field training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fields(tmp_path_factory):
    """8 steps of the 8x33x8 env in float64 with their fields; the JAX
    package's FullFieldNSDataset of them in sequences of 2, and the port's
    on the same arrays."""
    env = NSControlEnv(**SMALL, dtype=torch.float64, noise_scale=0.05,
                       seed=2, device="cpu")
    folder = generate_channel_dataset(
        str(tmp_path_factory.mktemp("ff")), 8, env=env, detect_plane=DP,
        save_fields=True)
    planes = [-2, -4]
    jds = jchannel.FullFieldNSDataset.from_folder(folder, np.arange(8),
                                                  planes, timestep=2)
    norm = NormalizerGivenMeanStd(
        *(torch.tensor(np.asarray(a)) for a in (jds.bound_v_norm.mean,
                                                jds.bound_v_norm.std)))
    ds = FullFieldNSDataset(
        v_plane=jds.v_plane, v_field=jds.v_field, U=jds.U, V=jds.V,
        W=jds.W, re=jds.re, dpdx=jds.dpdx, bound_v_norm=norm)
    return folder, planes, jds, ds


def test_pde_loss_fields_matches_jax(fields):
    """One field pair as the JAX function takes it, and the batched form
    the port's training uses: one value per field."""
    _, planes, jds, _ = fields
    grid = cf.make_channel_grid(8, 33, 8, **CPU64)
    jgrid = jcf.make_channel_grid(8, 33, 8, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    U, V, W = (a[:, 0] for a in (jds.U, jds.V, jds.W))      # (4, X, Y, Z)
    V_pred = V + 1e-3 * rng.normal(size=V.shape)
    dpdx = jds.dpdx[:, 0]
    batched = pde_loss_fields(grid, *map(torch.tensor, (U, V, V_pred, W)),
                              torch.tensor(dpdx).reshape(4, 1, 1, 1))
    assert batched.shape == (4,)
    for i in range(4):
        ref = jff.pde_loss_fields(jgrid, U[i], V[i], V_pred[i], W[i],
                                  dpdx[i])
        ours = pde_loss_fields(grid, *(torch.tensor(a[i]) for a in
                                       (U, V, V_pred, W)),
                               float(dpdx[i]))
        assert float(ref) > 0
        assert rel(ours, ref) <= 1e-12 and rel(batched[i], ref) <= 1e-12


@pytest.mark.parametrize("pde_loss_weight", [0.0, 1.0])
def test_fullfield_training_matches_jax(fields, pde_loss_weight,
                                        monkeypatch):
    """Two epochs of one batch (N == batch_size, sequences of 2 steps) from
    the same parameters: the loss history (total, data, pde) and every
    parameter after training within 1e-8."""
    _, planes, jds, ds = fields
    rng = np.random.default_rng(1)
    jmodel = jpino.PINObserverFullField(plane_num=2, **MODEL)
    tree = tree_for(jmodel, rng, (1, 8, 8, 2, 1))

    class Init64:
        """The JAX model with its init giving the float64 tree."""

        def init(self, rng_, x, re):
            return {"params": jax.tree.map(jnp.asarray, tree)}

        def apply(self, variables, x, re):
            return jmodel.apply(variables, x, re)

    monkeypatch.setattr(jff, "jnp", F64())
    jgrid = jcf.make_channel_grid(8, 33, 8, dtype=jnp.float64)
    kw = dict(plane_indexs=planes, n_epochs=2, batch_size=4,
              learning_rate=1e-3, pde_loss_weight=pde_loss_weight,
              verbose=False)
    jparams, jhist = jff.train_fullfield_observer(Init64(), jds, jgrid, **kw)
    model = load_jax_params(PINObserverFullField(plane_num=2, **MODEL,
                                                 **CPU64), tree)
    grid = cf.make_channel_grid(8, 33, 8, **CPU64)
    state, hist = train_fullfield_observer(model, ds, grid, **kw)
    for k in ("total", "data", "pde"):
        assert len(hist[k]) == 2
        np.testing.assert_allclose(hist[k], jhist[k], rtol=1e-8, atol=0,
                                   err_msg=k)
    assert (hist["pde"][0] > 0) == (pde_loss_weight > 0)
    want = carried(model, jparams)
    moved = 0
    for name, p in model.named_parameters():
        assert rel(p.detach(), want[name]) <= 1e-8, name
        assert torch.equal(state[name], p.detach())
        moved += int(not np.allclose(want[name], carried(model, tree)[name]))
    assert moved == len(want)


def test_eval_fullfield_observer_matches_jax(fields, monkeypatch):
    _, _, jds, ds = fields
    rng = np.random.default_rng(2)
    jmodel = jpino.PINObserverFullField(plane_num=2, **MODEL)
    tree = tree_for(jmodel, rng, (1, 8, 8, 2, 1))
    model = load_jax_params(PINObserverFullField(plane_num=2, **MODEL,
                                                 **CPU64), tree)
    monkeypatch.setattr(jff, "jnp", F64())
    ref = jff.eval_fullfield_observer(jmodel, jax.tree.map(jnp.asarray,
                                                           tree), jds,
                                      batch_size=3)
    from pde_policylearning_torch.training import eval_fullfield_observer
    assert abs(eval_fullfield_observer(model, ds, batch_size=3) - ref) \
        <= 1e-12 * ref


# ---------------------------------------------------------------------------
# the two policies in the closed loop
# ---------------------------------------------------------------------------

@pytest.fixture
def envs(tmp_path):
    jenv = JEnv(**SMALL, dtype=jnp.float64, noise_scale=0.02, seed=1)
    path = str(tmp_path / "state.npz")
    jenv.dump_state(path)
    env = NSControlEnv(**SMALL, dtype=torch.float64, init_cond_path=path,
                       device="cpu")
    return jenv, env


def observer_pair(rng, modes3=(1, 1)):
    kw = dict(MODEL, modes3=modes3)
    jobs = jpino.PINObserverFullField(plane_num=2, **kw)
    tree = tree_for(jobs, rng, (1, 8, 8, 1, 1))
    obs = load_jax_params(PINObserverFullField(plane_num=2, **kw, **CPU64),
                          tree)
    return jobs, jax.tree.map(jnp.asarray, tree), obs


def assert_loops_match(jenv, env, jpolicy, policy, n_steps=3):
    ref = jloop.run_closed_loop(jenv, jpolicy, n_steps=n_steps,
                                log_interval=n_steps, detect_plane=DP,
                                verbose=False, collect_planes=True)
    out = run_closed_loop(env, policy, n_steps=n_steps, log_interval=n_steps,
                          detect_plane=DP, verbose=False,
                          collect_planes=True)
    for name in ("U", "V", "W"):
        assert rel(getattr(env, name), getattr(jenv, name)) < 1e-8, name
    assert rel(out["opV2"], ref["opV2"]) < 1e-8
    assert rel(out["p2"], ref["p2"]) < 1e-8
    for k in SCOREBOARD_KEYS:
        atol = 1e-10 if "divergence" in k else 0.0
        np.testing.assert_allclose(out["series"][k], ref["series"][k],
                                   rtol=1e-8, atol=atol, err_msg=k)
    assert np.abs(out["opV2"].mean(axis=(1, 2))).max() < 1e-12
    return ref, out


@pytest.mark.parametrize("start", ["zero", "random"])
def test_optimal_policy_observer_closed_loop_matches_jax(envs, start,
                                                         monkeypatch):
    """Three closed-loop steps of `optimal-policy-observer`, three Adam
    steps each on the residual policy (a fresh Adam every control step, the
    policy's parameters carried), from the zeroed policy of the reference
    and from a random one."""
    jenv, env = envs
    rng = np.random.default_rng(3)
    jobs, jobs_p, obs = observer_pair(rng)
    jpol = jpino.PolicyModel2D(**MODEL)
    tree = tree_for(jpol, rng, (1, 8, 8, 1, 1))
    for leaf in ("kernel", "bias"):
        tree["head"]["fc2"][leaf] *= 1e-3
    if start == "zero":
        tree = jax.tree.map(np.zeros_like, tree)
    pol = load_jax_params(PolicyModel2D(**MODEL, **CPU64), tree)
    before = {n: p.detach().clone() for n, p in pol.named_parameters()}
    kw = dict(detect_plane=DP, opt_steps=3, opt_lr=1e-2, reg_weight=0.1)
    monkeypatch.setattr(jpolicies, "jnp", F64())
    ref, out = assert_loops_match(
        jenv, env,
        jpolicies.make_optimal_policy_observer(
            jenv.grid, observer_model=jobs, observer_params=jobs_p,
            policy_model=jpol, policy_params=jax.tree.map(jnp.asarray, tree),
            **kw),
        make_optimal_policy_observer(env.grid, observer_model=obs,
                                     policy_model=pol, **kw))
    # `gt`'s action is -v_plane of the step before.  From the zeroed
    # policy only fc2's bias ever gets a gradient (every other one passes
    # through fc2's zero kernel or a zero activation), so the residual is
    # constant over the plane and the mean subtraction removes it: the
    # policy is `gt`, in both packages.  From a random one it moves.
    off_gt = np.abs(out["opV2"][1:] + ref["v_plane"][:-1]).max()
    assert off_gt < 1e-14 if start == "zero" else off_gt > 1e-6
    # the policy's own parameters are untouched, the observer frozen
    assert all(torch.equal(p, before[n]) for n, p in pol.named_parameters())
    assert not any(p.requires_grad for p in obs.parameters())


@pytest.mark.parametrize("modes3", [(1, 1), (3, 3)])
def test_fullfield_optimal_observer_closed_loop_matches_jax(envs, modes3,
                                                            monkeypatch):
    """Three closed-loop steps of the full-field `optimal-observer`, three
    Adam steps each on the raw action through encode / decode with (X, Z)
    statistics; with 3 time modes on T = 1 against the JAX package's
    truncated-DFT route."""
    jenv, env = envs
    rng = np.random.default_rng(4)
    if modes3 != (1, 1):
        monkeypatch.setenv("PDE_SPECTRAL_BACKEND", "dft")
    jobs, jobs_p, obs = observer_pair(rng, modes3)
    m, s = 0.01 * rng.normal(size=(8, 8)), 0.5 + rng.random((8, 8))
    kw = dict(detect_plane=DP, opt_steps=3, opt_lr=1e-3, reg_weight=0.1)
    monkeypatch.setattr(jpolicies, "jnp", F64())
    ref, out = assert_loops_match(
        jenv, env,
        jpolicies.make_fullfield_optimal_observer(
            jenv.grid, observer_model=jobs, observer_params=jobs_p,
            bound_v_norm=JNorm(jnp.asarray(m), jnp.asarray(s)), **kw),
        make_fullfield_optimal_observer(
            env.grid, observer_model=obs,
            bound_v_norm=NormalizerGivenMeanStd(torch.tensor(m),
                                                torch.tensor(s)), **kw))
    # Adam moved the action off `gt`'s (-v_plane of the step before)
    assert np.abs(out["opV2"][1:] + ref["v_plane"][:-1]).max() > 1e-6


def test_policy_carry_threads_across_chunks_and_runs():
    """The adapted policy rides from chunk to chunk (three chunks of one
    step give the three-step run, bit for bit), every run starts from the
    policy's parameters again, and each action leaves detached."""
    g = torch.Generator().manual_seed(0)
    kw = dict(MODEL, device="cpu", generator=g)
    obs = PINObserverFullField(plane_num=2, **kw)
    pol = PolicyModel2D(**kw).zero_init_params()
    runs = []
    for log_interval in (3, 1, 3):
        env = NSControlEnv(**SMALL, noise_scale=0.02, seed=1, device="cpu")
        policy = make_optimal_policy_observer(env.grid, observer_model=obs,
                                              policy_model=pol,
                                              detect_plane=DP, opt_lr=1e-2)
        assert isinstance(policy, StatefulPolicy)
        runs.append(run_closed_loop(env, policy, n_steps=3,
                                    log_interval=log_interval,
                                    detect_plane=DP, verbose=False,
                                    collect_planes=True)["opV2"])
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[0], runs[2])
    st = NSControlEnv(**SMALL, noise_scale=0.02, seed=1,
                      device="cpu").state
    _, p2 = cf.boundary_pressures(env.grid, st)
    carry = policy.init_carry()
    opV1, opV2, carry2 = policy(carry, st, p2, None)
    assert carry2 is carry and not opV2.requires_grad
    assert not opV1.requires_grad
    assert any(p.detach().any() for p in carry[0].values())
    params, _ = policy.init_carry()
    assert all(not p.detach().any() for p in params.values())


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------

def test_fullfield_entry_trains_evaluates_and_reloads(tmp_path, capsys):
    """`run_pde_observers.main` on `configs/fullfield_pi_short.yaml` with
    the sizes cut to the 8x33x8 env (3 time modes on T = 1, as the config
    keeps 12): the dataset generated with its fields, the sequential
    split, the checkpoint written before the held-out rel-L2 and reloaded
    (`eval_ckpt`) to the same value, bit for bit."""
    args = load_yaml(os.path.join(ROOT, "configs", "fullfield_pi_short.yaml"))
    args.update(DATA_FOLDER=str(tmp_path / "ff"), x_range=8, y_range=8,
                Ny=33, generate_steps=12, ntrain=8, ntest=4, epochs=2,
                batch_size=4, layers=[8, 8, 8], modes1=[2, 2],
                modes2=[2, 2], modes3=[3, 3], fc_dim=8, set_epoch=-1,
                out_dir=str(tmp_path / "out"))
    state, hist = rpo.main(args, device="cpu")
    out = capsys.readouterr().out
    assert "Best model saved at" in out and "Held-out decoded" in out
    assert len(os.listdir(args.DATA_FOLDER)) == 12 * 5 + 1
    for k in ("total", "data", "pde"):
        assert len(hist[k]) == 2 and np.isfinite(hist[k]).all()
    assert hist["pde"][0] > 0 and 0 < hist["test_rel_l2"] < 10
    assert set(state) == {n for n, _ in rpo.build_fullfield_model(
        args, 3, device="cpu").named_parameters()}
    args.eval_ckpt = hist["checkpoint"]
    _, again = rpo.main(args, device="cpu")
    assert again == {"test_rel_l2": hist["test_rel_l2"]}


def write_planes(folder, n, size=32, seed=7):
    """A folder of numpy planes in the reference's format."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    p = rng.normal(size=(n, size, size)).astype(np.float32) * 1e-2
    v = rng.normal(size=(n, size, size)).astype(np.float32) * 1e-2
    for i in range(n):
        np.save(os.path.join(folder, f"P_planes_{i:06d}.npy"), p[i])
        np.save(os.path.join(folder, f"V_planes_{i:06d}.npy"), v[i])
    np.save(os.path.join(folder, "metadata.npy"), {
        "P_planes": {"mean": p.mean(0), "std": p.std(0) + 1e-8},
        "V_planes": {"mean": v.mean(0), "std": v.std(0) + 1e-8},
        "re": 178.1899})
    return folder


@pytest.mark.parametrize("policy", ["gt", "fno", "optimal-observer"])
def test_run_control_entry_on_the_cpu(tmp_path, capsys, policy):
    """`python -m pde_policylearning_torch.run_control` on
    `configs/base_control.yaml` (4 steps, the observer from a checkpoint
    of the port where the policy serves one), collecting the run's planes
    in the trainable format."""
    cfg = load_yaml(os.path.join(ROOT, "configs", "base_control.yaml"))
    ckpt = None
    if policy != "gt":
        ckpt = save_checkpoint(
            str(tmp_path / "fno.pt"),
            FNO2dObserver(12, 12, 32, device="cpu",
                          generator=torch.Generator().manual_seed(0)))
    cfg.update(DATA_FOLDER=write_planes(str(tmp_path / "planes"), 6),
               control_timestep=4, log_interval=2, collect_data=True,
               output_dir=str(tmp_path / "out"), model_checkpoint=ckpt,
               opt_steps=2)
    path = str(tmp_path / "control.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg), f)
    res = rc.main(["--control_yaml", path, "--policy_name", policy,
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Environment is initialized!" in out and "Final shear" in out
    for k in SCOREBOARD_KEYS:
        assert res["series"][k].shape == (4,)
        assert np.isfinite(res["series"][k]).all()
    assert np.abs(res["opV2"].mean(axis=(1, 2))).max() < 1e-6
    saved = os.listdir(str(tmp_path / "out" / cfg["exp_name"]))
    assert "metadata.npy" in saved and "opV2.npy" in saved
    # the 2-D env through the same entry: a few steps of its series
    res2d = rc.run_control(DotDict(env_name="NSControlEnv2D",
                                   policy_name=policy, control_timestep=3),
                           device="cpu")
    shear = res2d["series"]["drag_reduction/1_shear_stress"]
    assert shear.shape == (3,) and np.isfinite(shear).all()
    assert res2d["series"]["drag_reduction_relative/1_shear_stress"][0] \
        == 1.0


def test_observer_training_hands_off_to_run_control(tmp_path, capsys):
    """`run_pde_observers.main` with `run_control`: the trained `fno`
    observer serves the closed loop (run_pde_observers.py:226-229)."""
    args = load_yaml(os.path.join(ROOT, "configs", "base_fno.yaml"))
    args.update(DATA_FOLDER=write_planes(str(tmp_path / "planes"), 12),
                epochs=1, ntrain=8, ntest=4, batch_size=4, modes=4, width=6,
                x_range=32, y_range=32, set_epoch=-1,
                out_dir=str(tmp_path / "out"), run_control=True,
                control_timestep=3, log_interval=3)
    rpo.main(args, device="cpu")
    out = capsys.readouterr().out
    assert args.policy_name == "fno"
    assert "Best model saved at" in out and "Final shear stress" in out
