"""The drag study of the port (pde_policylearning_torch/tools/drag_rows.py)
at a small grid on the CPU: the `rno` and `transformer` rows served from
JAX `.msgpack` checkpoints against the JAX policies in the JAX loop in
float64, the `rand` row's draws, and the protocol for long rows of
scripts/drag_study.py (the cached rows, the partials, --promote,
--deadline, --only, a failing row, the table and summary.json)."""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.control import make_policy as jmake_policy
from pde_policylearning_tpu.control import run_closed_loop as jrun
from pde_policylearning_tpu.data.channel import PDEDataset as JPDEDataset
from pde_policylearning_tpu.envs import NSControlEnv as JEnv
from pde_policylearning_tpu.envs import channel_flow as jcf
from pde_policylearning_tpu.models.observers import \
    RNO2dObserver as JRNO2dObserver
from pde_policylearning_tpu.models.transformer import \
    SimpleTransformer as JSimpleTransformer
from pde_policylearning_tpu.training.checkpoint import save_msgpack
from pde_policylearning_torch.control import run_closed_loop
from pde_policylearning_torch.data import generate_channel_dataset
from pde_policylearning_torch.envs import NSControlEnv
from pde_policylearning_torch.models import RNO2dObserver, SimpleTransformer
from pde_policylearning_torch.tools import drag_rows as dr

GRID = (8, 33, 8)
SHEAR = dr.SHEAR
SMALL_TRANSFORMER = dict(n_hidden=8, n_head=2, freq_dim=6, fourier_modes=3,
                         num_encoder_layers=2, num_regressor_layers=2)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-300))


def small_observer(name, device, dtype=torch.float32):
    """The port's observer of each row at a width the 8 x 8 plane takes."""
    if name == "rno":
        return RNO2dObserver(3, 3, 6, layer_num=1, device=device,
                             dtype=dtype)
    return SimpleTransformer(**SMALL_TRANSFORMER, device=device, dtype=dtype)


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """A float64 state written by the JAX env, a planes folder, and for
    each sequence observer a JAX `.msgpack` of parameters drawn with numpy
    on the shapes of its flax tree."""
    tmp = tmp_path_factory.mktemp("study")
    state = str(tmp / "state.npz")
    JEnv(*GRID, detect_plane=25, dtype=jnp.float64, noise_scale=0.02,
         seed=1).dump_state(state)
    env = NSControlEnv(*GRID, detect_plane=25, dtype=torch.float64,
                       init_cond_path=state, device="cpu")
    data = generate_channel_dataset(str(tmp / "planes"), 6, env=env,
                                    detect_plane=25)
    rng = np.random.default_rng(14)
    models = {}
    for name, jmodel in (("rno", JRNO2dObserver(3, 3, 6, layer_num=1)),
                         ("transformer",
                          JSimpleTransformer(**SMALL_TRANSFORMER))):
        shapes = jax.eval_shape(
            lambda x: jmodel.init(jax.random.PRNGKey(0), x),
            jnp.zeros((1, 2, 8, 8, 1)))["params"]
        tree = jax.tree.map(lambda s: 0.2 * rng.normal(size=s.shape), shapes)
        path = save_msgpack(str(tmp / f"{name}.msgpack"), tree)
        models[name] = (jmodel, jax.tree.map(jnp.asarray, tree), path)
    return dict(state=state, data=data, models=models)


def jax_row(study, name, n_steps):
    """The row as scripts/drag_study.py runs it in the JAX package, from the
    same state, checkpoint and planes, in float64: the loop's series and
    actions."""
    jenv = JEnv(*GRID, detect_plane=25, test_plane=124, seed=0,
                dtype=jnp.float64, init_cond_path=study["state"])
    ds = JPDEDataset.from_folder(study["data"], np.arange(6))
    jmodel, params, _ = study["models"][name]
    policy = jmake_policy(name, jenv.grid, detect_plane=25, model=jmodel,
                          params=params, p_norm=ds.p_norm, v_norm=ds.v_norm,
                          model_timestep=2, action_scale=0.3,
                          action_clip=0.01)
    return jrun(jenv, policy, n_steps=n_steps, log_interval=2000,
                detect_plane=25, div_guard=1e9, verbose=False,
                collect_planes=True)


@pytest.mark.parametrize("name", ["rno", "transformer"])
def test_observer_rows_serve_jax_checkpoints_as_jax_does(study, name,
                                                         monkeypatch):
    """The `rno` and `transformer` rows from a JAX `.msgpack`: the first
    actions of the served policy and every step's wall shear of the row
    held to the JAX policy in the JAX loop, float64, 1e-8 (the tolerance
    of the sequence observers' closed loops in
    tests/test_torch_observer_policy.py)."""
    monkeypatch.setattr(dr, "observer", small_observer)
    n = 6
    ref = jax_row(study, name, n)
    ckpt = study["models"][name][2]
    res, series = dr.drag_rows(n, False, "cpu", GRID, data=study["data"],
                               init=study["state"], dtype=torch.float64,
                               **{name: ckpt})
    assert list(series) == ["unmanipulated", "gt", name]
    np.testing.assert_allclose(series[name], ref["series"][SHEAR],
                               rtol=1e-8)
    assert res[name]["tag"] == f"{name}:{name}.msgpack"
    assert res[name]["drag_change"] == pytest.approx(
        res[name]["tail"] / res["unmanipulated"]["tail"] - 1)
    # the served policy's actions, step by step
    env = NSControlEnv(*GRID, detect_plane=25, test_plane=124, seed=0,
                       init_cond_path=study["state"], dtype=torch.float64,
                       device="cpu")
    policy, _ = dr.row_policy(name, env, "cpu", ckpt, study["data"])
    out = run_closed_loop(env, policy, n_steps=n, log_interval=2000,
                          detect_plane=25, div_guard=1e9, verbose=False,
                          collect_planes=True)
    assert np.abs(ref["opV2"]).max() > 0
    assert rel(out["opV2"], ref["opV2"]) < 1e-8
    np.testing.assert_array_equal(out["series"][SHEAR], series[name])
    assert np.abs(out["opV2"].mean(axis=(1, 2))).max() < 1e-12


def test_rand_row_draws_uniform_actuation_as_jax(tmp_path):
    """The `rand` row is finite; its actions are drawn from the
    distribution of JAX's `rand_control`: uniform on [0, 0.01 x scale),
    nothing on the bottom wall (a two-sample test against JAX's draws and
    the uniform's moments)."""
    from scipy import stats
    res, series = dr.drag_rows(4, False, "cpu", GRID, rand=True)
    assert list(series) == ["unmanipulated", "gt", "rand"]
    assert np.isfinite(series["rand"]).all()
    assert res["rand"]["tag"] == "rand"
    env = NSControlEnv(*GRID, detect_plane=25, seed=0, device="cpu")
    policy, _ = dr.row_policy("rand", env, "cpu")
    gen = torch.Generator().manual_seed(0)
    draws = [policy(env.state, None, gen) for _ in range(64)]
    assert all(float(a.abs().max()) == 0 for a, _ in draws)
    ours = torch.cat([b.reshape(-1) for _, b in draws]).numpy()
    theirs = np.asarray(jcf.rand_control(jax.random.PRNGKey(0),
                                         (ours.size,)))
    assert ours.min() >= 0 and ours.max() < 0.01
    assert stats.ks_2samp(ours, theirs).pvalue > 1e-3
    assert stats.kstest(ours / 0.01, "uniform").pvalue > 1e-3
    sigma = 0.01 / np.sqrt(12 * ours.size)
    assert abs(ours.mean() - 0.005) < 5 * sigma


def test_cached_rows_are_read_not_run(tmp_path, monkeypatch):
    """A second call on the same directory reads every row from its
    <row>.npz (the tag, steps and record of the run that wrote it): no env
    is built and no step is taken."""
    out = str(tmp_path / "study")
    res, series = dr.drag_rows(5, False, "cpu", GRID, rand=True,
                               out_dir=out)
    for name in ("unmanipulated", "gt", "rand"):
        d = np.load(os.path.join(out, f"{name}.npz"))
        assert str(d["tag"]) == name and int(d["steps"]) == 5
        assert not os.path.exists(os.path.join(out, f"{name}.partial.npz"))

    def refuse(*a, **k):
        raise AssertionError("a cached row was run again")
    monkeypatch.setattr(dr, "NSControlEnv", refuse)
    monkeypatch.setattr(dr, "run_closed_loop", refuse)
    again, series2 = dr.drag_rows(5, False, "cpu", GRID, rand=True,
                                  out_dir=out)
    for name in ("unmanipulated", "gt", "rand"):
        np.testing.assert_array_equal(series2[name], series[name])
        assert again[name]["cached"] is True
        assert res[name]["corner_launches"] == 0    # plain on the CPU
        for k in ("tail", "steps", "substage_launches", "corner_launches",
                  "steps_per_s", "seconds"):
            assert again[name][k] == res[name][k], (name, k)
    assert again["drag_change"] == res["drag_change"]


def test_partials_are_banked_each_chunk_and_promoted(tmp_path, monkeypatch):
    """Every chunk banks <row>.partial.npz; a row that fails keeps its
    partial and is recorded as failed while the rest go on; --promote
    turns the partial into the row's file, scored as budget-bounded over
    matched windows; a retried row overwrites only a shorter partial."""
    monkeypatch.setattr(dr, "CHUNK", 3)
    saved = []
    real_save = dr._save
    monkeypatch.setattr(dr, "_save", lambda path, **a: saved.append(
        (os.path.basename(path), int(a["steps"]))) or real_save(path, **a))
    out = str(tmp_path / "study")
    dr.drag_rows(8, False, "cpu", GRID, out_dir=out)
    assert saved == [("unmanipulated.partial.npz", 3),
                     ("unmanipulated.partial.npz", 6),
                     ("unmanipulated.partial.npz", 8), ("unmanipulated.npz", 8),
                     ("gt.partial.npz", 3), ("gt.partial.npz", 6),
                     ("gt.partial.npz", 8), ("gt.npz", 8)]
    # a `rand` row that breaks in its second chunk
    real_policy = dr.row_policy
    calls = []

    def breaking(name, *a, **k):
        policy, tag = real_policy(name, *a, **k)

        def step(*args):
            calls.append(1)
            if len(calls) > 4:
                raise RuntimeError("the card went away")
            return policy(*args)
        return step, tag
    monkeypatch.setattr(dr, "row_policy", breaking)
    res, series = dr.drag_rows(8, False, "cpu", GRID, rand=True, out_dir=out)
    assert res["rand"] == {"failed": "RuntimeError: the card went away"}
    assert "rand" not in series and res["gt"]["cached"]
    assert "| rand | diverged/failed | — | — |" in res["table"]
    assert dr.failed(res) == ["rand"]
    partial = os.path.join(out, "rand.partial.npz")
    assert int(np.load(partial)["steps"]) == 3
    # a retry that gets less far leaves the longer partial
    calls.clear()
    calls.extend([1, 1, 1])
    saved.clear()
    dr.drag_rows(8, False, "cpu", GRID, rand=True, out_dir=out)
    assert ("rand.partial.npz", 3) not in saved
    assert int(np.load(partial)["steps"]) == 3
    monkeypatch.setattr(dr, "row_policy", real_policy)
    res, series = dr.drag_rows(8, False, "cpu", GRID, rand=True, out_dir=out,
                               promote_rows=["rand"])
    assert res["promoted"] == ["rand"] and res["rand"]["cached"]
    assert not os.path.exists(partial)
    rand = res["rand"]
    assert rand["steps"] == 3 and len(series["rand"]) == 3
    assert rand["matched"]["window"] == [1, 3]
    assert rand["matched"]["unmanipulated"] == pytest.approx(
        float(series["unmanipulated"][1:3].mean()))
    assert "| rand |" in res["table"] and "3 (budget-bounded)" in res["table"]


def test_deadline_stops_a_row_and_promotes_it(tmp_path, monkeypatch):
    """Past --deadline the running row stops at its next chunk and its
    partial becomes its file; the rows after it are not started."""
    monkeypatch.setattr(dr, "CHUNK", 3)
    clock = iter(range(1, 100))

    class Clock:
        perf_counter = staticmethod(time.perf_counter)

        @staticmethod
        def time():
            return next(clock)
    monkeypatch.setattr(dr, "time", Clock)
    out = str(tmp_path / "study")
    # read before the first row (1), after its first chunk (2), after its
    # second (3: past the deadline), before `gt` (4)
    res, series = dr.drag_rows(9, False, "cpu", GRID, out_dir=out,
                               deadline=2.5)
    assert res["unmanipulated"]["deadline"] is True
    assert res["unmanipulated"]["steps"] == 6 and len(series["unmanipulated"]) == 6
    assert res["not_started"] == ["gt"] and "gt" not in res
    assert os.path.exists(os.path.join(out, "unmanipulated.npz"))
    assert not os.path.exists(os.path.join(out, "unmanipulated.partial.npz"))
    # the deadline acts on the partials under --out
    with pytest.raises(ValueError, match="out_dir"):
        dr.drag_rows(9, False, "cpu", GRID, deadline=2.5)


def test_only_runs_the_named_rows(tmp_path):
    """--only runs the rows it names; rows cached under --out are read
    beside them, so a row run alone is scored once `unmanipulated` is
    there."""
    out = str(tmp_path / "study")
    res, series = dr.drag_rows(4, False, "cpu", GRID, rand=True, out_dir=out,
                               only=["rand"])
    assert list(series) == ["rand"] and "drag_change" not in res["rand"]
    res, series = dr.drag_rows(4, False, "cpu", GRID, rand=True, out_dir=out,
                               only=["unmanipulated"])
    assert list(series) == ["unmanipulated", "rand"]
    assert res["rand"]["cached"] and "gt" not in res
    assert res["rand"]["drag_change"] == pytest.approx(
        res["rand"]["tail"] / res["unmanipulated"]["tail"] - 1)
    with pytest.raises(SystemExit):
        dr.main(["--only", "rand,nope", "--out", out])


def test_a_failing_row_leaves_the_others(tmp_path):
    """A row whose checkpoint cannot be read is recorded as failed; the
    rows after it run and the exit code says so."""
    out = str(tmp_path / "study")
    res = dr.main(["--steps", "4", "--grid", *map(str, GRID), "--device",
                   "cpu", "--rand", "--rno", str(tmp_path / "missing.pt"),
                   "--out", out])
    assert dr.failed(res) == ["rno"] and "FileNotFoundError" in \
        res["rno"]["failed"]
    assert all(res[n]["finite"] for n in ("unmanipulated", "gt", "rand"))
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert summary["tail_mean"]["rno"] is None
    assert "rno" not in summary["steps"]


def test_table_and_summary_follow_the_study(tmp_path):
    """table.md and summary.json as scripts/drag_study.py:276-291 writes
    them: a line per row, its drag change to one decimal, the steps and a
    budget-bounded note for a row shorter than the study."""
    res = {"unmanipulated": dict(tail=3.2e-3, steps=50000),
           "gt": dict(tail=2.4e-3, steps=50000),
           "rno": {"failed": "RuntimeError: x"},
           "optimal-observer": dict(tail=2.5e-3, steps=31000)}
    names = list(res)
    assert dr.table(res, names, 50000).splitlines() == [
        "| policy | tail-mean shear | vs unmanipulated | steps |",
        "|---|---|---|---|",
        "| unmanipulated | 3.200e-03 | +0.0% | 50000 |",
        "| gt | 2.400e-03 | -25.0% | 50000 |",
        "| rno | diverged/failed | — | — |",
        "| optimal-observer | 2.500e-03 | -21.9% | 31000 (budget-bounded) |"]
    # without `unmanipulated` only the failed rows have a line
    assert dr.table({"rno": res["rno"], "gt": res["gt"]}, ["rno", "gt"],
                    50000).splitlines()[2:] == [
        "| rno | diverged/failed | — | — |"]
    dr.write(str(tmp_path), res, {}, names, 50000)
    with open(tmp_path / "summary.json") as f:
        assert json.load(f) == {
            "tail_mean": {"unmanipulated": 3.2e-3, "gt": 2.4e-3, "rno": None,
                          "optimal-observer": 2.5e-3},
            "steps": {"unmanipulated": 50000, "gt": 50000,
                      "optimal-observer": 31000}}
    assert (tmp_path / "table.md").read_text() == \
        dr.table(res, names, 50000) + "\n"
