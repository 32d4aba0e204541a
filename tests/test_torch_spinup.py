"""The port's spin-up tool (pde_policylearning_torch/tools/spinup.py) on
the CPU: its chunks against the JAX package's `spinup_chunk` in float64
from a JAX tripped state, the convergence rule of
scripts/spinup_turbulence.py:60-72 on made-up histories, the snapshot it
writes, and the exits without a card and on a chunk that is not
finite."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.envs import channel_flow as jcf
from pde_policylearning_torch.control import make_policy, run_closed_loop
from pde_policylearning_torch.envs import NSControlEnv
from pde_policylearning_torch.envs import channel_flow as cf
from pde_policylearning_torch.envs.control_env import default_snapshot_path
from pde_policylearning_torch.tools import spinup as sp
from test_torch_rk3 import grid_arrays

NX, NY, NZ = 8, 33, 8
UTAU2 = cf.DEFAULT_DPDX
NU = cf.DEFAULT_NU


def test_spinup_chunks_match_jax_spinup_chunk():
    """Three 4-step chunks of the tool from JAX's tripped state (carried
    across as numpy): each chunk's tail means and the state after them
    against JAX's `spinup_chunk` chunk by chunk, float64."""
    jgrid = jcf.make_channel_grid(Nx=NX, Ny=NY, Nz=NZ, dtype=jnp.float64)
    grid = cf.grid_from_arrays(grid_arrays(jgrid), dtype=torch.float64,
                               device="cpu")
    js = jcf.init_turbulent_state(jgrid, jax.random.PRNGKey(7))
    s0 = cf.ChannelState(**{k: torch.tensor(np.asarray(getattr(js, k)))
                            for k in ("U", "V", "W", "dPdx", "meanU0")})
    ref = []
    for _ in range(3):
        js, stats = jcf.spinup_chunk(jgrid, js, 4)
        ref.append(np.asarray(stats)[-2:].mean(axis=0))
    state, history, why, _ = sp.spinup(grid, None, chunk=4, min_chunks=3,
                                       max_chunks=3, state=s0)
    assert why in ("converged", "capped") and history.shape == (3, 4)
    np.testing.assert_allclose(history, np.asarray(ref), rtol=1e-8)
    for k in ("U", "V", "W"):
        a, b = getattr(state, k).numpy(), np.asarray(getattr(js, k))
        assert np.linalg.norm(a - b) <= 1e-8 * np.linalg.norm(b), k


def row(tau, bulk=0.89, dpdx=UTAU2):
    return [tau, tau, bulk, dpdx]


@pytest.mark.parametrize("history,want", [
    # fewer than MIN_CHUNKS, however settled
    ([row(UTAU2)] * 9, "too few chunks"),
    # laminar: under twice 3 nu Ub
    ([row(UTAU2)] * 9 + [row(1.5 * 3 * NU * 0.89)], "out of band"),
    # in band, more than 50% from u_tau^2
    ([row(UTAU2)] * 9 + [row(1.6 * UTAU2)], "out of band"),
    # in band, the last three 20% from their mean
    ([row(UTAU2)] * 8 + [row(0.8 * UTAU2), row(1.2 * UTAU2)], "not flat"),
    # in band and flat: the mean of both walls' shear counts
    ([row(UTAU2)] * 7 + [[1.1 * UTAU2, 0.9 * UTAU2, 0.89, UTAU2],
                         row(1.05 * UTAU2), row(0.95 * UTAU2)], "converged"),
    # the cap: 30 chunks end the run unconverged
    ([row(UTAU2)] * 28 + [row(0.7 * UTAU2), row(1.3 * UTAU2)], "capped"),
    # converged at the cap is converged
    ([row(UTAU2)] * 30, "converged"),
])
def test_convergence_rule(history, want):
    assert sp.verdict(history, NU, UTAU2) == want


def test_convergence_rule_reads_the_last_chunks_bulk():
    """The laminar shear 3 nu Ub takes the last chunk's bulk velocity, as
    the script's `bulk` is the chunk just run."""
    tau = 2.05 * 3 * NU * 1.0
    hist = [row(tau, bulk=0.5)] * 9 + [row(tau, bulk=1.0)]
    assert sp.verdict(hist, NU, tau) == "converged"
    hist[-1] = row(tau, bulk=1.1)
    assert sp.verdict(hist, NU, tau) == "out of band"


def test_snapshot_has_the_asset_layout_and_starts_an_env(tmp_path):
    """The tool's file has the packaged snapshot's keys and dtypes, its
    arrays' shapes for this grid, the steps and one history row a chunk,
    and an NSControlEnv starts from it on the CPU and steps."""
    out = str(tmp_path / "snap.npz")
    res = sp.main(["--device", "cpu", "--grid", str(NX), str(NY), str(NZ),
                   "--chunk", "3", "--min-chunks", "1", "--max-chunks", "2",
                   "--seed", "3", "--out", out])
    d, asset = np.load(out), np.load(default_snapshot_path())
    assert sorted(d.files) == sorted(asset.files)
    for k in asset.files:
        assert d[k].dtype == asset[k].dtype, k
    shapes = dict(U=(NX, NY + 1, NZ), V=(NX, NY, NZ), W=(NX, NY + 1, NZ),
                  dPdx=(), meanU0=(), nu=(), steps=(),
                  history=(res["chunks"], 4))
    assert {k: d[k].shape for k in d.files} == shapes
    assert int(d["steps"]) == 3 * res["chunks"]
    assert float(d["nu"]) == pytest.approx(NU, rel=1e-7)
    assert res["tau_b"] == pytest.approx(float(d["history"][-1, 0]),
                                         rel=1e-6)
    env = NSControlEnv(NX, NY, NZ, detect_plane=5, init_cond_path=out,
                       device="cpu")
    np.testing.assert_array_equal(env.U, d["U"])
    shear = run_closed_loop(env, make_policy("gt", env.grid, detect_plane=5),
                            n_steps=3, log_interval=3, detect_plane=5,
                            verbose=False)["series"][
        "drag_reduction/1_shear_stress"]
    assert np.isfinite(shear).all()


def test_the_packaged_asset_is_full_size():
    """The packaged snapshot (the JAX asset, byte for byte) has the
    tool's layout at 32x130x32."""
    asset = np.load(default_snapshot_path())
    assert asset["U"].shape == (32, 131, 32) and asset["V"].shape == \
        (32, 130, 32)
    assert asset["history"].shape[1] == 4
    assert int(asset["steps"]) == len(asset["history"]) * sp.CHUNK


def test_a_chunk_that_is_not_finite_exits_nonzero(tmp_path, monkeypatch):
    real = cf.spinup_chunk

    def blows_up(grid, state, n):
        state, stats = real(grid, state, n)
        stats[-1, 1] = float("nan")
        return state, stats
    monkeypatch.setattr(sp.cf, "spinup_chunk", blows_up)
    out = tmp_path / "snap.npz"
    with pytest.raises(SystemExit) as e:
        sp.main(["--device", "cpu", "--grid", str(NX), str(NY), str(NZ),
                 "--chunk", "2", "--out", str(out)])
    assert e.value.code != 0 and not out.exists()


def test_it_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sp.main(["--chunk", "2"])
