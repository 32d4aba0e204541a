"""The rest of the port's ops, data and utils against the JAX package, on
the CPU: the spectra (float64, to the last bit), the preprocessing of the
same files, the FEM helpers exactly and the Fourier continuation at
1e-10, the library's readers, transforms and datasets exactly, its
loaders after JAX's random fields at 1e-10, `flop_estimate` against the
count of a product, the visualization facade's arrays, `torch_reinit`'s
rule, and `run_spec_visualization` on a tiny folder."""
import os
import runpy
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from pde_policylearning_tpu.data import library as jlib
from pde_policylearning_tpu.data import preprocess as jpre
from pde_policylearning_tpu.data import synthetic as jsyn
from pde_policylearning_tpu.models.observers import \
    FNO2dObserver as JFNO2dObserver
from pde_policylearning_tpu.ops import fem as jfem
from pde_policylearning_tpu.ops import fourier_continuation as jfc
from pde_policylearning_tpu.training.checkpoint import save_msgpack as \
    jsave_msgpack
from pde_policylearning_tpu.utils import misc as jmisc
from pde_policylearning_tpu.utils import visualization as jvis
from pde_policylearning_torch import run_spec_visualization as tspec
from pde_policylearning_torch.data import library as lib
from pde_policylearning_torch.data import preprocess as pre
from pde_policylearning_torch.data.synthetic import kolmogorov_from_field
from pde_policylearning_torch.models import FNO2dObserver
from pde_policylearning_torch.ops import fem
from pde_policylearning_torch.ops.fourier_continuation import FCLegendre
from pde_policylearning_torch.training.torch_init import torch_reinit
from pde_policylearning_torch.utils import misc, profiling, visualization

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU64 = dict(device="cpu", dtype=torch.float64)


def rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    den = np.abs(b).max()
    return float(np.abs(a - b).max() / den) if den else \
        float(np.abs(a).max())


# -- utils/misc ---------------------------------------------------------------

@pytest.mark.parametrize("dims,s", [(2, 16), (2, 15), (3, 8)])
def test_spectra_match_jax(dims, s):
    rng = np.random.default_rng(dims * s)
    u = rng.normal(size=(3, *([s] * dims)))
    fn, jfn = (misc.spectrum2, jmisc.spectrum2) if dims == 2 else \
        (misc.spectrum3, jmisc.spectrum3)
    got, want = fn(torch.tensor(u)), np.asarray(jfn(jnp.asarray(u)))
    assert got.shape == (3, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=0)
    # the energy is all there (Parseval)
    np.testing.assert_allclose(got.sum(-1).numpy(),
                               0.5 * (u ** 2).mean(axis=tuple(range(1, dims
                                                                    + 1))),
                               rtol=1e-12)


def test_shells_round_half_to_even_as_jax():
    """No integer wavenumber vector has a half-integer magnitude, so the
    rule is held on the magnitudes themselves: half-integers go to the
    even neighbour in both packages, and the top shell is clipped."""
    kmag = np.array([0.0, 0.5, 1.5, 2.5, 3.49999, 3.5, 4.5, 7.2, 30.0])
    got = misc.radial_shells(torch.tensor(kmag), 8).numpy()
    want = np.clip(np.asarray(jnp.round(jnp.asarray(kmag)).astype(jnp.int32)),
                   0, 7)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 0, 2, 2, 3, 4, 4, 7, 7])


def test_count_params_seed_and_timer():
    model = FNO2dObserver(4, 4, 6, **CPU64)
    n = misc.count_params(model)
    assert n == sum(p.numel() for p in model.parameters())
    tree = {"a": np.zeros((3, 4)), "b": [np.zeros(5), {"c": np.zeros(())}]}
    assert misc.count_params(tree) == jmisc.count_params(tree) == 18
    g = misc.set_seed(5)
    a = np.random.uniform()
    jmisc.set_seed(5)
    assert np.random.uniform() == a
    assert torch.equal(torch.rand(3, generator=g),
                       torch.rand(3, generator=torch.Generator()
                                  .manual_seed(5)))
    res = {}
    with misc.timer("t", verbose=False, results=res):
        sum(range(100))
    assert res["t"] >= 0


# -- data/preprocess ----------------------------------------------------------

def test_preprocess_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    mat = str(tmp_path / "dump.mat")
    scipy.io.savemat(mat, {"U": rng.normal(size=(3, 8, 8)),
                           "P": rng.normal(size=(3, 8, 8))})
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    pre.mat_to_npy(mat, a)
    jpre.mat_to_npy(mat, b)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        x = np.load(os.path.join(a, f), allow_pickle=True)
        y = np.load(os.path.join(b, f), allow_pickle=True)
        if f == "metadata.npy":
            x, y = x.item(), y.item()
            assert x.keys() == y.keys()
            for k in ("U_field", "P_field"):
                for s in ("mean", "std"):
                    np.testing.assert_array_equal(x[k][s], y[k][s])
        else:
            np.testing.assert_array_equal(x, y)
    for i in range(2):
        np.save(os.path.join(a, f"V_planes_{i:03d}.npy"),
                rng.normal(size=(8, 8)))
    np.save(os.path.join(a, "W3_cube.npy"), rng.normal(size=(4, 4, 4)))
    np.testing.assert_allclose(pre.parse_energy_spectra(a),
                               jpre.parse_energy_spectra(a), rtol=1e-13)
    np.testing.assert_allclose(
        pre.parse_energy_spectra(a, "W3_cube", three_d=True),
        jpre.parse_energy_spectra(a, "W3_cube", three_d=True), rtol=1e-13)
    assert pre.parse_energy_spectra(a, "none").shape == (0,)
    trajs = tmp_path / "trajs"
    trajs.mkdir()
    for i in range(3):
        np.save(trajs / f"traj_{i}.npy", rng.normal(size=(4, 4)))
    np.save(trajs / "metadata.npy", {"re": 1})
    traj = str(tmp_path / "t.npy")
    np.save(traj, rng.normal(size=(2, 4, 4)))
    outs = [fn([str(trajs), traj], str(tmp_path / f"m{i}.npz"),
               res=(100.0,))
            for i, fn in enumerate((pre.merge_datasets, jpre.merge_datasets))]
    x, y = np.load(outs[0]), np.load(outs[1])
    for k in ("data1", "data2"):
        np.testing.assert_array_equal(x[k], y[k])


# -- ops ----------------------------------------------------------------------

def test_fem_helpers_match_jax_exactly():
    node = np.cumsum(np.random.default_rng(2).uniform(0.5, 1.5, size=9))
    for order in (1, 2, 3, 4):
        for x, y in zip(fem.quadpts(order), jfem.quadpts(order)):
            np.testing.assert_array_equal(x, y)
    for fn in ("get_laplacian_1d", "get_mass_1d"):
        for arg in (7, node):
            for normalize in (True, False):
                np.testing.assert_array_equal(
                    getattr(fem, fn)(arg, normalize),
                    getattr(jfem, fn)(arg, normalize))
    for graph in (node, np.stack([node, node ** 2], -1)):
        np.testing.assert_array_equal(fem.get_distance_matrix(graph),
                                      jfem.get_distance_matrix(graph))
    a = np.arange(24).reshape(4, 6)
    for axis in (0, 1):
        np.testing.assert_array_equal(
            fem.apply_periodic_boundary(a, 2, axis),
            jfem.apply_periodic_boundary(a, 2, axis))


@pytest.mark.parametrize("n,d", [(3, 4), (4, 6)])
def test_fc_legendre_matches_jax(n, d):
    fc = FCLegendre(n, d, **CPU64)
    jf = jfc.FCLegendre(n, d, dtype=jnp.float64)
    np.testing.assert_array_equal(fc.ext_mat.numpy(),
                                  jfc._extension_matrix(n, d))
    x = np.random.default_rng(n).normal(size=(2, 3, 10, 12))
    for name in ("extend_left_right", "extend_top_bottom", "extend2d"):
        got = getattr(fc, name)(torch.tensor(x))
        assert rel(got, getattr(jf, name)(jnp.asarray(x))) <= 1e-10
    assert fc(torch.tensor(x)).shape == (2, 3, 10 + d, 12 + d)


# -- data/library -------------------------------------------------------------

def test_readers_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(3, 4)), rng.normal(size=(2, 5))
    scipy.io.savemat(str(tmp_path / "v5.mat"), {"coeff": a, "sol": b})
    with h5py.File(str(tmp_path / "v73.mat"), "w") as f:
        f["coeff"] = a.T
    np.savez(str(tmp_path / "d.npz"), coeff=a)
    torch.save({"coeff": torch.tensor(a)}, str(tmp_path / "d.pt"))
    for name in ("v5.mat", "v73.mat", "d.npz", "d.pt"):
        got = lib.MatReader(str(tmp_path / name)).read_field("coeff")
        want = jlib.MatReader(str(tmp_path / name)).read_field("coeff")
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, a.astype(np.float32))
    with h5py.File(str(tmp_path / "h.h5"), "w") as f:
        f["x"] = rng.normal(size=(3, 8, 8))
        f["y"] = rng.normal(size=(3, 8, 8))
    for kw in ({}, {"resolution": 4, "n_samples": 2}):
        ds, jds = (m.H5pyDataset(str(tmp_path / "h.h5"), **kw)
                   for m in (lib, jlib))
        assert len(ds) == len(jds)
        for k in ("x", "y"):
            np.testing.assert_array_equal(ds[1][k], jds[1][k])


def test_positional_encodings_and_patches_match_jax():
    grid = lib.grid_positional_encoding(6, 5, ((0, 2), (-1, 1)), "cpu")
    np.testing.assert_array_equal(
        grid.numpy(), jlib.grid_positional_encoding(6, 5, ((0, 2), (-1, 1))))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        lib.append_2d_grid_positional_encoding(torch.tensor(x)).numpy(),
        jlib.append_2d_grid_positional_encoding(jnp.asarray(x)))
    pe, jpe = lib.PositionalEmbedding2D(), jlib.PositionalEmbedding2D()
    for a in (x, x[0]):
        np.testing.assert_array_equal(pe(torch.tensor(a)).numpy(),
                                      jpe(jnp.asarray(a)))
    mg, jmg = lib.RandomMGPatch(levels=2, seed=9), \
        jlib.RandomMGPatch(levels=2, seed=9)
    for _ in range(4):
        xy = (rng.normal(size=(16, 16, 2)), rng.normal(size=(16, 16, 1)))
        (px, py), (jx, jy) = mg(xy), jmg(xy)
        assert px.shape == (4, 4, 6)
        np.testing.assert_array_equal(px.numpy(), jx)
        np.testing.assert_array_equal(py.numpy(), jy)


def test_tensor_dataset_and_the_zarr_gate():
    rng = np.random.default_rng(5)
    x, y = rng.normal(size=(4, 3)), rng.normal(size=(4, 2))
    ds = lib.TensorDataset(x, y, transform_x=lambda a: 2 * a)
    jds = jlib.TensorDataset(x, y, transform_x=lambda a: 2 * a)
    assert len(ds) == len(jds) == 4
    for k in ("x", "y"):
        np.testing.assert_array_equal(ds[2][k], jds[2][k])
    tx, ty = ds.arrays("cpu", torch.float64)
    np.testing.assert_array_equal(tx.numpy(), x)
    try:
        import zarr  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="zarr"):
            lib.ZarrDataset("nonexistent.zarr")
    assert lib.ZarrDataset._RES_TO_STEP == jlib.ZarrDataset._RES_TO_STEP \
        == {128: 8, 256: 4, 512: 2, 1024: 1}


def test_darcy_given_jaxs_field():
    """JAX's `load_darcy_flow` (its field drawn from PRNGKey(seed)) and the
    port's construction and 2000-sweep solve on that field: a exactly, u
    at 1e-10; the port's own draw gives the same structure."""
    jtr, jts = jlib.load_darcy_flow(n_train=3, n_test=1, resolution=16,
                                    seed=2)
    grf = jsyn.gaussian_rf_2d(jax.random.PRNGKey(2), 16, 4, alpha=2.0,
                              tau=3.0)
    a, u = lib.darcy_from_field(torch.tensor(np.asarray(grf)))
    np.testing.assert_array_equal(a[:3, ..., None].numpy().astype(np.float32),
                                  jtr.x)
    assert rel(u[:3, ..., None], jtr.y) <= 1e-6   # the JAX set is float32
    ju = np.asarray(jlib._solve_darcy(jnp.asarray(a.numpy())))
    assert rel(u, ju) <= 1e-10
    tr, ts = lib.load_darcy_flow(n_train=3, n_test=1, resolution=16, seed=2,
                                 device="cpu")
    assert tr.x.shape == jtr.x.shape and ts.y.shape == jts.y.shape
    assert set(np.unique(tr.x)) <= {3.0, 12.0}


def test_navier_stokes_loader_given_jaxs_field():
    jtr, jts = jlib.load_navier_stokes(n_train=2, n_test=1, resolution=16,
                                       nt=3, seed=1, test_resolutions=[8])
    w0 = jsyn.gaussian_rf_2d(jax.random.PRNGKey(1), 16, 3)
    w = kolmogorov_from_field(torch.tensor(np.asarray(w0)), 3).numpy()
    assert rel(w[:2, ..., :1], jtr.x) <= 1e-10
    assert rel(w[:2, ..., -1:], jtr.y) <= 1e-10
    assert rel(w[2:, ::2, ::2, -1:], jts["8"].y) <= 1e-10
    tr, tests = lib.load_navier_stokes(n_train=2, n_test=1, resolution=16,
                                       nt=3, seed=1, test_resolutions=[8],
                                       device="cpu")
    assert tr.x.shape == jtr.x.shape and tests["8"].x.shape == (1, 8, 8, 1)


def test_burgers_and_spherical_swe_given_jaxs_draws():
    jtr, jts = jlib.load_burgers(n_train=2, n_test=1, resolution=32, seed=3)
    u0 = np.asarray(jsyn.gaussian_rf_2d(jax.random.PRNGKey(3), 32, 3))[:, :, 0]
    uT = lib.burgers_from_field(torch.tensor(u0)).numpy()
    np.testing.assert_array_equal(u0[:2, :, None], jtr.x)
    assert rel(uT[:2, :, None], jtr.y) <= 1e-10
    assert rel(uT[2:, :, None], jts.y) <= 1e-10
    tr, _ = lib.load_burgers(n_train=2, n_test=1, resolution=32, seed=3,
                             device="cpu")
    assert tr.y.shape == (2, 32, 1)
    jtr, jts = jlib.load_spherical_swe(n_train=2, n_test=1, nlat=8, nlon=16,
                                       seed=4)
    tr, ts = lib.load_spherical_swe(n_train=2, n_test=1, nlat=8, nlon=16,
                                    seed=4, device="cpu")
    for x, y in ((tr.x, jtr.x), (tr.y, jtr.y), (ts.y, jts.y)):
        assert x.dtype == np.float32
        assert rel(x, y) <= 1e-6


# -- utils/profiling and visualization ---------------------------------------

def test_profiling_on_the_cpu(tmp_path):
    lin = torch.nn.Linear(32, 16, bias=False)
    x = torch.randn(8, 32)
    assert profiling.flop_estimate(lin, x) == 2 * 8 * 32 * 16
    assert profiling.flop_estimate(lambda: 1 / 0) is None
    stats = profiling.benchmark(lin, x, warmup=1, iters=3)
    assert stats["mean_ms"] > 0 and stats["iters_per_s"] > 0
    res = profiling.profile_result(lin, x, warmup=1, iters=2)
    assert res["flops"] == 2 * 8 * 32 * 16 and res["gflops_per_s"] > 0
    with profiling.trace(str(tmp_path / "tr")) as path:
        lin(x)
    assert os.path.getsize(path) > 0
    assert "no memory statistics on the CPU" in profiling.memory_summary()


def test_visualization_arrays_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    m = rng.normal(size=(6, 7))
    np.testing.assert_array_equal(visualization.matrix2image(torch.tensor(m)),
                                  jvis.matrix2image(m))
    np.testing.assert_array_equal(
        visualization.matrix2image(m, -1, 1, "magma"),
        jvis.matrix2image(m, -1, 1, "magma"))
    u, v = rng.normal(size=(2, 6, 7))
    img = visualization.visualize_pressure_speed(m, -2, 2, u, v,
                                                 x_sample_interval=2)
    np.testing.assert_array_equal(
        img, jvis.visualize_pressure_speed(m, -2, 2, u, v,
                                           x_sample_interval=2))
    data = {"x": rng.normal(size=(2, 5, 5, 1)), "y": rng.normal(size=(2, 5, 5))}
    got, want = visualization.vis_diagram(data), jvis.vis_diagram(data)
    assert got.keys() == want.keys() == {"x", "y"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    path = visualization.save_images_to_video([img, img],
                                              str(tmp_path / "v.gif"))
    assert os.path.getsize(path) > 0


# -- training/torch_init ------------------------------------------------------

def test_torch_reinit_rule():
    """Linear weights and biases within torch's bounds, spectral weights
    untouched, spectral biases at ~1/width^2, `exclude` left as it is,
    and the same draws from the same generator."""
    from pde_policylearning_torch.models import FNO
    model = FNO((6, 6), 8, in_channels=3, out_channels=1, n_layers=2,
                **CPU64)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch_reinit(model, torch.Generator().manual_seed(0),
                 exclude=("/lifting/fc/kernel",))
    owners = dict(model.named_modules())
    for n, p in model.named_parameters():
        prefix, _, leaf = n.rpartition(".")
        owner = owners[prefix]
        if n == "lifting.fc.weight":
            assert torch.equal(p, before[n])
        elif isinstance(owner, torch.nn.Linear):
            bound = owner.in_features ** -0.5
            assert not torch.equal(p, before[n])
            assert p.abs().max() <= bound
            assert p.numel() < 16 or p.abs().max() > 0.5 * bound
        elif leaf == "bias":
            assert p.abs().max() < 5.0 / p.shape[-1] ** 2
        else:
            assert torch.equal(p, before[n]), n
    again = FNO((6, 6), 8, in_channels=3, out_channels=1, n_layers=2,
                **CPU64)
    again.load_state_dict({k: v for k, v in before.items()})
    torch_reinit(again, torch.Generator().manual_seed(0),
                 exclude=("/lifting/fc/kernel",))
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n


# -- run_spec_visualization ---------------------------------------------------

def test_run_spec_visualization_matches_jax(tmp_path, monkeypatch, capsys):
    """Both scripts on a tiny folder with an observer checkpoint the JAX
    package wrote: the npz fallback (an image format matplotlib refuses)
    holds the same curves, and the port also draws its png."""
    rng = np.random.default_rng(7)
    folder = tmp_path / "planes"
    folder.mkdir()
    p = rng.normal(size=(4, 16, 16)).astype(np.float32)
    v = rng.normal(size=(4, 16, 16)).astype(np.float32)
    for i in range(4):
        np.save(folder / f"P_planes_{i:06d}.npy", p[i])
        np.save(folder / f"V_planes_{i:06d}.npy", v[i])
    np.save(folder / "metadata.npy", {
        "P_planes": {"mean": p.mean(0), "std": p.std(0) + 1e-8},
        "V_planes": {"mean": v.mean(0), "std": v.std(0) + 1e-8}})
    jm = JFNO2dObserver(4, 4, 6)
    tree = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))["params"]
    ckpt = jsave_msgpack(str(tmp_path / "obs.msgpack"), tree)
    common = ["--data_folder", str(folder), "--ckpt", ckpt, "--modes", "4",
              "--width", "6", "--x_range", "16", "--y_range", "16"]
    monkeypatch.setattr(sys, "argv", ["run_spec_visualization.py", *common,
                                      "--out", str(tmp_path / "j.bad")])
    runpy.run_path(os.path.join(ROOT, "run_spec_visualization.py"),
                   run_name="__main__")
    curves = tspec.main([*common, "--out", str(tmp_path / "t.bad"),
                         "--device", "cpu"])
    assert "saved raw spectra" in capsys.readouterr().out
    want, got = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(got.files) == sorted(want.files) == \
        ["ground truth", "prediction"]
    for k in got.files:
        assert rel(got[k], want[k]) <= 1e-5
        np.testing.assert_array_equal(got[k], curves[k])
    tspec.main([*common, "--out", str(tmp_path / "t.png"), "--device",
                "cpu"])
    assert os.path.getsize(tmp_path / "t.png") > 0
