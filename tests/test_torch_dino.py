"""DINo in the port against the JAX package, in float64 on the CPU: every
module of `models/dino.py` (forward and gradients against `jax.grad` at
1e-10), `odeint_rk4`, every data function of `data/dino_datasets.py`
given JAX's draws, `train_dino` over 2 epochs of 2 batches with JAX's
permutations replayed (states, the three parameter groups and the history
at 1e-8 relative), the conditioned trainer and both evaluations, and both
entries at a tiny size, each reading the other package's `.msgpack`.

The JAX trainers draw their parameters with `model.init`, which makes
float32 leaves even under x64; the modules handed to them here are
subclasses whose `init` casts the tree to float64 (`f64`), so both
packages train in float64.  Nothing in the JAX package changes."""
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.data import dino_datasets as jdd
from pde_policylearning_tpu.data import synthetic as jsyn
from pde_policylearning_tpu.models import dino as jd
from pde_policylearning_tpu.training import dino_train as jt
from pde_policylearning_tpu.training.checkpoint import load_msgpack as \
    jload_msgpack
from pde_policylearning_torch import test_dino as ttest
from pde_policylearning_torch import train_dino as ttrain
from pde_policylearning_torch.data import dino_datasets as tdd
from pde_policylearning_torch.models import dino as td
from pde_policylearning_torch.training import dino_train as tt
from pde_policylearning_torch.training.checkpoint import load_msgpack
from pde_policylearning_torch.utils.transplant import (jax_params,
                                                       load_jax_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU64 = dict(device="cpu", dtype=torch.float64)
FWD, TRAIN = 1e-10, 1e-8


def rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    den = np.abs(b).max()
    return float(np.abs(a - b).max() / den) if den else \
        float(np.abs(a).max())


def f64(cls):
    """A flax module class whose `init` gives a float64 tree."""
    class F64(cls):
        def init(self, *a, **k):
            return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                                super().init(*a, **k))
    F64.__name__ = cls.__name__
    return F64


def random_tree(jmodel, inputs, rng, scale=0.3):
    shapes = jax.eval_shape(
        lambda *a: jmodel.init(jax.random.PRNGKey(0), *a),
        *[jnp.asarray(x) if isinstance(x, np.ndarray) else x
          for x in inputs])["params"]
    return jax.tree.map(lambda s: scale * rng.normal(size=s.shape), shapes)


def grads_tree(model, jtree):
    """The JAX gradient tree in the port's parameter layouts."""
    ref = load_jax_params(_clone(model), jax.tree.map(np.asarray, jtree))
    return dict(ref.named_parameters())


def _clone(model):
    import copy
    return copy.deepcopy(model)


def assert_matches(jmodel, model, inputs, rng, grad_inputs=(), scale=0.3):
    """Forward and the gradients of sum(out * w) to every parameter and to
    `inputs[grad_inputs]`, at FWD relative to the largest entry."""
    tree = random_tree(jmodel, inputs, rng, scale)
    load_jax_params(model, tree)
    jx = [jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in inputs]
    out_j = jmodel.apply({"params": jax.tree.map(jnp.asarray, tree)}, *jx)
    w = rng.normal(size=out_j.shape)
    argnums = (0, *[1 + i for i in grad_inputs])
    grads = jax.grad(lambda p, *xs: jnp.sum(jmodel.apply({"params": p}, *xs)
                                            * w), argnums=argnums)(
        jax.tree.map(jnp.asarray, tree), *jx)
    tx = [torch.tensor(x).requires_grad_(i in grad_inputs)
          if isinstance(x, np.ndarray) else x for i, x in enumerate(inputs)]
    out = model(*tx)
    assert rel(out, out_j) <= FWD
    (out * torch.tensor(w)).sum().backward()
    for i, g in zip(grad_inputs, grads[1:]):
        assert rel(tx[i].grad, g) <= FWD, f"input {i}"
    ref = grads_tree(model, grads[0])
    for n, p in model.named_parameters():
        assert rel(p.grad, ref[n].detach()) <= FWD, n
    return out.detach()


def test_swish_mlp_derivative_and_set_encoder_match_flax():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(3, 6))
    for out in (None, 4):
        assert_matches(jd.SwishMLP(8, out), td.SwishMLP(6, 8, out, **CPU64),
                       [u], rng, grad_inputs=(0,))
    assert_matches(jd.Derivative(state_c=2, code_c=3, hidden_c=8),
                   td.Derivative(2, 3, 8, **CPU64), [0.0, u], rng,
                   grad_inputs=(1,))
    x = rng.normal(size=(2, 3, 5))
    for out in (None, 4):
        enc = td.SetEncoder(5, 3, 8, out, **CPU64)
        assert {"ave_kernel", "ave_bias"} <= {n for n, _ in
                                              enc.named_parameters()}
        assert_matches(jd.SetEncoder(code_size=5, n_cond=3, hidden_size=8,
                                     out_size=out), enc, [x], rng,
                       grad_inputs=(0,))


@pytest.mark.parametrize("state_c,coord_dim", [(1, 2), (2, 3)])
def test_decoder_matches_flax_on_the_5d_input(state_c, coord_dim):
    """(B*T, H, W, S, D) coordinates and (B*T, S*C) codes, as
    `_decode_batch` feeds them."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, size=(4, 5, 6, state_c, coord_dim))
    codes = rng.normal(size=(4, state_c * 3))
    out = assert_matches(
        jd.Decoder(state_c=state_c, hidden_c=8, code_c=3,
                   coord_dim=coord_dim, n_layers=2),
        td.Decoder(state_c, 8, 3, coord_dim, n_layers=2, **CPU64),
        [x, codes], rng, grad_inputs=(0, 1), scale=0.05)
    assert out.shape == (4, 5, 6, state_c)


def test_two_state_channels_decode_identically_in_both_packages():
    """With state_c = 2 the decoder predicts the same height and vorticity:
    `_decode_batch` gives both channels the same coordinates and the
    FourierNet's code term is broadcast over them.  Pinned in both."""
    rng = np.random.default_rng(2)
    jdec = jd.Decoder(state_c=2, hidden_c=8, code_c=3, coord_dim=2)
    tree = random_tree(jdec, [np.zeros((1, 1, 1, 2, 2)), np.zeros((1, 6))],
                       rng, 0.05)
    states = rng.normal(size=(2, 3, 6))
    jout = np.asarray(jt._decode_batch(jdec, jax.tree.map(jnp.asarray, tree),
                                       jt.make_coords(8, 8), states, 2, 3))
    dec = load_jax_params(td.Decoder(2, 8, 3, 2, **CPU64), tree)
    out = tt._decode_batch(dec, tt.make_coords(8, 8, **CPU64),
                           torch.tensor(states), 2, 3).detach().numpy()
    assert out.shape == jout.shape == (2, 3, 8, 8, 2)
    assert np.abs(jout[..., 0] - jout[..., 1]).max() == 0.0
    assert np.abs(out[..., 0] - out[..., 1]).max() == 0.0
    assert rel(out, jout) <= FWD


def test_odeint_rk4_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(4, 4)) * 0.5
    y0 = rng.normal(size=(3, 4))
    ts = np.sort(rng.uniform(0, 1, size=7))
    want = jd.odeint_rk4(lambda t, y: jnp.tanh(y @ a) * jnp.cos(t),
                         jnp.asarray(y0), jnp.asarray(ts))
    got = td.odeint_rk4(lambda t, y: torch.tanh(y @ torch.tensor(a))
                        * torch.cos(t), torch.tensor(y0), torch.tensor(ts))
    assert got.shape == (7, 3, 4)
    assert rel(got, want) <= 1e-13
    ts = torch.linspace(0, 1, 21, dtype=torch.float64)
    ys = td.odeint_rk4(lambda t, y: -y, torch.ones(2, 3, dtype=torch.float64),
                       ts)
    np.testing.assert_allclose(ys[-1].numpy(), np.exp(-1.0), rtol=1e-6)


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("which", ["wave", "navier"])
def test_generated_trajectories_given_jaxs_field(which):
    """The port's solvers from JAX's own random field: the JAX data at
    1e-10 (wave: alpha 3, tau 5; NS: the default field)."""
    key = jax.random.PRNGKey(7)
    n, size, nt = 2, 16, 4
    if which == "wave":
        field = jsyn.gaussian_rf_2d(key, size, n, alpha=3.0, tau=5.0)
        want = jdd.generate_wave_data(key, n, size, nt)
        got = tdd.wave_data_from_field(torch.tensor(np.asarray(field)), nt)
    else:
        field = jsyn.gaussian_rf_2d(key, size, n)
        want = jdd.generate_navier_stokes_data(key, n, size, nt)
        got = tdd.navier_stokes_data_from_field(
            torch.tensor(np.asarray(field)), nt)
    assert got.shape == (n, nt, size, size, 1)
    assert rel(got, want) <= FWD
    gen = torch.Generator().manual_seed(0)
    fn = tdd.generate_wave_data if which == "wave" \
        else tdd.generate_navier_stokes_data
    data = fn(n, size, nt, generator=gen, **CPU64)
    assert data.shape == (n, nt, size, size, 1)
    assert torch.isfinite(data).all()


def test_masks_and_sphere_coords_match_jax():
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (16, 12)))
    want = np.asarray(jdd.generate_mask(key, 16, 12, 0.5))
    got = tdd.generate_mask(16, 12, 0.5, device="cpu", u=torch.tensor(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.3 < float(got.float().mean()) < 0.7
    gen = torch.Generator().manual_seed(0)
    m = tdd.generate_mask(16, 12, 0.25, gen, "cpu")
    assert m.dtype == torch.bool and 0.6 < float(m.float().mean()) < 0.9
    assert tdd.generate_mask(4, 5, 0.0, device="cpu").all()
    for args in ((16, 16), (9, 20, 1)):
        np.testing.assert_array_equal(
            tdd.generate_skipped_lat_lon_mask(*args, device="cpu").numpy(),
            np.asarray(jdd.generate_skipped_lat_lon_mask(*args)))
    np.testing.assert_array_equal(tdd.spherical_xyz_coords(8, 16),
                                  jdd.spherical_xyz_coords(8, 16))


@pytest.mark.parametrize("offset", [0, 10_000])
def test_shallow_water_data_matches_jax(offset):
    """The same numpy draws and the same float32 spectra through each
    package's inverse SHT: 1e-6 relative (the transforms' products)."""
    want = np.asarray(jdd.generate_shallow_water_data(None, 3, 8, 16, 4,
                                                      seed_offset=offset))
    got = tdd.generate_shallow_water_data(3, 8, 16, 4, seed_offset=offset,
                                          device="cpu")
    assert got.dtype == torch.float32 and got.shape == (3, 4, 8, 16, 2)
    assert rel(got, want) <= 1e-6
    # the quirk of the set itself: the channels are different fields
    assert np.abs(want[..., 0] - want[..., 1]).max() > 0


def test_shallow_water_datasets_synthetic_and_hdf5(tmp_path):
    import h5py
    jds = jdd.ShallowWaterDataset(n_seq=3, nt=4, nlat=8, nlon=16,
                                  group="test")
    ds = tdd.ShallowWaterDataset(n_seq=3, nt=4, nlat=8, nlon=16,
                                 group="test", device="cpu")
    assert len(ds) == 3 and ds.coord_dim == 3
    assert rel(ds.data, jds.data) <= 1e-6
    item, jitem = ds[1], jds[1]
    np.testing.assert_array_equal(item["coords"], jitem["coords"])
    np.testing.assert_array_equal(item["t"], jitem["t"])
    data, coords = ds.arrays("cpu", torch.float64)
    assert data.shape == (3, 4, 8, 16, 2) and coords.shape == (8, 16, 3)
    # the reference's dedalus layout: both read the same files
    rng = np.random.default_rng(4)
    d = tmp_path / "shallow_water_train"
    d.mkdir()
    for i in range(2):
        with h5py.File(d / f"traj_{i:04d}.h5", "w") as f:
            f["tasks/height"] = rng.normal(size=(5, 16, 32))
            f["tasks/vorticity"] = rng.normal(size=(5, 16, 32))
    jds = jdd.ShallowWaterDataset(2, 3, root=str(tmp_path))
    ds = tdd.ShallowWaterDataset(2, 3, root=str(tmp_path), device="cpu")
    assert ds.data.shape == (2, 3, 8, 16, 2)
    np.testing.assert_array_equal(ds.data, jds.data)
    np.testing.assert_array_equal(ds.coords, jds.coords)


def test_sst_dataset_matches_jax():
    for train in (True, False):
        kw = dict(nt_cond=2, nt_pred=3, train=train, zones=[1, 2],
                  n_days=120)
        jds, ds = jdd.SSTDataset(**kw), tdd.SSTDataset(**kw)
        assert len(ds) == len(jds) >= 2
        for i in (0, len(ds) - 1):
            a, b = ds[i], jds[i]
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


# -- training -----------------------------------------------------------------

def jax_train(jdec, jdyn, data, tg, key, n_epochs, batch_size, **kw):
    """The JAX `train_dino` and, drawn as it draws them, its initial
    parameters and its permutations."""
    rng, init_rng = jax.random.split(key)
    dp, yp, _ = jt.init_dino(jdec, jdyn, data.shape, kw["code_dim"],
                             kw.get("state_dim", 1),
                             2 if kw.get("coords") is None
                             else kw["coords"].shape[-1], init_rng)
    N = data.shape[0]
    n_b = max(1, N // min(batch_size, N))
    perms = []
    for _ in range(n_epochs):
        rng, sub = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(sub, N))
                     [:n_b * batch_size])
    out = jt.train_dino(jdec, jdyn, jnp.asarray(data), jnp.asarray(tg),
                        n_epochs=n_epochs, batch_size=batch_size, rng=key,
                        log_interval=1, verbose=False, **kw)
    return (dp, yp, perms), out


def setup(state_c, coord_dim, rng, N=4, T=3, H=6, C=3):
    data = rng.normal(size=(N, T, H, H + 1, state_c))
    tg = np.linspace(0, 1, T)
    jdec = f64(jd.Decoder)(state_c=state_c, hidden_c=8, code_c=C,
                           coord_dim=coord_dim, n_layers=2)
    jdyn = f64(jd.Derivative)(state_c=state_c, code_c=C, hidden_c=16)
    dec = td.Decoder(state_c, 8, C, coord_dim, n_layers=2, **CPU64)
    dyn = td.Derivative(state_c, C, 16, **CPU64)
    return data, tg, (jdec, jdyn), (dec, dyn)


@pytest.mark.parametrize("case", ["planar_masked", "sphere_xyz"])
def test_train_dino_replays_jax(case):
    """2 epochs of 2 batches from JAX's initial parameters with JAX's
    permutations: states, decoder, dynamics and history at 1e-8."""
    rng = np.random.default_rng(5)
    state_c, coord_dim = (1, 2) if case == "planar_masked" else (2, 3)
    data, tg, (jdec, jdyn), (dec, dyn) = setup(state_c, coord_dim, rng)
    kw = dict(code_dim=3, state_dim=state_c, lr=1e-2)
    if case == "planar_masked":
        kw["mask"] = rng.uniform(size=data.shape[2:4]) >= 0.3
    else:
        kw["coords"] = rng.normal(size=(*data.shape[2:4], 3))
    (dp, yp, perms), (jdp, jyp, jstates, jhist) = jax_train(
        jdec, jdyn, data, tg, jax.random.PRNGKey(11), 2, 2, **kw)
    load_jax_params(dec, jax.tree.map(np.asarray, dp))
    load_jax_params(dyn, jax.tree.map(np.asarray, yp))
    tkw = dict(kw)
    if "mask" in tkw:
        tkw["mask"] = torch.tensor(tkw["mask"])
    states, hist = tt.train_dino(dec, dyn, torch.tensor(data),
                                 torch.tensor(tg), n_epochs=2, batch_size=2,
                                 perms=perms, log_interval=1, verbose=False,
                                 **tkw)
    assert rel(states, jstates) <= TRAIN
    for key in ("autodec", "dyn"):
        assert len(hist[key]) == 2
        np.testing.assert_allclose(hist[key], jhist[key], rtol=TRAIN)
    assert hist["autodec"][0] > 0 and hist["dyn"][1] > 0
    for model, tree in ((dec, jdp), (dyn, jyp)):
        ref = dict(load_jax_params(_clone(model),
                                   jax.tree.map(np.asarray, tree))
                   .named_parameters())
        for n, p in model.named_parameters():
            assert rel(p, ref[n].detach()) <= TRAIN, n


def test_state_rows_outside_the_batch_move_in_both_packages():
    """Adam runs over every state row with a zero gradient outside the
    batch: a row of the first batch moves again at the second step by its
    stale momentum.  One epoch of 2 batches from zero states: a first-
    batch row ends at lr/10 (1 + b1 (1 - b1) / (1 - b1^2) / sqrt(b2 (1 -
    b2) / (1 - b2^2))) ~ 1.67 lr/10 in each entry, a second-batch row at
    (1 - b1) / (1 - b1^2) / sqrt((1 - b2) / (1 - b2^2)) ~ 0.74 lr/10; a
    row-only update would leave every row at lr/10."""
    rng = np.random.default_rng(6)
    data, tg, (jdec, jdyn), (dec, dyn) = setup(1, 2, rng)
    (dp, yp, perms), (_, _, jstates, _) = jax_train(
        jdec, jdyn, data, tg, jax.random.PRNGKey(2), 1, 2, code_dim=3)
    load_jax_params(dec, jax.tree.map(np.asarray, dp))
    load_jax_params(dyn, jax.tree.map(np.asarray, yp))
    states, _ = tt.train_dino(dec, dyn, torch.tensor(data), torch.tensor(tg),
                              code_dim=3, n_epochs=1, batch_size=2,
                              perms=perms, verbose=False)
    b1, b2, step = 0.9, 0.999, 1e-3
    first = step * (1 + b1 * (1 - b1) / (1 - b1 ** 2)
                    / np.sqrt(b2 * (1 - b2) / (1 - b2 ** 2)))
    second = step * (1 - b1) / (1 - b1 ** 2) / np.sqrt((1 - b2)
                                                       / (1 - b2 ** 2))
    for s in (states.numpy(), np.asarray(jstates)):
        np.testing.assert_allclose(np.abs(s[perms[0][:2]]), first, rtol=1e-4)
        np.testing.assert_allclose(np.abs(s[perms[0][2:]]), second,
                                   rtol=1e-4)
    assert rel(states, jstates) <= TRAIN


def test_conditioned_training_and_both_evaluations_match_jax():
    """`train_dino_conditioned` (2 epochs: the trainer, then 2 encoder
    steps), `eval_dino_cond`, and `eval_dino` with and without a mask."""
    rng = np.random.default_rng(8)
    data, tg, (jdec, jdyn), (dec, dyn) = setup(1, 2, rng, T=4)
    jenc = f64(jd.SetEncoder)(code_size=3, n_cond=2, hidden_size=8)
    enc = td.SetEncoder(3, 2, 8, **CPU64)
    key = jax.random.PRNGKey(4)
    (dp, yp, perms), _ = jax_train(jdec, jdyn, data, tg, key, 2, 2,
                                   code_dim=3)
    jdp, jyp, jep, jstates, jhist = jt.train_dino_conditioned(
        jdec, jdyn, jenc, jnp.asarray(data), jnp.asarray(tg), code_dim=3,
        n_cond=2, n_epochs=2, batch_size=2, rng=key, log_interval=1,
        verbose=False)
    ep0 = jax.jit(jenc.init)(key, jnp.zeros((1, 2, 3)))["params"]
    for m, tree in ((dec, dp), (dyn, yp), (enc, ep0)):
        load_jax_params(m, jax.tree.map(np.asarray, tree))
    td_ = torch.tensor(data)
    states, hist = tt.train_dino_conditioned(
        dec, dyn, enc, td_, torch.tensor(tg), code_dim=3, n_cond=2,
        n_epochs=2, batch_size=2, perms=perms, log_interval=1,
        verbose=False)
    assert rel(states, jstates) <= TRAIN
    np.testing.assert_allclose(hist["encoder"], jhist["encoder"], rtol=TRAIN)
    ref = dict(load_jax_params(_clone(enc), jax.tree.map(np.asarray, jep))
               .named_parameters())
    for n, p in enc.named_parameters():
        assert rel(p, ref[n].detach()) <= TRAIN, n

    res = tt.eval_dino_cond(dec, dyn, enc, td_, torch.tensor(tg), code_dim=3,
                            n_cond=2, adapt_steps=3)
    jres = jt.eval_dino_cond(jdec, jdyn, jenc, jdp, jyp, jep,
                             jnp.asarray(data), jnp.asarray(tg), code_dim=3,
                             n_cond=2, adapt_steps=3)
    assert abs(res["mse"] / jres["mse"] - 1) <= TRAIN
    assert rel(res["pred"], jres["pred"]) <= TRAIN
    for mask in (None, rng.uniform(size=data.shape[2:4]) >= 0.4):
        res = tt.eval_dino(dec, dyn, td_, torch.tensor(tg), code_dim=3,
                           adapt_steps=4, n_cond_frames=2,
                           mask=None if mask is None else torch.tensor(mask),
                           return_codes=True)
        jres = jt.eval_dino(jdec, jdyn, jdp, jyp, jnp.asarray(data),
                            jnp.asarray(tg), code_dim=3, adapt_steps=4,
                            n_cond_frames=2, mask=mask, return_codes=True)
        for k in ("mse", "mse_in_t", "mse_out_t"):
            assert abs(res[k] / jres[k] - 1) <= TRAIN, k
        assert rel(res["pred"], jres["pred"]) <= TRAIN
        assert rel(res["codes"], jres["codes"]) <= TRAIN


# -- the entries ----------------------------------------------------------------

TINY = ["--n_traj", "2", "--size", "8", "--n_frames", "3", "--code_dim",
        "4", "--hidden_c", "8", "--hidden_c_dyn", "16"]


def test_port_evaluates_a_jax_checkpoint(tmp_path, monkeypatch, capsys):
    """The JAX `train_dino.py` writes its .msgpack; the port's `test_dino`
    evaluates it on JAX's test trajectories (float32, as the entry runs)
    to the MSE of the JAX `eval_dino` on the same parameters and data
    (float64 under the tests' x64): 1e-5, float32 through 100 Adam
    steps of the adaptation."""
    out = str(tmp_path / "jax.msgpack")
    monkeypatch.setattr(sys, "argv", ["train_dino.py", "--epochs", "2",
                                      *TINY, "--out", out])
    runpy.run_path(os.path.join(ROOT, "train_dino.py"), run_name="__main__")
    assert "eval: mse" in capsys.readouterr().out
    data = jdd.generate_navier_stokes_data(jax.random.PRNGKey(1), 2, 8, 3)
    monkeypatch.setattr(ttest, "generate_navier_stokes_data",
                        lambda *a, **k: torch.tensor(np.asarray(data),
                                                     dtype=torch.float32))
    res = ttest.main(["--ckpt", out, *TINY, "--device", "cpu"])
    assert "test: mse" in capsys.readouterr().out
    jdec = jd.Decoder(state_c=1, hidden_c=8, code_c=4, coord_dim=2)
    jdyn = jd.Derivative(state_c=1, code_c=4, hidden_c=16)
    ckpt = jload_msgpack(out)
    jres = jt.eval_dino(jdec, jdyn, ckpt["dec"], ckpt["dyn"], data,
                        jnp.linspace(0, 1.0, 3), code_dim=4)
    for k in ("mse", "mse_in_t", "mse_out_t"):
        assert abs(res[k] / jres[k] - 1) <= 1e-5, (k, res[k], jres[k])


def test_port_checkpoint_reads_back_in_jax(tmp_path, capsys):
    """The port's `train_dino` entry on the CPU: the eval line, a falling
    loss, and its .msgpack read by the JAX `load_msgpack` with the JAX
    `test_dino` template, leaf for leaf; then the JAX `test_dino.py` runs
    on it."""
    out = str(tmp_path / "port.msgpack")
    res = ttrain.main(["--epochs", "6", *TINY, "--device", "cpu",
                       "--out", out])
    assert "eval: mse" in capsys.readouterr().out
    assert np.isfinite(res["eval"]["mse"])
    jdec = jd.Decoder(state_c=1, hidden_c=8, code_c=4, coord_dim=2)
    jdyn = jd.Derivative(state_c=1, code_c=4, hidden_c=16)
    tdec, tdyn, _ = jt.init_dino(jdec, jdyn, (2, 3, 8, 8, 1), 4, 1, 2,
                                 jax.random.PRNGKey(0))
    ckpt = jload_msgpack(out, {"dec": tdec, "dyn": tdyn,
                               "states_params": jnp.zeros((1,))})
    for name, model in (("dec", res["dec"]), ("dyn", res["dyn"])):
        mine = jax_params(model)[0]
        got = jax.tree_util.tree_leaves_with_path(ckpt[name])
        want = jax.tree_util.tree_leaves_with_path(mine)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(np.asarray(ckpt["states_params"]),
                                  res["states"].numpy())
    # the port's own reader gives the same tree
    mine = load_msgpack(out)
    np.testing.assert_array_equal(mine["states_params"],
                                  res["states"].numpy())


@pytest.mark.parametrize("dataset", ["wave", "shallow_water"])
def test_port_train_dino_entry_other_datasets(tmp_path, capsys, dataset):
    res = ttrain.main(["-d", dataset, "--epochs", "3", *TINY, "-r", "0.7",
                       "--device", "cpu", "--out",
                       str(tmp_path / "d.msgpack")])
    S = 2 if dataset == "shallow_water" else 1
    assert res["data"].shape == (2, 3, 8, 8 * (2 if S == 2 else 1), S)
    assert res["eval"]["pred"].shape == res["data"].shape
    assert np.isfinite(res["eval"]["mse"])
    assert not bool(res["mask"].all())
    assert os.path.exists(tmp_path / "d.msgpack")
