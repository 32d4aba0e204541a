"""PINO pretrain and finetune of the port (ops/pde_losses.py,
data/synthetic.py, data/pino_datasets.py, training/pino_train.py, the
train_pino entry, the JAX resume blob) against the JAX package's, on the
CPU: float64 for the functions and one training iteration, float32 where
the JAX entry script runs (its resume blob).  Inputs are numpy draws from a
seed; JAX's random draws are replayed where a function takes them."""
import math
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pde_policylearning_tpu import models as jmodels
from pde_policylearning_tpu.data import pino_datasets as jds
from pde_policylearning_tpu.data import synthetic as jsyn
from pde_policylearning_tpu.ops import pde_losses as jpl
from pde_policylearning_tpu.training import optimizers as jopt
from pde_policylearning_tpu.training import pino_train as jpt
from pde_policylearning_torch import train_pino
from pde_policylearning_torch.data import pino_datasets as ds
from pde_policylearning_torch.data import synthetic as syn
from pde_policylearning_torch.models import FNO
from pde_policylearning_torch.models.pino import PINObserver2d
from pde_policylearning_torch.ops import pde_losses as pl
from pde_policylearning_torch.training import pino_train as pt
from pde_policylearning_torch.utils.transplant import (jax_leaf_order,
                                                       load_jax_params,
                                                       load_jax_resume)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
TOL64 = 1e-10
SMALL = dict(modes1=(3, 3), modes2=(3, 3), modes3=(2, 2), layers=(8, 8, 8),
             fc_dim=16)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


# -- ops/pde_losses.py -------------------------------------------------------

def test_darcy_matches_jax():
    rng = np.random.default_rng(0)
    u, a = rng.normal(size=(2, 16, 16)), 1 + rng.random((2, 16, 16))
    assert rel(pl.fdm_darcy(t64(u), t64(a)),
               jpl.fdm_darcy(jnp.asarray(u), jnp.asarray(a))) < TOL64
    assert rel(pl.darcy_loss(t64(u), t64(a)),
               jpl.darcy_loss(jnp.asarray(u), jnp.asarray(a))) < TOL64


@pytest.mark.parametrize("n", [16, 12])
def test_ns_vorticity_residual_matches_jax(n):
    """Per-sample viscosity, two sizes."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(2, n, n, 7))
    v = np.array([1 / 40, 1 / 400])
    ours = pl.fdm_ns_vorticity(t64(w), t64(v), t_interval=0.5)
    ref = jpl.fdm_ns_vorticity(jnp.asarray(w), jnp.asarray(v),
                               t_interval=0.5, backend="fft")
    assert ours.shape == ref.shape
    assert rel(ours, ref) < TOL64


def test_ns_residual_vanishes_on_taylor_green():
    """tests/test_pino.py:54's exact solution, through both packages."""
    N, T, nu, t_int = 32, 9, 0.05, 0.1
    xs = np.linspace(0, 2 * np.pi, N, endpoint=False)
    X, Y, Tm = np.meshgrid(xs, xs, np.linspace(0, t_int, T), indexing="ij")
    w = (np.cos(X) * np.cos(Y) * np.exp(-2 * nu * Tm))[None]
    ours = pl.fdm_ns_vorticity(t64(w), v=t64([nu]), t_interval=t_int)
    ref = jpl.fdm_ns_vorticity(jnp.asarray(w), v=jnp.asarray([nu]),
                               t_interval=t_int)
    assert float(np.linalg.norm(ours) / np.linalg.norm(w)) < 5e-3
    # the residual is the cancellation of O(1) terms: held against |w|
    assert float(np.linalg.norm(ours.numpy() - np.asarray(ref))
                 / np.linalg.norm(w)) < 1e-12


def test_pino_loss_3d_and_forcing_match_jax():
    rng = np.random.default_rng(2)
    u, u0 = rng.normal(size=(2, 16, 16, 5)), rng.normal(size=(2, 16, 16))
    f = pl.get_forcing(16, device="cpu", dtype=torch.float64)
    jf = jpl.get_forcing(16)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-12)
    v = np.array([1 / 40, 1 / 100])
    ours = pl.pino_loss_3d(t64(u), t64(u0), f, t64(v), 1.0)
    ref = jpl.pino_loss_3d(jnp.asarray(u), jnp.asarray(u0), jf,
                           jnp.asarray(v), 1.0)
    for a, b in zip(ours, ref):
        assert rel(a, b) < TOL64
    assert pl.channelflow_pino_loss is pl.pino_loss_3d


def test_burgers_matches_jax():
    rng = np.random.default_rng(3)
    u, u0 = rng.normal(size=(3, 8, 16)), rng.normal(size=(3, 16))
    assert rel(pl.fdm_burgers(t64(u), 0.01),
               jpl.fdm_burgers(jnp.asarray(u), 0.01)) < TOL64
    for a, b in zip(pl.pino_loss_burgers(t64(u), t64(u0), 0.01),
                    jpl.pino_loss_burgers(jnp.asarray(u), jnp.asarray(u0),
                                          0.01)):
        assert rel(a, b) < TOL64
    assert float(pl.fdm_burgers(torch.ones(2, 8, 16, dtype=torch.float64),
                                0.01).abs().max()) < 1e-10


# -- data/synthetic.py -------------------------------------------------------

def jax_grf_noise(key, batch, size):
    """The complex draw of `synthetic.gaussian_rf_2d` (its key split)."""
    kr, ki = jax.random.split(key)
    return np.asarray((jax.random.normal(kr, (batch, size, size))
                       + 1j * jax.random.normal(ki, (batch, size, size)))
                      * (1.0 / math.sqrt(2.0)))


@pytest.mark.parametrize("alpha,tau,sigma", [(2.5, 7.0, None),
                                             (2.0, 3.0, 1.5)])
def test_grf_is_jax_given_its_draw(alpha, tau, sigma):
    key = jax.random.PRNGKey(7)
    ref = jsyn.gaussian_rf_2d(key, 16, batch=3, alpha=alpha, tau=tau,
                              sigma=sigma)
    noise = torch.tensor(jax_grf_noise(key, 3, 16))
    sqrt_eig = syn.grf_sqrt_eig(16, alpha, tau, sigma, device="cpu",
                                dtype=torch.float64)
    assert float(sqrt_eig[0, 0]) == 0.0
    assert rel(syn.grf_from_noise(sqrt_eig, noise), ref) < 1e-12


def test_grf_amplitude_matches_reference():
    """test_pino.py:166's check of the port's own draw: band power as the
    size**2 eigenvalue scale and variance-1/2 components give it, at two
    resolutions."""
    alpha, tau = 2.5, 7.0
    sigma = tau ** (0.5 * (2 * alpha - 2.0))
    g = torch.Generator().manual_seed(0)
    for S in (32, 64):
        u = syn.gaussian_rf_2d(S, 256, alpha, tau, generator=g,
                               device="cpu", dtype=torch.float64).numpy()
        power = (np.abs(np.fft.fft2(u, axes=(1, 2))) ** 2).mean(0)
        k = np.fft.fftfreq(S, d=1.0 / S)
        k2 = k[:, None] ** 2 + k[None, :] ** 2
        expect = (S ** 2 * np.sqrt(2.0) * sigma
                  * (4 * np.pi ** 2 * k2 + tau ** 2) ** (-alpha / 2)) ** 2 / 2
        expect[0, 0] = 0.0
        band = np.abs(np.sqrt(k2) - 2.0) < 0.5
        assert 0.8 < power[band].mean() / expect[band].mean() < 1.25, S


@pytest.mark.parametrize("forced,scale", [(True, 1.0), (False, 2 * np.pi)])
def test_ns_rollout_matches_jax(forced, scale):
    rng = np.random.default_rng(4)
    w0 = rng.normal(size=(2, 16, 16))
    y = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    forcing = np.broadcast_to(-4 * np.cos(4 * y), (16, 16)) if forced \
        else None
    ref = jsyn.ns_vorticity_rollout(
        jnp.asarray(w0), None if forcing is None else jnp.asarray(forcing),
        1 / 40, 1e-2, n_steps=6, record_every=2, deriv_scale=scale)
    ours = syn.ns_vorticity_rollout(
        t64(w0), None if forcing is None else t64(forcing), 1 / 40, 1e-2,
        n_steps=6, record_every=2, deriv_scale=scale)
    assert ours.shape == ref.shape == (2, 16, 16, 3)
    assert rel(ours, ref) < 1e-11
    np.testing.assert_allclose(
        pl.get_forcing(16, "cpu", torch.float64)[0, :, :, 0].numpy(),
        np.broadcast_to(-4 * np.cos(4 * y), (16, 16)), atol=1e-12)


def test_kolmogorov_data_shape_and_first_frame():
    g = torch.Generator().manual_seed(0)
    traj = syn.generate_kolmogorov_data(3, 16, 5, generator=g, device="cpu",
                                        substeps=4)
    assert traj.shape == (3, 16, 16, 5) and torch.isfinite(traj).all()
    g2 = torch.Generator().manual_seed(0)
    w0 = syn.gaussian_rf_2d(16, 3, generator=g2, device="cpu")
    assert torch.equal(traj[..., 0], w0)


# -- data/pino_datasets.py ---------------------------------------------------

@pytest.mark.parametrize("t_duration,with_re", [(1.0, True), (0.5, False),
                                                (0.0, True)])
def test_kf_dataset_from_file_matches_jax(tmp_path, t_duration, with_re):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "kf_Re250.npy")
    np.save(path, rng.normal(size=(3, 9, 16, 16)).astype(np.float32))
    kw = dict(n_samples=2, offset=1, t_duration=t_duration, with_re=with_re)
    args = ([path], (8, 8, 5), (8, 8, 5), (16, 16, 9))
    ours, ref = ds.KFDataset.from_file(*args, **kw), \
        jds.KFDataset.from_file(*args, **kw)
    np.testing.assert_array_equal(ours.u, ref.u)
    np.testing.assert_array_equal(ours.a, ref.a)
    if with_re:
        np.testing.assert_array_equal(ours.re, ref.re)
        assert ours.re[0] == 250.0
    else:
        assert ours.re is None and ref.re is None
    u, a = ours.arrays(torch.float64, "cpu")[:2]
    assert u.dtype == torch.float64 and tuple(a.shape) == ours.a.shape
    for g_ours, g_ref in zip(ds.get_grid3d(4, 3, 2.0),
                             jds.get_grid3d(4, 3, 2.0)):
        np.testing.assert_array_equal(g_ours, g_ref)


def test_multi_reynolds_npz_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    path = str(tmp_path / "multi_reynolds.npz")
    np.savez(path, data1=rng.normal(size=(2, 5, 8, 8)),
             data2=np.array([100.0, 200.0]))
    args = ([path], (8, 8, 5), (8, 8, 5), (8, 8, 5))
    ours = ds.MultipleReynoldsKFaDataset.from_file(*args)
    ref = jds.MultipleReynoldsKFaDataset.from_file(*args)
    for k in ("u", "a", "re"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))


def test_kf_generate_and_mat_loaders(tmp_path):
    from scipy.io import savemat
    kf = ds.KFDataset.generate(3, 8, 3, re=40.0, device="cpu",
                               save_path=str(tmp_path / "kf.npy"))
    u, a, re = kf.arrays(device="cpu")
    assert u.shape == (3, 8, 8, 3) and a.shape == (3, 8, 8, 3, 4)
    assert torch.equal(a[..., 0, 3], u[..., 0]) and float(re[0]) == 40.0
    rng = np.random.default_rng(7)
    mat = str(tmp_path / "b.mat")
    savemat(mat, {"input": rng.normal(size=(4, 16)),
                  "output": rng.normal(size=(4, 6, 16)),
                  "coeff": rng.normal(size=(4, 8, 8)),
                  "sol": rng.normal(size=(4, 8, 8))})
    for ours, ref in ((ds.BurgersDataset.from_mat(mat, sub=2, n=3),
                       jds.BurgersDataset.from_mat(mat, sub=2, n=3)),
                      (ds.DarcyDataset.from_mat(mat, sub=2),
                       jds.DarcyDataset.from_mat(mat, sub=2))):
        for x, y in zip(ours.arrays(device="cpu"), ref.arrays()):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# -- training/pino_train.py --------------------------------------------------

def kf_arrays(n=2, S=8, T=5, seed=8):
    """(u, a, re) numpy float64: a draws of u with a's w0 channel its first
    frame, as KFDataset builds it."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, S, S, T))
    gx, gy, gt = ds.get_grid3d(S, T)
    grid = np.concatenate([gx[0], gy[0], gt[0]], -1)
    a = np.concatenate([np.broadcast_to(grid, (n, S, S, T, 3)),
                        np.broadcast_to(u[..., :1, None], (n, S, S, T, 1))],
                       -1)
    return u, a, np.array([40.0, 100.0, 60.0, 80.0][:n])


def carried_pino(params_seed=0, S=8, T=5, **over):
    """A flax PINObserver2d tree (float64) and the port's model with it."""
    cfg = {**SMALL, **over}
    jm = jmodels.PINObserver2d(**cfg)
    tree = jax.jit(jm.init)(jax.random.PRNGKey(params_seed),
                            jnp.zeros((1, S, S, T, 4)),
                            jnp.ones((1,)))["params"]
    tree = jax.tree.map(lambda x: np.asarray(x, np.float64), tree)
    m = PINObserver2d(**cfg, device="cpu", dtype=torch.float64)
    load_jax_params(m, tree)
    return jm, tree, m


def port_params(m, like):
    """The port's parameters as a flax tree shaped like `like` (a Dense
    weight transposed back to its kernel)."""
    owners, params = dict(m.named_modules()), dict(m.named_parameters())
    out = []
    for name in jax_leaf_order(m):
        p = params[name].detach().numpy()
        linear = isinstance(owners.get(name.rpartition(".")[0]),
                            torch.nn.Linear)
        out.append(p.T if linear and name.endswith("weight") else p)
    return jax.tree.unflatten(jax.tree.structure(like), out)


def tree_rel(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return rel(np.concatenate([np.ravel(x) for x in la]),
               np.concatenate([np.ravel(x) for x in lb]))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_ns_iteration_matches_jax(accum):
    """One iteration from carried parameters on the whole set (so that
    either package's index draw gives the same batch): the loss parts and
    the updated parameters, float64; accumulation of 2 micro-batches in
    the port against JAX's as well."""
    u, a, re = kf_arrays()
    jm, tree, m = carried_pino()
    kw = dict(iterations=1, batch_size=2, accum_steps=accum, verbose=False,
              learning_rate=1e-2, milestones=[1], log_interval=1)
    jparams, jh = jpt.train_ns(jm, tuple(jnp.asarray(x) for x in (u, a, re)),
                               params=jax.tree.map(jnp.asarray, tree), **kw)
    h = pt.train_ns(m, (t64(u), t64(a), t64(re)), **kw)
    for k in ("total", "data", "ic", "f"):
        assert rel(h[k], jh[k]) < 1e-9, k
    assert tree_rel(port_params(m, jparams), jparams) < 1e-9


def test_train_ns_tracks_jax_through_the_schedule(tmp_path):
    """110 float32 iterations from carried parameters on JAX-generated
    Kolmogorov flow, the config's milestones, remat, the whole set as the
    batch: the two loss histories agree to 1e-4 (read:
    the same four decimals at 32x32x17 over 300 iterations); both settle
    with the residual term at ~1, a near-constant field."""
    ds_j = jds.KFDataset.generate(jax.random.PRNGKey(0), 4, 12, 9, re=400.0,
                                  save_path=str(tmp_path / "kf.npy"))
    u, a, re = ds_j.u, ds_j.a, ds_j.re.astype(np.float32)
    cfg = dict(modes1=(4,) * 3, modes2=(4,) * 3, modes3=(3,) * 3,
               layers=(8,) * 4, fc_dim=16, remat=True)
    jm = jmodels.PINObserver2d(**cfg)
    tree = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.asarray(a[:1]), jnp.asarray(re[:1]))
        ["params"])
    kw = dict(iterations=110, batch_size=4, learning_rate=1e-3,
              milestones=[25, 50, 75, 100], gamma=0.5, log_interval=110,
              verbose=False)
    _, jh = jpt.train_ns(jm, tuple(jnp.asarray(x) for x in (u, a, re)),
                         params=jax.tree.map(jnp.array, tree), **kw)
    m = load_jax_params(PINObserver2d(**cfg, device="cpu"), tree)
    h = pt.train_ns(m, tuple(torch.tensor(x) for x in (u, a, re)), **kw)
    for k in ("total", "data", "ic", "f"):
        assert rel(h[k], jh[k]) < 1e-4, k


def test_accumulation_equals_the_full_batch():
    u, a, re = (t64(x) for x in kf_arrays(n=4))
    hist = []
    for accum in (1, 2, 4):
        m = carried_pino()[2]
        hist.append((pt.train_ns(m, (u, a, re), iterations=2, batch_size=4,
                                 accum_steps=accum, verbose=False),
                     torch.cat([p.detach().reshape(-1)
                                for p in m.parameters()])))
    for h, p in hist[1:]:
        for k in ("total", "data", "ic", "f"):
            assert rel(h[k], hist[0][0][k]) < 1e-12, k
        assert rel(p, hist[1 - 1][1]) < 1e-12
    with pytest.raises(ValueError):
        pt.train_ns(m, (u, a, re), iterations=1, batch_size=4,
                    accum_steps=3, verbose=False)


@pytest.mark.parametrize("start", [0, 3, 7])
def test_schedule_matches_optax_per_iteration(start):
    """The rate of each iteration, milestones included (optax applies one
    from the count equal to it on), and from a resumed count."""
    milestones, gamma, base = [2, 5, 8], 0.5, 2.5e-3
    sched = jopt.multistep_lr(base, milestones, gamma)
    m = torch.nn.Linear(2, 2)
    opt, sch = pt.make_optimizer(m, base, milestones, gamma,
                                 start_iter=start)
    for count in range(start, start + 8):
        assert opt.param_groups[0]["lr"] == pytest.approx(
            float(sched(count)), rel=1e-7), count
        opt.step()
        sch.step()


def test_bf16_iteration_matches_jax():
    """compute_dtype bf16: the parameters and inputs rounded to bf16 in the
    forward, the FFTs in float32, the residual on the float32 output.
    Rounding points differ between XLA and torch (bf16 has 8 bits), so
    the loss parts are held at 2e-2 and the updated parameters at 2e-2."""
    u, a, re = kf_arrays()
    jm, tree, m = carried_pino()
    tree32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tree)
    m = m.float()
    kw = dict(iterations=1, batch_size=2, verbose=False, log_interval=1,
              learning_rate=1e-3)
    jparams, jh = jpt.train_ns(
        jm, tuple(jnp.asarray(x, jnp.float32) for x in (u, a, re)),
        params=tree32, compute_dtype=jnp.bfloat16, **kw)
    h = pt.train_ns(m, tuple(torch.tensor(x, dtype=torch.float32)
                             for x in (u, a, re)), compute_dtype="bf16",
                    **kw)
    for k in ("total", "data", "ic", "f"):
        assert rel(h[k], jh[k]) < 2e-2, k
    assert tree_rel(port_params(m, jparams), jparams) < 2e-2
    assert all(p.dtype == torch.float32 for p in m.parameters())


def test_bf16_with_remat_runs_and_matches_no_remat():
    """The casts hold through the trunk's recomputation in the backward."""
    u, a, re = (torch.tensor(x, dtype=torch.float32) for x in kf_arrays())
    grads = []
    for remat in (False, True):
        m = PINObserver2d(**SMALL, remat=remat, device="cpu",
                          generator=torch.Generator().manual_seed(0))
        forcing = pl.get_forcing(8, device="cpu")
        with pt.cast_parameters(m, torch.bfloat16):
            pt.ns_losses(m, a, u, re, forcing,
                         compute_dtype=torch.bfloat16)[0].backward()
        grads.append(torch.cat([p.grad.reshape(-1) for p in m.parameters()]))
    assert rel(grads[1], grads[0]) < 1e-6


def test_eval_ns_matches_jax():
    u, a, re = kf_arrays(n=3)
    jm, tree, m = carried_pino()
    ref = jpt.eval_ns(jm, jax.tree.map(jnp.asarray, tree),
                      tuple(jnp.asarray(x) for x in (u, a, re)),
                      batch_size=2)
    ours = pt.eval_ns(m, (t64(u), t64(a), t64(re)), batch_size=2)
    assert abs(ours / ref - 1) < 1e-10


def test_progressive_train_is_train_ns_per_stage():
    u, a, re = kf_arrays()
    jm, tree, m = carried_pino()
    data = [tuple(jnp.asarray(x) for x in (u, a, re))] * 2
    jparams, jh = jpt.progressive_train(
        jm, data, iters_per_stage=1, batch_size=2, verbose=False,
        params=jax.tree.map(jnp.asarray, tree), log_interval=1)
    h = pt.progressive_train(m, [(t64(u), t64(a), t64(re))] * 2,
                             iters_per_stage=1, batch_size=2, verbose=False,
                             log_interval=1)
    assert len(h) == 2
    for ours, ref in zip(h, jh):
        assert rel(ours["total"], ref["total"]) < 1e-9
    assert tree_rel(port_params(m, jparams), jparams) < 1e-9


def test_mixed_train_one_pair_runs():
    """Its equation step draws random fields the JAX function draws from
    its own keys: held for a finite, falling data loss."""
    u, a, re = (t64(x) for x in kf_arrays(n=2, S=16))
    m = PINObserver2d(**SMALL, device="cpu", dtype=torch.float64,
                      generator=torch.Generator().manual_seed(0))
    h = pt.mixed_train(m, (u, a, re), iterations=3, batch_size=2,
                       eq_batch_size=2, log_interval=1, verbose=False)
    assert np.isfinite(h["data"]).all() and np.isfinite(h["eq"]).all()
    assert len(h["data"]) == 3


def fno_pair(in_channels=1):
    cfg = dict(n_modes=(3, 3), hidden_channels=8, in_channels=in_channels,
               out_channels=1, n_layers=2, lifting_channels=8,
               projection_channels=8)
    jm = jmodels.FNO(**cfg)
    return jm, FNO(**cfg, device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("which", ["burgers", "darcy"])
def test_2d_trainers_one_step_match_jax(which):
    rng = np.random.default_rng(9)
    jm, m = fno_pair()
    if which == "burgers":
        data = (rng.normal(size=(3, 8)), rng.normal(size=(3, 6, 8)))
        x0 = jnp.zeros((1, 6, 8, 1))
        jfn, fn = jpt.train_2d_burger, pt.train_2d_burger
    else:
        data = (1 + rng.random((3, 12, 12)), rng.normal(size=(3, 12, 12)))
        x0 = jnp.zeros((1, 12, 12, 1))
        jfn, fn = jpt.train_2d_operator, pt.train_2d_operator
    tree = jax.tree.map(lambda x: np.asarray(x, np.float64),
                        jax.jit(jm.init)(jax.random.PRNGKey(0), x0)["params"])
    load_jax_params(m, tree)
    kw = dict(iterations=1, batch_size=3, verbose=False, log_interval=1)
    jparams, jh = jfn(jm, tuple(jnp.asarray(x) for x in data),
                      params=jax.tree.map(jnp.asarray, tree), **kw)
    h = fn(m, tuple(t64(x) for x in data), **kw)
    assert rel(h["total"], jh["total"]) < 1e-9
    after = load_jax_params(fno_pair()[1], jax.tree.map(np.asarray, jparams))
    for (n1, p1), (_, p2) in zip(m.named_parameters(),
                                 after.named_parameters()):
        assert rel(p1.detach(), p2.detach()) < 1e-8, n1


# -- the resume blob and the entry ------------------------------------------

def tiny_config(tmp_path, **train):
    return {
        "seed": 0, "ckpt_dir": str(tmp_path), "ckpt_name": "tiny.msgpack",
        "data": {"paths": [str(tmp_path / "kf.npy")], "Re": 40,
                 "raw_res": [16, 16, 3], "data_res": [16, 16, 3],
                 "pde_res": [16, 16, 3], "n_samples": 2, "n_test": 2,
                 "test_offset": 4, "t_duration": 1.0},
        "model": {"layers": [8, 8, 8], "modes1": [4, 4], "modes2": [4, 4],
                  "modes3": [2, 2], "fc_dim": 16, "in_dim": 4,
                  "out_dim": 1, "act": "gelu"},
        "train": {"batchsize": 2, "accum_steps": 1, "base_lr": 1e-3,
                  "milestones": [1, 2], "scheduler_gamma": 0.5,
                  "xy_loss": 5.0, "ic_loss": 1.0, "f_loss": 1.0,
                  "log_interval": 1, **train},
    }


def run_jax_entry(cfg_path, monkeypatch, *extra):
    monkeypatch.setattr(sys, "argv", ["train_pino.py", "--config",
                                      str(cfg_path), *extra])
    runpy.run_path(os.path.join(ROOT, "train_pino.py"), run_name="__main__")


def eval_line(out, tag="eval rel-L2:"):
    return float(out.split(tag)[-1].split()[0])


def test_jax_resume_blob_continues_in_the_port(tmp_path, capsys,
                                               monkeypatch):
    """The JAX entry script writes its blob (save_interval 1) after 2 of 3
    iterations; the port resumes it (parameters, Adam's moments and
    count, the schedule's count) and runs the third, as the JAX entry
    does from the same blob.  float32 (the JAX entry's dtype), the whole
    set as the batch: the held-out rel-L2 at 1e-4."""
    cfg = tiny_config(tmp_path, iterations=2, save_interval=1)
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    run_jax_entry(path, monkeypatch)
    # a copy: the continuation writes the entry's blob again
    blob_path = str(tmp_path / "after2.resume.npy")
    os.replace(tmp_path / "tiny.msgpack.resume.npy", blob_path)
    blob = np.load(blob_path, allow_pickle=True).item()
    assert blob["done"] == 2
    # the blob's leaves in the port: parameters, moments, counts
    m = train_pino.build_model(cfg["model"], "cpu")
    opt, sch = pt.make_optimizer(m, 1e-3, [1, 2], 0.5)
    assert load_jax_resume(m, blob, opt, sch) == 2
    n = len(jax_leaf_order(m))
    assert len(blob["opt_state"]) == 2 * n + 2
    owners = dict(m.named_modules())
    for name, mu, nu in zip(jax_leaf_order(m), blob["opt_state"][1:n + 1],
                            blob["opt_state"][n + 1:2 * n + 1]):
        st = opt.state[dict(m.named_parameters())[name]]
        assert int(st["step"]) == 2
        dense = isinstance(owners[name.rpartition(".")[0]], torch.nn.Linear) \
            and name.endswith("weight")
        for got, want in ((st["exp_avg"], mu), (st["exp_avg_sq"], nu)):
            got = got.numpy()
            np.testing.assert_array_equal(got.T if dense else got, want)
    assert sch.last_epoch == 2 and opt.param_groups[0]["lr"] == 2.5e-4
    capsys.readouterr()

    cfg["train"]["iterations"] = 3
    path.write_text(yaml.safe_dump(cfg))
    run_jax_entry(path, monkeypatch, "--resume", blob_path)
    ref = capsys.readouterr().out
    hist = train_pino.main(["--config", str(path), "--resume", blob_path,
                            "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resuming from" in out and "iter 3/3" in out
    assert len(hist["total"]) == 1
    assert abs(eval_line(out) / eval_line(ref) - 1) < 1e-4
    jtotal = float(ref.split("iter 3/3: total")[1].split()[0])
    assert abs(hist["total"][0] / jtotal - 1) < 1e-4


def test_port_resume_file_round_trip(tmp_path, capsys):
    """The port's own resume file: 2 iterations, then a third from it,
    equal to 3 at once (float64 is not needed: the same code runs)."""
    cfg = tiny_config(tmp_path, iterations=3, save_interval=2)
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    whole = train_pino.main(["--config", str(path), "--device", "cpu"])
    resume = str(tmp_path / "tiny.resume.pt")
    assert os.path.exists(resume)
    # iterations 2 and 3 saved at 2; resume runs the third alone
    again = train_pino.main(["--config", str(path), "--resume", resume,
                             "--device", "cpu"])
    assert len(again["total"]) == 1
    assert abs(again["total"][0] / whole["total"][2] - 1) < 1e-5
    capsys.readouterr()


def test_train_pino_entry_on_the_finetune_protocol(tmp_path, capsys):
    """The tiny finetune config of the JAX entry's own test through the port's
    entry: the TTA line, the eval line, the checkpoint, the test split's
    own file; then `--test` reads the checkpoint back."""
    cfg = {
        "seed": 0, "ckpt_dir": str(tmp_path),
        "ckpt_name": "finetune-smoke.msgpack",
        "data": {"paths": [str(tmp_path / "kf.npy")], "Re": 40,
                 "raw_res": [16, 16, 3], "data_res": [16, 16, 3],
                 "pde_res": [16, 16, 3], "n_samples": 1, "train_offset": 4,
                 "n_test": 2, "test_offset": 4, "t_duration": 1.0},
        "model": {"layers": [8, 8, 8], "modes1": [4, 4], "modes2": [4, 4],
                  "modes3": [2, 2], "fc_dim": 16, "in_dim": 4,
                  "out_dim": 1, "act": "gelu"},
        "train": {"batchsize": 1, "accum_steps": 1, "iterations": 2,
                  "base_lr": 2.5e-3, "milestones": [1],
                  "scheduler_gamma": 0.5, "xy_loss": 0.0, "ic_loss": 5.0,
                  "f_loss": 1.0, "log_interval": 1},
    }
    path = tmp_path / "finetune.yaml"
    path.write_text(yaml.safe_dump(cfg))
    hist = train_pino.main(["--config", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "finetuned-trajectory rel-L2" in out and "eval rel-L2" in out
    assert np.isfinite(eval_line(out, "finetuned-trajectory rel-L2:"))
    ckpt = tmp_path / "finetune-smoke.pt"
    assert hist["checkpoint"] == str(ckpt) and ckpt.exists()
    off = np.load(str(tmp_path / "kf.npy") + ".off4.npy", mmap_mode="r")
    assert off.shape[0] >= 2
    res = train_pino.main(["--config", str(path), "--test", "--ckpt",
                           str(ckpt), "--device", "cpu"])
    assert "test rel-L2" in capsys.readouterr().out
    assert abs(res["test"] / hist["eval"] - 1) < 1e-6


def test_entries_need_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_pino.main(["--config", os.path.join(
            ROOT, "configs", "pino-observer-pretrain-1s.yaml")])
