"""The port's spherical harmonic transforms, SFNO, DeepONet and the
beta -> k entry against the JAX package, in float64 on the CPU.  Flax
parameters are drawn with numpy on the shapes of flax's tree and carried
by `load_jax_params`.  The transforms are held at 1e-12, the model
forwards at 1e-10 and the gradients (against `jax.grad`) at 1e-9, each
relative to the largest entry of the tensor; the data of the entry
exactly, and one Adam step against optax at 1e-12."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import run_learning_beta_to_k as jbk
from pde_policylearning_tpu.models import deeponet as jdeep
from pde_policylearning_tpu.models import sfno as jsfno
from pde_policylearning_tpu.ops import sht as jsht
from pde_policylearning_torch import run_learning_beta_to_k as tbk
from pde_policylearning_torch.models import DeepONetCartesianProd
from pde_policylearning_torch.models.sfno import SFNO, SphericalConv
from pde_policylearning_torch.ops import sht
from pde_policylearning_torch.utils.transplant import load_jax_params

CPU64 = dict(device="cpu", dtype=torch.float64)
SHT, FWD, GRAD = 1e-12, 1e-10, 1e-9
GRIDS = ["equiangular", "legendre-gauss"]


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-300
    assert np.abs(got - want).max() <= tol * scale, \
        np.abs(got - want).max() / scale


def draw_params(jmodel, rng, *inputs, scale=0.1):
    shapes = jax.eval_shape(
        lambda *a: jmodel.init(jax.random.PRNGKey(0), *a),
        *(jnp.asarray(a) for a in inputs))["params"]
    return jax.tree.map(lambda s: scale * rng.normal(size=s.shape), shapes)


def carried(jmodel, model, rng, *inputs, scale=0.3):
    params = draw_params(jmodel, rng, *inputs, scale=scale)
    load_jax_params(model, params)
    return params


def grads_match(jmodel, model, params, inputs, y):
    """Every parameter's gradient of sum((f - y)^2) against jax.grad,
    carried into a copy of the module by `load_jax_params`."""
    def jloss(p):
        return jnp.sum((jmodel.apply({"params": p},
                                     *(jnp.asarray(a) for a in inputs))
                        - y) ** 2)
    jgrads = jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(params))
    model.zero_grad()
    ((model(*(torch.tensor(a) for a in inputs)) - torch.tensor(y)) ** 2) \
        .sum().backward()
    ref = dict(load_jax_params(copy.deepcopy(model), jgrads)
               .named_parameters())
    for name, p in model.named_parameters():
        close(p.grad, ref[name].detach().numpy(), GRAD)


@pytest.mark.parametrize("grid", GRIDS)
def test_sht_matrices_are_jaxs(grid):
    for args in ((16, 32), (12, 24, 8, 6), (32, 64, 32, 32)):
        for a, b in zip(sht.sht_matrices(*args, grid=grid),
                        jsht.sht_matrices(*args, grid=grid)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("modes", [None, (8, 6)])
def test_rsht_irsht_match_jax(grid, modes):
    """The analysis of a random field and the synthesis of random
    coefficients, and the round trip of a band-limited field (the JAX
    test's), against the JAX transforms."""
    rng = np.random.default_rng(0)
    nlat, nlon = 16, 32
    f = rng.normal(size=(2, nlat, nlon, 3))
    lmax, mmax = modes or (None, None)
    close(sht.rsht(torch.tensor(f), lmax, mmax, grid),
          jsht.rsht(jnp.asarray(f), lmax, mmax, grid), SHT)
    L, M = modes or (nlat, nlat // 2 + 1)
    flm = rng.normal(size=(2, L, M, 3)) + 1j * rng.normal(size=(2, L, M, 3))
    close(sht.irsht(torch.tensor(flm), nlat, nlon, grid),
          jsht.irsht(jnp.asarray(flm), nlat, nlon, grid), SHT)
    band = flm[:, :8, :8].copy()
    for l in range(8):
        band[:, l, l + 1:] = 0
    band[:, :, 0] = band[:, :, 0].real
    back = sht.rsht(sht.irsht(torch.tensor(band), nlat, nlon, grid), 8,
                    band.shape[2], grid)
    close(back, band, 1e-10)


@pytest.mark.parametrize("contraction", ["dhconv", "full"])
@pytest.mark.parametrize("grid", GRIDS)
def test_spherical_conv_matches_flax(contraction, grid):
    """`SphericalConv` on the JAX test's shapes, layers 0 and 1 of two,
    and with lmax clipped to nlat and mmax to nlon // 2 + 1."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, 24, 3))
    for n_modes in ((6, 6), (16, 16)):
        kw = dict(n_modes=n_modes, n_layers=2, contraction=contraction,
                  grid=grid)
        jm = jsfno.SphericalConv(3, 5, **kw)
        m = SphericalConv(3, 5, **kw, **CPU64)
        params = carried(jm, m, rng, x)
        for index in (0, 1):
            with torch.no_grad():
                out = m(torch.tensor(x), index)
            ref = jax.jit(lambda p, a, i=index: jm.apply({"params": p}, a,
                                                          i))(params, x)
            close(out, ref, FWD)


@pytest.mark.parametrize("grid", GRIDS)
def test_sfno_matches_flax(grid):
    """The JAX test's SFNO (2 layers, (6, 6) modes, 12 x 24), forward and
    every parameter's gradient."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, 24, 2))
    y = rng.normal(size=(2, 12, 24, 1))
    kw = dict(n_modes=(6, 6), hidden_channels=8, in_channels=2,
              out_channels=1, n_layers=2, lifting_channels=8,
              projection_channels=8, grid=grid)
    jm, m = jsfno.SFNO(**kw), SFNO(**kw, **CPU64)
    params = carried(jm, m, rng, x)
    assert {"convs.w0.mm2", "convs.w1.mm2", "convs.bias",
            "skip1.conv.weight"} <= {n for n, _ in m.named_parameters()}
    with torch.no_grad():
        close(m(torch.tensor(x)), jax.jit(lambda p, a: jm.apply(
            {"params": p}, a))(params, x), FWD)
    grads_match(jm, m, params, [x], y)


def test_deeponet_matches_flax():
    """Forward and gradients; the scalar `bias` is a 0-d leaf."""
    rng = np.random.default_rng(3)
    u = rng.normal(size=(4, 10))
    coords = rng.normal(size=(25, 2))
    y = rng.normal(size=(4, 25))
    jm = jdeep.DeepONetCartesianProd(branch_layers=(16, 8),
                                     trunk_layers=(16, 12, 8))
    m = DeepONetCartesianProd(10, 2, (16, 8), (16, 12, 8), **CPU64)
    params = carried(jm, m, rng, u, coords)
    assert m.bias.shape == () and float(m.bias.detach()) == params["bias"]
    with torch.no_grad():
        close(m(torch.tensor(u), torch.tensor(coords)),
              jm.apply({"params": params}, u, coords), FWD)
    grads_match(jm, m, params, [u, coords], y)
    with pytest.raises(ValueError, match="latent"):
        DeepONetCartesianProd(10, 2, (16, 8), (16, 4), **CPU64)


def test_backstepping_data_are_jaxs():
    """The numpy data of the entry, in float64, and as float32 the arrays
    the JAX entry trains on; the closed form's limits."""
    for n, grid in ((5, 24), (3, 7)):
        ours = tbk.make_dataset(n, grid, np.random.default_rng(0))
        theirs = jbk.make_dataset(n, grid, np.random.default_rng(0))
        for a, b in zip(ours, theirs):
            assert a.dtype == np.float64
            np.testing.assert_array_equal(a.astype(np.float32),
                                          np.asarray(b))
    k = tbk.backstepping_kernel(1e-6, np.array([[0.5]]), np.array([[0.3]]))
    np.testing.assert_allclose(k, -1e-6 * 0.3 / 2, rtol=1e-4)
    z = np.linspace(0, 20, 50)
    np.testing.assert_array_equal(tbk.bessel_i1_over_z(z),
                                  jbk.bessel_i1_over_z(z))


def test_adam_step_matches_optax():
    """One step of the entry's loop (`train_step`: the MSE on the whole
    set, Adam at 1e-3) against optax's `adam(1e-3)` from the same
    parameters: the loss and every updated parameter."""
    rng = np.random.default_rng(4)
    b, coords, k = tbk.make_dataset(6, 8, rng)
    jm = jdeep.DeepONetCartesianProd(branch_layers=(16, 16, 8),
                                     trunk_layers=(16, 16, 8))
    m = DeepONetCartesianProd(8, 2, (16, 16, 8), (16, 16, 8), **CPU64)
    params = carried(jm, m, rng, b, coords, scale=0.5)
    opt = optax.adam(1e-3)
    state = opt.init(params)

    def jloss(p):
        return jnp.mean((jm.apply({"params": p}, b, coords) - k) ** 2)
    for _ in range(2):
        loss, g = jax.value_and_grad(jloss)(params)
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
    topt = torch.optim.Adam(m.parameters(), lr=1e-3)
    for _ in range(2):
        tloss = tbk.train_step(m, topt, *(torch.tensor(a) for a in
                                          (b, coords, k)))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-12)
    ref = dict(load_jax_params(copy.deepcopy(m), jax.tree.map(
        np.asarray, params)).named_parameters())
    for name, p in m.named_parameters():
        close(p, ref[name].detach().numpy(), 1e-12)


def test_beta_to_k_main_on_the_cpu(capsys):
    """The entry at a few iterations: five prints, finite numbers."""
    model, hist = tbk.main(["--iters", "10", "--n_train", "8", "--n_test",
                            "4", "--n_grid", "6", "--latent", "8"],
                           device="cpu")
    out = capsys.readouterr().out
    assert out.count("test rel-L2") == 5 and len(hist) == 5
    assert [h[0] for h in hist] == [2, 4, 6, 8, 10]
    assert np.isfinite(np.asarray(hist)).all()
    assert isinstance(model, DeepONetCartesianProd)
