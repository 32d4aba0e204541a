"""The PINO and MFN modules of the port against the JAX package's, float64
on the CPU: every module of `models/mfn.py` and `models/pino.py`, forward
and the gradient to the input and to every parameter (against
`jax.grad`), with the T axis padded; the rule for time modes past the
spectrum against the JAX package's truncated-DFT route
(`PDE_SPECTRAL_BACKEND=dft`, its TPU route); and the flax trees of both
full-width flagship models carried leaf by leaf by `load_jax_params`.
The flax parameters are numpy draws on the shapes of `model.init`'s tree,
handed to flax as they are and to the port through `load_jax_params`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.models import mfn as jmfn
from pde_policylearning_tpu.models import pino as jpino
from pde_policylearning_torch.models import mfn, pino
from pde_policylearning_torch.ops import fourier
from pde_policylearning_torch.utils import transplant
from pde_policylearning_torch.utils.transplant import load_jax_params

CPU64 = dict(device="cpu", dtype=torch.float64)
TOL = 1e-9


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den else \
        float(np.linalg.norm(a))


def random_tree(jmodel, inputs, rng, scale=0.3):
    """numpy draws on the shapes of `jmodel.init`'s parameter tree."""
    shapes = jax.eval_shape(
        lambda *a: jmodel.init(jax.random.PRNGKey(0), *a),
        *[jnp.asarray(x) for x in inputs])["params"]
    return jax.tree.map(lambda s: scale * rng.normal(size=s.shape), shapes)


def assert_module_matches(jmodel, model, inputs, rng, scale=0.3,
                          grad_inputs=(0,)):
    """Forward and the gradients of sum(out * w) to `inputs[grad_inputs]`
    and to every parameter, JAX against the port, rel L2 <= TOL each."""
    tree = random_tree(jmodel, inputs, rng, scale)
    load_jax_params(model, tree)
    jtree = jax.tree.map(jnp.asarray, tree)
    jx = [jnp.asarray(x) for x in inputs]
    out_j = jmodel.apply({"params": jtree}, *jx)
    w = rng.normal(size=out_j.shape)

    def loss(p, *xs):
        return jnp.sum(jmodel.apply({"params": p}, *xs) * w)

    grads = jax.grad(loss, argnums=(0, *[1 + i for i in grad_inputs]))(
        jtree, *jx)
    tx = [torch.tensor(x).requires_grad_(i in grad_inputs)
          for i, x in enumerate(inputs)]
    out = model(*tx)
    assert tuple(out.shape) == out_j.shape
    assert rel(out.detach(), out_j) <= TOL
    (out * torch.as_tensor(w)).sum().backward()
    for i, g in zip(grad_inputs, grads[1:]):
        assert rel(tx[i].grad, g) <= TOL, f"input {i}"
    # the JAX gradient tree in the port's layouts, by the same rules
    carried = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    owners = dict(model.named_modules())
    for name, g in transplant._flatten(jax.tree.map(np.asarray,
                                                    grads[0])).items():
        prefix, _, leaf = name.rpartition(".")
        leaf, g = transplant._carry(owners.get(prefix), leaf, g)
        carried[f"{prefix}.{leaf}" if prefix else leaf] = g
    for n, p in model.named_parameters():
        assert rel(p.grad, carried[n]) <= TOL, n
    return out.detach(), grads


def test_mfn_modules_match_jax():
    rng = np.random.default_rng(0)
    for code_shape in ((2, 3), (2,)):
        code = rng.normal(size=code_shape)
        assert_module_matches(
            jmfn.MultiplicativeNet(5),
            mfn.MultiplicativeNet(6, code_shape[-1] if len(code_shape) > 1
                                  else 1, 5, **CPU64),
            [rng.normal(size=(2, 4, 3, 6)), code], rng,
            grad_inputs=(0, 1))
    assert_module_matches(jmfn.MFNFourierLayer(6, 2.0),
                          mfn.MFNFourierLayer(3, 6, 2.0, **CPU64),
                          [rng.normal(size=(2, 5, 3))], rng)
    for out_size in (1, 2):
        assert_module_matches(
            jmfn.FourierNet(6, out_size, n_layers=2, input_scale=8.0),
            mfn.FourierNet(3, 4, 6, out_size, n_layers=2, input_scale=8.0,
                           **CPU64),
            [rng.normal(size=(2, 5, 3)), rng.normal(size=(2, 4))], rng,
            grad_inputs=(0, 1))


def test_kaiming_uniform_draws_the_jax_bounds():
    """The MFN parameters lie in +-1/sqrt(last axis), as
    `_kaiming_uniform` draws them (the bias's bound from its own length)."""
    m = mfn.MultiplicativeNet(9, 4, 16, generator=torch.Generator(
        ).manual_seed(0), **CPU64)
    for p, fan in ((m.A, 4), (m.B, 9), (m.bias, 16)):
        bound, top = fan ** -0.5, float(p.detach().abs().max())
        assert 0.8 * bound < top <= bound


@pytest.mark.parametrize("order", [2, 3])
def test_spectral_conv_nd_matches_jax(order):
    rng = np.random.default_rng(1)
    modes = (3, 2, 2)[:order]
    shape = (2, 8, 6, 4, 3)[:order + 1] + (3,)
    assert_module_matches(jpino.SpectralConvND(3, 5, modes),
                          pino.SpectralConvND(3, 5, modes, **CPU64),
                          [rng.normal(size=shape)], rng)


@pytest.mark.parametrize("act,remat", [("gelu", False), ("gelu", True),
                                       ("tanh", False), ("relu", False),
                                       ("leaky_relu", True),
                                       ("none", False)])
def test_pino_trunk_matches_jax(act, remat):
    rng = np.random.default_rng(2)
    kw = dict(modes1=(3, 2), modes2=(2, 2), modes3=(2, 1), act=act,
              remat=remat)
    assert_module_matches(jpino.PINOTrunk((3, 5, 4), **kw),
                          pino.PINOTrunk((3, 5, 4), **kw, **CPU64),
                          [rng.normal(size=(2, 8, 6, 4, 3))], rng)


@pytest.mark.parametrize("fourier_layer", [False, True])
def test_pino_observer_2d_matches_jax(fourier_layer):
    """T = 4 padded by (1, 2) rows (pad_ratio (0.25, 0.5)), 4 time modes
    of the padded 7."""
    rng = np.random.default_rng(3)
    kw = dict(modes1=(3, 2), modes2=(2, 3), modes3=(4, 2), layers=(6, 6, 5),
              fc_dim=5, in_dim=2, out_dim=2, pad_ratio=(0.25, 0.5),
              use_fourier_layer=fourier_layer)
    assert_module_matches(
        jpino.PINObserver2d(**kw), pino.PINObserver2d(**kw, **CPU64),
        [rng.normal(size=(2, 8, 6, 4, 2)), 1 + rng.random(2)], rng)


@pytest.mark.parametrize("name", ["PINObserverFullField", "PolicyModel2D"])
def test_flagship_models_match_jax(name):
    """The two models of the flagship slice (their `PlanePredHead` with the
    parent's mnet2), T = 4 padded by (0, 1), the Reynolds number scaled
    by max_re."""
    rng = np.random.default_rng(4)
    kw = dict(modes1=(3, 2), modes2=(2, 2), modes3=(2, 3), layers=(6, 5, 6),
              fc_dim=5, in_dim=1, pad_ratio=(0.0, 0.25))
    if name == "PINObserverFullField":
        kw["plane_num"] = 3
    out, _ = assert_module_matches(
        getattr(jpino, name)(**kw), getattr(pino, name)(**kw, **CPU64),
        [rng.normal(size=(2, 8, 6, 4, 1)), 178.19 + rng.random(2)], rng)
    want = (2, 3, 8, 6, 4) if name == "PINObserverFullField" \
        else (2, 8, 6, 4, 1)
    assert tuple(out.shape) == want


def test_zero_init_params_zeroes_in_place():
    rng = np.random.default_rng(5)
    kw = dict(modes1=(2, 2), modes2=(2, 2), modes3=(1, 1), layers=(8, 8, 8),
              fc_dim=8, in_dim=1)
    jmodel, model = jpino.PolicyModel2D(**kw), pino.PolicyModel2D(**kw,
                                                                  **CPU64)
    x = [rng.normal(size=(1, 8, 8, 1, 1)), np.ones(1)]
    tree = jmodel.zero_init_params(random_tree(jmodel, x, rng))
    params = list(model.parameters())
    assert model.zero_init_params() is model
    assert all(float(p.abs().max()) == 0 for p in params)
    assert all(p is q for p, q in zip(params, model.parameters()))
    assert all(not np.asarray(a).any() for a in jax.tree.leaves(tree))
    with torch.no_grad():
        assert not model(*map(torch.tensor, x)).any()


def test_dense_net_and_low_rank_match_jax():
    rng = np.random.default_rng(6)
    for act, out_act in (("relu", None), ("tanh", "gelu")):
        assert_module_matches(
            jpino.DenseNet((3, 7, 5, 2), act, out_act),
            pino.DenseNet((3, 7, 5, 2), act, out_act, **CPU64),
            [rng.normal(size=(2, 6, 3))], rng)
    assert_module_matches(jpino.LowRank2d(4, 3), pino.LowRank2d(4, 3,
                                                                **CPU64),
                          [rng.normal(size=(2, 10, 4)),
                           rng.normal(size=(2, 10, 2))], rng,
                          grad_inputs=(0, 1))


def test_pad_t_and_get_act_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 5, 4))
    for num_pad in ((0, 0), (1, 0), (0, 2), (2, 3)):
        padded = pino._pad_t(torch.tensor(x), num_pad)
        np.testing.assert_array_equal(padded.numpy(),
                                      jpino._pad_t(jnp.asarray(x), num_pad))
        np.testing.assert_array_equal(
            pino._unpad_t(padded, num_pad).numpy(), x)
    for name in ("tanh", "gelu", "relu", "leaky_relu", "none"):
        assert rel(pino.get_act(name)(torch.tensor(x)),
                   jpino.get_act(name)(jnp.asarray(x))) <= 1e-15, name


# ---------------------------------------------------------------------------
# time modes past the spectrum: the truncated-DFT route's rule
# ---------------------------------------------------------------------------

def dropped(tree_or_grads):
    """The entries past the first time mode of every spectral weight leaf
    (mm2 layout (2, m1, m2, m3, in, out))."""
    flat = transplant._flatten(jax.tree.map(np.asarray, tree_or_grads))
    return {k: v[:, :, :, 1:] for k, v in flat.items()
            if k.endswith("mm2")}


@pytest.mark.parametrize("which", ["conv", "observer"])
def test_time_modes_past_the_spectrum_follow_the_dft_route(which,
                                                           monkeypatch):
    """modes3 = 3 on a time axis of length 1 (the full-field observer's
    configs keep 12 there): the JAX package's FFT route refuses it, its
    TPU route (the truncated DFT, selected here on the CPU by
    PDE_SPECTRAL_BACKEND=dft) computes it; the port matches that route's
    forward and gradients, and both give the time modes past the first an
    exactly zero gradient."""
    rng = np.random.default_rng(8)
    if which == "conv":
        jmodel = jpino.SpectralConvND(3, 4, (2, 2, 3))
        model = pino.SpectralConvND(3, 4, (2, 2, 3), **CPU64)
        inputs = [rng.normal(size=(2, 8, 6, 1, 3))]
    else:
        kw = dict(plane_num=2, modes1=(2, 2), modes2=(2, 2), modes3=(3, 3),
                  layers=(6, 6, 6), fc_dim=5, in_dim=1,
                  pad_ratio=(0.0, 0.0625))
        jmodel = jpino.PINObserverFullField(**kw)
        model = pino.PINObserverFullField(**kw, **CPU64)
        inputs = [rng.normal(size=(2, 8, 6, 1, 1)), 178.19 + np.zeros(2)]
    monkeypatch.setenv("PDE_SPECTRAL_BACKEND", "dft")
    tree = random_tree(jmodel, inputs, rng)
    monkeypatch.setenv("PDE_SPECTRAL_BACKEND", "xla")
    with pytest.raises(ValueError, match="exceeds the available spectrum"):
        jmodel.apply({"params": jax.tree.map(jnp.asarray, tree)},
                     *map(jnp.asarray, inputs))
    with pytest.raises(ValueError, match="exceeds the available spectrum"):
        fourier.spectral_conv_nd(
            torch.zeros(1, 8, 6, 1, 3, dtype=torch.float64),
            [{"mm2": torch.zeros(2, 2, 2, 3, 3, 4, dtype=torch.float64)}] * 4,
            (2, 2, 3))
    monkeypatch.setenv("PDE_SPECTRAL_BACKEND", "dft")
    _, grads = assert_module_matches(jmodel, model, inputs, rng)
    for k, g in dropped(grads[0]).items():
        assert not g.any(), k
    torch_grads = {n: p.grad.numpy()[:, :, :, 1:]
                   for n, p in model.named_parameters() if n.endswith("mm2")}
    assert torch_grads and not any(g.any() for g in torch_grads.values())


def test_dft_rule_is_spectral_conv_nd_within_the_spectrum():
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.normal(size=(2, 8, 6, 4, 3)))
    ws = [{"mm2": torch.tensor(rng.normal(size=(2, 3, 2, 3, 3, 4)))}
          for _ in range(4)]
    assert torch.equal(fourier.spectral_conv_nd_dft_rule(x, ws, (3, 2, 3)),
                       fourier.spectral_conv_nd(x, ws, (3, 2, 3)))
    # past it the weights are cut to the budget, 4 // 2 + 1 = 3
    np.testing.assert_array_equal(
        fourier.spectral_conv_nd_dft_rule(
            x, [{"mm2": torch.cat([w["mm2"], w["mm2"]], 3)} for w in ws],
            (3, 2, 6)).numpy(),
        fourier.spectral_conv_nd(x, ws, (3, 2, 3)).numpy())


# ---------------------------------------------------------------------------
# the full-width trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["PINObserverFullField", "PolicyModel2D"])
def test_load_jax_params_carries_the_full_width_trees(name, monkeypatch):
    """Every leaf of the flax tree of the full-width model
    (`configs/fullfield_pi.yaml`: modes 12^3 x 4, layers 64 x 5, fc_dim
    128; 906 MB of spectral weights) names a parameter of the port's
    model, by `load_jax_params`'s rules, in its shape, and every parameter
    is named: checked on shapes alone (the port's model on the meta
    device, the flax tree by `jax.eval_shape`, through the truncated-DFT
    route, which takes 12 time modes on T = 1)."""
    monkeypatch.setenv("PDE_SPECTRAL_BACKEND", "dft")
    kw = dict(modes1=(12,) * 4, modes2=(12,) * 4, modes3=(12,) * 4,
              layers=(64,) * 5, fc_dim=128, in_dim=1,
              pad_ratio=(0.0, 0.0625))
    if name == "PINObserverFullField":
        kw["plane_num"] = 3
    shapes = jax.eval_shape(
        lambda x, r: getattr(jpino, name)(**kw).init(
            jax.random.PRNGKey(0), x, r),
        jnp.zeros((1, 32, 32, 1, 1)), jnp.ones((1,)))["params"]
    model = getattr(pino, name)(**kw, device="meta")
    own = {n: tuple(p.shape) for n, p in model.named_parameters()}
    owners = dict(model.named_modules())
    carried = {}
    for key, s in transplant._flatten(shapes).items():
        prefix, _, leaf = key.rpartition(".")
        leaf, v = transplant._carry(owners.get(prefix), leaf,
                                    np.broadcast_to(np.float32(0), s.shape))
        carried[f"{prefix}.{leaf}"] = v.shape
    assert carried == own
    spectral = sum(np.prod(s) for n, s in own.items() if n.endswith("mm2"))
    assert spectral == 4 * 4 * 2 * 64 * 64 * 12 ** 3     # 226M floats
