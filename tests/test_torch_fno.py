"""The port's model layers, `SpectralConv`, `FNO` and `FNO2dObserver`
against the flax modules, in float64 on the CPU.  Each flax module is
initialised with `model.init`, its parameter tree is turned to numpy (every
leaf perturbed from a seeded numpy generator, so zero-initialised biases
count too), handed back to flax and loaded into the port's module with
`load_jax_params`; the inputs are numpy arrays from the same generator."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.models import fno as jfno
from pde_policylearning_tpu.models import layers as jlayers
from pde_policylearning_tpu.models.observers import \
    FNO2dObserver as JFNO2dObserver
from pde_policylearning_tpu.models.spectral_layers import \
    SpectralConv as JSpectralConv
from pde_policylearning_torch.models import (FNO, FNO1d, FNO3d, TFNO2d,
                                             FNO2dObserver, SpectralConv,
                                             layers, make_grid)
from pde_policylearning_torch.utils.transplant import load_jax_params

CPU64 = dict(device="cpu", dtype=torch.float64)


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def init_tree(jmodel, rng, *inputs, **kw):
    """flax init -> numpy parameter tree with every leaf perturbed."""
    variables = jmodel.init(jax.random.PRNGKey(0),
                            *(jnp.asarray(a) for a in inputs), **kw)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float64) + 0.1 * rng.normal(size=a.shape),
        jax.tree.map(np.asarray, variables.get("params", {})))


def japply(jmodel, tree, *inputs, **kw):
    return np.asarray(jmodel.apply(
        {"params": jax.tree.map(jnp.asarray, tree)},
        *(jnp.asarray(a) for a in inputs), **kw))


def assert_matches(jmodel, model, inputs, rng, tol=1e-10, kw=None, tkw=None):
    tree = init_tree(jmodel, rng, *inputs, **(kw or {}))
    load_jax_params(model, tree)
    ref = japply(jmodel, tree, *inputs, **(kw or {}))
    with torch.no_grad():
        out = model(*(t64(a) for a in inputs), **(tkw or kw or {}))
    assert out.dtype == torch.float64 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)
    return tree


def test_gelu_is_the_tanh_approximation():
    """flax's default gelu is the tanh form; torch's default is not."""
    x = np.linspace(-4, 4, 101)
    ref = np.asarray(fnn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(layers.gelu(t64(x)).numpy(), ref, rtol=1e-12,
                               atol=1e-14)
    exact = torch.nn.functional.gelu(t64(x)).numpy()
    assert np.abs(exact - ref).max() > 1e-4


@pytest.mark.parametrize("name", [
    "lifting", "projection", "projection_hidden", "mlp", "mlp3",
    "soft_gating", "soft_gating_bias", "skip_linear", "skip_identity",
    "skip_soft", "group_norm"])
def test_layers_match_flax(name):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 5, 4))
    jmodel, model = {
        "lifting": lambda: (jlayers.Lifting(7), layers.Lifting(4, 7, **CPU64)),
        "projection": lambda: (jlayers.Projection(2),
                               layers.Projection(4, 2, **CPU64)),
        "projection_hidden": lambda: (jlayers.Projection(2, 9),
                                      layers.Projection(4, 2, 9, **CPU64)),
        "mlp": lambda: (jlayers.ChannelMLP(5, 3),
                        layers.ChannelMLP(4, 5, 3, **CPU64)),
        "mlp3": lambda: (jlayers.ChannelMLP(n_layers=3),
                         layers.ChannelMLP(4, n_layers=3, **CPU64)),
        "soft_gating": lambda: (jlayers.SoftGating(4),
                                layers.SoftGating(4, **CPU64)),
        "soft_gating_bias": lambda: (jlayers.SoftGating(4, True),
                                     layers.SoftGating(4, True, **CPU64)),
        "skip_linear": lambda: (jlayers.SkipConnection(6, "linear"),
                                layers.SkipConnection(4, 6, "linear",
                                                      **CPU64)),
        "skip_identity": lambda: (jlayers.SkipConnection(4, "identity"),
                                  layers.SkipConnection(4, 4, "identity")),
        "skip_soft": lambda: (jlayers.SkipConnection(4),
                              layers.SkipConnection(4, 4, **CPU64)),
        "group_norm": lambda: (jlayers.GroupNorm(4),
                               layers.GroupNorm(4, **CPU64)),
    }[name]()
    assert_matches(jmodel, model, [x], rng)


def test_norm_functions_match_jax():
    """Population variance (jnp.var), not torch's unbiased default."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 4, 3))
    np.testing.assert_allclose(
        layers.instance_norm(t64(x)).numpy(),
        np.asarray(jlayers.instance_norm(jnp.asarray(x))), rtol=1e-12,
        atol=1e-12)
    emb = rng.normal(size=(6,))
    assert_matches(jlayers.AdaIN(3, mlp_hidden=8),
                   layers.AdaIN(6, 3, mlp_hidden=8, **CPU64), [x, emb], rng)
    with pytest.raises(ValueError, match="skip type"):
        layers.SkipConnection(3, 3, "conv")


CONV_CASES = {
    "dense_2layers": dict(n_layers=2),
    "joint_dense": dict(n_layers=2, joint_factorization=True),
    "tucker": dict(factorization="tucker", implementation="factorized"),
    "joint_tucker": dict(n_layers=2, joint_factorization=True,
                         factorization="tucker"),
    "joint_cp": dict(n_layers=2, joint_factorization=True,
                     factorization="cp", implementation="factorized"),
    "joint_tt": dict(n_layers=2, joint_factorization=True,
                     factorization="tt"),
    "separable": dict(separable=True, factorization="cp"),
    "incremental": dict(incremental_n_modes=(4, 4)),
    "scaled": dict(n_layers=2, output_scaling_factor=[[2.0, 1.5],
                                                      [0.5, 0.5]]),
    "no_bias_ortho": dict(use_bias=False, fft_norm="ortho"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_spectral_conv_matches_flax(case):
    rng = np.random.default_rng(2)
    kw = CONV_CASES[case]
    cin, cout = (4, 4) if kw.get("separable") else (3, 4)
    x = rng.normal(size=(2, 12, 10, cin))
    index = kw.get("n_layers", 1) - 1
    jmodel = JSpectralConv(cin, cout, (8, 6), **kw)
    model = SpectralConv(cin, cout, (8, 6), **kw, **CPU64)
    assert_matches(jmodel, model, [x], rng, kw=dict(index=index))


def test_spectral_conv_1d_and_call_time_modes():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 3))
    assert_matches(JSpectralConv(3, 5, 8), SpectralConv(3, 5, 8, **CPU64),
                   [x], rng, kw=dict(half_modes=(3,)))
    with pytest.raises(ValueError, match="separable requires"):
        SpectralConv(3, 4, (4, 4), separable=True, **CPU64)


FNO_CASES = {
    "default": dict(),
    "mlp": dict(use_mlp=True),
    "mlp_preactivation": dict(use_mlp=True, preactivation=True),
    "preactivation": dict(preactivation=True),
    "group_norm": dict(norm="group_norm", use_mlp=True),
    "instance_norm": dict(norm="instance_norm"),
    "quirk": dict(reference_act_quirk=True, n_layers=3),
    "quirk_mlp": dict(reference_act_quirk=True, use_mlp=True),
    "soft_skips": dict(fno_skip="soft-gating", mlp_skip="linear",
                       use_mlp=True),
    "identity_skip": dict(fno_skip="identity"),
    "scaled": dict(output_scaling_factor=[2.0, 1.0, 0.5, 1.0]),
    "scaled_scalar": dict(output_scaling_factor=1.5, n_layers=1),
    "padded": dict(domain_padding=0.25),
    "padded_symmetric": dict(domain_padding=0.25,
                             domain_padding_mode="symmetric"),
    "joint_tucker": dict(factorization="tucker", joint_factorization=True,
                         rank=0.5),
    "backward_norm": dict(fft_norm="backward", implementation="reconstructed",
                          factorization="cp", rank=0.3),
}


@pytest.mark.parametrize("case", sorted(FNO_CASES))
def test_fno_matches_flax(case):
    """2-D FNO at a small size (modes 6, width 8, 12x12) over the block
    options; float64 1e-9 (a few layers of 1e-10 ops)."""
    rng = np.random.default_rng(4)
    kw = {"n_layers": 2, "projection_channels": 16, **FNO_CASES[case]}
    x = rng.normal(size=(2, 12, 12, 3))
    assert_matches(jfno.FNO((6, 6), 8, **kw), FNO((6, 6), 8, **kw, **CPU64),
                   [x], rng, tol=1e-9)


def test_fno_ada_in_matches_flax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 12, 12, 3))
    emb = rng.normal(size=(5,))
    kw = dict(n_layers=2, projection_channels=16, norm="ada_in")
    jmodel = jfno.FNO((6, 6), 8, **kw)
    model = FNO((6, 6), 8, ada_in_features=5, **kw, **CPU64)
    tree = init_tree(jmodel, rng, x, ada_embedding=jnp.asarray(emb))
    load_jax_params(model, tree)
    ref = japply(jmodel, tree, x, ada_embedding=jnp.asarray(emb))
    with torch.no_grad():
        out = model(t64(x), ada_embedding=t64(emb))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-9, atol=1e-9)
    with pytest.raises(ValueError, match="Got norm=batch"):
        FNO((6, 6), 8, norm="batch", **CPU64)


@pytest.mark.parametrize("dim", ["1d", "3d", "tfno2d"])
def test_fno_other_ranks_match_flax(dim):
    rng = np.random.default_rng(6)
    kw = dict(n_layers=2, projection_channels=16)
    if dim == "1d":
        x = rng.normal(size=(2, 16, 3))
        pair = jfno.FNO1d(6, 8, **kw), FNO1d(6, 8, **kw, **CPU64)
    elif dim == "3d":
        x = rng.normal(size=(1, 8, 6, 8, 3))
        pair = (jfno.FNO3d(4, 4, 4, 6, **kw),
                FNO3d(4, 4, 4, 6, **kw, **CPU64))
    else:
        x = rng.normal(size=(2, 12, 12, 3))
        pair = (jfno.TFNO2d(6, 6, 8, rank=0.4, **kw),
                TFNO2d(6, 6, 8, rank=0.4, **kw, **CPU64))
        assert "core" in dict(pair[1].fno_blocks.convs.w0.items())
    assert_matches(*pair, [x], rng, tol=1e-9)


@pytest.mark.parametrize("modes,width,size,use_v", [
    (6, 8, 16, False), (6, 8, 16, True), (12, 32, 32, False)])
def test_fno2d_observer_matches_flax(modes, width, size, use_v):
    """The observer at a small size and once at the full published width
    (modes 12, width 32, the 32x32 wall plane); float64 1e-8."""
    rng = np.random.default_rng(7)
    inputs = [rng.normal(size=(2, size, size))
              for _ in range(2 if use_v else 1)]
    jmodel = JFNO2dObserver(modes, modes, width, use_v_plane=use_v)
    model = FNO2dObserver(modes, modes, width, use_v_plane=use_v, **CPU64)
    tree = assert_matches(jmodel, model, inputs, rng, tol=1e-8)
    if not use_v:
        # (B, H, W, 1) planes are taken as they are
        with torch.no_grad():
            out4 = model(t64(inputs[0])[..., None])
        np.testing.assert_allclose(out4.numpy(),
                                   japply(jmodel, tree, inputs[0]),
                                   rtol=1e-8, atol=1e-8)


def test_make_grid_matches_jax():
    from pde_policylearning_tpu.models.observers import make_grid as jgrid
    np.testing.assert_allclose(
        make_grid((2, 5, 7), torch.float64, "cpu").numpy(),
        np.asarray(jgrid((2, 5, 7))), rtol=1e-15, atol=1e-15)


def test_observer_routes_agree_in_float32():
    """The kernel route (its plain contraction on the CPU) against the
    plain route through the whole float32 observer: they differ only in
    the contraction's summation order."""
    gen = torch.Generator().manual_seed(0)
    plain = FNO2dObserver(12, 12, 32, conv_backend="plain", generator=gen,
                          device="cpu")
    routed = FNO2dObserver(12, 12, 32, conv_backend="kernel", device="cpu")
    routed.load_state_dict(plain.state_dict())
    x = torch.as_tensor(np.random.default_rng(8).normal(size=(1, 32, 32)),
                        dtype=torch.float32)
    with torch.no_grad():
        a, b = plain(x), routed(x)
    assert float((a - b).norm() / a.norm()) < 1e-5


def test_seeded_init_is_reproducible_and_scaled():
    def build(seed):
        return FNO2dObserver(12, 12, 32, device="cpu",
                             generator=torch.Generator().manual_seed(seed))
    a, b, c = build(1), build(1), build(2)
    for (n, p), q, r in zip(a.named_parameters(), b.parameters(),
                            c.parameters()):
        assert torch.equal(p, q), n
        if p.abs().max() > 0:
            assert not torch.equal(p, r), n
    w = a.fno2d.projection.fc1.weight           # (256, 32): variance 1/32
    assert abs(float(w.detach().std()) - 32 ** -0.5) < 0.01
    assert float(a.fno2d.projection.fc1.bias.detach().abs().max()) == 0.0
    spec = a.fno2d.fno_blocks.convs.w0.mm2.detach()  # |w| rms 1/(32*32)
    rms = float((spec[0] ** 2 + spec[1] ** 2).mean().sqrt())
    assert abs(rms * 1024 - 1) < 0.05


def test_models_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FNO2dObserver(6, 6, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpectralConv(3, 3, (4, 4))


def test_load_jax_params_refuses_what_it_cannot_place():
    rng = np.random.default_rng(9)
    jmodel = JFNO2dObserver(6, 6, 8)
    x = rng.normal(size=(1, 16, 16))
    tree = init_tree(jmodel, rng, x)
    model = FNO2dObserver(6, 6, 8, **CPU64)
    assert load_jax_params(model, tree) is model
    w = model.fno2d.lifting.fc.weight
    np.testing.assert_array_equal(
        w.detach().numpy(), tree["fno2d"]["lifting"]["fc"]["kernel"].T)
    np.testing.assert_array_equal(
        model.fno2d.fno_blocks.convs.w3.mm2.detach().numpy(),
        tree["fno2d"]["fno_blocks"]["convs"]["w3"]["mm2"])

    extra = {"fno2d": {**tree["fno2d"], "pos_embed": {"table": np.zeros(3)}}}
    with pytest.raises(KeyError, match="no parameter 'fno2d.pos_embed"):
        load_jax_params(model, extra)
    fewer = {"fno2d": {k: v for k, v in tree["fno2d"].items()
                       if k != "projection"}}
    with pytest.raises(KeyError, match="fills no value for .*projection"):
        load_jax_params(model, fewer)
    with pytest.raises(ValueError, match="has shape"):
        load_jax_params(FNO2dObserver(6, 6, 4, **CPU64), tree)
