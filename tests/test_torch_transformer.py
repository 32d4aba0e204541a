"""The port's transformer operators against the flax modules, in float64
on the CPU: the four attention functions, the token spectral conv, each
attention type through `SimpleAttention`, the encoder layer, the
regressors, the conv blocks and resizes, `SimpleTransformer` and
`FourierTransformer2D`, and the parameter gradients.  Parameters are
drawn with numpy on the shapes of flax's tree and loaded into the port
with `load_jax_params`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.models import transformer as jt
from pde_policylearning_torch.models import transformer as tt
from pde_policylearning_torch.ops import spectral_cuda
from pde_policylearning_torch.utils.transplant import load_jax_params

CPU64 = dict(device="cpu", dtype=torch.float64)
TOL = 1e-8


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def draw_params(jmodel, rng, *inputs, scale=0.1, **kw):
    """numpy leaves of `scale` x normal on the shapes of flax's tree
    (`jax.eval_shape` of `init`)."""
    shapes = jax.eval_shape(
        lambda *a: jmodel.init(jax.random.PRNGKey(0), *a, **kw),
        *(jnp.asarray(a) for a in inputs))["params"]
    return jax.tree.map(lambda s: scale * rng.normal(size=s.shape), shapes)


def both(jmodel, model, inputs, rng, kw=None, pick=None, scale=0.1):
    """(port output, flax output) on the same parameters and inputs."""
    kw = kw or {}
    params = draw_params(jmodel, rng, *inputs, scale=scale, **kw)
    load_jax_params(model, params)
    ref = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, **kw))(
        params, *(jnp.asarray(a) for a in inputs))
    with torch.no_grad():
        out = model(*(t64(a) for a in inputs), **kw)
    if pick is not None:
        out, ref = out[pick], ref[pick]
    return out.numpy(), np.asarray(ref)


def close(a, b, tol=TOL):
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def qkv(rng, shape=(2, 2, 24, 4)):
    return [rng.normal(size=shape) for _ in range(3)]


@pytest.mark.parametrize("fn,kw", [
    ("attention", dict(attention_type="softmax")),
    ("attention", dict(attention_type="fourier")),
    ("attention_mask", dict(attention_type="softmax")),
    ("attention_mask", dict(attention_type="fourier")),
    ("linear_attention", dict(attention_type="galerkin")),
    ("linear_attention", dict(attention_type="linear")),
    ("causal_linear_attention", {}),
    ("freq_attention", dict(attention_type="fourier", modes=5)),
    ("freq_attention", dict(attention_type="softmax", modes=5))])
def test_attention_functions_match_jax(fn, kw):
    rng = np.random.default_rng(0)
    q, k, v = qkv(rng)
    if fn == "attention_mask":
        fn = "attention"
        kw = dict(kw, mask=(rng.random((24, 24)) > 0.3).astype(np.float64))
    jout = getattr(jt, fn)(*(jnp.asarray(a) for a in (q, k, v)),
                           **{k_: jnp.asarray(v_) if k_ == "mask" else v_
                              for k_, v_ in kw.items()})
    out = getattr(tt, fn)(*(t64(a) for a in (q, k, v)),
                          **{k_: t64(v_) if k_ == "mask" else v_
                             for k_, v_ in kw.items()})
    for a, b in zip(out, jout):
        a = a.numpy() if not a.is_complex() else a.resolve_conj().numpy()
        close(a, np.asarray(b))


def test_token_conv_and_feed_forward_match_flax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, 6))
    close(*both(jt.SpectralConv1dToken(5, dropout=0.0),
                tt.SpectralConv1dToken(6, 5, dropout=0.0, **CPU64), [x],
                rng))
    for act in ("relu", "silu", "gelu"):
        close(*both(jt.FeedForward(9, out_dim=4, activation=act),
                    tt.FeedForward(6, 9, out_dim=4, activation=act,
                                   **CPU64), [x], rng))
    with pytest.raises(ValueError, match="fewer than"):
        tt.SpectralConv1dToken(6, 5, **CPU64)(t64(x[:, :20]))


@pytest.mark.parametrize("attention_type,norm", [
    ("fourier", False), ("fourier", True), ("galerkin", True),
    ("linear", False), ("causal", False), ("freq", False),
    ("softmax", True), ("integral", False)])
def test_simple_attention_matches_flax(attention_type, norm):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 40, 8))
    jm = jt.SimpleAttention(n_head=2, d_model=8,
                            attention_type=attention_type, pos_dim=0,
                            dropout=0.0, norm=norm)
    m = tt.SimpleAttention(2, 8, attention_type, pos_dim=0, dropout=0.0,
                           norm=norm, **CPU64)
    out, ref = both(jm, m, [x, x, x], rng, pick=0)
    close(out, ref)


@pytest.mark.parametrize("attention_type", ["fourier", "galerkin"])
def test_encoder_layer_matches_flax(attention_type):
    """With a positional input (the attention's `fc`), with and without
    the post-norms, and the positional encoding added."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, 8))
    pos = rng.normal(size=(2, 40, 1))
    jm = jt.SimpleTransformerEncoderLayer(
        d_model=8, n_head=2, dim_feedforward=16,
        attention_type=attention_type, dropout=0.0)
    m = tt.SimpleTransformerEncoderLayer(
        d_model=8, n_head=2, dim_feedforward=16,
        attention_type=attention_type, dropout=0.0, with_pos=True, **CPU64)
    close(*both(jm, m, [x, pos], rng, pick=0))
    kw = dict(d_model=8, n_head=2, dim_feedforward=16, layer_norm=False,
              pos_emb=True, residual_type="minus", dropout=0.0,
              attention_type=attention_type)
    close(*both(jt.SimpleTransformerEncoderLayer(**kw),
                tt.SimpleTransformerEncoderLayer(**kw, **CPU64), [x], rng,
                pick=0))
    np.testing.assert_allclose(tt.positional_encoding(40, 8).numpy(),
                               np.asarray(jt.positional_encoding(40, 8)),
                               rtol=1e-15, atol=1e-15)


def test_bulk_regressor_matches_flax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 12, 6))
    for sort in (False, True):
        close(*both(jt.BulkRegressor(3, 5, sort_output=sort),
                    tt.BulkRegressor(6, 12, 3, 5, sort_output=sort,
                                     **CPU64), [x], rng))


@pytest.mark.parametrize("block", ["res_proj", "res_same", "down", "up"])
def test_conv_blocks_match_flax(block):
    """The 3x3 convs (flax kernel (3, 3, in, out) carried as
    permute(3, 2, 0, 1)) and the bilinear resizes: jax.image.resize
    antialiases when it shrinks."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, 10, 3))
    x8 = rng.normal(size=(2, 12, 10, 8))
    jm, m, inp = {
        "res_proj": (jt.Conv2dResBlock(8), tt.Conv2dResBlock(3, 8, **CPU64),
                     x),
        "res_same": (jt.Conv2dResBlock(8, activation="relu"),
                     tt.Conv2dResBlock(8, 8, activation="relu", **CPU64),
                     x8),
        "down": (jt.DownScaler(8), tt.DownScaler(3, 8, **CPU64), x),
        "up": (jt.UpScaler(8), tt.UpScaler(8, 8, **CPU64), x8),
    }[block]
    close(*both(jm, m, [inp], rng, scale=0.3))


def test_resize_matches_jax_image_resize():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 12, 10, 3))
    for size in ((6, 5), (24, 20), (7, 9), (12, 10)):
        ref = jax.image.resize(jnp.asarray(x), (2, *size, 3), "bilinear")
        close(tt._resize(t64(x), size, antialias=True).numpy(),
              np.asarray(ref))


@pytest.mark.parametrize("attention_type", ["fourier", "galerkin"])
def test_simple_transformer_matches_flax(attention_type):
    """Tokens of (T, H, W), two encoder layers, the spectral regressor on
    each timestep's plane."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 2, 8, 8, 1))
    kw = dict(n_hidden=8, n_head=2, freq_dim=6, fourier_modes=3,
              num_encoder_layers=2, num_regressor_layers=2,
              attention_type=attention_type)
    close(*both(jt.SimpleTransformer(**kw), tt.SimpleTransformer(**kw,
                                                                 **CPU64),
                [x], rng))


def test_fourier_transformer_2d_matches_flax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 12, 12, 3))
    kw = dict(n_hidden=8, n_head=2, freq_dim=6, fourier_modes=3,
              num_encoder_layers=2)
    close(*both(jt.FourierTransformer2D(**kw),
                tt.FourierTransformer2D(**kw, **CPU64), [x], rng, scale=0.3))


def test_transformer_gradients_match_jax():
    """Every parameter's gradient through `SimpleTransformer` against
    jax.grad, 1e-8 of the largest entry of each."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 2, 8, 8, 1))
    y = rng.normal(size=(2, 2, 8, 8, 1))
    kw = dict(n_hidden=8, n_head=2, freq_dim=6, fourier_modes=3,
              num_encoder_layers=2, num_regressor_layers=2)
    jm = jt.SimpleTransformer(**kw)
    params = draw_params(jm, rng, x, scale=0.3)
    model = load_jax_params(tt.SimpleTransformer(**kw, **CPU64), params)

    def jloss(p):
        return jnp.sum((jm.apply({"params": p}, jnp.asarray(x)) - y) ** 2)

    jgrads = jax.jit(jax.grad(jloss))(params)
    loss = ((model(t64(x)) - t64(y)) ** 2).sum()
    loss.backward()
    flat = {}

    def walk(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}.")
            else:
                flat[f"{pre}{k}"] = np.asarray(v)
    walk(jgrads)
    named = dict(model.named_parameters())
    assert len(flat) == len(named)
    for name, g in flat.items():
        pre, _, leaf = name.rpartition(".")
        tname = {"kernel": f"{pre}.weight", "scale": f"{pre}.weight"}.get(
            leaf, name)
        want = g.T if leaf == "kernel" else g
        got = named[tname].grad.numpy()
        scale = np.abs(want).max() + 1e-300
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=TOL, err_msg=name)


def test_full_width_transformer_and_launches(monkeypatch):
    """The published width (base_transformer.yaml: n_hidden 96, 2 heads,
    freq_dim 48, 12 modes, 8 encoder and 3 regressor layers, T = 2, 32x32)
    in float32 against flax, and its 2-D spectral convs: the regressor's
    3, one launch each on the kernel route; the token convs take the plain
    route, off the kernel."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(1, 2, 32, 32, 1)).astype(np.float32)
    jm = jt.SimpleTransformer(n_hidden=96, n_head=2, freq_dim=48,
                              fourier_modes=12)
    m = tt.SimpleTransformer(n_hidden=96, n_head=2, freq_dim=48,
                             fourier_modes=12, conv_backend="kernel",
                             device="cpu")
    params = draw_params(jm, rng, x, scale=0.05)
    load_jax_params(m, params)
    ref = jax.jit(lambda p, a: jm.apply({"params": p}, a))(
        jax.tree.map(lambda a: a.astype(np.float32), params), x)
    calls = []
    real = spectral_cuda._corners
    monkeypatch.setattr(spectral_cuda, "_corners", lambda *a, adjoint=False:
                        calls.append(adjoint) or real(*a, adjoint=adjoint))
    with torch.no_grad():
        out = m(torch.as_tensor(x))
    assert calls == [False] * 3
    err = np.linalg.norm(out.numpy() - np.asarray(ref)) / \
        np.linalg.norm(np.asarray(ref))
    assert err < 1e-5


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_graph_feature_extraction_is_accepted(kind):
    """The constructor takes the graph feature lifts: `feat_extract` owns
    the graph layers and the Dense leaves beside them, and any other
    type is refused (the parity is `tests/test_torch_zoo.py`'s)."""
    m = tt.SimpleTransformer(feat_extract_type=kind, n_hidden=8,
                             num_feat_layers=2, **CPU64)
    names = {n for n, _ in m.feat_extract.named_parameters()}
    layer = "gc" if kind == "gcn" else "gat"
    assert {"kernel", "bias", f"{layer}0.{'w' if kind == 'gcn' else 'W'}"
            ".weight", f"{layer}1.{'w' if kind == 'gcn' else 'W'}.weight"} \
        <= names
    with pytest.raises(ValueError, match="feat_extract_type"):
        tt.SimpleTransformer(feat_extract_type="mlp", **CPU64)
