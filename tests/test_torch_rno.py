"""The port's RNO modules, `RNO2dObserver`, `DoubleConv` and `UNet`
against the flax modules, in float64 on the CPU, and the layouts that
`load_jax_params` carries across (Dense, Conv, ConvTranspose, LayerNorm,
BatchNorm statistics).  Each flax module is initialised with
`model.init`, every leaf of its trees perturbed from a seeded numpy
generator, handed back to flax and loaded into the port's module; the
inputs are numpy arrays from the same generator."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pde_policylearning_tpu.models import observers as jobs
from pde_policylearning_tpu.models import rno as jrno
from pde_policylearning_torch.models import (DoubleConv, FourierLayer2d,
                                             RNO2d, RNO2dObserver, RNOCell,
                                             RNOLayer, RNOSpectralConv2d,
                                             SpectralConvWithFC,
                                             SpectralRegressor, UNet)
from pde_policylearning_torch.ops import spectral_cuda
from pde_policylearning_torch.utils.transplant import load_jax_params

CPU64 = dict(device="cpu", dtype=torch.float64)


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def init_trees(jmodel, rng, *inputs, **kw):
    """The shapes of flax's trees (`jax.eval_shape` of `init`, which
    traces and does not run it) -> numpy (params, batch_stats or None),
    every leaf 0.1 x normal from `rng` (batch variances 0.5 + |normal|)."""
    variables = jax.eval_shape(
        lambda *a: jmodel.init(jax.random.PRNGKey(0), *a, **kw),
        *(jnp.asarray(a) for a in inputs))

    def draw(tree, f):
        return jax.tree.map(lambda s: f(rng.normal(size=s.shape)), tree)
    stats = variables.get("batch_stats")
    return (draw(variables["params"], lambda a: 0.1 * a),
            None if stats is None else draw(stats, lambda a: 0.5 + abs(a)))


def japply(jmodel, params, stats, *inputs, **kw):
    variables = {"params": params}
    if stats is not None:
        variables["batch_stats"] = stats
    return np.asarray(jax.jit(lambda v, *a: jmodel.apply(v, *a, **kw))(
        variables, *(jnp.asarray(a) for a in inputs)))


def assert_matches(jmodel, model, inputs, rng, tol=1e-8, kw=None):
    params, stats = init_trees(jmodel, rng, *inputs, **(kw or {}))
    load_jax_params(model, params, stats)
    ref = japply(jmodel, params, stats, *inputs, **(kw or {}))
    with torch.no_grad():
        out = model(*(t64(a) for a in inputs), **(kw or {}))
    assert out.dtype == torch.float64 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)
    return params, stats


X = (2, 16, 16, 6)   # batch, H, W, width


@pytest.mark.parametrize("name", ["spectral", "fourier", "cell",
                                  "layer_seq", "layer_last", "fc_silu",
                                  "fc_relu_last", "regressor",
                                  "regressor_fc"])
def test_rno_modules_match_flax(name):
    rng = np.random.default_rng(3)
    x = rng.normal(size=X)
    seq = rng.normal(size=(2, 3, 16, 16, 6))
    grid = rng.normal(size=(2, 16, 16, 2))
    jm, m, inputs = {
        "spectral": (jrno.RNOSpectralConv2d(6, 5, 4, 3),
                     RNOSpectralConv2d(6, 5, 4, 3, **CPU64), [x]),
        "fourier": (jrno.FourierLayer2d(4, 4, 6),
                    FourierLayer2d(4, 4, 6, **CPU64), [x]),
        "cell": (jrno.RNOCell(4, 4, 6), RNOCell(4, 4, 6, **CPU64),
                 [x, rng.normal(size=X)]),
        "layer_seq": (jrno.RNOLayer(4, 4, 6, return_sequences=True),
                      RNOLayer(4, 4, 6, return_sequences=True, **CPU64),
                      [seq]),
        "layer_last": (jrno.RNOLayer(4, 4, 6), RNOLayer(4, 4, 6, **CPU64),
                       [seq, rng.normal(size=X)]),
        "fc_silu": (jrno.SpectralConvWithFC(6, 5, 4, 4),
                    SpectralConvWithFC(6, 5, 4, 4, **CPU64), [x]),
        "fc_relu_last": (
            jrno.SpectralConvWithFC(6, 5, 4, 4, activation="relu",
                                    last_activation=False),
            SpectralConvWithFC(6, 5, 4, 4, activation="relu",
                               last_activation=False, **CPU64), [x]),
        "regressor": (jrno.SpectralRegressor(6, 5, 1, 4),
                      SpectralRegressor(6, 5, 1, 4, **CPU64), [x]),
        "regressor_fc": (
            jrno.SpectralRegressor(6, 5, 2, 4, num_spectral_layers=3,
                                   spacial_fc=True, dim_feedforward=7,
                                   activation="relu"),
            SpectralRegressor(6, 5, 2, 4, num_spectral_layers=3,
                              spacial_fc=True, dim_feedforward=7,
                              activation="relu", **CPU64), [x, grid]),
    }[name]
    assert_matches(jm, m, inputs, rng)


@pytest.mark.parametrize("kw,call", [
    (dict(), {}), (dict(layer_num=2, recurrent_index=1), {}),
    (dict(layer_num=2, pad_amount=(3, 2), pad_dim="both"),
     dict(timestep=2))])
def test_rno2d_matches_flax(kw, call):
    """The whole RNO: input projection, stacked layers with their residual,
    the autoregressive predict loop (T steps, the first consuming the
    sequence; an explicit `timestep` overrides the length), the
    regressor, padding."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 16, 16, 1))
    assert_matches(jrno.RNO2d(4, 4, 6, **kw), RNO2d(4, 4, 6, **kw, **CPU64),
                   [x], rng, kw=call)


@pytest.mark.parametrize("width,size,T", [(6, 16, 2), (34, 32, 2)])
def test_rno2d_observer_matches_flax(width, size, T):
    """The observer at a small size and at the full published width
    (matlab_rno.yaml: modes 12, width 34, one layer, T = 2, 32x32)."""
    rng = np.random.default_rng(5)
    modes = 12 if size == 32 else 4
    x = rng.normal(size=(2, T, size, size, 1))
    assert_matches(jobs.RNO2dObserver(modes, modes, width),
                   RNO2dObserver(modes, modes, width, **CPU64), [x], rng)


def test_rno_gradients_match_jax():
    """Every parameter's gradient of a loss through the RNO observer
    against jax.grad, 1e-8."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 2, 16, 16, 1))
    y = rng.normal(size=(2, 16, 16, 1))
    jm = jobs.RNO2dObserver(4, 4, 6, layer_num=2)
    params, _ = init_trees(jm, rng, x)
    model = load_jax_params(RNO2dObserver(4, 4, 6, layer_num=2, **CPU64),
                            params)

    def jloss(p):
        return jnp.sum((jm.apply({"params": p}, jnp.asarray(x)) - y) ** 2)

    jgrads = jax.jit(jax.grad(jloss))(params)
    loss = ((model(t64(x)) - t64(y)) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(params)),
                               rtol=1e-10)
    flat = {}

    def walk(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}.")
            else:
                flat[f"{pre}{k}"] = np.asarray(v)
    walk(jax.tree.map(np.asarray, jgrads))
    named = dict(model.named_parameters())
    assert len(flat) == len(named)
    for name, g in flat.items():
        tname = name[:-len("kernel")] + "weight" if name.endswith("kernel") \
            else name
        got = named[tname].grad.numpy()
        want = g.T if name.endswith("kernel") else g
        scale = np.abs(want).max() + 1e-300
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=1e-8, err_msg=name)


@pytest.mark.parametrize("train", [False, True])
def test_double_conv_matches_flax(train):
    """Conv -> BatchNorm -> relu twice, with the running statistics (eval)
    and with the batch's (train)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 8, 8, 5))
    jm = jobs.DoubleConv(7, mid_channels=6)
    m = DoubleConv(5, 7, mid_channels=6, **CPU64)
    params, stats = init_trees(jm, rng, x)
    load_jax_params(m, params, stats)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    if train:
        ref, _ = jm.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out = m(t64(x), train=train)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-8,
                               atol=1e-8)


@pytest.mark.parametrize("kw", [dict(), dict(bilinear=True),
                                dict(use_spectral_conv=False)])
def test_unet_matches_flax(kw):
    """The UNet (eval statistics) on 16x16 planes, modes 4: transposed
    convs or the nearest repeat, the spectral last block or a DoubleConv."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 16, 16))
    assert_matches(jobs.UNet(modes=4, **kw), UNet(modes=4, **kw, **CPU64),
                   [x], rng)


def test_load_jax_params_carries_each_layout():
    """Non-symmetric kernels, where a swap of kh and kw or a missing flip
    changes the output: a Conv, a ConvTranspose (flax's transpose_kernel
    False), a Dense, a LayerNorm, and BatchNorm statistics beside the
    parameters."""
    rng = np.random.default_rng(10)

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.Conv(4, (3, 3), padding=1, name="conv")(x)
            x = fnn.ConvTranspose(3, (2, 3), strides=(2, 2),
                                  name="tconv")(x)
            x = fnn.LayerNorm(epsilon=1e-5, name="ln")(x)
            x = fnn.BatchNorm(use_running_average=True, name="bn")(x)
            return fnn.Dense(2, name="fc")(x)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(2, 4, 3, padding=1, **CPU64)
            self.tconv = nn.ConvTranspose2d(4, 3, (2, 3), stride=2, **CPU64)
            self.ln = nn.LayerNorm(3, eps=1e-5, **CPU64)
            self.bn = nn.BatchNorm2d(3, **CPU64)
            self.fc = nn.Linear(3, 2, **CPU64)

        def forward(self, x):
            x = self.conv(x.permute(0, 3, 1, 2))
            # flax's SAME padding of a stride-2 transposed conv keeps
            # 2 x the input: torch's output is cut to it
            x = self.tconv(x)[..., :, :8, :8]
            x = self.ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            x = self.bn.eval()(x)
            return self.fc(x.permute(0, 2, 3, 1))

    x = rng.normal(size=(2, 4, 4, 2))
    params, stats = init_trees(JNet(), rng, x)
    assert params["conv"]["kernel"].shape == (3, 3, 2, 4)
    ref = japply(JNet(), params, stats, x)
    net = load_jax_params(Net(), params, stats)
    np.testing.assert_array_equal(
        net.conv.weight.detach().numpy(),
        params["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(net.bn.running_var.numpy(),
                                  stats["bn"]["var"])
    with torch.no_grad():
        np.testing.assert_allclose(net(t64(x)).numpy(), ref, rtol=1e-10,
                                   atol=1e-10)
        # the old rule (`.T` of every kernel) passes the shape check and
        # swaps the spatial axes: another output
        bad = Net()
        load_jax_params(bad, params, stats)
        bad.conv.weight.copy_(t64(params["conv"]["kernel"].T))
        assert np.abs(bad(t64(x)).numpy() - ref).max() > 1e-3
    with pytest.raises(KeyError, match="fills no value for .*running_mean"):
        load_jax_params(Net(), params)


def test_unet_needs_its_batch_stats():
    rng = np.random.default_rng(11)
    params, stats = init_trees(jobs.UNet(modes=4), rng,
                               rng.normal(size=(1, 16, 16)))
    with pytest.raises(KeyError, match="running_var"):
        load_jax_params(UNet(modes=4, **CPU64), params)
    load_jax_params(UNet(modes=4, **CPU64), params, stats)


def test_seeded_init_follows_the_jax_distributions():
    """A generator makes the model a function of its seed; the scales are
    the JAX package's: spectral std sqrt(2) / (in x out), input projection
    and gate biases normal(1), Dense 1 / sqrt(fan_in)."""
    def make(seed):
        return RNO2dObserver(12, 12, 34, generator=torch.Generator()
                             .manual_seed(seed), device="cpu")
    a, b, c = make(0), make(0), make(1)
    for (n, p), q, r in zip(a.named_parameters(), b.parameters(),
                            c.parameters()):
        assert torch.equal(p, q), n
        assert p.numel() == 1 or not p.any() or not torch.equal(p, r), n
    rno = a.rno
    # the complex weight's std: sqrt(2) / (in x out), half the variance
    # in each of the real and imaginary leaves
    w = rno.layer0.scan.cell.f1.spec_conv.w0.mm2.detach()
    assert abs(float(w.std()) * 34 * 34 - 1) < 0.05
    assert abs(float(rno.input_projection.weight.detach().std()) - 1) < 0.3
    lin = rno.layer0.scan.cell.f3.pointwise.weight.detach()
    assert abs(float(lin.std()) * 34 ** 0.5 - 1) < 0.05
    assert float(rno.layer0.scan.cell.f3.pointwise.bias.abs().max()) == 0


def test_rno_launches_per_forward(monkeypatch):
    """The RNO observer's 2-D spectral convs through the kernel route: 8
    per cell step, T scanned steps on the first of T predict steps and one
    on each later one, and 2 of the regressor per predict step (T = 2, one
    layer: 8 x (2 + 1) + 2 x 2 = 28); the UNet 1."""
    calls = []
    real = spectral_cuda._corners
    monkeypatch.setattr(spectral_cuda, "_corners", lambda *a, adjoint=False:
                        calls.append(adjoint) or real(*a, adjoint=adjoint))
    gen = torch.Generator().manual_seed(0)
    rno = RNO2dObserver(4, 4, 6, conv_backend="kernel", generator=gen,
                        device="cpu")
    with torch.no_grad():
        rno(torch.randn(1, 2, 16, 16, 1, generator=gen))
    assert len(calls) == 28
    calls.clear()
    with torch.no_grad():
        rno(torch.randn(1, 3, 16, 16, 1, generator=gen))
    assert len(calls) == 8 * (3 + 1 + 1) + 2 * 3
    calls.clear()
    unet = UNet(modes=4, conv_backend="kernel", generator=gen, device="cpu")
    with torch.no_grad():
        unet(torch.randn(1, 16, 16, 1, generator=gen))
    assert calls == [False]


def test_rno_layer_remat_recomputes_the_same_gradients():
    """`remat` recomputes each cell in the backward pass: the same
    output and gradients as the stored activations."""
    gen = torch.Generator().manual_seed(2)
    layer = RNOLayer(4, 4, 6, return_sequences=True, generator=gen, **CPU64)
    x = torch.randn(2, 3, 16, 16, 6, generator=gen, dtype=torch.float64)
    grads = []
    for remat in (False, True):
        layer.remat = remat
        out = layer(x)
        grads.append((out, torch.autograd.grad((out ** 2).sum(),
                                               list(layer.parameters()))))
    (o0, g0), (o1, g1) = grads
    assert torch.equal(o0, o1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-14)


def test_every_block_defaults_to_the_card(monkeypatch):
    """device=None means the card for the observers and for each of their
    blocks, and raises without one."""
    from pde_policylearning_torch.models import (SimpleAttention,
                                                 SimpleTransformer)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: RNOCell(4, 4, 6), lambda: FourierLayer2d(4, 4, 6),
                 lambda: SpectralRegressor(6, 5, 1, 4),
                 lambda: RNO2dObserver(4, 4, 6), lambda: DoubleConv(3, 4),
                 lambda: UNet(modes=4), lambda: SimpleAttention(2, 8),
                 lambda: SimpleTransformer(n_hidden=8, freq_dim=6)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
