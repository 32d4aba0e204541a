"""The port's graph feature extractors, the transformer with its 'gcn' /
'gat' feature lift and the UNO against the flax modules, in float64 on the
CPU.  Parameters are drawn with numpy on the shapes of flax's tree and
carried into the port by `load_jax_params`; the inputs come from the same
numpy generator.  Forwards are held at 1e-10 and gradients (against
`jax.grad`) at 1e-9, each relative to the largest entry of the tensor."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu import models as jmodels
from pde_policylearning_tpu.models import graph as jgraph
from pde_policylearning_tpu.models import transformer as jt
from pde_policylearning_tpu.models import uno as juno
from pde_policylearning_torch import models
from pde_policylearning_torch.models import graph
from pde_policylearning_torch.models.uno import UNO
from pde_policylearning_torch.utils.transplant import load_jax_params

CPU64 = dict(device="cpu", dtype=torch.float64)
FWD, GRAD = 1e-10, 1e-9


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def draw_params(jmodel, rng, *inputs, scale=0.1, **kw):
    """numpy leaves of `scale` x normal on the shapes of flax's tree
    (`jax.eval_shape` of `init`)."""
    shapes = jax.eval_shape(
        lambda *a: jmodel.init(jax.random.PRNGKey(0), *a, **kw),
        *(jnp.asarray(a) for a in inputs))["params"]
    return jax.tree.map(lambda s: scale * rng.normal(size=s.shape), shapes)


def japply(jmodel, params, *inputs, **kw):
    return np.asarray(jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a, **kw))(params, *(jnp.asarray(a) for a in inputs)))


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-300
    assert np.abs(got - want).max() <= tol * scale, \
        np.abs(got - want).max() / scale


def parity(jmodel, model, inputs, rng, tol=FWD, scale=0.1, kw=None):
    """Carry flax's parameters into `model` and hold the two outputs;
    returns the parameters."""
    kw = kw or {}
    params = draw_params(jmodel, rng, *inputs, scale=scale, **kw)
    load_jax_params(model, params)
    with torch.no_grad():
        out = model(*(t64(a) for a in inputs),
                    **{k: t64(v) if isinstance(v, np.ndarray) else v
                       for k, v in kw.items()})
    assert out.dtype == torch.float64
    close(out, japply(jmodel, params, *inputs, **kw), tol)
    return params


def grads_match(jmodel, model, params, x, y):
    """Every parameter's gradient of sum((f(x) - y)^2) against jax.grad:
    flax's gradient tree carried by `load_jax_params` into a copy of the
    module, so that each leaf meets the parameter of its layout."""
    def jloss(p):
        return jnp.sum((jmodel.apply({"params": p}, jnp.asarray(x)) - y) ** 2)

    jgrads = jax.jit(jax.grad(jloss))(params)
    model.zero_grad()
    ((model(t64(x)) - t64(y)) ** 2).sum().backward()
    want = load_jax_params(copy.deepcopy(model),
                           jax.tree.map(np.asarray, jgrads))
    ref = dict(want.named_parameters())
    for name, p in model.named_parameters():
        close(p.grad, ref[name].detach().numpy(), GRAD)


def adjacency(rng, B, N, zero_frac=0.5):
    """A (B, N, N) signed matrix with a share of exact zeros, so that the
    GAT's graph mask has both cases."""
    a = rng.normal(size=(B, N, N))
    return np.where(rng.random((B, N, N)) < zero_frac, 0.0, a)


@pytest.mark.parametrize("name", ["conv", "conv_nobias", "gcn", "gcn_silu",
                                  "gat_layer", "gat_layer_adj", "gat",
                                  "gat_gelu"])
def test_graph_modules_match_flax(name):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 10, 4))
    adj = adjacency(rng, 2, 10)
    jm, m = {
        "conv": (jgraph.GraphConvolution(8),
                 graph.GraphConvolution(4, 8, **CPU64)),
        "conv_nobias": (jgraph.GraphConvolution(8, use_bias=False),
                        graph.GraphConvolution(4, 8, use_bias=False,
                                               **CPU64)),
        "gcn": (jgraph.GCN(8, num_layers=2),
                graph.GCN(4, 8, num_layers=2, **CPU64)),
        "gcn_silu": (jgraph.GCN(8, num_layers=3, activation="silu"),
                     graph.GCN(4, 8, num_layers=3, activation="silu",
                               **CPU64)),
        "gat_layer": (jgraph.GraphAttention(8),
                      graph.GraphAttention(4, 8, **CPU64)),
        "gat_layer_adj": (jgraph.GraphAttention(8, graph_lap=False,
                                                alpha=0.2),
                          graph.GraphAttention(4, 8, graph_lap=False,
                                               alpha=0.2, **CPU64)),
        "gat": (jgraph.GAT(8, num_layers=2),
                graph.GAT(4, 8, num_layers=2, **CPU64)),
        "gat_gelu": (jgraph.GAT(8, num_layers=2, activation="gelu"),
                     graph.GAT(4, 8, num_layers=2, activation="gelu",
                               **CPU64)),
    }[name]
    parity(jm, m, [x, adj], rng, scale=0.5)


def test_gat_gradients_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 10, 4))
    adj = adjacency(rng, 2, 10)
    y = rng.normal(size=(2, 10, 8))
    jm, m = jgraph.GAT(8, num_layers=2), graph.GAT(4, 8, num_layers=2,
                                                   **CPU64)
    params = draw_params(jm, rng, x, adj, scale=0.5)
    load_jax_params(m, params)

    def jloss(p):
        return jnp.sum((jm.apply({"params": p}, jnp.asarray(x),
                                 jnp.asarray(adj)) - y) ** 2)
    jgrads = jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(params))
    ((m(t64(x), t64(adj)) - t64(y)) ** 2).sum().backward()
    ref = dict(load_jax_params(copy.deepcopy(m), jgrads).named_parameters())
    for name, p in m.named_parameters():
        close(p.grad, ref[name].detach().numpy(), GRAD)


def test_attention_dropout_mask_shape_and_rate():
    """The dropout of flax's `nn.Dropout`: entries kept with probability
    0.9 and scaled by 1 / 0.9, drawn from the generator given (the same
    seed gives the same mask); the GAT takes it only when not
    deterministic."""
    x = torch.ones((4, 64, 64), dtype=torch.float64)
    gen = torch.Generator().manual_seed(3)
    out = graph.dropout(x, 0.1, gen)
    assert out.shape == x.shape
    kept = out != 0
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.9))
    assert abs(1 - kept.double().mean().item() - 0.1) < 0.01
    again = graph.dropout(x, 0.1, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)

    rng = np.random.default_rng(2)
    xs, adj = t64(rng.normal(size=(2, 10, 4))), t64(adjacency(rng, 2, 10))
    m = graph.GAT(4, 8, num_layers=2, generator=torch.Generator()
                  .manual_seed(0), **CPU64)
    det = m(xs, adj)
    a = m(xs, adj, deterministic=False,
          generator=torch.Generator().manual_seed(5))
    b = m(xs, adj, deterministic=False,
          generator=torch.Generator().manual_seed(5))
    assert a.shape == det.shape and torch.equal(a, b)
    assert not torch.allclose(a, det)


TKW = dict(n_hidden=8, n_head=2, freq_dim=6, fourier_modes=3,
           num_encoder_layers=1, num_regressor_layers=2, num_feat_layers=2)


@pytest.mark.parametrize("kind", ["gcn", "gat"])
@pytest.mark.parametrize("with_edge", [True, False])
def test_transformer_graph_feature_lift_matches_flax(kind, with_edge):
    """With an edge the lift is the GCN / GAT (the tree's
    `feat_extract.gc0.w` / `feat_extract.gat0.W`, `a`); without one it is
    the Dense (`feat_extract.kernel`, `bias`).  Either tree loads into the
    same port module, the other route's parameters left as they are."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 2, 6, 6, 1))
    edge = np.broadcast_to(
        graph.grid_laplacian(6, 6, 2, **CPU64).numpy(), (2, 72, 72)).copy()
    jm = jt.SimpleTransformer(feat_extract_type=kind, **TKW)
    m = models.SimpleTransformer(feat_extract_type=kind, **TKW, **CPU64)
    kw = dict(edge=edge) if with_edge else {}
    params = parity(jm, m, [x], rng, scale=0.3, kw=kw)
    leaves = set(params["feat_extract"])
    assert leaves == ({f"{'gc' if kind == 'gcn' else 'gat'}{i}"
                       for i in range(2)} if with_edge
                      else {"kernel", "bias"})


def test_transformer_graph_lift_refuses_a_tree_without_it():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 2, 6, 6, 1))
    params = draw_params(jt.SimpleTransformer(feat_extract_type="gcn",
                                              **TKW), rng, x)
    del params["feat_extract"]
    with pytest.raises(KeyError, match="feat_extract"):
        load_jax_params(models.SimpleTransformer(feat_extract_type="gcn",
                                                 **TKW, **CPU64), params)


UKW = dict(in_channels=2, out_channels=1, hidden_channels=8,
           lifting_channels=8, projection_channels=8, n_layers=4,
           uno_out_channels=[8, 8, 8, 8], uno_n_modes=[[3, 3]] * 4,
           uno_scalings=[[1.0, 1.0], [0.5, 0.5], [1.0, 1.0], [2.0, 2.0]])


@pytest.mark.parametrize("factorization", [None, "tucker"])
def test_uno_matches_flax(factorization):
    """The JAX test's UNO (4 layers, 0.5 down and 2.0 up, the U's skips),
    dense and Tucker (rank 0.5, the factorized contraction), forward and
    every parameter's gradient."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 16, 16, 2))
    y = rng.normal(size=(2, 16, 16, 1))
    kw = dict(UKW, factorization=factorization, rank=0.5)
    jm, m = juno.UNO(**kw), UNO(**kw, **CPU64)
    params = parity(jm, m, [x], rng, scale=0.5)
    names = {n for n, _ in m.named_parameters()}
    assert {"hskip0.conv.weight", "hskip1.conv.weight",
            "block3.convs.w0." + ("mm2" if factorization is None
                                  else "factors3")} <= names
    grads_match(jm, m, params, x, y)


def test_uno_with_domain_padding_and_wider_channels():
    """Input channels of a block different from its output after the skip
    concatenation (8 + 12 -> 6), one-sided domain padding, 12 x 16."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 12, 16, 3))
    kw = dict(in_channels=3, out_channels=2, hidden_channels=8,
              lifting_channels=8, projection_channels=10, n_layers=3,
              uno_out_channels=[12, 8, 6], uno_n_modes=[[4, 4], [2, 2],
                                                        [4, 4]],
              uno_scalings=[[1.0, 1.0], [0.5, 0.5], [2.0, 2.0]],
              factorization=None, domain_padding=0.25)
    parity(juno.UNO(**kw), UNO(**kw, **CPU64), [x], rng, scale=0.5)


def test_uno_in_dispatcher():
    """`get_model` builds the UNO from the JAX test's config (device and
    dtype under the arch's keys), and it computes the JAX model's
    function."""
    config = {
        "arch": "uno",
        "uno": {
            "data_channels": 2, "out_channels": 1, "hidden_channels": 8,
            "lifting_channels": 8, "projection_channels": 8, "n_layers": 2,
            "uno_out_channels": [8, 8], "uno_n_modes": [[3, 3], [3, 3]],
            "uno_scalings": [[1.0, 1.0], [1.0, 1.0]],
        },
    }
    jm = jmodels.get_model(copy.deepcopy(config))
    config["uno"].update(CPU64)
    m = models.get_model(config)
    assert isinstance(m, UNO) and "uno" in models.available_models()
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 8, 8, 2))
    parity(jm, m, [x], rng, scale=0.5)
    with torch.no_grad():
        assert tuple(m(t64(x)).shape) == (1, 8, 8, 1)
