"""Graph feature extractors for the transformer models.

Counterpart of `pde_policylearning_tpu/models/graph.py` (reference:
libs/models/attention_layers.py:197 (GraphConvolution), :245
(GraphAttention) and the GCN/GAT stacks of transformer_models.py:592-604),
on dense (B, N, N) adjacency or graph-Laplacian tensors.  Names follow the
flax tree: `gc{i}.w` (a Dense), `gat{i}.W` (a Dense without bias) and
`gat{i}.a`.  The weights are drawn from `generator` at the scale of the
flax initializers (normal, variance 1 / fan_in for a Dense, 2 / (fan_in +
fan_out) for xavier), and the attention's dropout draws its mask from the
generator handed to the call.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from . import layers

_ACT = {"relu": F.relu, "silu": F.silu, "gelu": layers.gelu}


class GraphConvolution(nn.Module):
    """x' = A (x W) + b over a dense adjacency / Laplacian
    (attention_layers.py:197)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        self.w = layers.flax_init_(
            nn.Linear(in_features, out_features, bias=use_bias, **factory),
            generator)

    def forward(self, x, edge):
        """x: (B, N, F); edge: (B, N, N) -> (B, N, out)."""
        return torch.einsum("bnm,bmf->bnf", edge, self.w(x))


class GCN(nn.Module):
    """Stack of graph convolutions `gc{i}` with the activation between
    them."""

    def __init__(self, in_features: int, out_features: int,
                 num_layers: int = 2, activation: str = "relu",
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.act = _ACT[activation]
        for i in range(num_layers):
            self.add_module(f"gc{i}", GraphConvolution(
                in_features if i == 0 else out_features, out_features,
                generator=generator, device=device, dtype=dtype))

    def forward(self, x, edge):
        for i in range(self.num_layers):
            x = getattr(self, f"gc{i}")(x, edge)
            if i < self.num_layers - 1:
                x = self.act(x)
        return x


def dropout(x, rate: float, generator: Optional[torch.Generator] = None):
    """flax `nn.Dropout`: keep each entry with probability 1 - rate, drawn
    from `generator` (None: torch's global generator), and scale the kept
    ones by 1 / (1 - rate)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class GraphAttention(nn.Module):
    """Dense GAT layer (attention_layers.py:245): pairwise logits
    `leaky_relu(h a1 + (h a2)^T)` from the projected features, masked by
    the graph (`|adj| > interaction_thresh` for a Laplacian, `adj > 0`
    otherwise; -9e15 elsewhere), a softmax over the neighbours, dropout on
    the attention, then the attention times h."""

    def __init__(self, in_features: int, out_features: int,
                 alpha: float = 1e-2, graph_lap: bool = True,
                 interaction_thresh: float = 1e-6, dropout: float = 0.1,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        self.out_features = out_features
        self.alpha = alpha
        self.graph_lap = graph_lap
        self.interaction_thresh = interaction_thresh
        self.dropout = dropout
        self.W = layers.flax_init_(
            nn.Linear(in_features, out_features, bias=False, **factory),
            generator, std=(2.0 / (in_features + out_features)) ** 0.5)
        a = torch.empty((2 * out_features, 1), **factory)
        a.normal_(0.0, (2.0 / (2 * out_features + 1)) ** 0.5,
                  generator=generator)
        self.a = nn.Parameter(a)

    def forward(self, node, adj, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        h = self.W(node)
        a1, a2 = self.a[:self.out_features, 0], self.a[self.out_features:, 0]
        e = (h @ a1)[:, :, None] + (h @ a2)[:, None, :]
        e = F.leaky_relu(e, negative_slope=self.alpha)
        if self.graph_lap:
            mask = adj.abs() > self.interaction_thresh
        else:
            mask = adj > 0
        e = torch.where(mask, e, torch.full((), -9e15, dtype=e.dtype,
                                            device=e.device))
        attn = torch.softmax(e, dim=-1)
        if self.dropout > 0 and not deterministic:
            attn = dropout(attn, self.dropout, generator)
        return torch.einsum("bnm,bmf->bnf", attn, h)


class GAT(nn.Module):
    """Stack of GAT layers `gat{i}` with the activation between them."""

    def __init__(self, in_features: int, out_features: int,
                 num_layers: int = 2, activation: str = "relu",
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.act = _ACT[activation]
        for i in range(num_layers):
            self.add_module(f"gat{i}", GraphAttention(
                in_features if i == 0 else out_features, out_features,
                generator=generator, device=device, dtype=dtype))

    def forward(self, x, adj, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        for i in range(self.num_layers):
            x = getattr(self, f"gat{i}")(x, adj, deterministic=deterministic,
                                         generator=generator)
            if i < self.num_layers - 1:
                x = self.act(x)
        return x


def grid_laplacian(H: int, W: int, T: int = 1, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    """The dense normalized graph Laplacian I - D^-1/2 A D^-1/2 of the
    4-neighbour graph of an H x W plane (no wrap), block-diagonal over T
    planes: an (N, N) tensor, N = T H W, with the tokens in the order of a
    (T, H, W) reshape, the edge a 'gcn' / 'gat' transformer takes."""
    idx = torch.arange(H * W).reshape(H, W)
    a = torch.zeros((H * W, H * W), dtype=torch.float64)
    for src, dst in ((idx[:, :-1], idx[:, 1:]), (idx[:-1], idx[1:])):
        a[src.reshape(-1), dst.reshape(-1)] = 1.0
        a[dst.reshape(-1), src.reshape(-1)] = 1.0
    d = a.sum(1).rsqrt()
    lap = torch.eye(H * W, dtype=torch.float64) - d[:, None] * a * d[None]
    return torch.block_diag(*[lap] * T).to(
        device=layers.factory(device, dtype)["device"], dtype=dtype)
