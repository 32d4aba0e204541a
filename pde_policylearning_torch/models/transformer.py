"""Galerkin / Fourier transformer operator models.

Counterpart of `pde_policylearning_tpu/models/transformer.py` (reference:
libs/models/transformer_models.py (SimpleTransformerEncoderLayer :30,
SimpleTransformer :506, FourierTransformer2D :672, DownScaler / UpScaler
:394, :444) and libs/models/attention_layers.py (attention :636,
linear_attention :673, causal_linear_attn :699, freq_attention :580,
SimpleAttention :773, FeedForward :971, BulkRegressor :1007, positional
encodings :46-107, SpectralConv1d :1057)).

Layout: tokens (B, N, C), planes channels-last (B, H, W, C).  The token
projections (`SpectralConv1dToken`, a 1-D spectral conv over the token
axis) and `freq_attention` stay on `torch.fft` and a complex einsum: the
corner-contraction kernel, like the JAX package's Pallas kernel, takes
2-D convs only.  The spectral regressor's 2-D convs take the kernel on a
CUDA tensor (`conv_backend`).  Names follow the flax tree; parameters are
drawn from `generator` by the JAX package's initializers (the attention
projections' `diag_dominant_init` included).

Where flax sizes a layer from the input it first sees, the constructors
take the size: a token conv keeps `modes` modes and needs at least
2 (modes - 1) tokens (flax cuts its modes to the tokens instead), and a
positional input is declared with `pos_dim` > 0 and `with_pos` (flax
creates the attention's `fc` on the first call with `pos`).
`feat_extract_type` 'gcn' / 'gat' needs `models/graph.py`, which is not
ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops import factorized, fourier
from ..utils.device import resolve_device
from . import layers
from .graph import GAT, GCN
from .rno import SpectralRegressor
from .spectral_layers import _as_parameters, _as_weight

_ACT = {"relu": F.relu, "silu": F.silu, "gelu": layers.gelu}


# ---------------------------------------------------------------------------
# attention primitives
# ---------------------------------------------------------------------------

def attention(q, k, v, attention_type="softmax", mask=None):
    """Classic / Fourier (unnormalized integral) attention
    (attention_layers.py:636-670).  q, k, v: (B, H, N, D)."""
    d_k = q.shape[-1]
    scores = torch.einsum("bhnd,bhmd->bhnm", q, k) / math.sqrt(d_k)
    n = scores.shape[-1]
    if attention_type == "softmax":
        if mask is not None:
            scores = torch.where(mask == 0, -1e9, scores)
        p = torch.softmax(scores, dim=-1)
    else:  # 'fourier', 'integral', 'local': scores / seq_len
        if mask is not None:
            scores = torch.where(mask == 0, 0.0, scores)
        p = scores / n
    return torch.einsum("bhnm,bhmd->bhnd", p, v), p


def linear_attention(q, k, v, attention_type="galerkin"):
    """Softmax-free Q (K^T V) / n (attention_layers.py:673-697)."""
    n = q.shape[-2]
    if attention_type in ("linear", "global"):
        q = torch.softmax(q, dim=-1)
        k = torch.softmax(k, dim=-2)
    kv = torch.einsum("bhnd,bhne->bhde", k, v) / n
    return torch.einsum("bhnd,bhde->bhne", q, kv), kv


def causal_linear_attention(q, k, v, eps=1e-7):
    """Causal linearized attention through cumulative sums
    (attention_layers.py:699-724)."""
    n = q.shape[-2]
    k = k / n
    kv_cum = torch.cumsum(torch.einsum("bhnd,bhne->bhnde", k, v), dim=2)
    k_cum = torch.cumsum(k, dim=2)
    d_inv = 1.0 / torch.einsum("bhnd,bhnd->bhn", k_cum + eps, q)
    return torch.einsum("bhnd,bhnde,bhn->bhne", q, kv_cum, d_inv), kv_cum


def freq_attention(q, k, v, attention_type="fourier", modes=16):
    """Attention in truncated rfft space over the token axis
    (attention_layers.py:580-633): a plain (not conjugated) complex
    product, as the reference's att_complex_matmul_1d."""
    n = q.shape[-2]
    d_k = q.shape[-1]

    def to_freq(x):
        return torch.fft.rfft(x, n=n, dim=-2, norm="ortho")[..., :modes, :]

    qf, kf, vf = to_freq(q), to_freq(k), to_freq(v)
    scores = torch.einsum("bhnd,bhmd->bhnm", qf, kf) / math.sqrt(d_k)
    if attention_type == "softmax":
        p = torch.softmax(scores.abs(), dim=-1).to(scores.dtype)
    else:
        p = scores / n
    outf = torch.einsum("bhnm,bhmd->bhnd", p, vf)
    return torch.fft.irfft(outf, n=n, dim=-2, norm="ortho"), p


def diag_dominant_init_(linear: nn.Linear, generator=None,
                        xavier_gain: float = 1e-2,
                        diagonal_weight: float = 1e-2) -> nn.Linear:
    """Xavier-uniform of gain `xavier_gain` (flax's variance_scaling
    fan_avg uniform) plus `diagonal_weight` on the diagonal, zero bias:
    the reference's attention-projection init (attention_layers.py:919-932)
    that keeps Q/K/V near the identity at start."""
    out_f, in_f = linear.weight.shape
    limit = math.sqrt(3.0 * xavier_gain / ((in_f + out_f) / 2.0))
    w = linear.weight
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)
        if diagonal_weight > 0:
            w.add_(diagonal_weight * torch.eye(out_f, in_f, dtype=w.dtype,
                                               device=w.device))
        linear.bias.zero_()
    return linear


class SpectralConv1dToken(nn.Module):
    """Linear residual + 1-D spectral conv over the token axis + SiLU: the
    Q/K/V projection of SimpleAttention (attention_layers.py:1057).
    Weight `w` {'mm2': (2, modes, in, out)}; the conv takes the plain
    route (torch.fft and a complex einsum) on every device."""

    def __init__(self, in_dim: int, out_dim: int, modes: int = 16,
                 dropout: float = 0.1, activation: str = "silu",
                 generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        self.modes = modes
        self.dropout = dropout
        self.act = F.silu if activation == "silu" else F.relu
        self.linear = diag_dominant_init_(
            nn.Linear(in_dim, out_dim, **factory), generator)
        self.w = _as_parameters(factorized.init_factorized(
            generator, (in_dim, out_dim, modes), "dense",
            std=1.0 / (in_dim * out_dim), **factory))

    def forward(self, x, deterministic: bool = True):
        res = self.linear(x)
        if self.dropout > 0 and not deterministic:
            x = F.dropout(x, self.dropout, training=True)
        if x.shape[-2] // 2 + 1 < self.modes:
            raise ValueError(
                f"SpectralConv1dToken: {x.shape[-2]} tokens hold fewer than "
                f"its {self.modes} modes")
        conv = fourier.spectral_conv_nd(x, [_as_weight(self.w)],
                                        (self.modes,), fft_norm="ortho")
        return self.act(conv + res)


class SimpleAttention(nn.Module):
    """Multi-head attention whose projections are token spectral convs,
    with per-head LayerNorm of K/V (or Q/K) when `norm`
    (attention_layers.py:773).  `pos_dim` > 0 with `with_pos`: the call
    takes `pos` (B, N, pos_dim), concatenated to every head, and an `fc`
    back to `d_model`."""

    def __init__(self, n_head: int, d_model: int,
                 attention_type: str = "fourier", pos_dim: int = 1,
                 dropout: float = 0.1, norm: bool = False,
                 norm_eps: float = 1e-5, with_pos: bool = False,
                 generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} is no multiple of n_head "
                             f"{n_head}")
        self.n_head = n_head
        self.d_k = d_model // n_head
        self.attention_type = attention_type
        self.norm = norm
        self.norm_eps = norm_eps
        self.pos_dim = pos_dim if with_pos else 0
        for name in ("proj_q", "proj_k", "proj_v"):
            self.add_module(name, SpectralConv1dToken(
                d_model, d_model, dropout=dropout, generator=generator,
                **factory))
        if norm:
            pair = ("norm_K", "norm_V") if attention_type in (
                "linear", "galerkin", "global") else ("norm_K", "norm_Q")
            for name in pair:
                setattr(self, f"{name}_scale", nn.Parameter(
                    torch.ones((n_head, 1, self.d_k), **factory)))
                setattr(self, f"{name}_bias", nn.Parameter(
                    torch.zeros((n_head, 1, self.d_k), **factory)))
        if self.pos_dim > 0:
            self.fc = layers.dense(n_head * (self.d_k + self.pos_dim),
                                   d_model, generator, **factory)

    def _head_norm(self, x, name):
        # per-head LayerNorm over the feature dim, population variance
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        xn = (x - mean) / torch.sqrt(var + self.norm_eps)
        return xn * getattr(self, f"{name}_scale") \
            + getattr(self, f"{name}_bias")

    def forward(self, query, key, value, pos=None, mask=None, weight=None,
                deterministic: bool = True):
        bsz = query.shape[0]
        if weight is not None:
            query, key = weight * query, weight * key

        def project(x, name):
            y = getattr(self, name)(x, deterministic=deterministic)
            return y.reshape(bsz, -1, self.n_head, self.d_k).transpose(1, 2)

        q, k, v = (project(query, "proj_q"), project(key, "proj_k"),
                   project(value, "proj_v"))
        if self.norm:
            k = self._head_norm(k, "norm_K")
            if self.attention_type in ("linear", "galerkin", "global"):
                v = self._head_norm(v, "norm_V")
            else:
                q = self._head_norm(q, "norm_Q")
        use_pos = pos is not None and self.pos_dim > 0
        if pos is not None and not use_pos:
            raise ValueError("SimpleAttention: a `pos` needs pos_dim > 0 and "
                             "with_pos=True at construction")
        if use_pos:
            p = pos[:, None].expand(bsz, self.n_head, *pos.shape[1:])
            q, k, v = (torch.cat([p, t], dim=-1) for t in (q, k, v))

        t = self.attention_type
        if t in ("linear", "galerkin", "global"):
            x, attn = linear_attention(q, k, v, t)
        elif t == "causal":
            x, attn = causal_linear_attention(q, k, v)
        elif t == "freq":
            x, attn = freq_attention(q, k, v)
        elif t in ("fourier", "integral", "local") and mask is None:
            # (Q K^T / (sqrt(d) n)) V with no softmax between the products
            # is Q (K^T V) / (sqrt(d) n): O(N d^2), no N x N scores
            dk, n = q.shape[-1], q.shape[-2]
            kv = torch.einsum("bhnd,bhne->bhde", k, v)
            x = torch.einsum("bhnd,bhde->bhne", q, kv) / (math.sqrt(dk) * n)
            attn = kv
        else:
            x, attn = attention(q, k, v, t, mask=mask)
        out = x.transpose(1, 2).reshape(bsz, -1, x.shape[1] * x.shape[-1])
        if use_pos:
            out = self.fc(out)
        return out, attn


class FeedForward(nn.Module):
    """Two-layer MLP (attention_layers.py:971)."""

    def __init__(self, in_dim: int, dim_feedforward: int = 1024,
                 out_dim: Optional[int] = None, activation: str = "relu",
                 dropout: float = 0.1, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        self.act = _ACT[activation]
        self.dropout = dropout
        self.lr1 = layers.dense(in_dim, dim_feedforward, generator, **factory)
        self.lr2 = layers.dense(dim_feedforward, out_dim or in_dim,
                                generator, **factory)

    def forward(self, x, deterministic: bool = True):
        x = self.act(self.lr1(x))
        if self.dropout > 0 and not deterministic:
            x = F.dropout(x, self.dropout, training=True)
        return self.lr2(x)


def positional_encoding(n: int, d_model: int, dtype=torch.float64,
                        device=None):
    """Sinusoidal positional encoding (attention_layers.py:46-63),
    computed in numpy float64."""
    pos = np.arange(n)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    pe = np.zeros((n, d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: (d_model - d_model // 2)])
    return torch.as_tensor(pe, dtype=dtype, device=device)


class SimpleTransformerEncoderLayer(nn.Module):
    """attn -> residual [+LN] -> FFN -> residual [+LN]
    (transformer_models.py:30-150).  Both LayerNorms take eps 1e-5 (torch's
    default, which the reference uses)."""

    def __init__(self, d_model: int = 96, n_head: int = 2, pos_dim: int = 1,
                 dim_feedforward: int = 512, attention_type: str = "fourier",
                 layer_norm: bool = True, attn_norm: Optional[bool] = None,
                 pos_emb: bool = False, residual_type: str = "add",
                 activation_type: str = "relu", dropout: float = 0.1,
                 ffn_dropout: Optional[float] = None, norm_eps: float = 1e-5,
                 with_pos: bool = False, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        self.d_model = d_model
        self.pos_emb = pos_emb
        self.layer_norm = layer_norm
        self.residual_type = residual_type
        self.dropout = dropout
        self.attn = SimpleAttention(
            n_head, d_model, attention_type, pos_dim=pos_dim,
            dropout=dropout,
            norm=(not layer_norm) if attn_norm is None else attn_norm,
            with_pos=with_pos, generator=generator, **factory)
        if layer_norm:
            self.layer_norm1 = nn.LayerNorm(d_model, eps=norm_eps, **factory)
            self.layer_norm2 = nn.LayerNorm(d_model, eps=norm_eps, **factory)
        self.ff = FeedForward(d_model, dim_feedforward,
                              activation=activation_type,
                              dropout=ffn_dropout or dropout,
                              generator=generator, **factory)

    def _drop(self, x, deterministic):
        if self.dropout > 0 and not deterministic:
            return F.dropout(x, self.dropout, training=True)
        return x

    def forward(self, x, pos=None, weight=None, deterministic: bool = True):
        if self.pos_emb:
            x = x + positional_encoding(x.shape[1], self.d_model, x.dtype,
                                        x.device)[None]
        att, attn_weight = self.attn(x, x, x, pos=pos, weight=weight,
                                     deterministic=deterministic)
        att = self._drop(att, deterministic)
        if self.residual_type in ("add", "plus") or self.residual_type is None:
            x = x + att
        else:
            x = x - att
        if self.layer_norm:
            x = self.layer_norm1(x)
        x = x + self._drop(self.ff(x, deterministic=deterministic),
                           deterministic)
        if self.layer_norm:
            x = self.layer_norm2(x)
        return x, attn_weight


class BulkRegressor(nn.Module):
    """Per-target bulk sequence regressor (attention_layers.py:1007):
    (B, N, C) -> (B, pred_len, n_targets)."""

    def __init__(self, in_dim: int, seq_len: int, n_targets: int,
                 pred_len: int, sort_output: bool = False, generator=None,
                 device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        self.sort_output = sort_output
        self.linear = layers.dense(in_dim, n_targets, generator, **factory)
        self.regressor = layers.dense(seq_len, pred_len, generator,
                                      **factory)

    def forward(self, x):
        out = self.regressor(self.linear(x).transpose(-1, -2))
        out = out.transpose(-1, -2)
        return torch.sort(out, dim=-1).values if self.sort_output else out


class _DenseOrGraph:
    """The Dense route of a graph feature lift: flax's `Dense` leaves
    `kernel` (in, out) and `bias` held as they are, beside the graph
    layers, and the rule that picks the route (JAX
    `models/transformer.py:362-371`: the graph layers when an edge is
    given)."""

    def _add_dense(self, in_features, out_features, generator, factory):
        kernel = torch.empty((in_features, out_features), **factory)
        kernel.normal_(0.0, in_features ** -0.5, generator=generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(out_features, **factory))

    def dense(self, x):
        return x @ self.kernel + self.bias


class GCNFeatExtract(_DenseOrGraph, GCN):
    """`feat_extract` of `feat_extract_type='gcn'`: the GCN layers
    `gc{i}` with an edge, the Dense without one."""
    jax_alternatives = (("kernel", "bias"), ("gc",))

    def __init__(self, in_features, out_features, num_layers=2,
                 generator=None, **factory):
        super().__init__(in_features, out_features, num_layers,
                         generator=generator, **factory)
        self._add_dense(in_features, out_features, generator, factory)

    def forward(self, x, edge=None, deterministic: bool = True,
                generator=None):
        return self.dense(x) if edge is None else super().forward(x, edge)


class GATFeatExtract(_DenseOrGraph, GAT):
    """`feat_extract` of `feat_extract_type='gat'`: the GAT layers
    `gat{i}` with an edge (dropout from `generator` when not
    deterministic), the Dense without one."""
    jax_alternatives = (("kernel", "bias"), ("gat",))

    def __init__(self, in_features, out_features, num_layers=2,
                 generator=None, **factory):
        super().__init__(in_features, out_features, num_layers,
                         generator=generator, **factory)
        self._add_dense(in_features, out_features, generator, factory)

    def forward(self, x, edge=None, deterministic: bool = True,
                generator=None):
        if edge is None:
            return self.dense(x)
        return super().forward(x, edge, deterministic=deterministic,
                               generator=generator)


_GRAPH_FEAT = {"gcn": GCNFeatExtract, "gat": GATFeatExtract}


class SimpleTransformer(nn.Module):
    """Sequence-to-field operator transformer (transformer_models.py:506):
    (T, H, W) flattened to tokens -> feature lift -> `num_encoder_layers`
    encoder layers -> spectral regressor (decoder 'ifft') on each
    timestep's plane.  node (B, T, H, W, D) -> (B, T, H, W, n_targets).
    The regressor runs `num_regressor_layers` 2-D spectral convs per
    forward, on B x T planes."""

    def __init__(self, node_feats: int = 1, n_hidden: int = 96,
                 n_head: int = 2, n_targets: int = 1, pos_dim: int = 1,
                 freq_dim: int = 48, fourier_modes: int = 12,
                 num_encoder_layers: int = 8, num_regressor_layers: int = 3,
                 attention_type: str = "fourier", layer_norm: bool = True,
                 spacial_residual: bool = False,
                 dim_feedforward: Optional[int] = None,
                 dropout: float = 0.05, decoder_dropout: float = 0.0,
                 regressor_activation: str = "silu",
                 feat_extract_type: Optional[str] = None,
                 num_feat_layers: int = 2, with_pos: bool = False,
                 conv_backend: str = "auto",
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.n_hidden = n_hidden
        self.n_targets = n_targets
        self.num_encoder_layers = num_encoder_layers
        self.spacial_residual = spacial_residual
        self.feat_extract_type = feat_extract_type
        if feat_extract_type in _GRAPH_FEAT:
            self.feat_extract = _GRAPH_FEAT[feat_extract_type](
                node_feats, n_hidden, num_feat_layers, generator=generator,
                **factory)
        elif feat_extract_type is None:
            self.feat_extract = layers.dense(node_feats, n_hidden,
                                             generator, **factory)
        else:
            raise ValueError(f"Unknown feat_extract_type "
                             f"{feat_extract_type!r}")
        for i in range(num_encoder_layers):
            self.add_module(f"encoder{i}", SimpleTransformerEncoderLayer(
                d_model=n_hidden, n_head=n_head, pos_dim=pos_dim,
                dim_feedforward=dim_feedforward or 2 * n_hidden,
                attention_type=attention_type, layer_norm=layer_norm,
                dropout=dropout, with_pos=with_pos, generator=generator,
                **factory))
        self.regressor = SpectralRegressor(
            n_hidden=n_hidden, freq_dim=freq_dim, out_dim=n_targets,
            modes=fourier_modes, num_spectral_layers=num_regressor_layers,
            activation=regressor_activation, dropout=decoder_dropout,
            conv_backend=conv_backend, generator=generator, **factory)

    def forward(self, node, v_plane=None, pos=None, grid=None, weight=None,
                edge=None, deterministic: bool = True, generator=None):
        """node: (B, T, H, W, D) -> (B, T, H, W, n_targets).  `edge`
        (B, N, N), N = T H W, feeds a 'gcn' / 'gat' feature lift, and
        `generator` draws the GAT's attention dropout."""
        B, T, H, W, D = node.shape
        x = node.reshape(B, -1, D)
        if self.feat_extract_type is None:
            x = self.feat_extract(x)
        else:
            x = self.feat_extract(x, edge, deterministic=deterministic,
                                  generator=generator)
        res = x
        for i in range(self.num_encoder_layers):
            x, _ = getattr(self, f"encoder{i}")(x, pos=pos, weight=weight,
                                                deterministic=deterministic)
        if self.spacial_residual:
            x = res + x
        x = self.regressor(x.reshape(B * T, H, W, self.n_hidden),
                           deterministic=deterministic)
        return x.reshape(B, T, H, W, self.n_targets)


def _resize(x, size, antialias):
    """`jax.image.resize(x, (B, *size, C), 'bilinear')` for channels-last
    x: half-pixel centres, and a triangle widened by the scale when it
    shrinks (antialias), which is torch's bilinear with `antialias=True`
    and `align_corners=False`."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                      align_corners=False, antialias=antialias)
    return y.permute(0, 2, 3, 1)


class Conv2dResBlock(nn.Module):
    """conv -> act -> conv + residual (attention_layers.py:132);
    channels-last."""

    def __init__(self, in_dim: int, out_dim: int, activation: str = "silu",
                 generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        self.act = {"relu": F.relu, "silu": F.silu}[activation]
        if in_dim != out_dim:
            self.proj = layers.dense(in_dim, out_dim, generator, **factory)
        self.conv1 = layers.flax_init_(
            nn.Conv2d(in_dim, out_dim, 3, padding=1, **factory), generator)
        self.conv2 = layers.flax_init_(
            nn.Conv2d(out_dim, out_dim, 3, padding=1, **factory), generator)

    def forward(self, x):
        res = self.proj(x) if hasattr(self, "proj") else x
        h = x.permute(0, 3, 1, 2)
        h = self.conv2(self.act(self.conv1(h))).permute(0, 2, 3, 1)
        return self.act(h + res)


class DownScaler(nn.Module):
    """Conv-res-block + bilinear down-scaling (transformer_models.py:394)."""

    def __init__(self, in_dim: int, out_dim: int, scale_factor: float = 0.5,
                 generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        self.scale_factor = scale_factor
        self.conv = Conv2dResBlock(in_dim, out_dim, generator=generator,
                                   **factory)

    def forward(self, x):
        x = self.conv(x)
        H, W = x.shape[1:3]
        size = (int(round(H * self.scale_factor)),
                int(round(W * self.scale_factor)))
        return _resize(x, size, antialias=True)


class UpScaler(nn.Module):
    """Bilinear up-scaling + conv (transformer_models.py:444)."""

    def __init__(self, in_dim: int, out_dim: int, scale_factor: float = 2.0,
                 generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = layers.factory(device, dtype)
        self.scale_factor = scale_factor
        self.conv = layers.flax_init_(
            nn.Conv2d(in_dim, out_dim, 3, padding=1, **factory), generator)

    def forward(self, x):
        H, W = x.shape[1:3]
        size = (int(round(H * self.scale_factor)),
                int(round(W * self.scale_factor)))
        x = _resize(x, size, antialias=True).permute(0, 3, 1, 2)
        return F.silu(self.conv(x)).permute(0, 2, 3, 1)


class FourierTransformer2D(nn.Module):
    """2-D encoder-decoder transformer: downscale -> encoder stack ->
    upscale -> spectral regressor (transformer_models.py:672).
    node (B, H, W, D) -> (B, H, W, n_targets)."""

    def __init__(self, node_feats: int = 3, n_hidden: int = 96,
                 n_head: int = 2, n_targets: int = 1, pos_dim: int = 2,
                 freq_dim: int = 48, fourier_modes: int = 12,
                 num_encoder_layers: int = 4, num_regressor_layers: int = 2,
                 attention_type: str = "galerkin",
                 downscale_factor: float = 0.5, dropout: float = 0.05,
                 with_pos: bool = False, conv_backend: str = "auto",
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.n_hidden = n_hidden
        self.num_encoder_layers = num_encoder_layers
        self.downscaler = DownScaler(node_feats, n_hidden, downscale_factor,
                                     generator=generator, **factory)
        for i in range(num_encoder_layers):
            self.add_module(f"encoder{i}", SimpleTransformerEncoderLayer(
                d_model=n_hidden, n_head=n_head, pos_dim=pos_dim,
                dim_feedforward=2 * n_hidden, attention_type=attention_type,
                dropout=dropout, with_pos=with_pos, generator=generator,
                **factory))
        self.upscaler = UpScaler(n_hidden, n_hidden, 1.0 / downscale_factor,
                                 generator=generator, **factory)
        self.regressor = SpectralRegressor(
            n_hidden=n_hidden, freq_dim=freq_dim, out_dim=n_targets,
            modes=fourier_modes, num_spectral_layers=num_regressor_layers,
            conv_backend=conv_backend, generator=generator, **factory)

    def forward(self, node, pos=None, grid=None, weight=None,
                deterministic: bool = True):
        B, H, W, _ = node.shape
        x = self.downscaler(node)
        h, w = x.shape[1:3]
        x = x.reshape(B, -1, self.n_hidden)
        for i in range(self.num_encoder_layers):
            x, _ = getattr(self, f"encoder{i}")(x, pos=pos,
                                                deterministic=deterministic)
        x = self.upscaler(x.reshape(B, h, w, self.n_hidden))
        if x.shape[1] != H or x.shape[2] != W:
            x = _resize(x, (H, W), antialias=True)
        return self.regressor(x, deterministic=deterministic)


FourierTransformer2DLite = FourierTransformer2D
