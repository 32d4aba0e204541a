"""FNO family: N-D Fourier Neural Operator, Tucker-factorized TFNO variants.

Counterpart of `pde_policylearning_tpu/models/fno.py` (reference:
neuralop/models/tfno.py:42 (FNO), :222/342/467 (FNO1d/2d/3d), :594-624
(TFNO partials); neuralop/models/fno_block.py:123-170 (FNOBlocks)).

Layout: channels-last (B, d1..dN, C); weights stay per layer (or one joint
tensor).  Submodule and parameter names follow the flax tree
(`lifting.fc`, `fno_blocks.convs.w{i}`, `fno_blocks.fno_skip{i}.conv`,
`projection.fc1`), see `utils/transplant.py`.

The reference's post-activation condition (fno_block.py:152),
`if not self.preactivation and (self.mlp is not None) or (index <
(self.n_layers - index))`, fires on unintended layers through operator
precedence and `n_layers - index`; as in the JAX package the intended rule
is the default (in post-activation mode the non-linearity follows
conv+skip whenever an MLP follows or this is not the last layer), and
`reference_act_quirk` reproduces the reference verbatim.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch import nn

from ..ops import padding as padding_ops
from ..ops import resample as resample_ops
from ..utils.device import resolve_device
from . import layers
from .spectral_layers import SpectralConv, _norm_tuple


class FNOBlocks(nn.Module):
    """`n_layers` Fourier layers sharing one SpectralConv module.

    Each layer: [norm] -> spectral conv + skip -> act [-> MLP + skip -> act],
    with optional resnet-style preactivation ordering (fno_block.py:123-170).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 n_modes: Union[int, Sequence[int]], n_layers: int = 1,
                 output_scaling_factor: Optional[Any] = None,
                 use_mlp: bool = False, mlp_dropout: float = 0.0,
                 mlp_expansion: float = 0.5,
                 non_linearity: Callable = layers.gelu,
                 norm: Optional[str] = None,
                 ada_in_features: Optional[int] = None,
                 preactivation: bool = False, fno_skip: str = "linear",
                 mlp_skip: str = "soft-gating", separable: bool = False,
                 factorization: Optional[str] = None, rank: float = 1.0,
                 joint_factorization: bool = False,
                 implementation: str = "factorized",
                 fft_norm: str = "forward",
                 incremental_n_modes: Optional[Sequence[int]] = None,
                 conv_backend: str = "auto",
                 reference_act_quirk: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        factory = dict(device=resolve_device(device), dtype=dtype)
        modes = _norm_tuple(n_modes)
        self.n_dim = len(modes)
        self.n_layers = n_layers
        self.use_mlp = use_mlp
        self.non_linearity = non_linearity
        self.norm = norm
        self.preactivation = preactivation
        self.reference_act_quirk = reference_act_quirk
        osf = output_scaling_factor
        if osf is not None:
            if isinstance(osf, (float, int)):
                osf = [[float(osf)] * self.n_dim] * n_layers
            elif isinstance(osf[0], (float, int)):
                osf = [[float(s)] * self.n_dim for s in osf]
        self._osf = osf

        self.convs = SpectralConv(
            in_channels, out_channels, modes, n_layers=n_layers,
            separable=separable, factorization=factorization, rank=rank,
            implementation=implementation,
            joint_factorization=joint_factorization, fft_norm=fft_norm,
            output_scaling_factor=osf,
            incremental_n_modes=incremental_n_modes, backend=conv_backend,
            generator=generator, **factory)
        for i in range(n_layers):
            self.add_module(f"fno_skip{i}", layers.SkipConnection(
                in_channels, out_channels, fno_skip, **factory))
            if use_mlp:
                self.add_module(f"mlp{i}", layers.ChannelMLP(
                    out_channels, out_channels=out_channels,
                    hidden_channels=int(round(out_channels * mlp_expansion)),
                    dropout=mlp_dropout, non_linearity=non_linearity,
                    **factory))
                self.add_module(f"mlp_skip{i}", layers.SkipConnection(
                    in_channels, out_channels, mlp_skip, **factory))
        n_norms = n_layers * (2 if use_mlp else 1)
        if norm == "group_norm":
            for i in range(n_norms):
                self.add_module(f"norm{i}", layers.GroupNorm(out_channels,
                                                             **factory))
        elif norm == "ada_in":
            for i in range(n_norms):
                self.add_module(f"norm{i}", layers.AdaIN(
                    ada_in_features, out_channels, **factory))
        elif norm not in (None, "instance_norm"):
            raise ValueError(
                f"Got norm={norm} but expected None or one of "
                "[instance_norm, group_norm, ada_in]")

    def _apply_norm(self, x, norm_index, ada_embedding):
        if self.norm is None:
            return x
        if self.norm == "instance_norm":
            return layers.instance_norm(x)
        mod = getattr(self, f"norm{norm_index}")
        if self.norm == "ada_in":
            return mod(x, ada_embedding)
        return mod(x)

    def _resample(self, x, index):
        if self._osf is None:
            return x
        return resample_ops.resample(x, self._osf[index],
                                     list(range(1, 1 + self.n_dim)))

    def forward(self, x, index: int = 0, ada_embedding=None,
                deterministic: bool = True):
        n_norms = 2 if self.use_mlp else 1
        act = self.non_linearity
        if self.preactivation:
            x = act(x)
            x = self._apply_norm(x, n_norms * index, ada_embedding)

        x_skip_fno = self._resample(getattr(self, f"fno_skip{index}")(x),
                                    index)
        if self.use_mlp:
            x_skip_mlp = self._resample(
                getattr(self, f"mlp_skip{index}")(x), index)

        x_fno = self.convs(x, index)
        if not self.preactivation:
            x_fno = self._apply_norm(x_fno, n_norms * index, ada_embedding)
        x = x_fno + x_skip_fno

        last_layer = index == self.n_layers - 1
        if self.reference_act_quirk:
            # fno_block.py:152 verbatim: `not prea and mlp` binds before
            # `or`, and the second disjunct is index < n_layers - index
            if (not self.preactivation and self.use_mlp) or \
                    (index < self.n_layers - index):
                x = act(x)
        elif not self.preactivation and (self.use_mlp or not last_layer):
            x = act(x)

        if self.use_mlp:
            if self.preactivation:
                if not last_layer:
                    x = act(x)
                x = self._apply_norm(x, n_norms * index + 1, ada_embedding)
            x = getattr(self, f"mlp{index}")(
                x, deterministic=deterministic) + x_skip_mlp
            if not self.preactivation:
                x = self._apply_norm(x, n_norms * index + 1, ada_embedding)
                if not last_layer:
                    x = act(x)
        return x


class FNO(nn.Module):
    """N-Dimensional Fourier Neural Operator (tfno.py:42).

    lift -> [domain pad] -> n_layers x FNOBlock -> [unpad] -> project.
    Dimensionality inferred from len(n_modes).  The parameters live on
    `device` (None: the card) in `dtype`; with a `generator` they are all
    drawn from it (spectral weights as in the reference, linear layers by
    `layers.init_linears_`), which makes a model a function of a seed.
    """

    def __init__(self, n_modes: Sequence[int], hidden_channels: int,
                 in_channels: int = 3, out_channels: int = 1,
                 lifting_channels: int = 256,
                 projection_channels: int = 256, n_layers: int = 4,
                 output_scaling_factor: Optional[Any] = None,
                 incremental_n_modes: Optional[Sequence[int]] = None,
                 use_mlp: bool = False, mlp_dropout: float = 0.0,
                 mlp_expansion: float = 0.5,
                 non_linearity: Callable = layers.gelu,
                 norm: Optional[str] = None,
                 ada_in_features: Optional[int] = None,
                 preactivation: bool = False, fno_skip: str = "linear",
                 mlp_skip: str = "soft-gating", separable: bool = False,
                 factorization: Optional[str] = None, rank: float = 1.0,
                 joint_factorization: bool = False,
                 implementation: str = "factorized",
                 domain_padding: Optional[float] = None,
                 domain_padding_mode: str = "one-sided",
                 fft_norm: str = "forward", conv_backend: str = "auto",
                 reference_act_quirk: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.n_dim = len(_norm_tuple(n_modes))
        self.n_layers = n_layers
        self.domain_padding = domain_padding
        self.domain_padding_mode = domain_padding_mode
        self.output_scaling_factor = output_scaling_factor
        osf = output_scaling_factor
        if osf is not None and not joint_factorization:
            if isinstance(osf, (float, int)):
                osf = [osf] * n_layers
        self.lifting = layers.Lifting(in_channels, hidden_channels,
                                      **factory)
        self.fno_blocks = FNOBlocks(
            in_channels=hidden_channels, out_channels=hidden_channels,
            n_modes=n_modes, n_layers=n_layers, output_scaling_factor=osf,
            use_mlp=use_mlp, mlp_dropout=mlp_dropout,
            mlp_expansion=mlp_expansion, non_linearity=non_linearity,
            norm=norm, ada_in_features=ada_in_features,
            preactivation=preactivation, fno_skip=fno_skip,
            mlp_skip=mlp_skip, separable=separable,
            factorization=factorization, rank=rank,
            joint_factorization=joint_factorization,
            implementation=implementation, fft_norm=fft_norm,
            incremental_n_modes=incremental_n_modes,
            conv_backend=conv_backend,
            reference_act_quirk=reference_act_quirk, generator=generator,
            **factory)
        self.projection = layers.Projection(
            hidden_channels, out_channels, projection_channels,
            non_linearity=non_linearity, **factory)
        if generator is not None:
            layers.init_linears_(self, generator)

    def forward(self, x, deterministic: bool = True, ada_embedding=None):
        """x: (B, d1..dN, in_channels) -> (B, e1..eN, out_channels)."""
        x = self.lifting(x)
        padded = self.domain_padding is not None and self.domain_padding > 0
        if padded:
            x = padding_ops.pad_domain(x, self.domain_padding,
                                       self.domain_padding_mode)
        for i in range(self.n_layers):
            x = self.fno_blocks(x, i, ada_embedding=ada_embedding,
                                deterministic=deterministic)
        if padded:
            x = padding_ops.unpad_domain(
                x, self.domain_padding, self.domain_padding_mode,
                self.output_scaling_factor)
        return self.projection(x)


def FNO1d(n_modes_height, hidden_channels, **kwargs):
    """1D FNO (tfno.py:222)."""
    return FNO(n_modes=(n_modes_height,), hidden_channels=hidden_channels,
               **kwargs)


def FNO2d(n_modes_height, n_modes_width, hidden_channels, **kwargs):
    """2D FNO (tfno.py:342)."""
    return FNO(n_modes=(n_modes_height, n_modes_width),
               hidden_channels=hidden_channels, **kwargs)


def FNO3d(n_modes_height, n_modes_width, n_modes_depth, hidden_channels,
          **kwargs):
    """3D FNO (tfno.py:467)."""
    return FNO(n_modes=(n_modes_height, n_modes_width, n_modes_depth),
               hidden_channels=hidden_channels, **kwargs)


# Tucker-factorized variants (tfno.py:594-624 partialclass equivalents)
def TFNO(**kw):
    kw.setdefault("factorization", "tucker")
    return FNO(**kw)


def TFNO1d(n_modes_height, hidden_channels, **kw):
    kw.setdefault("factorization", "tucker")
    return FNO1d(n_modes_height, hidden_channels, **kw)


def TFNO2d(n_modes_height, n_modes_width, hidden_channels, **kw):
    kw.setdefault("factorization", "tucker")
    return FNO2d(n_modes_height, n_modes_width, hidden_channels, **kw)


def TFNO3d(n_modes_height, n_modes_width, n_modes_depth, hidden_channels,
           **kw):
    kw.setdefault("factorization", "tucker")
    return FNO3d(n_modes_height, n_modes_width, n_modes_depth,
                 hidden_channels, **kw)
