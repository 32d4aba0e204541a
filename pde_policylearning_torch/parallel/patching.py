"""Multigrid domain-decomposition patching, its patch batch scattered over
the model group.

Counterpart of `pde_policylearning_tpu/parallel/patching.py` (reference:
neuralop/training/patching.py:8 (MultigridPatching2D), :161
(make_patches)).  The patch functions are pure copies (circular padding by
index arithmetic, window slicing), equal to the JAX functions exactly.
With a mesh, the patch batch is split over the model group by two autograd
Functions, the reference's Megatron-style mappings (mpu/mappings.py:33-96),
which the JAX package leaves to XLA's sharding constraint:
  * scatter: forward keeps this rank's block; backward all-gathers;
  * gather: forward all-gathers; backward keeps this rank's block and does
    not reduce.  Every model rank computes the same loss from the gathered
    output, so a reduce-scatter would make the gradient mp times too large
    (the reference's grad-rescale hook, patching.py:36-38).
The parameters' gradients are then summed over the model group and
averaged over the data group (`mesh.all_reduce_gradients(...,
model_split=True)`): the gradient of the unsharded loss, which is what the
JAX package's pjit computes.

Layout: channels-last (B, H, W, C).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .mesh import MODEL_AXIS, Mesh, axis_slice, gather


def _wrap_index(n: int, p: int, device):
    return torch.arange(-p, n + p, device=device) % n


def _wrap_pad_2d(x, ph, pw):
    """Circular padding of (B, H, W, C) by ph rows and pw columns (any
    width, as numpy's 'wrap' mode)."""
    if ph == 0 and pw == 0:
        return x
    x = x[:, _wrap_index(x.shape[1], ph, x.device)]
    return x[:, :, _wrap_index(x.shape[2], pw, x.device)]


def _windows_2d(x, win_h, win_w, stride_h, stride_w, n_h, n_w):
    """An n_h x n_w grid of (win_h, win_w) windows -> (B * n_h * n_w,
    win_h, win_w, C), batch-major then window row then column, the
    reference's unfold + reshape order (patching.py:198-201)."""
    rows = []
    for i in range(n_h):
        cols = [x[:, i * stride_h:i * stride_h + win_h,
                  j * stride_w:j * stride_w + win_w, :] for j in range(n_w)]
        rows.append(torch.stack(cols, dim=1))
    patches = torch.stack(rows, dim=1)   # (B, n_h, n_w, win_h, win_w, C)
    B, C = x.shape[0], x.shape[-1]
    return patches.reshape(B * n_h * n_w, win_h, win_w, C)


def make_patches(x: torch.Tensor, n, p=0) -> torch.Tensor:
    """(B, H, W, C) -> (B*n1*n2, H/n1 + 2p1, W/n2 + 2p2, C) with circular
    padding (patching.py:161-202)."""
    if isinstance(n, int):
        n = [n, n]
    if isinstance(p, int):
        p = [p, p]
    B, H, W, C = x.shape
    if n[0] <= 1 and n[1] <= 1:
        return _wrap_pad_2d(x, p[0], p[1])
    if H % n[0] != 0 or W % n[1] != 0:
        raise ValueError("Patches must be equally sized")
    ph, pw = H // n[0], W // n[1]
    xp = _wrap_pad_2d(x, p[0], p[1])
    return _windows_2d(xp, ph + 2 * p[0], pw + 2 * p[1], ph, pw, n[0], n[1])


def stitch_patches(x: torch.Tensor, n) -> torch.Tensor:
    """Inverse of make_patches with p=0 (patching.py:77-103)."""
    if isinstance(n, int):
        n = [n, n]
    if n[0] <= 1 and n[1] <= 1:
        return x
    Bn, ph, pw, C = x.shape
    B = Bn // (n[0] * n[1])
    x = x.reshape(B, n[0], n[1], ph, pw, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, n[0] * ph, n[1] * pw, C)


def make_mg_patches(x: torch.Tensor, levels: int,
                    padding_fraction=0) -> torch.Tensor:
    """Patches + per-level coarsened context channels
    (patching.py:105-153).  Output channels = C * (levels + 1)."""
    if levels <= 0:
        return x
    if isinstance(padding_fraction, (int, float)):
        padding_fraction = [padding_fraction, padding_fraction]
    B, H, W, C = x.shape
    pad = [int(round(H * padding_fraction[0])),
           int(round(W * padding_fraction[1]))]
    n = 2 ** levels
    patched = make_patches(x, n=n, p=pad)
    s1 = patched.shape[1] - 2 * pad[0]
    s2 = patched.shape[2] - 2 * pad[1]

    pieces = [patched]
    for level in range(1, levels + 1):
        sub = 2 ** level
        s1_stride = s1 // sub
        s2_stride = s2 // sub
        x_sub = x[:, ::sub, ::sub, :]
        # symmetric circular pad so that n windows of the patch size with
        # the coarse stride cover the subsampled field (patching.py:128-137)
        s1_pad = math.ceil((s1 + (n - 1) * s1_stride
                            - x_sub.shape[1]) / 2.0) + pad[0]
        s2_pad = math.ceil((s2 + (n - 1) * s2_stride
                            - x_sub.shape[2]) / 2.0) + pad[1]
        x_sub = _wrap_pad_2d(x_sub, s1_pad, s2_pad)
        pieces.append(_windows_2d(x_sub, s1 + 2 * pad[0], s2 + 2 * pad[1],
                                  s1_stride, s2_stride, n, n))
    return torch.cat(pieces, dim=-1)


class ScatterToModel(torch.autograd.Function):
    """Forward: this rank's block of the leading axis over the model
    group.  Backward: the blocks' gradients all-gathered."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x[axis_slice(mesh, x.shape[0], MODEL_AXIS)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather(ctx.mesh, g, MODEL_AXIS), None


class GatherFromModel(torch.autograd.Function):
    """Forward: the model group's blocks all-gathered along the leading
    axis.  Backward: this rank's block of the gradient, not reduced (every
    model rank holds the same loss)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather(mesh, x, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return g[axis_slice(mesh, g.shape[0], MODEL_AXIS)].contiguous(), None


class MultigridPatching2D:
    """patch / unpatch with, given a mesh, the patch batch split over the
    model group (patching.py:40-75).  `patch` scatters the model input,
    `unpatch` gathers the model output before cropping and stitching, so
    the loss sees the whole batch on every model rank.  Without stitching,
    the targets are patched too (whole on every rank)."""

    def __init__(self, levels: int = 0, padding_fraction=0,
                 mesh: Optional[Mesh] = None, stitching: bool = True):
        self.levels = levels
        self.skip_padding = (padding_fraction is None
                             or (isinstance(padding_fraction, (int, float))
                                 and padding_fraction <= 0))
        if isinstance(padding_fraction, (int, float)):
            padding_fraction = [padding_fraction, padding_fraction]
        self.padding_fraction = padding_fraction
        self.n_patches = 2 ** levels
        self.mesh = mesh
        self.stitching = stitching
        self._pad = None

    @property
    def model_split(self) -> bool:
        """Whether the model ranks compute disjoint blocks of the patch
        batch (their gradients then sum over the model group)."""
        return (self.mesh is not None and self.mesh.model_group is not None
                and self.levels > 0)

    def patch(self, x, y):
        if self.levels <= 0:
            return x, y
        B, H, W, C = x.shape
        self._pad = [int(round(H * self.padding_fraction[0])),
                     int(round(W * self.padding_fraction[1]))]
        if self.mesh is not None and not self.stitching:
            y = make_patches(y, self.n_patches, 0)
        x = make_mg_patches(x, self.levels, self.padding_fraction)
        if self.model_split:
            x = ScatterToModel.apply(x, self.mesh)
        return x, y

    def unpatch(self, out, y, evaluation: bool = False):
        if self.levels > 0 and self.model_split:
            out = GatherFromModel.apply(out, self.mesh)
        # the JAX function returns the patches unstitched and uncropped
        # when padding_fraction <= 0 (patching.py:159-161); kept
        if self.levels <= 0 or self.skip_padding:
            return out, y
        ph, pw = self._pad
        if ph > 0 or pw > 0:
            out = out[:, ph:out.shape[1] - ph, pw:out.shape[2] - pw, :]
        if self.stitching or evaluation:
            out = stitch_patches(out, self.n_patches)
        return out, y
