"""Plain reference of one control step of the full-field optimal-observer
(run_control.py:186-224 of the paper's code), independent of the program.

Opposition control on the state gives both walls' actuation.  The top
wall's is the start of `opt_steps` steps of plain Adam (`pino.adam_step`,
a fresh Adam: both moments and the step count zero) on the raw action v,
minimizing ||decode(observer(encode(v), Re))|| + reg ||v||: the observer
is the PINO plane model of `pino.plane_model` on the encoded action as one
(1, Nx, Nz, 1, 1) sample, every predicted plane decoded by the top wall's
(Nx, Nz) statistics.  The action after the last step, less its plane mean
(zero net flux), is the top wall's.  TF32 stays off in the library's own
products, so that only `precision.tf32` rounds.
"""
from __future__ import annotations

import torch

from . import channel as ch
from . import pino as rpino

# the normalizer's guard against a zero deviation (libs/utilities3.py:74)
EPS = 1e-8


def encode(x, mean, std):
    return (x - mean) / (std + EPS)


def decode(x, mean, std):
    return x * (std + EPS) + mean


def objective(weights, v, mean, std, re, *, reg_weight: float, **model_kw):
    """The descent's objective of the action v (Nx, Nz)."""
    Nx, Nz = v.shape
    x = encode(v, mean, std).reshape(1, Nx, Nz, 1, 1)
    pred = rpino.plane_model(weights, x, re, **model_kw)  # (1, X, Z, 1, P)
    planes = pred[0, :, :, 0].permute(2, 0, 1)            # (P, X, Z)
    return (torch.linalg.vector_norm(decode(planes, mean, std))
            + reg_weight * torch.linalg.vector_norm(v))


def control_step(weights, V, mean, std, *, detect_plane: int, re: float,
                 opt_steps: int, lr: float, reg_weight: float, n_layers: int,
                 modes, pad_ratio, max_re: float):
    """One control step from the state's V (1, Nx, Ny, Nz): (op1, op2),
    each (1, Nx, Nz), in V's dtype; `weights`, `mean` and `std` in that
    dtype too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    op1, op2 = ch.opposition(V, detect_plane)
    re_t = torch.full((1,), re, dtype=V.dtype, device=V.device)
    model_kw = dict(n_layers=n_layers, modes=tuple(modes),
                    pad_ratio=pad_ratio, max_re=max_re)
    p = {"v": op2[0].clone()}
    m = {"v": torch.zeros_like(p["v"])}
    s = {"v": torch.zeros_like(p["v"])}
    for t in range(1, opt_steps + 1):
        leaf = p["v"].detach().requires_grad_()
        with torch.enable_grad():
            (g,) = torch.autograd.grad(
                objective(weights, leaf, mean, std, re_t,
                          reg_weight=reg_weight, **model_kw), leaf)
        rpino.adam_step(p, {"v": g}, m, s, t, lr)
    v = p["v"]
    return op1, (v - v.mean())[None]
