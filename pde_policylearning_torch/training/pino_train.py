"""PINO training loops: data and physics-residual losses.

Counterpart of `pde_policylearning_tpu/training/pino_train.py` (reference:
train_pino.py:41-130 (train_ns), libs/pino_utils/train_2d.py:13
(train_2d_operator), :119 (train_2d_burger), train_3d.py:16-250
(mixed_train), eval_3d.py:15 (eval_ns)).  Each loop runs on the data's
device; its losses stay there, one row per iteration, and are read back
once per `log_interval` chunk.  Minibatches are drawn without replacement
(`torch.randperm` from a generator on the data's device).  The optimizer
is torch's Adam, the same update as `optax.adam`, under a per-iteration
`MultiStepLR` where milestones are given (a milestone applies from the
iteration whose count equals it on, as optax's schedule does).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from bisect import bisect_right
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.losses import SimpleLpLoss
from ..ops.pde_losses import (darcy_loss, get_forcing, pino_loss_3d,
                              pino_loss_burgers)
from .optimizers import multistep_lr

_DTYPES = {None: None, "bf16": torch.bfloat16}


def _generator(device, generator) -> torch.Generator:
    return generator if generator is not None else \
        torch.Generator(device=device).manual_seed(0)


def make_optimizer(model: torch.nn.Module, learning_rate: float,
                   milestones=None, gamma: float = 0.5, start_iter: int = 0):
    """Adam over `model`'s parameters and, where `milestones` are given, a
    `MultiStepLR` stepped once per iteration; both placed at iteration
    `start_iter` (the rate `learning_rate * gamma ** #(milestones <=
    start_iter)`).  Returns (optimizer, scheduler or None)."""
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate)
    sched = None
    if milestones is not None:
        sched = multistep_lr(opt, milestones, gamma)
        set_iteration(opt, sched, start_iter)
    return opt, sched


def set_iteration(optimizer, scheduler, count: int) -> None:
    """Put `scheduler` (a `MultiStepLR`) at `count` completed iterations:
    its epoch and the optimizer's rate."""
    scheduler.last_epoch = int(count)
    ms = sorted(scheduler.milestones.elements())
    for group, base in zip(optimizer.param_groups, scheduler.base_lrs):
        group["lr"] = base * scheduler.gamma ** bisect_right(ms, count)


@contextmanager
def cast_parameters(model, compute_dtype):
    """Within the block `model` computes with its parameters cast to
    `compute_dtype` (nothing changes for None): forward, backward and the
    trunk's remat recomputation alike, and the gradient reaches the
    float32 parameters through the casts.  The spectral convolutions
    upcast to float32 around their transforms (`ops/fourier.py:
    _conv_through`, `factorized.as_complex`)."""
    if compute_dtype is None:
        yield
        return
    from torch.nn.utils.stateless import _reparametrize_module
    cast = {n: p.to(compute_dtype) for n, p in model.named_parameters()}
    with _reparametrize_module(model, cast):
        yield


def ns_losses(model, ab, ub, reb, forcing, *, xy_weight=5.0, ic_weight=1.0,
              f_weight=1.0, t_interval=1.0, compute_dtype=None):
    """The composite loss of one batch, (total, data, ic, f): `xy_weight`
    x data rel-L2 + `ic_weight` x IC rel-L2 + `f_weight` x residual
    rel-L2 (train_pino.py:41-130).  Under `compute_dtype` (inside
    `cast_parameters`) the inputs are cast to it and the output back to
    the data's dtype: the residual is always taken on that output; the
    viscosity is 1 / Re as rounded to that dtype, as the JAX function
    computes it."""
    u0 = ab[..., 0, -1]
    if compute_dtype is None:
        out = model(ab, reb)
    else:
        out = model(ab.to(compute_dtype), reb.to(compute_dtype))
    out = out.squeeze(-1).to(ub.dtype)
    lp = SimpleLpLoss(size_average=True)
    data_loss = lp(out, ub)
    re_used = reb if compute_dtype is None else reb.to(compute_dtype)
    visc = 1.0 / re_used.to(ub.dtype)
    loss_ic, loss_f = pino_loss_3d(out, u0, forcing, visc, t_interval)
    total = xy_weight * data_loss + ic_weight * loss_ic + f_weight * loss_f
    return total, data_loss, loss_ic, loss_f


def train_ns(model, data, *, iterations: int = 2000, batch_size: int = 4,
             learning_rate: float = 1e-3, milestones=None,
             gamma: float = 0.5, xy_weight: float = 5.0,
             ic_weight: float = 1.0, f_weight: float = 1.0,
             t_interval: float = 1.0,
             generator: Optional[torch.Generator] = None,
             log_interval: int = 200, eval_data=None, compute_dtype=None,
             accum_steps: int = 1, checkpoint_fn: Optional[Callable] = None,
             optimizer=None, scheduler=None, start_iter: int = 0,
             verbose: bool = True):
    """Kolmogorov-flow PINO pretrain / finetune (train_pino.py:41-130),
    training `model` in place.

    data: (u, a, re) tensors on one device, u (N, S, S, T), a (N, S, S, T,
    4), re (N,).  compute_dtype: None, 'bf16' or a torch dtype, the
    forward's dtype (`cast_parameters`); the parameters, the optimizer and the
    losses stay float32.  accum_steps: each optimizer step averages the
    gradients of `accum_steps` micro-batches of batch_size // accum_steps
    samples, taken one after the other (the full-width config's batch 4
    as 4 x 1 on a 16 GB chip).  optimizer, scheduler: as `make_optimizer`
    gives them (made here when None), at iteration `start_iter` for a
    resumed run.  checkpoint_fn(done, model, optimizer, scheduler) is
    called after every chunk.  Returns the history: per-iteration 'total',
    'data', 'ic', 'f', and 'eval' when `eval_data` is given."""
    u, a, re = data
    n = u.shape[0]
    S = u.shape[1]
    forcing = get_forcing(S, device=u.device, dtype=u.dtype)
    compute_dtype = _DTYPES.get(compute_dtype, compute_dtype)
    if batch_size % accum_steps:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"accum_steps {accum_steps}")
    micro = batch_size // accum_steps
    if optimizer is None:
        optimizer, scheduler = make_optimizer(model, learning_rate,
                                              milestones, gamma, start_iter)
    generator = _generator(u.device, generator)
    weights = dict(xy_weight=xy_weight, ic_weight=ic_weight,
                   f_weight=f_weight, t_interval=t_interval,
                   compute_dtype=compute_dtype)

    def step(row):
        idx = torch.randperm(n, generator=generator,
                             device=u.device)[:batch_size]
        optimizer.zero_grad(set_to_none=True)
        parts = u.new_zeros(4)
        for ib in idx.reshape(accum_steps, micro):
            with cast_parameters(model, compute_dtype):
                losses = ns_losses(model, a[ib], u[ib], re[ib], forcing,
                                   **weights)
                (losses[0] / accum_steps).backward()
            parts += torch.stack([x.detach() for x in losses])
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        row.copy_(parts / accum_steps)

    def on_chunk(done, metrics, seconds):
        if verbose:
            last = metrics[-1]
            print(f"iter {done}/{iterations}: total {last[0]:.4f} "
                  f"data {last[1]:.4f} ic {last[2]:.4f} f {last[3]:.4f} "
                  f"({seconds * 1e3:.1f} ms/iter)", flush=True)
        if checkpoint_fn is not None:
            checkpoint_fn(done, model, optimizer, scheduler)

    cols = _chunked(step, 4, iterations, log_interval, u, on_chunk,
                    start_iter)
    history = dict(zip(("total", "data", "ic", "f"), cols))
    if eval_data is not None:
        history["eval"] = eval_ns(model, eval_data)
        if verbose:
            print(f"eval rel-L2: {history['eval']:.5f}")
    return history


@torch.no_grad()
def eval_ns(model, data, batch_size: int = 8) -> float:
    """Mean relative L2 over held-out trajectories, in batches of
    `batch_size`, the last partial batch dropped (eval_3d.py:15); one host
    read."""
    u, a, re = data
    lp = SimpleLpLoss(size_average=True)
    batch_size = min(batch_size, u.shape[0])
    n = u.shape[0] // batch_size * batch_size
    errs = [lp(model(a[i:i + batch_size], re[i:i + batch_size]).squeeze(-1),
               u[i:i + batch_size]) for i in range(0, n, batch_size)]
    return float(torch.stack(errs).mean().cpu())


def mixed_train(model, data, *, iterations=1000, batch_size=4,
                eq_batch_size=4, learning_rate=1e-3, xy_weight=5.0,
                ic_weight=1.0, f_weight=1.0, t_interval=1.0, S=None,
                generator: Optional[torch.Generator] = None,
                log_interval=200, verbose=True):
    """Alternate a data-loss step with an equation-only step on fresh
    random-field initial conditions (train_3d.py:125-250): the physics
    loss needs no labels.  One Adam takes both steps.  Returns the history
    of both losses, read every `log_interval` iterations."""
    from ..data.pino_datasets import get_grid3d
    from ..data.synthetic import gaussian_rf_2d

    u, a, re = data
    dev = u.device
    n = u.shape[0]
    S = S or u.shape[1]
    T = u.shape[3]
    forcing = get_forcing(S, device=dev, dtype=u.dtype)
    generator = _generator(dev, generator)
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate)
    gx, gy, gt = get_grid3d(S, T)
    grid3 = torch.as_tensor(np.concatenate([gx, gy, gt], axis=-1),
                            dtype=u.dtype, device=dev)      # (1, S, S, T, 3)
    weights = dict(xy_weight=xy_weight, ic_weight=ic_weight,
                   f_weight=f_weight, t_interval=t_interval)

    def eq_loss(w0, reb):
        B = w0.shape[0]
        a_in = torch.cat([grid3.expand(B, S, S, T, 3),
                          w0[..., None, None].expand(B, S, S, T, 1)], dim=-1)
        out = model(a_in, reb).squeeze(-1)
        ic, f = pino_loss_3d(out, w0, forcing, 1.0 / reb, t_interval)
        return ic_weight * ic + f_weight * f

    def descend(loss):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    history = {"data": [], "eq": []}
    for i in range(iterations):
        idx = torch.randperm(n, generator=generator, device=dev)[:batch_size]
        dl = descend(ns_losses(model, a[idx], u[idx], re[idx], forcing,
                               **weights)[0])
        w0 = gaussian_rf_2d(S, eq_batch_size, generator=generator,
                            device=dev, dtype=u.dtype)
        re_s = re[torch.randint(n, (eq_batch_size,), generator=generator,
                                device=dev)]
        el = descend(eq_loss(w0, re_s))
        if (i + 1) % log_interval == 0:
            dl, el = torch.stack([dl, el]).tolist()
            history["data"].append(dl)
            history["eq"].append(el)
            if verbose:
                print(f"iter {i + 1}/{iterations}: data {dl:.4f} "
                      f"eq {el:.4f}")
    return history


def progressive_train(model, datasets, *, iters_per_stage=1000, **kwargs):
    """`train_ns` through progressively finer datasets (train_3d.py:258):
    `datasets` is a list of (u, a, re) ordered coarse -> fine, the same
    model carried through; a fresh optimizer each stage, as in the JAX
    function.  Returns the list of histories."""
    return [train_ns(model, data, iterations=iters_per_stage, **kwargs)
            for data in datasets]


def _chunked(step_fn, n_metrics, iterations, log_interval, like,
             on_chunk, start: int = 0):
    """Run `step_fn(row)` from iteration `start` to `iterations`, each
    call writing its metrics into a row of a tensor of `like`'s dtype and
    device that is read
    once per chunk of `log_interval`, then `on_chunk(done, rows, seconds
    per iteration)`.  Returns the columns' histories."""
    cols = [[] for _ in range(n_metrics)]
    done = start
    while done < iterations:
        k = min(log_interval, iterations - done)
        rows = like.new_empty((k, n_metrics))
        t0 = time.perf_counter()
        for i in range(k):
            step_fn(rows[i])
        metrics = rows.cpu().numpy()                    # one read a chunk
        for j in range(n_metrics):
            cols[j].extend(metrics[:, j].tolist())
        done += k
        on_chunk(done, metrics, (time.perf_counter() - t0) / k)
    return cols


def _print_total(iterations, verbose):
    def on_chunk(done, metrics, _seconds):
        if verbose:
            print(f"iter {done}/{iterations}: total {metrics[-1, 0]:.4f}")
    return on_chunk


def _adam_step(model, optimizer, losses, row):
    optimizer.zero_grad(set_to_none=True)
    losses[0].backward()
    optimizer.step()
    row.copy_(torch.stack([x.detach() for x in losses]))


def train_2d_burger(model, data, *, iterations=1000, batch_size=8,
                    learning_rate=1e-3, visc=0.01, ic_weight=5.0,
                    f_weight=1.0, data_weight=1.0,
                    generator: Optional[torch.Generator] = None,
                    verbose=True, log_interval=200):
    """Burgers PINO training (train_2d.py:119): data rel-L2 + IC MSE +
    spectral residual.  data: (u0 (N, nx), u (N, nt, nx)); the model maps
    (B, nt, nx, 1) -> (B, nt, nx, 1).  Returns {'total': [...]}."""
    u0, u = data
    n = u0.shape[0]
    lp = SimpleLpLoss(size_average=True)
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate)
    generator = _generator(u.device, generator)

    def step(row):
        idx = torch.randperm(n, generator=generator,
                             device=u.device)[:batch_size]
        u0b, ub = u0[idx], u[idx]
        nt, nx = ub.shape[1], ub.shape[2]
        x_in = u0b[:, None, :, None].expand(u0b.shape[0], nt, nx, 1)
        out = model(x_in).squeeze(-1)
        dl = lp(out, ub)
        ic, f = pino_loss_burgers(out, u0b, visc)
        _adam_step(model, optimizer,
                   (data_weight * dl + ic_weight * ic + f_weight * f,
                    dl, ic, f), row)

    cols = _chunked(step, 4, iterations, log_interval, u,
                    _print_total(iterations, verbose))
    return {"total": cols[0]}


def train_2d_operator(model, data, *, iterations=1000, batch_size=8,
                      learning_rate=1e-3, data_weight=5.0, f_weight=1.0,
                      generator: Optional[torch.Generator] = None,
                      verbose=True, log_interval=200):
    """Darcy operator training with the finite-difference residual
    (train_2d.py:13).  data: (a (N, S, S), u (N, S, S)); the model maps
    (B, S, S, 1) -> (B, S, S, 1).  Returns the 'total', 'data', 'f'
    histories."""
    a, u = data
    n = a.shape[0]
    lp = SimpleLpLoss(size_average=True)
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate)
    generator = _generator(u.device, generator)

    def step(row):
        idx = torch.randperm(n, generator=generator,
                             device=u.device)[:batch_size]
        ab, ub = a[idx], u[idx]
        out = model(ab[..., None]).squeeze(-1)
        dl = lp(out, ub)
        fl = darcy_loss(out, ab)
        _adam_step(model, optimizer,
                   (data_weight * dl + f_weight * fl, dl, fl), row)

    cols = _chunked(step, 3, iterations, log_interval, u,
                    _print_total(iterations, verbose))
    return dict(zip(("total", "data", "f"), cols))
