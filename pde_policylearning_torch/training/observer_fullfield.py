"""Physics-informed full-field observer training.

Counterpart of `pde_policylearning_tpu/training/observer_fullfield.py`
(reference: run_pde_observers.py:200-239, the FullFieldNSDataset branch):
the top wall's v-plane -> `PINObserverFullField`'s planes, trained on the
decoded relative L2 plus `pde_loss_weight` times the channel env's RHS
difference (control_env.py:627-633).  The physics term is the env's plain
`compute_rhs` over every (sample, time step) of a batch at once, where the
JAX package vmaps it.  As in the JAX function the optimizer is Adam with
no weight decay and no schedule, whatever the config names
(`weight_decay`, `step_size`, `gamma`); the batches are drawn afresh every
epoch (`torch.randperm` from a generator on the data's device), and the
losses are read back once per chunk of epochs.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..envs import channel_flow as cf


def pde_loss_fields(grid, U, V_true, V_pred, W, dPdx):
    """||RHS(U, V_true, W) - RHS(U, V_pred, W)||, summed over the three
    momentum components (control_env.py:627-633).  The fields may carry
    leading batch axes (with `dPdx` shaped to broadcast against them): one
    value per field."""
    true = cf.compute_rhs(grid, U, V_true, W, dPdx)
    pred = cf.compute_rhs(grid, U, V_pred, W, dPdx)
    return sum(torch.linalg.vector_norm(a - b, dim=(-3, -2, -1))
               for a, b in zip(true, pred))


def _decoded_planes(model, norm, v_plane, re):
    """(B, T, X, Z) encoded boundary planes -> the decoded predictions
    (B, T, P, X, Z)."""
    pred = model(v_plane.movedim(1, -1)[..., None], re)  # (B, P, X, Z, T)
    return norm.decode(pred.movedim(-1, 1))


def _relative_l2(pred, target):
    """Per-sample relative L2 of (B, ...) arrays, (B,)."""
    b = pred.shape[0]
    return (torch.linalg.vector_norm(pred.reshape(b, -1)
                                     - target.reshape(b, -1), dim=1)
            / (torch.linalg.vector_norm(target.reshape(b, -1), dim=1)
               + 1e-12))


def _pde_term(grid, plane_indexs, U, V, W, dpdx, pred_dec):
    """The predicted planes put into the true V field at `plane_indexs`
    (y rows), each (sample, time step) scored by `pde_loss_fields`; the
    mean over all of them."""
    n = pred_dec.shape[0] * pred_dec.shape[1]
    U, V, W = (a.reshape(n, *a.shape[2:]) for a in (U, V, W))
    rows = [i % V.shape[-2] for i in plane_indexs]
    V_pred = V.clone()
    V_pred[:, :, rows, :] = pred_dec.reshape(
        n, *pred_dec.shape[2:]).movedim(1, 2)
    return pde_loss_fields(grid, U, V, V_pred, W,
                           dpdx.reshape(n, 1, 1, 1)).mean()


def fullfield_losses(model, grid, norm, plane_indexs, pde_loss_weight,
                     v_plane, v_field, U, V, W, dpdx, re):
    """(total, data, pde) of one batch: the decoded relative L2 of the
    predicted planes, the physics term (0 where `pde_loss_weight` <= 0)
    and data + pde_loss_weight * pde (the JAX function's `loss_fn`)."""
    pred_dec = _decoded_planes(model, norm, v_plane, re)
    data = _relative_l2(pred_dec, norm.decode(v_field)).mean()
    if pde_loss_weight <= 0:
        return data, data, torch.zeros_like(data)
    pde = _pde_term(grid, plane_indexs, U, V, W, dpdx, pred_dec)
    return data + pde_loss_weight * pde, data, pde


def _on(model):
    p = next(model.parameters())
    return dict(device=p.device, dtype=p.dtype)


def train_fullfield_observer(model, dataset, grid, *,
                             plane_indexs: Sequence[int], n_epochs: int = 10,
                             batch_size: int = 2,
                             learning_rate: float = 1e-3,
                             pde_loss_weight: float = 0.0,
                             generator: Optional[torch.Generator] = None,
                             verbose: bool = True):
    """Train `model` (a `PINObserverFullField`) in place on a
    `FullFieldNSDataset`, on the model's device and in its dtype; `grid`
    is the env's grid on that device.  `generator` (None: one seeded with
    0) orders the batches.  Returns (the model's state dict, history):
    per epoch the mean 'total', 'data' and 'pde' losses of its steps, and
    'epoch_time', the seconds per epoch of each chunk."""
    on = _on(model)
    dev = on["device"]

    def tensor(a):
        return torch.tensor(np.asarray(a), **on)

    v_plane, v_field, U, V, W, dpdx = (
        tensor(a) for a in (dataset.v_plane, dataset.v_field, dataset.U,
                            dataset.V, dataset.W, dataset.dpdx))
    N = v_plane.shape[0]
    re = torch.full((N,), float(dataset.re), **on)
    norm = dataset.bound_v_norm.to(**on)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=learning_rate)
    n_batches = max(1, N // batch_size)
    history = {"total": [], "data": [], "pde": [], "epoch_time": []}
    # the host reads the losses every `log_every` epochs, as the JAX
    # function fetches them
    log_every = 10 if n_epochs >= 30 else 1
    pending, t0 = [], time.perf_counter()
    for epoch in range(n_epochs):
        perm = torch.randperm(N, generator=generator, device=dev)
        steps = []
        for idx in perm[:n_batches * batch_size].reshape(n_batches,
                                                         batch_size):
            opt.zero_grad(set_to_none=True)
            total, data, pde = fullfield_losses(
                model, grid, norm, plane_indexs, pde_loss_weight,
                *(a[idx] for a in (v_plane, v_field, U, V, W, dpdx, re)))
            total.backward()
            opt.step()
            steps.append(torch.stack([total.detach(), data.detach(),
                                      pde.detach()]))
        pending.append(torch.stack(steps).mean(0))
        if (epoch + 1) % log_every and epoch + 1 != n_epochs:
            continue
        for row in torch.stack(pending).cpu().numpy():
            for name, v in zip(("total", "data", "pde"), row):
                history[name].append(float(v))
        dt = time.perf_counter() - t0
        history["epoch_time"].append(dt / len(pending))
        pending, t0 = [], time.perf_counter()
        if verbose:
            print(f"epoch {epoch + 1}/{n_epochs}: total "
                  f"{history['total'][-1]:.4f} data "
                  f"{history['data'][-1]:.4f} pde {history['pde'][-1]:.4f} "
                  f"({dt:.2f}s)", flush=True)
    return dict(model.state_dict()), history


def eval_fullfield_observer(model, dataset, batch_size: int = 4) -> float:
    """The held-out decoded data relative L2, the mean over the samples
    (the eval half of the reference's FullFieldNSDataset branch,
    run_pde_observers.py:244-280); one host read."""
    on = _on(model)
    v_plane, v_field = (torch.tensor(np.asarray(a), **on)
                        for a in (dataset.v_plane, dataset.v_field))
    N = v_plane.shape[0]
    re = torch.full((N,), float(dataset.re), **on)
    norm = dataset.bound_v_norm.to(**on)
    with torch.no_grad():
        totals = [_relative_l2(
            _decoded_planes(model, norm, v_plane[i:i + batch_size],
                            re[i:i + batch_size]),
            norm.decode(v_field[i:i + batch_size])).sum()
            for i in range(0, N, batch_size)]
        return float(torch.stack(totals).sum()) / N
