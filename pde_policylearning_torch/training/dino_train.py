"""DINo training: auto-decoding and latent dynamics.

Counterpart of `pde_policylearning_tpu/training/dino_train.py`
(reference: train_dino.py:165-265, the alternating optimization of the
decoder, the dynamics and the per-sequence latent states;
libs/DINo/utils.py:199 (eval_dino, test-time latent adaptation)).

One training step updates the three groups as the JAX step does:
- auto-decoding: MSE(decoder(coords, states[idx]), data[idx]) on the
  observation mask; its gradient moves the decoder (Adam at lr) and the
  latent states (Adam at lr / 10).  The states' Adam runs over the whole
  (N, T, S*C) tensor with a zero gradient outside the batch, as the JAX
  step scatters the batch's gradient into zeros before `optax.adam`: rows
  outside the batch still decay their moments and move by their stale
  momentum;
- dynamics: MSE(odeint_rk4(dyn, states[idx][:, 0], t), states[idx]) with
  the states gathered before their update and held constant; Adam at
  lr / 10 on the dynamics.
The modules are trained in place; the mask's points are gathered by
indices fixed at the start, so a step reads nothing back to the host.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models.dino import odeint_rk4
from ..utils.device import resolve_device
from .optimizers import adam_l2


def init_dino(data_shape, code_dim: int, state_dim: int, device=None,
              dtype=torch.float32) -> torch.Tensor:
    """The per-sequence latent states (N, T, state_dim * code_dim), zero,
    for data (N, T, H, W, state_dim)."""
    return torch.zeros((data_shape[0], data_shape[1], state_dim * code_dim),
                       device=resolve_device(device), dtype=dtype)


def make_coords(H: int, W: int, coord_dim: int = 2, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """The normalized coordinate grid (H, W, coord_dim) on [-1, 1]^2."""
    device = resolve_device(device)
    xs = torch.linspace(-1, 1, H, device=device, dtype=dtype)
    ys = torch.linspace(-1, 1, W, device=device, dtype=dtype)
    X, Y = torch.meshgrid(xs, ys, indexing="ij")
    return torch.stack([X, Y], dim=-1)[..., :coord_dim]


def _decode_batch(dec, coords, states, state_dim: int, code_dim: int):
    """coords (H, W, D); states (B, T, S*C) -> fields (B, T, H, W, S).
    Every state channel sees the same coordinates and the same code
    (the JAX function's broadcast), so the S channels come out equal."""
    B, T = states.shape[0], states.shape[1]
    H, W, D = coords.shape
    x = coords[None, :, :, None, :].expand(B * T, H, W, state_dim, D)
    out = dec(x, states.reshape(B * T, state_dim * code_dim))
    return out.reshape(B, T, H, W, state_dim)


def _mask_index(mask, H, W, device):
    """The flat (H * W) indices of the observed points."""
    if mask is None:
        return torch.arange(H * W, device=device)
    return torch.as_tensor(mask, device=device).reshape(-1).nonzero()[:, 0]


def _masked_mse(out, target, index):
    """mean((out - target)^2 over the observed points), as JAX's
    `diff[:, :, mask, :]`."""
    diff = (out - target) ** 2
    return diff.flatten(2, 3).index_select(2, index).mean()


def _rollout(dyn, code0, t_grid):
    """odeint_rk4 of the dynamics from code0 (B, SC) -> (B, T, SC)."""
    return odeint_rk4(dyn, code0, t_grid).transpose(0, 1)


def train_dino(dec, dyn, data, t_grid, *, code_dim: int, state_dim: int = 1,
               n_epochs: int = 100, batch_size: int = 16, lr: float = 1e-2,
               mask=None, generator: Optional[torch.Generator] = None,
               perms: Optional[Sequence] = None, log_interval: int = 20,
               verbose: bool = True, coords=None):
    """Train `dec` and `dyn` in place on data (N, T, H, W, S); returns
    (states, history).

    coords: an optional (H, W, D) grid (xyz on the sphere for the
    shallow-water set); the planar normalized grid by default.  Each
    epoch takes the batches of one permutation of the N sequences: the
    epoch's entry of `perms` where given (the JAX function's
    `jax.random.permutation` draws, to replay them), else
    `torch.randperm` from `generator`.  history['autodec'] and
    history['dyn'] hold the last step's losses every `log_interval`
    epochs and at the end."""
    N, T, H, W, S = data.shape
    assert S == state_dim
    device, dtype = data.device, data.dtype
    coords = make_coords(H, W, device=device, dtype=dtype) if coords is None \
        else torch.as_tensor(coords, device=device, dtype=dtype)
    index = _mask_index(mask, H, W, device)
    t_grid = torch.as_tensor(t_grid, device=device, dtype=dtype)
    states = init_dino(data.shape, code_dim, state_dim, device, dtype)
    states.requires_grad_(True)
    dec_params = list(dec.parameters())
    dyn_params = list(dyn.parameters())
    opt_dec = adam_l2(dec_params, lr)
    opt_dyn = adam_l2(dyn_params, lr / 10)
    opt_states = adam_l2([states], lr / 10)

    def step(idx):
        batch = states.detach()[idx]
        bs = batch.clone().requires_grad_(True)
        out = _decode_batch(dec, coords, bs, state_dim, code_dim)
        l_ad = _masked_mse(out, data[idx], index)
        g_bs, *g_dec = torch.autograd.grad(l_ad, [bs, *dec_params])
        full = torch.zeros_like(states)
        full[idx] = g_bs
        states.grad = full
        for p, g in zip(dec_params, g_dec):
            p.grad = g
        opt_states.step()
        opt_dec.step()
        # the dynamics against the latent trajectory before the update
        l_dyn = torch.mean((_rollout(dyn, batch[:, 0], t_grid) - batch) ** 2)
        for p, g in zip(dyn_params, torch.autograd.grad(l_dyn, dyn_params)):
            p.grad = g
        opt_dyn.step()
        return l_ad.detach(), l_dyn.detach()

    history = {"autodec": [], "dyn": []}
    batch_size = min(batch_size, N)
    n_batches = max(1, N // batch_size)
    for epoch in range(n_epochs):
        if perms is not None:
            perm = torch.tensor(np.asarray(perms[epoch]), device=device)
        else:
            perm = torch.randperm(N, generator=generator,
                                  device=generator.device if generator
                                  is not None else device).to(device)
        perm = perm[:n_batches * batch_size].reshape(n_batches, batch_size)
        for bi in range(n_batches):
            l_ad, l_dyn = step(perm[bi])
        if (epoch + 1) % log_interval == 0 or epoch == n_epochs - 1:
            l_ad, l_dyn = float(l_ad), float(l_dyn)
            history["autodec"].append(l_ad)
            history["dyn"].append(l_dyn)
            if verbose:
                print(f"epoch {epoch + 1}/{n_epochs}: autodec {l_ad:.3e} "
                      f"dyn {l_dyn:.3e}")
    return states.detach(), history


def train_dino_conditioned(dec, dyn, encoder, data, t_grid, *,
                           code_dim: int, state_dim: int = 1, n_cond: int = 2,
                           n_epochs: int = 50, batch_size: int = 16,
                           lr: float = 1e-2, mask=None,
                           generator: Optional[torch.Generator] = None,
                           perms: Optional[Sequence] = None,
                           log_interval: int = 20, verbose: bool = True):
    """Conditioned DINo (train_dino.py's n_cond > 0 path): `train_dino`,
    then the SetEncoder, which aggregates the first n_cond frames' codes
    into the forecast's initial code, fitted with Adam at lr / 10 for
    n_epochs full-set steps to the whole latent trajectory.  Returns
    (states, history); history['encoder'] is the last step's loss."""
    states, hist = train_dino(
        dec, dyn, data, t_grid, code_dim=code_dim, state_dim=state_dim,
        n_epochs=n_epochs, batch_size=batch_size, lr=lr, mask=mask,
        generator=generator, perms=perms, log_interval=log_interval,
        verbose=verbose)
    t_grid = torch.as_tensor(t_grid, device=data.device, dtype=data.dtype)
    enc_params = list(encoder.parameters())
    opt = adam_l2(enc_params, lr / 10)
    for _ in range(n_epochs):
        code0 = encoder(states[:, :n_cond])
        loss = torch.mean((_rollout(dyn, code0, t_grid) - states) ** 2)
        for p, g in zip(enc_params, torch.autograd.grad(loss, enc_params)):
            p.grad = g
        opt.step()
    hist["encoder"] = float(loss.detach())
    if verbose:
        print(f"encoder fit loss: {hist['encoder']:.3e}")
    return states, hist


def eval_dino_cond(dec, dyn, encoder, data, t_grid, *, code_dim: int,
                   state_dim: int = 1, n_cond: int = 2,
                   adapt_steps: int = 100, adapt_lr: float = 1e-2,
                   mask=None):
    """Conditioned evaluation (DINo/utils.py:275): codes adapted on the
    first n_cond frames, aggregated by the SetEncoder, the forecast from
    the aggregated code on the planar grid."""
    t_grid = torch.as_tensor(t_grid, device=data.device, dtype=data.dtype)
    res = eval_dino(dec, dyn, data[:, :n_cond], t_grid[:n_cond],
                    code_dim=code_dim, state_dim=state_dim,
                    adapt_steps=adapt_steps, adapt_lr=adapt_lr,
                    n_cond_frames=n_cond, mask=mask, return_codes=True)
    with torch.no_grad():
        codes = _rollout(dyn, encoder(res["codes"]), t_grid)
        coords = make_coords(data.shape[2], data.shape[3],
                             device=data.device, dtype=data.dtype)
        pred = _decode_batch(dec, coords, codes, state_dim, code_dim)
    return {"mse": float(torch.mean((pred - data) ** 2)), "pred": pred}


def eval_dino(dec, dyn, data, t_grid, *, code_dim: int, state_dim: int = 1,
              adapt_steps: int = 100, adapt_lr: float = 1e-2,
              n_cond_frames: int = 1, mask=None, return_codes: bool = False,
              coords=None):
    """Test-time adaptation and forecast (DINo/utils.py:199-273): fresh
    zero codes fitted to the first n_cond_frames frames by adapt_steps
    Adam steps, the code ODE rolled out from the first, decoded; the MSE
    over all frames, the first n_cond_frames (in-t) and the rest
    (out-t, None without)."""
    N, T, H, W, S = data.shape
    device, dtype = data.device, data.dtype
    coords = make_coords(H, W, device=device, dtype=dtype) if coords is None \
        else torch.as_tensor(coords, device=device, dtype=dtype)
    index = _mask_index(mask, H, W, device)
    t_grid = torch.as_tensor(t_grid, device=device, dtype=dtype)
    codes = torch.zeros((N, n_cond_frames, state_dim * code_dim),
                        device=device, dtype=dtype, requires_grad=True)
    opt = adam_l2([codes], adapt_lr)
    target = data[:, :n_cond_frames]
    for _ in range(adapt_steps):
        out = _decode_batch(dec, coords, codes, state_dim, code_dim)
        codes.grad, = torch.autograd.grad(
            _masked_mse(out, target, index), [codes])
        opt.step()
    codes0 = codes.detach()
    with torch.no_grad():
        pred = _decode_batch(dec, coords, _rollout(dyn, codes0[:, 0], t_grid),
                             state_dim, code_dim)
        mse = torch.mean((pred - data) ** 2, dim=(0, 2, 3, 4))
    n_in = n_cond_frames
    out = {"mse": float(mse.mean()), "mse_in_t": float(mse[:n_in].mean()),
           "mse_out_t": float(mse[n_in:].mean()) if T > n_in else None,
           "pred": pred}
    if return_codes:
        out["codes"] = codes0
    return out
