"""Optimizers and learning-rate schedules as torch optimizers and
schedulers.

Counterpart of `pde_policylearning_tpu/training/optimizers.py` (reference:
torch.optim.Adam + StepLR in run_pde_observers.py, and the NAdam variant
of libs/pino_utils/negadam.py), held to the optax chains the JAX package
builds, step for step:
- `adam_l2`: optax's `clip_by_global_norm` (the gradients times
  max / norm where the global norm exceeds max; torch's `clip_grad_norm_`
  takes max / (norm + 1e-6)), then the coupled L2 decay added to the
  gradient before the moments (what `torch.optim.Adam(weight_decay=...)`
  does), then Adam;
- `negadam`: optax's `scale_by_adam(nesterov=True)`, whose first moment
  is b1 m_hat(t+1) + (1 - b1) g_hat(t), with no momentum-decay schedule
  (`torch.optim.NAdam` has one);
- `step_lr`: optax's staircase `exponential_decay` over optimizer steps,
  `transition_steps = step_size_epochs * steps_per_epoch`: torch's StepLR
  stepped once per optimizer step;
- `multistep_lr`: optax's `piecewise_constant_schedule`, torch's
  MultiStepLR stepped once per optimizer step.
Every update stays on the parameters' device: no host read per step.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g * max_norm / ||g|| where the
    global norm ||g|| of all `grads` is at least max_norm."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


class AdamL2(torch.optim.Adam):
    """torch's Adam (coupled L2 decay) with optax's global-norm clip first
    (`grad_clip`, None: no clip)."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 weight_decay: float = 0.0,
                 grad_clip: Optional[float] = None):
        super().__init__(params, lr=lr, weight_decay=weight_decay)
        self.grad_clip = grad_clip

    @torch.no_grad()
    def step(self, closure=None):
        if self.grad_clip is not None:
            grads = [p.grad for g in self.param_groups for p in g["params"]
                     if p.grad is not None]
            clip_by_global_norm_(grads, self.grad_clip)
        return super().step(closure)


class NesterovAdam(torch.optim.Optimizer):
    """optax's `add_decayed_weights` + `scale_by_adam(nesterov=True)` +
    the learning rate (libs/pino_utils/negadam.py:54): with t the step,
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, the update
    -lr (b1 m / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t))
    / (sqrt(v / (1 - b2^t)) + eps)."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.lerp_(g, 1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = b1 * m / (1 - b1 ** (t + 1)) \
                    + (1 - b1) * g / (1 - b1 ** t)
                denom = (v / (1 - b2 ** t)).sqrt_().add_(group["eps"])
                p.addcdiv_(m_hat, denom, value=-group["lr"])
        return loss


def adam_l2(params: Iterable, learning_rate: float,
            weight_decay: float = 0.0,
            grad_clip: Optional[float] = None) -> AdamL2:
    """Adam with torch-style (coupled) L2 weight decay and optax's
    global-norm clip (the JAX package's `adam_l2`); `learning_rate` is the
    base rate, which a scheduler of this module then steps."""
    return AdamL2(params, lr=learning_rate, weight_decay=weight_decay,
                  grad_clip=grad_clip)


def negadam(params: Iterable, learning_rate: float,
            weight_decay: float = 0.0) -> NesterovAdam:
    """The NAdam variant of the JAX package (optax's Nesterov Adam)."""
    return NesterovAdam(params, lr=learning_rate, weight_decay=weight_decay)


def step_lr(optimizer, step_size_epochs: int, gamma: float,
            steps_per_epoch: int):
    """StepLR over optimizer steps: the rate falls by `gamma` every
    `step_size_epochs` epochs of `steps_per_epoch` steps.  Call its
    `step()` after every optimizer step."""
    return torch.optim.lr_scheduler.StepLR(
        optimizer, step_size=step_size_epochs * steps_per_epoch, gamma=gamma)


def multistep_lr(optimizer, milestones, gamma: float):
    """MultiStepLR over optimizer steps (PINO training,
    train_pino.py:208): the rate falls by `gamma` at each of
    `milestones`."""
    return torch.optim.lr_scheduler.MultiStepLR(
        optimizer, milestones=[int(m) for m in milestones], gamma=gamma)
