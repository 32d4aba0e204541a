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
  MultiStepLR stepped once per optimizer step;
- `FusedAdam`: optax's `adam` (torch's Adam without weight decay) as one
  CUDA kernel a step over every tensor (`fused_adam_kernel`), for the
  flagship policy's inner steps.
Every update stays on the parameters' device: no host read per step.
"""
from __future__ import annotations

import ctypes
from typing import Iterable, Optional

import torch

from ..native import cuda_build


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


def adam_plain_(params, grads, exp_avgs, exp_avg_sqs, step, *, lr: float,
                betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """The plain version of `fused_adam_kernel`, any device and float dtype:
    advance the 0-dim `step` by one, then one Adam step in place on every
    leaf, in the order of torch's single-tensor Adam (`lerp_`, `mul_` and
    `addcmul_`, sqrt / sqrt(1 - b2^t) + eps, `addcdiv_`), the bias
    corrections in float64 on the host (one read of `step`)."""
    b1, b2 = betas
    step.add_(1)
    t = float(step)
    step_size = lr / (1 - b1 ** t)
    bc2_sqrt = (1 - b2 ** t) ** 0.5
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        m.lerp_(g, 1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.addcdiv_(m, (v.sqrt() / bc2_sqrt).add_(eps), value=-step_size)


def adam_plan(sizes) -> list:
    """The launches of `fused_adam_kernel` over leaves of `sizes`
    elements: for each, the leaves it updates (indices into `sizes`), each
    one's first chunk of `cuda_build.ADAM_CHUNK` elements in the launch,
    and the launch's number of chunks.  Consecutive leaves, at most
    `ADAM_MAX_LEAVES` a launch (the table is one kernel parameter, within
    4 KB); an empty leaf has nothing to update and is left out."""
    chunk, cap = cuda_build.ADAM_CHUNK, cuda_build.ADAM_MAX_LEAVES
    leaves = [i for i, n in enumerate(sizes) if n > 0]
    plan = []
    for j in range(0, len(leaves), cap):
        idx, chunk0, n_chunks = leaves[j:j + cap], [], 0
        for i in idx:
            chunk0.append(n_chunks)
            n_chunks += -(-sizes[i] // chunk)
        if n_chunks >= 2 ** 31:
            raise ValueError(f"fused Adam: {n_chunks} chunks in one launch "
                             "exceed the kernel's int32 chunk index")
        plan.append((idx, chunk0, n_chunks))
    return plan


def fused_adam_kernel(params, grads, exp_avgs, exp_avg_sqs, step, scal, *,
                      lr: float, betas=(0.9, 0.999),
                      eps: float = 1e-8) -> None:
    """One Adam step on the card (csrc/adam.cu), in place, over float32
    CUDA leaves whose parameter, gradient and moments are contiguous,
    16-B aligned tensors of one shape: `pde_adam_count` (one thread)
    advances `step`, a 0-dim float32 tensor, and writes the step's two
    bias-corrected scalars to `scal` (two floats); then `pde_adam_update`,
    `multi_tensor_apply_adam_kernel`, reads p, g, m and v once and writes
    p, m and v once, 28 B a parameter, in one launch for up to
    `ADAM_MAX_LEAVES` leaves (`adam_plan`).  Both on the current stream,
    without a host read, so that a CUDA graph can capture them.  The
    arithmetic is `adam_plain_`'s.  Raises on anything else; it never
    falls back.  `launches` counts the update's launches and `params` the
    parameters they covered (under a graph, the captured ones)."""
    dev = step.device
    if not (step.is_cuda and step.dtype is torch.float32
            and step.numel() == 1 and scal.device == dev
            and scal.dtype is torch.float32 and scal.numel() == 2):
        raise ValueError("fused Adam: step (one float32) and scal (two "
                         "float32) on the card expected")
    leaves = list(zip(params, grads, exp_avgs, exp_avg_sqs))
    for k, leaf in enumerate(leaves):
        for what, a in zip("pgmv", leaf):
            cuda_build.check_cuda_f32(f"fused Adam leaf {k} {what}", a,
                                      leaf[0].shape)
            if a.device != dev:
                raise ValueError(f"fused Adam leaf {k} {what}: on {a.device}"
                                 f", the step count on {dev}")
            if a.data_ptr() % 16:
                raise ValueError(f"fused Adam leaf {k} {what}: the kernel "
                                 "reads float4s; the tensor starts off a "
                                 "16-B boundary")
    b1, b2 = betas
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(lib.pde_adam_count(step.data_ptr(), scal.data_ptr(),
                                        lr, b1, b2, stream), "pde_adam_count")
    for idx, chunk0, n_chunks in adam_plan([p.numel() for p in params]):
        table = cuda_build.AdamTable(scal=scal.data_ptr(), b2=b2, a1=1 - b1,
                                     a2=1 - b2, eps=eps, n_leaves=len(idx),
                                     n_chunks=n_chunks)
        for j, (i, c0) in enumerate(zip(idx, chunk0)):
            table.leaf[j] = cuda_build.AdamLeaf(
                *(a.data_ptr() for a in leaves[i]), leaves[i][0].numel(), c0)
        cuda_build.check(lib.pde_adam_update(ctypes.byref(table), stream),
                         "pde_adam_update")
        fused_adam_kernel.launches += 1
        fused_adam_kernel.params += sum(params[i].numel() for i in idx)


fused_adam_kernel.launches = 0
fused_adam_kernel.params = 0


class FusedAdam(torch.optim.Optimizer):
    """Adam without weight decay and without AMSGrad (optax's `adam`; the
    flagship policy's inner optimizer, `control/policies.py`), one step
    over all its leaves at once: on the card `fused_adam_kernel`, two
    launches a step (the count, the update), on the CPU its plain version
    `adam_plain_`.  One parameter group, no closure: it raises otherwise.

    `state[p]` holds `exp_avg`, `exp_avg_sq` and `step` as torch's Adam
    does, but the leaves share one `step` tensor, so every leaf takes
    every step: a leaf without a gradient raises rather than being
    skipped.  Zeroing every state tensor in place
    (`control.policies._restart`) makes the next step a fresh
    optimizer's first, also under a CUDA graph."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))
        self._scal = None

    def add_param_group(self, param_group: dict) -> None:
        if self.param_groups:
            raise ValueError("FusedAdam takes one parameter group")
        super().add_param_group(param_group)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("FusedAdam takes no closure")
        group, = self.param_groups
        params = group["params"]
        if any(p.grad is None for p in params):
            raise ValueError("FusedAdam steps every leaf: a parameter has "
                             "no gradient")
        if not self.state[params[0]]:
            step = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
            for p in params:
                self.state[p].update(step=step, exp_avg=torch.zeros_like(p),
                                     exp_avg_sq=torch.zeros_like(p))
            self._scal = torch.empty(2, dtype=torch.float32,
                                     device=step.device)
        states = [self.state[p] for p in params]
        args = ([p.grad for p in params], [s["exp_avg"] for s in states],
                [s["exp_avg_sq"] for s in states], states[0]["step"])
        kw = dict(lr=group["lr"], betas=group["betas"], eps=group["eps"])
        if states[0]["step"].is_cuda:
            fused_adam_kernel(params, *args, self._scal, **kw)
        else:
            adam_plain_(params, *args, **kw)


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
