"""Generic trainer: epochs of permuted batches with best-parameter
tracking, the losses read back once per chunk of epochs.

Counterpart of `pde_policylearning_tpu/training/trainer.py` (reference:
neuralop/training/trainer.py:13 and the loop of run_pde_observers.py:
167-324).  The JAX package scans batches and epochs on the device; here
the loops are Python, and what it keeps on the device stays there: the
batch order (`torch.randperm` from the caller's generator on the data's
device), every step's loss, the best test loss and the best parameters
(`torch.where` on the device, no host branch).  The host reads the
losses once per chunk of epochs (`log_interval`, capped by
`max_chunk_steps` batch steps), as the JAX package does, with no `.item()`
per step.

Dropout is off unless `train_model_kwargs` turns it on for the training
passes (`{"deterministic": False}`), as in the JAX `Trainer`; evaluation
passes take `model_kwargs` alone.  `compute_dtype` (e.g. torch.bfloat16)
keeps float32 master weights and runs each batch's forward, backward and
regularizer on casts of the parameters and inputs
(`pino_train.cast_parameters`), the loss in the targets' dtype.  The JAX
`Trainer` applies `{"params": p}` alone, so a module with BatchNorm
statistics (the UNet's `DoubleConv`) cannot be trained by it; this one
refuses such a module.

With a `mesh` (`parallel.make_mesh`): the parameters are broadcast from
rank 0 at the start; every rank draws the same global permutation and
takes its block of each global batch over 'data'; the gradients are
all-reduced before each update (summed over 'model' where a `patcher`
with the mesh splits the patch batch there, else averaged), and the
epoch losses averaged over 'data' in rank order, so the history and the
best parameters are the same on every rank.  Every rank evaluates the
whole test set.  Memory model, unlike the JAX `Trainer`'s (which shards
the arrays 1/N over 'data'): every rank holds the whole dataset.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..parallel.mesh import (DATA_AXIS, all_reduce_gradients, ordered_sum,
                             replicate, split_batch_size)
from .checkpoint import load_checkpoint, save_checkpoint
from .optimizers import adam_l2, step_lr
from .pino_train import cast_parameters


def relative_l2_loss(pred, target, decoder=None):
    """Mean per-sample relative L2 after decoding (the observers' `myloss`
    with NormalizerGivenMeanStd decode, run_pde_observers.py:186-193).
    The decoder's statistics broadcast against the samples as they do in
    the JAX package: (H, W) statistics against (B, H, W, 1) planes make
    (B, H, W, W) arrays, whose norms the loss compares."""
    if decoder is not None:
        pred = decoder.decode(pred)
        target = decoder.decode(target)
    b = pred.shape[0]
    diff = torch.linalg.vector_norm(pred.reshape(b, -1)
                                    - target.reshape(b, -1), dim=1)
    ynorm = torch.linalg.vector_norm(target.reshape(b, -1), dim=1)
    return torch.mean(diff / ynorm)


class Trainer:
    """Train a module of the port on tensor datasets.

    The parameters mirror the reference budgets: n_epochs, batch_size,
    learning rate, StepLR(step_size epochs, gamma), Adam weight_decay
    (`optimizers.adam_l2`, optionally with `grad_clip`).  `loss_fn(pred,
    target)` defaults to the decoded relative L2; `loss_reduction='sum'`
    scales the training loss by the batch size (the reference's
    LpLoss(size_average=False) gradient; reported losses stay means);
    `regularizer(model)` is added to every batch's loss.
    """

    def __init__(self, model, n_epochs: int, batch_size: int,
                 learning_rate: float = 1e-3, weight_decay: float = 1e-4,
                 grad_clip: Optional[float] = None, step_size: int = 100,
                 gamma: float = 0.5, loss_fn: Optional[Callable] = None,
                 regularizer: Optional[Callable] = None, decoder=None,
                 log_interval: int = 50, model_kwargs: Optional[dict] = None,
                 patcher=None, mesh=None,
                 compute_dtype: Optional[torch.dtype] = None,
                 max_chunk_steps: int = 4000, loss_reduction: str = "mean",
                 train_model_kwargs: Optional[dict] = None,
                 verbose: bool = True):
        if any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
               for m in model.modules()):
            raise ValueError(
                "Trainer: the module holds BatchNorm statistics; the JAX "
                "package's Trainer applies the parameters alone and cannot "
                "train it either (ROADMAP.md queue 3)")
        if loss_reduction not in ("mean", "sum"):
            raise ValueError("loss_reduction must be 'mean' or 'sum'")
        if patcher is not None and patcher.mesh is not None \
                and patcher.mesh is not mesh:
            raise ValueError("Trainer: the patcher's mesh must be the "
                             "trainer's")
        self.model = model
        self.n_epochs = n_epochs
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.step_size = step_size
        self.gamma = gamma
        self.decoder = decoder
        self.loss_fn = loss_fn or (
            lambda pred, target: relative_l2_loss(pred, target, decoder))
        self.regularizer = regularizer
        self.log_interval = log_interval
        self.model_kwargs = model_kwargs or {}
        self.train_model_kwargs = (
            {**self.model_kwargs, **train_model_kwargs}
            if train_model_kwargs else self.model_kwargs)
        self.patcher = patcher
        self.mesh = mesh
        self.compute_dtype = compute_dtype
        self.max_chunk_steps = max_chunk_steps
        self.loss_reduction = loss_reduction
        self.verbose = verbose

    def batch_loss(self, xb, yb, train: bool = False):
        """The loss of one batch: through the patcher where there is one,
        on casts to `compute_dtype` where it is set, with the training
        passes' keywords when `train`."""
        kw = self.train_model_kwargs if train else self.model_kwargs
        with cast_parameters(self.model, self.compute_dtype):
            if self.compute_dtype is not None:
                xb = xb.to(self.compute_dtype)
            if self.patcher is not None:
                xb, _ = self.patcher.patch(xb, yb)
                pred, yb = self.patcher.unpatch(self.model(xb, **kw), yb)
            else:
                pred = self.model(xb, **kw)
            loss = self.loss_fn(pred.to(yb.dtype).reshape(yb.shape), yb)
            if self.regularizer is not None:
                loss = loss + self.regularizer(self.model)
        return loss

    def test_loss(self, test_data):
        """The mean batch loss over the test set in sequential batches of
        min(batch_size, n_test), as a 0-d tensor on the device: what
        `train` compares epoch by epoch."""
        x, y = test_data
        eval_bs = min(self.batch_size, x.shape[0])
        steps = max(1, x.shape[0] // eval_bs)
        with torch.no_grad():
            return torch.stack([
                self.batch_loss(x[i * eval_bs:(i + 1) * eval_bs],
                                y[i * eval_bs:(i + 1) * eval_bs])
                for i in range(steps)]).mean()

    def train(self, train_data, test_data,
              generator: Optional[torch.Generator] = None):
        """train_data / test_data: (x, y) tensors with a leading sample
        axis, on the model's device.  `generator` (on that device; None: a
        generator seeded with 0) orders the batches.  Returns (the best
        parameters as a state dict, history) and leaves the model with
        the last epoch's parameters."""
        x_train, y_train = train_data
        n_train, bs = x_train.shape[0], self.batch_size
        steps_per_epoch = n_train // bs
        if steps_per_epoch < 1:
            raise ValueError(f"Trainer: {n_train} training samples make no "
                             f"batch of {bs}")
        dev = x_train.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        model, mesh = self.model, self.mesh
        names, params = zip(*((n, p) for n, p in model.named_parameters()
                              if p.requires_grad))
        if mesh is not None:
            # this rank's block of every global batch
            lbs = split_batch_size(bs, mesh)
            lo = mesh.data_rank * lbs
            model_split = (self.patcher is not None
                           and self.patcher.model_split)
            replicate(mesh, model)
        opt = adam_l2(params, self.learning_rate, self.weight_decay,
                      self.grad_clip)
        sched = step_lr(opt, self.step_size, self.gamma, steps_per_epoch)
        loss_scale = float(bs) if self.loss_reduction == "sum" else 1.0
        test_steps = max(1, test_data[0].shape[0]
                         // min(bs, test_data[0].shape[0]))
        best = [p.detach().clone() for p in params]
        best_loss = torch.tensor(math.inf, dtype=torch.float32, device=dev)

        def train_epoch():
            perm = torch.randperm(n_train, generator=generator, device=dev)
            losses = []
            for s in range(steps_per_epoch):
                idx = perm[s * bs:(s + 1) * bs]
                if mesh is not None:
                    idx = idx[lo:lo + lbs]
                opt.zero_grad(set_to_none=True)
                loss = self.batch_loss(x_train[idx], y_train[idx],
                                       train=True) * loss_scale
                loss.backward()
                if mesh is not None:
                    all_reduce_gradients(mesh, params, model_split)
                opt.step()
                sched.step()
                losses.append(loss.detach() / loss_scale)
            loss = torch.stack(losses).mean()
            if mesh is not None:
                loss = ordered_sum(mesh, loss, DATA_AXIS) / mesh.dp
            return loss

        history = {"train_loss": [], "test_loss": [], "epoch_time": []}
        done = 0
        epochs_per_chunk = max(1, min(
            self.log_interval,
            self.max_chunk_steps // (steps_per_epoch + test_steps)))
        while done < self.n_epochs:
            n = min(epochs_per_chunk, self.n_epochs - done)
            t0 = time.perf_counter()
            read = []
            for _ in range(n):
                tr = train_epoch().float()
                te = self.test_loss(test_data).float()
                better = te < best_loss
                with torch.no_grad():
                    for b, p in zip(best, params):
                        b.copy_(torch.where(better, p, b))
                best_loss = torch.minimum(te, best_loss)
                read += [tr, te]
            # one device -> host read per chunk: the losses and the best
            read = torch.stack(read + [best_loss]).cpu().numpy()
            dt = time.perf_counter() - t0
            tr, te = read[0:-1:2], read[1:-1:2]
            history["train_loss"].extend(np.asarray(tr).tolist())
            history["test_loss"].extend(np.asarray(te).tolist())
            history["epoch_time"].append(dt / n)
            done += n
            if self.verbose:
                print(f"epoch {done}/{self.n_epochs}: train {tr[-1]:.5f} "
                      f"test {te[-1]:.5f} best {float(read[-1]):.5f} "
                      f"({dt / n * 1e3:.1f} ms/epoch)", flush=True)
        history["best_loss"] = float(best_loss)
        best_state = dict(model.state_dict())
        best_state.update(zip(names, best))
        return best_state, history

    def evaluate(self, test_data):
        """The loss on the whole test set in one batch, as a float."""
        x, y = test_data
        with torch.no_grad():
            pred = self.model(x, **self.model_kwargs)
            return float(self.loss_fn(pred.reshape(y.shape), y))

    def evaluate_multi(self, test_loaders: dict) -> dict:
        """Per-resolution evaluation (the reference Trainer's
        `test_loaders`, neuralop/training/trainer.py:192-254): a name (e.g.
        '32x32') -> (x, y)."""
        return {name: self.evaluate(data)
                for name, data in test_loaders.items()}

    def save_state(self, path: str, optimizer=None, scheduler=None,
                   epoch: int = 0) -> str:
        """A resumable training state (the reference's {model, optim,
        scheduler} checkpoints, libs/pino_utils/utils.py:156-195)."""
        return save_checkpoint(path, self.model, optimizer, scheduler, epoch)

    def load_state(self, path: str, optimizer=None, scheduler=None) -> int:
        return load_checkpoint(path, self.model, optimizer, scheduler)
