"""Observer training: optimizers and schedules, checkpoints, the
trainer, the physics-informed full-field observer's training."""
from .checkpoint import load_checkpoint, save_checkpoint
from .observer_fullfield import (eval_fullfield_observer, fullfield_losses,
                                 pde_loss_fields, train_fullfield_observer)
from .optimizers import (AdamL2, NesterovAdam, adam_l2, multistep_lr,
                         negadam, step_lr)
from .trainer import Trainer, relative_l2_loss

__all__ = ["load_checkpoint", "save_checkpoint", "AdamL2", "NesterovAdam",
           "adam_l2", "multistep_lr", "negadam", "step_lr", "Trainer",
           "relative_l2_loss", "eval_fullfield_observer", "fullfield_losses",
           "pde_loss_fields", "train_fullfield_observer"]
