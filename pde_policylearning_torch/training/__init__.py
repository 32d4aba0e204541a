"""Observer training: optimizers and schedules, checkpoints (torch's and
the JAX package's .msgpack), the trainer, the physics-informed
full-field observer's training, PINO training, DINo training, torch's
default initialization."""
from .checkpoint import (load_checkpoint, load_msgpack, save_checkpoint,
                         save_msgpack)
from .dino_train import (eval_dino, eval_dino_cond, init_dino, make_coords,
                         train_dino, train_dino_conditioned)
from .observer_fullfield import (eval_fullfield_observer, fullfield_losses,
                                 pde_loss_fields, train_fullfield_observer)
from .optimizers import (AdamL2, FusedAdam, NesterovAdam, adam_l2,
                         multistep_lr, negadam, step_lr)
from .pino_train import (eval_ns, mixed_train, progressive_train,
                         train_2d_burger, train_2d_operator, train_ns)
from .torch_init import torch_reinit
from .trainer import Trainer, relative_l2_loss

__all__ = ["load_checkpoint", "save_checkpoint", "load_msgpack",
           "save_msgpack", "eval_dino", "eval_dino_cond", "init_dino",
           "make_coords", "train_dino", "train_dino_conditioned",
           "torch_reinit", "AdamL2", "FusedAdam", "NesterovAdam",
           "adam_l2", "multistep_lr", "negadam", "step_lr", "Trainer",
           "relative_l2_loss", "eval_fullfield_observer", "fullfield_losses",
           "pde_loss_fields", "train_fullfield_observer", "eval_ns",
           "mixed_train", "progressive_train", "train_2d_burger",
           "train_2d_operator", "train_ns"]
