"""Operations of one control step of the full-field optimal-observer loop,
from its shapes: kernel D's env step (`channel.work`), and `opt_steps`
times the frozen observer's forward on the (1, Nx, Nz, 1) action plus its
backward to that input alone (one forward more, `pino.forward_flops`),
plus Adam over the Nx x Nz action (`pino.ADAM_FLOPS_PER_PARAM` an
element).  The encode, decode, norms and the plane mean are element-wise
and not counted, as `pino.forward_flops` counts none.
"""
from __future__ import annotations

from . import channel, pino


def observer_flops(cfg: dict) -> float:
    """One forward of the configuration's observer on one action plane."""
    return pino.forward_flops(
        1, cfg["Nx"], cfg["Nz"], 1, width=cfg["width"],
        n_layers=cfg["n_layers"], modes=tuple(cfg["modes"]),
        fc_dim=cfg["fc_dim"], in_dim=cfg["in_dim"], out_dim=cfg["plane_num"],
        pad_ratio=cfg["pad_ratio"])


def descent_flops(cfg: dict) -> float:
    """The descent of one control step: `opt_steps` x (forward + backward
    to the input + Adam over the action)."""
    adam = pino.ADAM_FLOPS_PER_PARAM * cfg["Nx"] * cfg["Nz"]
    return cfg["opt_steps"] * (2 * observer_flops(cfg) + adam)


def step_flops(cfg: dict) -> float:
    """One control step: the env step and the descent."""
    return channel.work("rk3_fullstep", 1, cfg["Nx"], cfg["Ny"],
                        cfg["Nz"])[0] + descent_flops(cfg)
