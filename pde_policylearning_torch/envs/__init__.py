from . import channel_flow
from .channel_flow import (ChannelGrid, ChannelState, apply_boundary_condition,
                           boundary_pressures, calculate_mean_u,
                           compute_pressure, compute_rhs, divergence,
                           gt_control, init_state, make_channel_grid,
                           poisson_solve, projection_step, rand_control)
from .control_env import NSControlEnv

__all__ = [
    "channel_flow", "ChannelGrid", "ChannelState",
    "apply_boundary_condition", "boundary_pressures", "calculate_mean_u",
    "compute_pressure", "compute_rhs", "divergence", "gt_control",
    "init_state", "make_channel_grid", "poisson_solve", "projection_step",
    "rand_control", "NSControlEnv",
]
