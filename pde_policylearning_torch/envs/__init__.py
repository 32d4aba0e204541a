from . import channel2d, channel_flow
from .channel2d import NSControlEnv2D
from .channel_flow import (ChannelGrid, ChannelState, apply_boundary_condition,
                           batched_rollout, boundary_pressures,
                           calculate_mean_u, compute_pressure, compute_rhs,
                           divergence, env_step, gt_control,
                           init_batched_states, init_state,
                           init_turbulent_state, make_channel_grid,
                           poisson_solve, projection_step, rand_control,
                           reichardt_profile, rk3_step, rollout,
                           spinup_chunk)
from .control_env import NSControlEnv
from .rk3_cuda import batch_states, unbatch_states

__all__ = [
    "channel_flow", "ChannelGrid", "ChannelState",
    "apply_boundary_condition", "batched_rollout", "boundary_pressures",
    "calculate_mean_u", "compute_pressure", "compute_rhs", "divergence",
    "env_step", "gt_control", "init_batched_states", "init_state",
    "init_turbulent_state", "make_channel_grid", "poisson_solve",
    "projection_step", "rand_control", "reichardt_profile", "rk3_step",
    "rollout", "spinup_chunk", "batch_states", "unbatch_states",
    "NSControlEnv", "channel2d", "NSControlEnv2D",
]
