"""Control policies for the channel-flow env.

Each policy is a function `(state, p2, generator) -> (opV1, opV2)`; the
closed loop calls it once per step with the state in kernel layout.
Counterpart of `pde_policylearning_tpu/control/policies.py:make_policy`
for the policies that need no model.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..envs import channel_flow as cf

# The model-based policies and the queue item of ROADMAP.md that ports them.
_NOT_YET = {
    "fno": "queue 1 item 5 (the observer-policy slice)",
    "rno": "queue 1 item 5 (the observer-policy slice)",
    "transformer": "queue 1 item 5 (the observer-policy slice)",
    "optimal-observer": "queue 1 item 5 (the observer-policy slice)",
    "optimal-policy-observer":
        "queue 1 item 7 (the flagship gradient-control slice)",
    "fullfield-optimal-observer":
        "queue 1 item 7 (the flagship gradient-control slice)",
}


def make_policy(name: str, grid, *, detect_plane: int = 25,
                rand_scale: float = 1.0) -> Callable:
    """Build a policy function by name: `unmanipulated`, `gt` (opposition
    control) or `rand`."""
    Nx, Nz = grid.Nx, grid.Nz

    if name == "unmanipulated":
        def policy(state, p2, generator):
            z = torch.zeros((Nx, Nz), dtype=state.U.dtype,
                            device=state.U.device)
            return z, z
        return policy

    if name == "gt":
        def policy(state, p2, generator):
            return cf.gt_control(state, detect_plane)
        return policy

    if name == "rand":
        def policy(state, p2, generator):
            opV2 = rand_scale * cf.rand_control(
                generator, (Nx, Nz), dtype=state.U.dtype,
                device=state.U.device)
            return torch.zeros_like(opV2), opV2
        return policy

    if name in _NOT_YET:
        raise NotImplementedError(
            f"policy {name!r} is not ported yet: ROADMAP.md {_NOT_YET[name]}")
    raise ValueError(f"Not supported policy name: {name}")
