"""Control policies for the channel-flow env.

Each policy is a function `(state, p2, generator) -> (opV1, opV2)`; the
closed loop calls it once per step with the state in kernel layout.
Counterpart of `pde_policylearning_tpu/control/policies.py:make_policy`
for the policies that need no model, for the three that serve an
observer's estimate of the detection-plane velocity (opposition control:
`fno` on one plane, `rno` and `transformer` on a sequence of
`model_timestep` copies of it), and for `optimal-observer` (a few Adam
steps on the action through the frozen observer, every control step).
`StatefulPolicy` and the policies that carry a learned state come with
ROADMAP.md queue 1 item 4, where their only users are.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..envs import channel_flow as cf

# The model-based policies and the queue item of ROADMAP.md that ports them.
_NOT_YET = {
    "optimal-policy-observer":
        "queue 1 item 4 (the flagship gradient-control slice)",
    "fullfield-optimal-observer":
        "queue 1 item 4 (the flagship gradient-control slice)",
}


def make_policy(name: str, grid, *, detect_plane: int = 25,
                model=None, p_norm=None, v_norm=None,
                rand_scale: float = 1.0, model_timestep: int = 1,
                bound_v_norm=None, plane_norm=None,
                opt_steps: int = 10, opt_lr: float = 1e-3,
                reg_weight: float = 0.1,
                action_scale: float = 1.0,
                action_clip: Optional[float] = None) -> Callable:
    """Build a policy function by name: `unmanipulated`, `gt` (opposition
    control), `rand`, `fno`, `rno`, `transformer` or `optimal-observer`.

    `model` is the observer (an `nn.Module` that holds its own parameters,
    so there is no `params` argument) on the env's device; the normalizers
    are `ops.normalization` objects on that device or None.  `rno` and
    `transformer` hand the model the wall-pressure plane repeated over
    `model_timestep` steps, (1, T, Nx, Nz, 1); the transformer's estimate
    is its last step's."""
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

    if name in ("fno", "rno", "transformer"):
        if model is None:
            raise ValueError(f"policy {name!r} needs the observer `model`")

        def policy(state, p2, generator):
            with torch.no_grad():
                x = p2.reshape(Nx, Nz)
                if p_norm is not None:
                    x = p_norm.encode(x)
                if name == "fno":
                    pred = model(x[None, :, :, None])
                else:
                    pred = model(x[None, None, :, :, None].expand(
                        1, model_timestep, Nx, Nz, 1))
                    if name == "transformer":
                        pred = pred[:, -1]
                pred = pred.reshape(Nx, Nz)
                v_hat = v_norm.decode(pred) if v_norm is not None else pred
                # opposition control with the estimated detection-plane
                # velocity: the observer predicts +V, gt_control applies -V
                opV2 = -action_scale * v_hat
                if action_clip is not None:
                    opV2 = torch.clamp(opV2, -action_clip, action_clip)
                # zero net flux last: clipping after the mean subtraction
                # would bring a net wall flux back, and the divergence
                # guard trips
                opV2 = opV2 - torch.mean(opV2)
                return torch.zeros_like(opV2), opV2.to(state.U.dtype)
        return policy

    if name == "optimal-observer":
        # gradient through the frozen observer: argmin_opV2
        # ||decode(observer(encode(opV2)))|| + reg*||opV2||, mean-subtracted
        # (run_control.py:186-224)
        if model is None:
            raise ValueError("policy 'optimal-observer' needs the observer "
                             "`model`")

        def objective(opV2):
            x = bound_v_norm.encode(opV2) if bound_v_norm is not None \
                else opV2
            pred = model(x[None, :, :, None])
            if plane_norm is not None:
                pred = plane_norm.decode(pred)
            return (torch.linalg.vector_norm(pred)
                    + reg_weight * torch.linalg.vector_norm(opV2))

        def policy(state, p2, generator):
            opV1, opV2 = cf.gt_control(state, detect_plane)
            # a fresh leaf and a fresh Adam every control step
            # (run_control.py:172); the observer's parameters must not
            # need a gradient (freeze them with requires_grad_(False)), so
            # that only d objective / d action is computed
            v = opV2.detach().reshape(Nx, Nz).clone().requires_grad_()
            opt = torch.optim.Adam([v], lr=opt_lr)
            with torch.enable_grad():
                for _ in range(opt_steps):
                    (v.grad,) = torch.autograd.grad(objective(v), v)
                    opt.step()
            v = v.detach()
            return opV1, v - torch.mean(v)
        return policy

    if name in _NOT_YET:
        raise NotImplementedError(
            f"policy {name!r} is not ported yet: ROADMAP.md {_NOT_YET[name]}")
    raise ValueError(f"Not supported policy name: {name}")
