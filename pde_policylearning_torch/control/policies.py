"""Control policies for the channel-flow env.

Each policy is a function `(state, p2, generator) -> (opV1, opV2)`; the
closed loop calls it once per step with the state in kernel layout.
Counterpart of `pde_policylearning_tpu/control/policies.py`: `make_policy`
for the policies that need no model, for the three that serve an
observer's estimate of the detection-plane velocity (opposition control:
`fno` on one plane, `rno` and `transformer` on a sequence of
`model_timestep` copies of it), and for `optimal-observer` (a few Adam
steps on the action through the frozen observer, every control step);
and the two factories of the flagship slice, which return a
`StatefulPolicy`: `make_optimal_policy_observer` (a residual
`PolicyModel2D` adapted online through the frozen full-field observer)
and `make_fullfield_optimal_observer` (Adam on the raw action through
it).  Neither differentiates through the env step: the gradient goes
through the models only, and every action leaves the policy detached.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import functional_call

from ..envs import channel_flow as cf
from ..training.optimizers import FusedAdam
from ..utils.profiling import span


class StatefulPolicy:
    """A policy with a carry that the control loop threads from step to
    step (`control.loop.closed_loop_chunk`): `step_fn(carry, state, p2,
    generator) -> (opV1, opV2, carry)`.  Where the JAX package's carry is
    an immutable tree that every run starts from, `init_carry` here is a
    function that sets up the carry a run starts from, so that a step may
    update the carry's tensors in place."""

    def __init__(self, init_carry: Callable[[], object], step_fn: Callable):
        self.init_carry = init_carry
        self.step_fn = step_fn

    def __call__(self, carry, state, p2, generator):
        return self.step_fn(carry, state, p2, generator)


def _restart(opt: torch.optim.Optimizer) -> None:
    """Zero an Adam's moments and step counts in place, so that its
    next step is a fresh optimizer's first (the reference builds a new
    Adam every control step, run_control.py:172) without allocating the
    moments again (1.8 GB at the full-width `PolicyModel2D`)."""
    for st in opt.state.values():
        for t in st.values():
            t.zero_()


def _cuda_graph(fn: Callable[[], None], warmup: int = 2) -> Callable:
    """`fn` (no arguments; it reads and writes tensors that outlive it) run
    `warmup` times on a side stream, then captured as one CUDA graph;
    returns the graph's replay.  The flagship policies' inner Adam loops
    are thousands of small launches a control step, which the host cannot
    issue as fast as the card runs them; replayed, they cost one launch.
    The warm-up and the capture are the span `policy.capture`.

    The graph reads and writes the tensors that `fn` holds at their
    addresses at the capture, so the replay holds `fn`, and through its
    closure every one of them, for as long as the graph lives.  A tensor
    that only the closure held would go back to the caching allocator
    once the caller returned, and the next tensor of its size would take
    its memory: the replays would read that tensor's values."""
    with span("policy.capture"):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()

    def replay():
        graph.replay()
    replay.captured = fn
    return replay


def make_optimal_policy_observer(grid, *, observer_model, policy_model,
                                 detect_plane: int = 25, re: float = 178.19,
                                 opt_lr: float = 1e-4, opt_steps: int = 3,
                                 reg_weight: float = 0.1,
                                 cuda_graph: bool = True) -> StatefulPolicy:
    """'optimal-policy-observer' (run_control.py:162-185): every control
    step takes `opt_steps` Adam steps (a fresh Adam each control step) on
    the residual `policy_model` (a `PolicyModel2D` of the wall pressure),
    minimizing ||observer(gt + residual, Re)|| + reg ||gt + residual||
    through the frozen full-field `observer_model`, then actuates `gt`
    plus the residual with its plane mean subtracted (zero net flux; the
    JAX package subtracts it too, policies.py:87-95, where the reference
    does not).

    The carry is a copy of the policy's parameters (leaves that need a
    gradient) and their Adam (`training.optimizers.FusedAdam`: on the card
    one kernel a step over every leaf), allocated once: every run starts from
    `policy_model`'s parameters again, which the policy never changes.
    `observer_model` is frozen here (`requires_grad_(False)`), so that only
    the gradient to its input is computed.  Both models lie on the env's
    device in the state's dtype.  On the card the Adam steps of a control
    step are one CUDA graph (`cuda_graph`), captured at the first step
    (`policy.capture`) and replayed, its inputs copied in, every step
    (`policy.replay`)."""
    observer_model.requires_grad_(False)
    Nx, Nz = grid.Nx, grid.Nz
    carry, graphed = {}, {}

    def init_carry():
        if not carry:
            params = {n: p.detach().clone().requires_grad_()
                      for n, p in policy_model.named_parameters()}
            carry.update(params=params, opt=FusedAdam(
                list(params.values()), lr=opt_lr))
        with torch.no_grad():
            for n, p in policy_model.named_parameters():
                carry["params"][n].copy_(p)
        return carry["params"], carry["opt"]

    def adapt(params, opt, p2_in, opV2_in, re_arr):
        """The control step's Adam steps on the residual policy, from a
        fresh Adam; returns the residual after them."""
        leaves = list(params.values())
        with torch.no_grad():
            _restart(opt)
        with torch.enable_grad():
            for _ in range(opt_steps):
                act = opV2_in + functional_call(policy_model, params,
                                                (p2_in, re_arr))
                loss = (torch.linalg.vector_norm(observer_model(act, re_arr))
                        + reg_weight * torch.linalg.vector_norm(act))
                for p, g in zip(leaves, torch.autograd.grad(loss, leaves)):
                    p.grad = g
                opt.step()
        with torch.no_grad():
            return functional_call(policy_model, params, (p2_in, re_arr))

    def replay(params, opt, p2_in, opV2_in, re_arr):
        if not graphed:
            ins = [a.clone() for a in (p2_in, opV2_in, re_arr)]
            saved = [p.detach().clone() for p in params.values()]
            graphed["replay"] = _cuda_graph(
                lambda: graphed.update(res=adapt(params, opt, *ins)))
            # the warm-up calls moved the carry: put it back
            with torch.no_grad():
                for p, v in zip(params.values(), saved):
                    p.copy_(v)
            graphed["ins"] = ins
        with span("policy.replay"):
            for buf, a in zip(graphed["ins"], (p2_in, opV2_in, re_arr)):
                buf.copy_(a)
            graphed["replay"]()
        return graphed["res"]

    def step_fn(carry_, state, p2, generator):
        params, opt = carry_
        opV1, opV2_gt = cf.gt_control(state, detect_plane)
        re_arr = torch.full((1,), re, dtype=opV2_gt.dtype,
                            device=opV2_gt.device)
        args = (params, opt, p2.reshape(1, Nx, Nz, 1, 1),
                opV2_gt.reshape(1, Nx, Nz, 1, 1), re_arr)
        res = (replay if cuda_graph and opV2_gt.is_cuda else adapt)(*args)
        res = res.reshape(opV2_gt.shape)
        return opV1, opV2_gt + (res - torch.mean(res)), carry_

    return StatefulPolicy(init_carry, step_fn)


def make_fullfield_optimal_observer(grid, *, observer_model, bound_v_norm,
                                    detect_plane: int = 25,
                                    re: float = 178.19, opt_lr: float = 1e-3,
                                    opt_steps: int = 10,
                                    reg_weight: float = 0.1,
                                    cuda_graph: bool = True
                                    ) -> StatefulPolicy:
    """'optimal-observer' through the full-field observer
    (run_control.py:186-224): every control step takes `opt_steps` Adam
    steps (a fresh Adam) on the raw action, from `gt`'s, minimizing
    ||decode(observer(encode(opV2), Re))|| + reg ||opV2|| (the gradient
    flows through the encode), then subtracts the plane mean (zero net
    flux, run_control.py:223).  `bound_v_norm` is the V field's statistics
    on the top wall's plane, (Nx, Nz), on the env's device; the observer
    is frozen here.  The JAX package carries the observer's parameters (a
    TPU compile-size measure); here the carry is empty.

    The Adam is `training.optimizers.FusedAdam` on both paths (on the card
    two launches a step, the arithmetic of `adam_plain_`), so that the
    two paths part only where the capture would.  The descent of a control
    step is the span `policy.descend`.  On the card it is one CUDA graph
    (`cuda_graph`), captured at the first step (`policy.capture`) and
    replayed, its start copied in, every step (`policy.replay`, around
    `policy.descend`); the graph restarts its Adam itself."""
    observer_model.requires_grad_(False)
    Nx, Nz = grid.Nx, grid.Nz
    graphed = {}

    def objective(v, re_arr):
        x = bound_v_norm.encode(v)[None, :, :, None, None]
        pred = observer_model(x, re_arr)                  # (1, P, X, Z, 1)
        pred_dec = bound_v_norm.decode(torch.movedim(pred, -1, 1))
        return (torch.linalg.vector_norm(pred_dec)
                + reg_weight * torch.linalg.vector_norm(v))

    def descend(v, opt, re_arr):
        """`opt_steps` steps of a fresh `opt` on the leaf `v`, in place."""
        with torch.no_grad():
            _restart(opt)
        with torch.enable_grad():
            for _ in range(opt_steps):
                (v.grad,) = torch.autograd.grad(objective(v, re_arr), v)
                opt.step()

    def eager(v0, re_arr):
        v = v0.clone().requires_grad_()
        with span("policy.descend"):
            descend(v, FusedAdam([v], lr=opt_lr), re_arr)
        return v.detach()

    def replay(v0, re_arr):
        if not graphed:
            v = v0.clone().requires_grad_()
            start, re_buf = v0.clone(), re_arr.clone()
            opt = FusedAdam([v], lr=opt_lr)

            def run():
                with torch.no_grad():
                    v.copy_(start)
                descend(v, opt, re_buf)
            graphed.update(v=v, start=start, replay=_cuda_graph(run))
        with span("policy.replay"), span("policy.descend"):
            graphed["start"].copy_(v0)
            graphed["replay"]()
        return graphed["v"].detach()

    def step_fn(carry, state, p2, generator):
        opV1, opV2_gt = cf.gt_control(state, detect_plane)
        v0 = opV2_gt.detach().reshape(Nx, Nz)
        re_arr = torch.full((1,), re, dtype=v0.dtype, device=v0.device)
        v = (replay if cuda_graph and v0.is_cuda else eager)(v0, re_arr)
        return opV1, (v - torch.mean(v)).reshape(opV2_gt.shape), carry

    return StatefulPolicy(tuple, step_fn)


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

    raise ValueError(f"Not supported policy name: {name}")
