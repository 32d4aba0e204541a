"""The full-field optimal-observer loop: `control/loop.py:run_closed_loop`
with the policy of `tools/drag_rows.flagship_policy("optimal-observer")`
through the frozen full-width `PINObserverFullField`, given the
configuration's normalizer and controller settings, one env, kernel D,
CUDA graphs on.  Every control step takes `opt_steps` Adam steps on the
top wall's raw action (a fresh Adam each step), each a forward of the
observer and its backward to the action.

The window, its calls and the per-step CUDA events are `loop.py`'s: calls
of `call_steps` steps (one host fetch a call, the planes collected),
continued on the same env, after a discarded window of `warmup_seconds`
on a copy of the inputs.  The traced slice opens the program's spans
(`utils.profiling.spans`) under the profiler, so that the device time of
the operations launched inside `policy.descend` can be read: each replay
of the graph by its `cudaGraphLaunch`'s correlation id.

The check starts from the states at the start of sampled calls.  The
policy: the float64 reference's control step (`reference/ffo.py`) on that
state against the program's first actuation (`opV2_rel`).  The DNS:
`check_steps` steps of the float64 reference driven by the program's own
actuation, against the program's wall pressure and v plane.
"""
from __future__ import annotations

import bisect
import time

import numpy as np

from .. import harness
from ..counts import ffo as ffo_counts
from ..reference import channel as ref
from ..reference import ffo as rffo
from ..reference import precision
from . import loop

DESCENT = "policy.descend"


class TimedPolicy(loop.TimedPolicy):
    """`loop.TimedPolicy` (a CUDA event at every call) for a policy with
    no parameters to take statistics of: a request to take them is
    dropped."""

    def __call__(self, carry, state, p2, generator):
        self.grab = False
        return super().__call__(carry, state, p2, generator)


def normalizer_stats(gref, cfg: dict, noise: float, seed: int, device):
    """The per-(x, z) mean and deviation (ddof 0) of `gt`'s top-wall
    actuation over `normalizer_states` states of the seed, computed in
    float64, returned in float32: the tensors both the program and the
    reference take."""
    import torch
    _, V, _, _, _ = harness.channel_states(
        gref, cfg["normalizer_states"], noise, seed, device, torch.float64)
    _, op2 = ref.opposition(V, cfg["detect_plane"])
    return (op2.mean(0).float(), op2.std(0, correction=0).float())


def setup(ctx) -> dict:
    import torch
    from pde_policylearning_torch.control import run_closed_loop
    from pde_policylearning_torch.envs import NSControlEnv
    from pde_policylearning_torch.envs import channel_flow as cf
    from pde_policylearning_torch.models import PINObserverFullField
    cfg, cell, dev = ctx.config, ctx.cell, ctx.device
    torch.backends.cuda.matmul.allow_tf32 = cfg["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    f32 = torch.float32
    env = NSControlEnv(Nx=cfg["Nx"], Ny=cfg["Ny"], Nz=cfg["Nz"],
                       dt=cfg["dt"], detect_plane=cfg["detect_plane"],
                       device=dev)
    gref = ref.make_grid(**harness.grid_kw(cfg))
    U, V, W, dP, mU = harness.channel_states(gref, 1, cell["noise"], ctx.seed,
                                             dev, f32)
    env.state = cf.ChannelState(U=U[0], V=V[0], W=W[0], dPdx=dP[0],
                                meanU0=mU[0])
    stats = normalizer_stats(gref, cfg, cell["noise"], ctx.seed, dev)
    weights = harness.pino_weights(cfg, cfg["plane_num"], ctx.seed, dev, f32)
    obs = PINObserverFullField(plane_num=cfg["plane_num"],
                               pad_ratio=tuple(cfg["pad_ratio"]),
                               max_re=cfg["max_re"],
                               **harness.pino_model_kw(cfg), device=dev)
    obs.load_state_dict(weights)
    obs.requires_grad_(False)
    policy = TimedPolicy(make_policy(cfg, env.grid, obs, stats))
    S = dict(env=env, gref=gref, weights=weights, stats=stats, policy=policy,
             run_closed_loop=run_closed_loop, cast={})
    # the discarded window, from a copy of the inputs
    start = env.state
    env.state = cf.ChannelState(U=U[0].clone(), V=V[0].clone(),
                                W=W[0].clone(), dPdx=dP[0].clone(),
                                meanU0=mU[0].clone())
    window(S, ctx, cell["warmup_seconds"], "discarded window")
    env.state = start
    return S


def make_policy(cfg: dict, grid, observer, stats, cuda_graph: bool = True):
    """The program's `optimal-observer` with the configuration's controller
    settings: what `tools/drag_rows.flagship_policy("optimal-observer")`
    builds, whose defaults they are."""
    from pde_policylearning_torch.control import \
        make_fullfield_optimal_observer
    from pde_policylearning_torch.ops.normalization import \
        NormalizerGivenMeanStd
    return make_fullfield_optimal_observer(
        grid, observer_model=observer,
        bound_v_norm=NormalizerGivenMeanStd(*stats),
        detect_plane=cfg["detect_plane"], re=cfg["re"], opt_lr=cfg["opt_lr"],
        opt_steps=cfg["opt_steps"], reg_weight=cfg["reg_weight"],
        cuda_graph=cuda_graph)


# the window, its calls and per-step events are the opo loop's
window = loop.window


# ---------------------------------------------------------------------------
# the traced slice
# ---------------------------------------------------------------------------

def launched_inside(spans, runtime, device) -> float:
    """Device seconds of the operations launched inside any of `spans`
    ((start, end) on the host): those whose runtime call ((start, end,
    correlation id): a kernel launch, a copy, a fill or a
    `cudaGraphLaunch`, whose replayed kernels carry its correlation id)
    starts inside a span, of `device` ((start, end, correlation id)); the
    union of their intervals, in seconds of the ns given."""
    spans = sorted(spans)
    starts = [s for s, _ in spans]
    inside = set()
    for s, _, corr in runtime:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= spans[i][1]:
            inside.add(corr)
    total, end = 0, None
    for s, e in sorted((s, e) for s, e, corr in device if corr in inside):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-9


def descent_s(prof) -> float:
    """`launched_inside` the profile's spans `policy.descend`: 0 where it
    holds none."""
    from torch.autograd import DeviceType

    from pde_policylearning_torch.utils import profiling
    spans = [(e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name() == DESCENT and e.device_type() == DeviceType.CPU]
    if not spans:
        return 0.0
    ev = profiling.profile_events(prof)
    return launched_inside(spans, ev["runtime"], ev["device"])


def trace(S, ctx, attempts: int = 3) -> dict:
    """`harness.traced`'s slice and reading, with the program's spans on
    and `descent_s` added to the reading."""
    import torch
    from pde_policylearning_torch.utils import profiling
    n = ctx.cell["trace_steps"]
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profiling.spans(), harness._profile() as prof:
            t0 = time.perf_counter_ns()
            loop._call(S, ctx, n)
            torch.cuda.synchronize()
            t1 = time.perf_counter_ns()
        dev, host = harness._events(prof)
        if dev:
            out = harness.reduce_trace(dev, host, (t1 - t0) * 1e-9, n)
            out["descent_s"] = descent_s(prof)
            return out
    raise RuntimeError("torch.profiler read no device event in "
                       f"{attempts} slices")


def layer_inputs(ctx) -> dict:
    return dict(ops_per_step=ffo_counts.step_flops(ctx.config))


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

# what the reference put in the program's place is computed as: the
# control (float32 with TF32 emulated), or a fault planted in it
PLACED = {True: dict(dtype="float32", tf32=True, lr_scale=1.0),
          "wrong_lr": dict(dtype="float64", tf32=False, lr_scale=2.0)}


def _ref_policy(S, ctx, dtype, lr_scale: float = 1.0):
    """The reference control step in `dtype`, with Adam's learning rate
    times `lr_scale`: V (1, Nx, Ny, Nz) -> (op1, op2)."""
    cfg = ctx.config
    if dtype not in S["cast"]:
        S["cast"][dtype] = ({k: v.to(dtype) for k, v in S["weights"].items()},
                            [a.to(dtype) for a in S["stats"]])
    weights, (mean, std) = S["cast"][dtype]

    def policy(V):
        return rffo.control_step(
            weights, V, mean, std, detect_plane=cfg["detect_plane"],
            re=cfg["re"], opt_steps=cfg["opt_steps"],
            lr=lr_scale * cfg["opt_lr"], reg_weight=cfg["reg_weight"],
            n_layers=cfg["n_layers"], modes=cfg["modes"],
            pad_ratio=cfg["pad_ratio"], max_re=cfg["max_re"])
    return policy


def _placed(S, ctx, start, how: dict) -> dict:
    """`check_steps` control steps of the reference policy and DNS from the
    call's start state, computed as `how` says: the planes p2, opV2 and
    v_plane (steps, Nx, Nz)."""
    import torch
    cfg, g = ctx.config, S["gref"]
    dtype = getattr(torch, how["dtype"])
    pol = _ref_policy(S, ctx, dtype, how["lr_scale"])
    with precision.tf32(how["tf32"]):
        U, V, W, dP, mU = (a.to(dtype).reshape((1,) + tuple(a.shape))
                           for a in (start.U, start.V, start.W, start.dPdx,
                                     start.meanU0))
        out = {k: [] for k in ("p2", "opV2", "v_plane")}
        for _ in range(ctx.cell["check_steps"]):
            op1, op2 = pol(V)
            U, V, W, dP, p2 = ref.step(g, U, V, W, dP, mU, op1, op2)
            out["p2"].append(p2[0])
            out["opV2"].append(op2[0])
            out["v_plane"].append(V[0, :, V.shape[-2] - cfg["detect_plane"]])
        return {k: torch.stack(v).double().cpu().numpy()
                for k, v in out.items()}


def numbers(planes, ref_op2, dns) -> dict:
    """The compared numbers of one sample: the relative L2 gap of the first
    step's actuation against the reference's on the same state
    (`opV2_rel`); the worst step's relative L2 gap of the wall pressure
    and of the v plane against the reference DNS driven by the same
    actuation."""
    out = {"opV2_rel": harness.rel(planes["opV2"][0], ref_op2)}
    out.update({f"{k}_rel": harness.worst_rel(planes[k], dns[k], 1)
                for k in ("p2", "v_plane")})
    return out


def check(S, ctx, samples, control=False) -> dict:
    """The worst of each number over the samples: the program against the
    float64 reference, or with `control` the reference put in the
    program's place as `PLACED[control]` says."""
    import torch
    f64, K = torch.float64, ctx.cell["check_steps"]
    pol = _ref_policy(S, ctx, f64)
    worst: dict = {}
    for start, planes, _, _ in samples:
        _, ref_op2 = pol(start.V.to(f64)[None])
        if control:
            planes = _placed(S, ctx, start, PLACED[control])
        dns = loop.rollout(S, ctx, start, f64, False, K,
                           op2_seq=np.asarray(planes["opV2"]))[0]
        for k, v in numbers(planes, ref_op2[0].cpu().numpy(), dns).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


# the discarded window of `capture_case`'s set-up, in seconds
CAPTURE_WARMUP_S = 5.0


def capture_case(seed: int) -> dict:
    """The program's CUDA graph against its eager path and the float64
    reference, on the cell's own inputs at full width: the cell's set-up
    (with a discarded window of `CAPTURE_WARMUP_S`) and a 2-s window, then,
    from the state reached, one control step of the graph; the same again
    after 64 one-element tensors were allocated (the size of the tensor
    whose freed memory the replays once read); the eager path; and the
    reference.  Returns the relative L2 gaps of the actuations
    (`graph_ref`, `eager_ref`, `graph_eager`) and whether the two replays
    agree bit for bit (`replays_equal`)."""
    import torch
    from pde_policylearning_torch.envs import channel_flow as cf
    from pde_policylearning_torch.envs import rk3_cuda as rk
    from pde_policylearning_torch.models import PINObserverFullField
    from ..run import prepare
    _, _, ctx = prepare(harness.benchmark(), "pino-fullfield-oo.ffo-loop",
                        seed, "cuda", {"warmup_seconds": CAPTURE_WARMUP_S})
    S = setup(ctx)
    window(S, ctx, 2.0)
    cfg, env = ctx.config, S["env"]
    kst = rk.state_to_kstate(env.state)
    _, p2 = cf.boundary_pressures(env.grid, env.state)
    graph = S["policy"].policy
    a_g = graph((), kst, p2, None)[1].clone()
    held = [torch.full((1,), float(i), device=ctx.device) for i in range(64)]
    a_g2 = graph((), kst, p2, None)[1].clone()
    obs = PINObserverFullField(plane_num=cfg["plane_num"],
                               pad_ratio=tuple(cfg["pad_ratio"]),
                               max_re=cfg["max_re"],
                               **harness.pino_model_kw(cfg),
                               device=ctx.device)
    obs.load_state_dict(S["weights"])
    eager = make_policy(cfg, env.grid, obs, S["stats"], cuda_graph=False)
    a_e = eager((), kst, p2, None)[1]
    f64 = torch.float64
    _, r = _ref_policy(S, ctx, f64)(env.state.V.to(f64)[None])
    del held
    g, g2, e, r = (a.reshape(r.shape[1:]).double().cpu().numpy()
                   for a in (a_g, a_g2, a_e, r[0]))
    return dict(graph_ref=harness.rel(g, r), eager_ref=harness.rel(e, r),
                graph_eager=harness.rel(g, e),
                replays_equal=bool((g == g2).all()))


def release(S) -> None:
    S.pop("policy", None)
    S.pop("env", None)
