"""The flagship control loop: `control/loop.py:run_closed_loop` with
`tools/drag_rows.flagship_policy("optimal-policy-observer")` through the
frozen full-width `PINObserverFullField`, one env, kernel D, CUDA graphs
on.

The window is calls of `call_steps` steps (one host fetch a call, the
planes collected), continued on the same env.  Set-up ends in a discarded
window of `warmup_seconds` on a copy of the inputs: the CUDA graph
captured, every kernel built, and most processes past the slow mode that
they start in (steps ~6.5% slower, the card idle between the graph's
kernels at unchanged clocks; it ends at a random time, mostly within 20
s, and on some machines not within a run: its cause lies outside the
process).  The benchmark's wrapper around the policy records a CUDA
event as each step's policy is called; a step's interval runs to the next
step's event (the window's last, to its end), so a stall anywhere lands
in a step.  Each call's median interval of both windows goes to standard
error.

The check starts from the states at the start of sampled calls (call 0
starts from the benchmark's own inputs; every call starts the policy's
carry afresh).  The policy: the float64 reference policy (observer,
residual policy, Adam) on that state against the program's first
actuation and, leaf by leaf, the residual policy's parameters and Adam's
second moments after that step's inner Adam steps.  The DNS:
`check_steps` steps of the float64 reference driven by the program's own
actuation, against the program's wall pressure, v plane and dPdx.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from .. import harness
from ..counts import channel as ch_counts
from ..counts import pino as pino_counts
from ..reference import channel as ref
from ..reference import precision
from ..reference import pino as rpino

DPDX = "drag_reduction/3_3_dPdx_reverse_cal"


class TimedPolicy:
    """The policy as the loop sees it, with a CUDA event recorded at every
    call while `events` is a list, and the residual policy's leaf
    statistics (`leaf_stats`) taken after the call when `grab` is set."""

    def __init__(self, policy):
        self.policy = policy
        self.init_carry = policy.init_carry
        self.events = None
        self.grab = False
        self.grabbed = None

    def __call__(self, carry, state, p2, generator):
        import torch
        if self.events is not None and state.U.is_cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        out = self.policy(carry, state, p2, generator)
        if self.grab:
            self.grab = False
            params, opt = carry
            moments = {k: opt.state[p] for k, p in params.items()
                       if p in opt.state}
            self.grabbed = leaf_stats(
                params, {k: m["exp_avg_sq"] for k, m in moments.items()})
        return out


def leaf_stats(params: dict, m2: dict) -> dict:
    """Leaf by leaf: the parameter's sum (signed, so that a step of the
    wrong size or sign shows) and norm, and the second moment's norm.
    Scalars on the device, not copies: a copy of every leaf would allocate
    gigabytes inside the window."""
    import torch

    def sums(d):
        return {k: a.detach().sum() for k, a in d.items()}

    def norms(d):
        return dict(zip(d, torch._foreach_norm(
            [a.detach() for a in d.values()]))) if d else {}
    return dict(p_sum=sums(params), p_norm=norms(params), m2_norm=norms(m2))


def setup(ctx) -> dict:
    import torch
    from pde_policylearning_torch.control import run_closed_loop
    from pde_policylearning_torch.envs import NSControlEnv
    from pde_policylearning_torch.envs import channel_flow as cf
    from pde_policylearning_torch.models import PINObserverFullField
    from pde_policylearning_torch.tools import drag_rows
    cfg, cell, dev = ctx.config, ctx.cell, ctx.device
    f32 = torch.float32
    env = NSControlEnv(Nx=cfg["Nx"], Ny=cfg["Ny"], Nz=cfg["Nz"],
                       dt=cfg["dt"], detect_plane=cfg["detect_plane"],
                       device=dev)
    gref = ref.make_grid(**harness.grid_kw(cfg))
    U, V, W, dP, mU = harness.channel_states(gref, 1, cell["noise"], ctx.seed,
                                             dev, f32)
    env.state = cf.ChannelState(U=U[0], V=V[0], W=W[0], dPdx=dP[0],
                                meanU0=mU[0])
    weights = harness.pino_weights(cfg, cfg["plane_num"], ctx.seed, dev, f32)
    obs = PINObserverFullField(plane_num=cfg["plane_num"],
                               pad_ratio=tuple(cfg["pad_ratio"]),
                               **harness.pino_model_kw(cfg), device=dev)
    obs.load_state_dict(weights)
    obs.requires_grad_(False)
    policy = TimedPolicy(drag_rows.flagship_policy(
        cell["policy"], env, obs, opt_steps=cell["opt_steps"]))
    S = dict(env=env, gref=gref, weights=weights, policy=policy,
             run_closed_loop=run_closed_loop)
    # the discarded window, from a copy of the inputs
    start = env.state
    env.state = cf.ChannelState(U=U[0].clone(), V=V[0].clone(),
                                W=W[0].clone(), dPdx=dP[0].clone(),
                                meanU0=mU[0].clone())
    window(S, ctx, cell["warmup_seconds"], "discarded window")
    env.state = start
    return S


def _show(what: str, win: dict) -> None:
    """A window's steps and each call's median step interval, on standard
    error."""
    ms, n = win.get("step_ms", []), win["steps"] // max(1, win["calls"])
    med = [round(float(np.median(ms[i:i + n])), 2)
           for i in range(0, len(ms), n)]
    print(f"{what}: {win['steps']} steps in {win['seconds']:.1f} s; each "
          f"call's median step ms {med}", file=sys.stderr)


def _call(S, ctx, n):
    with harness.span("bench.run_closed_loop"):
        return S["run_closed_loop"](
            S["env"], S["policy"], n, log_interval=n, collect_planes=True,
            detect_plane=ctx.config["detect_plane"], seed=ctx.seed,
            verbose=False)


def window(S, ctx, seconds: float, what: str = "measured window") -> dict:
    import torch
    cell, env, pol = ctx.cell, S["env"], S["policy"]
    K, n_call = cell["check_steps"], cell["call_steps"]
    rng = np.random.default_rng(ctx.seed)
    drawn = int(rng.integers(1, max(2, int(seconds / (
        n_call * cell["est_step_s"])) - 1)))
    on_card = env.state.U.is_cuda
    samples, last = {}, None
    pol.events = []
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    while True:
        start = env.state
        pol.grab = True
        res = _call(S, ctx, n_call)
        got = (start, {k: res[k][:K] for k in ("p2", "opV2", "v_plane")},
               res["series"][DPDX][:K], pol.grabbed)
        pol.grabbed = None
        if n in (0, drawn):
            samples[n] = got
        last = got
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if on_card:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    samples[n - 1] = last
    steps, ms = n * n_call, []
    if on_card:
        evs = pol.events + [end]
        ms = [a.elapsed_time(b) for a, b in zip(evs[:-1], evs[1:])]
        if len(ms) != steps:
            raise RuntimeError(f"{len(ms)} step intervals for {steps} steps")
    pol.events = None
    win = dict(seconds=elapsed, steps=steps, attempted=steps,
               e2e={"control_steps_per_s": steps / elapsed}, calls=n,
               step_ms=ms, samples=[samples[k] for k in sorted(samples)])
    _show(what, win)
    return win


def trace(S, ctx) -> dict:
    def one():
        _call(S, ctx, ctx.cell["trace_steps"])
        return ctx.cell["trace_steps"]
    return harness.traced(one)


def layer_inputs(ctx) -> dict:
    cfg, cell = ctx.config, ctx.cell
    g = (cfg["Nx"], cfg["Ny"], cfg["Nz"])
    kw = dict(width=cfg["width"], n_layers=cfg["n_layers"],
              modes=tuple(cfg["modes"]), fc_dim=cfg["fc_dim"],
              in_dim=cfg["in_dim"])
    shape = (1, cfg["Nx"], cfg["Nz"], 1)
    f_obs = pino_counts.forward_flops(*shape, out_dim=cfg["plane_num"],
                                      pad_ratio=cfg["pad_ratio"], **kw)
    f_pol = pino_counts.forward_flops(*shape, out_dim=1,
                                      pad_ratio=cfg["pad_ratio"], **kw)
    # Adam's work over the policy's leaves that can get a gradient: the
    # spectral weights of the time modes a T = 1 plane holds, and the rest
    n_pol = pino_counts.n_live_params(out_dim=1, T=shape[-1],
                                      pad_ratio=cfg["pad_ratio"], **kw)
    k = cell["opt_steps"]
    policy = k * (3 * f_pol + 2 * f_obs
                  + pino_counts.ADAM_FLOPS_PER_PARAM * n_pol) + f_pol
    return dict(ops_per_step=ch_counts.work("rk3_fullstep", 1, *g)[0] + policy,
                adam_bytes_per_step=k * n_pol
                * pino_counts.ADAM_BYTES_PER_PARAM)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

# what the reference put in the program's place is computed as: the
# control (float32 with TF32 emulated), or a fault planted in it
PLACED = {True: dict(dtype="float32", tf32=True, lr_scale=1.0),
          "wrong_lr": dict(dtype="float64", tf32=False, lr_scale=2.0)}


def _policy_ref(S, ctx, p, dtype, lr_scale=1.0):
    """The reference residual policy on parameters `p` (kept across the
    call's steps) and weights in `dtype`, with Adam's learning rate times
    `lr_scale`: (state V, p2, info) -> (op1, op2).  The first control step
    leaves in `info` its first inner step's gradients and the leaf
    statistics after its inner steps."""
    import torch
    cfg, cell = ctx.config, ctx.cell
    W = {k: v.to(dtype) for k, v in S["weights"].items()}
    dp = cfg["detect_plane"]
    model_kw = dict(n_layers=cfg["n_layers"], modes=tuple(cfg["modes"]),
                    pad_ratio=cfg["pad_ratio"], max_re=cfg["max_re"])
    Nx, Nz = cfg["Nx"], cfg["Nz"]

    def residual(V, p2, info):
        op1, op2 = ref.opposition(V, dp)
        re = torch.full((1,), cfg["re"], dtype=dtype, device=V.device)
        x_p2 = p2.reshape(1, Nx, Nz, 1, 1)
        gt = op2.reshape(1, Nx, Nz, 1, 1)
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        first = None
        for t in range(1, cell["opt_steps"] + 1):
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            with torch.enable_grad():
                act = gt + rpino.plane_model(leaves, x_p2, re, **model_kw)
                loss = (torch.linalg.vector_norm(
                    rpino.plane_model(W, act, re, **model_kw))
                    + 0.1 * torch.linalg.vector_norm(act))
                grads = dict(zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()))))
            if first is None:
                first = grads
            rpino.adam_step(p, grads, m, v2, t, lr_scale * cell["opt_lr"])
        res = rpino.plane_model(p, x_p2, re, **model_kw).reshape(1, Nx, Nz)
        if "first_grads" not in info:
            info.update(first_grads=first, stats=leaf_stats(p, v2))
        return op1, op2 + (res - res.mean())

    return residual


def rollout(S, ctx, start, dtype, tf32: bool, steps: int, op2_seq=None,
            lr_scale: float = 1.0):
    """`steps` control steps of the reference from the call's start state in
    `dtype` (with TF32 emulated in its products, where `tf32`): the bottom
    wall takes opposition control from the reference's own state, the top
    wall the reference policy's actuation or, where `op2_seq` is given,
    that sequence.  Returns the planes p2, opV2, v_plane (steps, Nx, Nz)
    and dPdx (steps,), and without `op2_seq` the policy's `info`: the
    first step's first gradients and leaf statistics."""
    import torch
    cfg, g = ctx.config, S["gref"]
    with precision.tf32(tf32):
        U, V, W, dP, mU = (a.to(dtype).reshape((1,) + tuple(a.shape))
                           for a in (start.U, start.V, start.W, start.dPdx,
                                     start.meanU0))
        _, p2 = ref.wall_pressures(g, U, V, W, dP)
        if op2_seq is None:
            params = {n: torch.zeros(s, dtype=dtype, device=U.device)
                      for n, s, _ in harness.pino_shapes(cfg, 1)}
            pol = _policy_ref(S, ctx, params, dtype, lr_scale)
        out = {k: [] for k in ("p2", "opV2", "v_plane", "dpdx")}
        info = {}
        for i in range(steps):
            if op2_seq is None:
                op1, op2 = pol(V, p2, info)
            else:
                op1, _ = ref.opposition(V, cfg["detect_plane"])
                op2 = torch.as_tensor(op2_seq[i], device=U.device,
                                      dtype=dtype)[None]
            U, V, W, dP, p2 = ref.step(g, U, V, W, dP, mU, op1, op2)
            out["p2"].append(p2[0])
            out["opV2"].append(op2[0])
            out["v_plane"].append(V[0, :, V.shape[-2] - cfg["detect_plane"]])
            out["dpdx"].append(dP[0])
        arrays = {k: torch.stack(v).double().cpu().numpy()
                  for k, v in out.items()}
        return arrays, info


def _floats(stats) -> dict:
    return {kind: {k: float(v) for k, v in d.items()}
            for kind, d in (stats or {}).items()}


def _leaf_gap(prog: dict, refd: dict, live) -> float:
    """The worst live leaf's gap between the program's and the reference's
    reading, against the larger of that leaf's reference magnitude and the
    median live leaf's."""
    base = float(np.median([abs(refd[k]) for k in live]))
    return max((abs(prog.get(k, 0.0) - refd[k])
                / max(abs(refd[k]), base, 1e-30) for k in live), default=0.0)


def numbers(planes, dpdx, grabbed, policy_ref, dns_ref) -> dict:
    """The compared numbers of one sample.  The policy: the relative L2 gap
    of the first step's actuation against the reference policy's on the
    same state (`opV2_rel`); over the leaves whose reference gradient is at
    least a thousandth of the median leaf's, the worst leaf's gap after
    that step's inner Adam steps of the parameter's sum (`param_gap`: the
    steps' size and sign) and of the second moment's norm (`moment2_gap`:
    a sum of squared gradients, which no cancellation between the inner
    steps can shrink, as it can the first moment's signed sum);
    and the count of the other leaves that the program moved
    (`policy_stray`).  The DNS, driven on both sides by the actuation
    under test: the worst step's relative L2 gap of the wall pressure and
    of the v plane, and the worst dPdx gap over the RMS of the
    reference's."""
    ref_first, info = policy_ref
    arrays = dns_ref[0]
    out = {"opV2_rel": harness.rel(planes["opV2"][0], ref_first["opV2"][0])}
    out.update({f"{k}_rel": harness.worst_rel(planes[k], arrays[k], 1)
                for k in ("p2", "v_plane")})
    rdp = arrays["dpdx"]
    out["dpdx_rel"] = float(np.max(np.abs(np.asarray(dpdx) - rdp))
                            / np.sqrt(np.mean(rdp ** 2)))
    prog, refs = _floats(grabbed), _floats(info["stats"])
    gn = {k: float(g.norm()) for k, g in info["first_grads"].items()}
    med = float(np.median(list(gn.values())))
    live = [k for k in gn if gn[k] > 1e-3 * med]
    for name, kind in (("param_gap", "p_sum"), ("moment2_gap", "m2_norm")):
        out[name] = _leaf_gap(prog.get(kind, {}), refs[kind], live)
    out["policy_stray"] = float(sum(
        1 for k in gn if k not in live
        and prog.get("p_norm", {}).get(k, 0.0)))
    return out


def check(S, ctx, samples, control=False) -> dict:
    """The worst of each number over the samples: the program against the
    float64 reference, or with `control` the reference put in the
    program's place as `PLACED[control]` says."""
    import torch
    f64, K = torch.float64, ctx.cell["check_steps"]
    worst: dict = {}
    for start, planes, dpdx, stats in samples:
        policy_ref = rollout(S, ctx, start, f64, False, 1)
        if control:
            how = PLACED[control]
            planes, info = rollout(S, ctx, start, getattr(torch, how["dtype"]),
                                   how["tf32"], K,
                                   lr_scale=how["lr_scale"])
            dpdx, stats = planes["dpdx"], info["stats"]
        dns_ref = rollout(S, ctx, start, f64, False, K,
                          op2_seq=np.asarray(planes["opV2"]))
        for k, v in numbers(planes, dpdx, stats, policy_ref,
                            dns_ref).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def release(S) -> None:
    S.pop("policy", None)
    S.pop("env", None)
