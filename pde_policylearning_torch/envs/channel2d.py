"""2-D channel-flow control environment (Chorin projection, collocated
grid).

Counterpart of `pde_policylearning_tpu/envs/channel2d.py` (reference:
libs/envs/ns_control_2d.py:70 (NSControlEnv2D), build_up_b :13,
pressure_poisson_periodic :41): a 41 x 41 grid, periodic in x, no-slip
walls with wall-normal actuation, Jacobi pressure sweeps, the flow driven
by a force F, iterated to a (quasi-)steady state, and bisection on F for a
constant mass flow (solve_fixed_mass :493).  Layout (ny, nx): rows are y
(walls at 0 and -1), columns x (periodic).  float64 by default, as the
JAX constructor says (JAX runs it in float32 unless x64 is on).

The JAX step is one compiled program whose steady-state iteration is a
`while_loop` on the relative change of the mass.  Here one iteration (the
wall conditions, the pressure source, 50 Jacobi sweeps, the momentum
update and the relative change) is one function on fixed buffers, and on
the card it is captured once as a CUDA graph and replayed.  The loop's
test stays on the device: a flag `go` and the iteration count live in the
buffers, an iteration with `go` false leaves the state as it is
(`torch.where`), so the host reads the flag only every `check_every`
iterations and still gets the `while_loop`'s state and count exactly; a
solve that can run at most `check_every` iterations reads nothing.  The
bisection's bounds stay on the device too.  Every read of a device value
by the host (`host_read`) is counted in `host_read.count`, the info values
and the flag reads alike; there is none per Jacobi sweep.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import resolve_device


class Channel2DState(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    F: torch.Tensor


def host_read(t: torch.Tensor) -> np.ndarray:
    """`t` as numpy on the host: one device-to-host read, counted in
    `host_read.count`."""
    host_read.count += 1
    return t.detach().cpu().numpy()


host_read.count = 0


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """`value` (a float or a 0-d tensor) as a new 0-d tensor of `like`'s
    dtype and device; a float is filled in on the device, so that no copy
    from pageable host memory waits on the stream."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=like.dtype, device=like.device).clone()
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


def _roll_x(a, shift):
    return torch.roll(a, shift, dims=1)


def build_up_b(rho, dt, dx, dy, u, v):
    """Pressure-Poisson source (ns_control_2d.py:13-38), periodic in x;
    the wall rows stay zero."""
    ux = (_roll_x(u, -1) - _roll_x(u, 1)) / (2 * dx)
    vy = torch.zeros_like(v)
    vy[1:-1] = (v[2:] - v[:-2]) / (2 * dy)
    uy = torch.zeros_like(u)
    uy[1:-1] = (u[2:] - u[:-2]) / (2 * dy)
    vx = (_roll_x(v, -1) - _roll_x(v, 1)) / (2 * dx)
    b = rho * (ux / dt - ux ** 2 - 2 * uy * vx - vy ** 2)
    b = b + rho * vy / dt
    b[0] = 0.0
    b[-1] = 0.0
    return b


def pressure_poisson_periodic(p, dx, dy, b, nit: int = 50):
    """`nit` Jacobi sweeps, periodic in x and dp/dy = 0 at the walls
    (ns_control_2d.py:41-68).  Each sweep computes the interior rows from
    the previous sweep's field, then copies the rows next to the walls
    onto them; the null mode is whatever the sweeps leave."""
    denom = 2 * (dx ** 2 + dy ** 2)
    cb = (dx ** 2 * dy ** 2 / denom * b)[1:-1]
    p = p.clone()
    for _ in range(nit):
        mid = p[1:-1]
        px = (_roll_x(mid, -1) + _roll_x(mid, 1)) * dy ** 2
        py = (p[2:] + p[:-2]) * dx ** 2
        new = (px + py) / denom - cb
        p[1:-1] = new
        p[-1] = p[-2]
        p[0] = p[1]
    return p


def _momentum_update(un, vn, p, dx, dy, dt, rho, nu, F):
    """Upwind convection, central diffusion, pressure gradient and forcing
    (ns_control_2d.py:382-478), periodic in x; the wall rows keep un's and
    vn's."""
    conv_u = un * dt / dx * (un - _roll_x(un, 1))
    conv_v_u = torch.zeros_like(un)
    conv_v_u[1:-1] = vn[1:-1] * dt / dy * (un[1:-1] - un[:-2])
    px = dt / (2 * rho * dx) * (_roll_x(p, -1) - _roll_x(p, 1))
    lap_u = torch.zeros_like(un)
    lap_u[1:-1] = nu * (
        dt / dx ** 2 * (_roll_x(un, -1) - 2 * un + _roll_x(un, 1))[1:-1]
        + dt / dy ** 2 * (un[2:] - 2 * un[1:-1] + un[:-2]))
    u = un - conv_u - conv_v_u - px + lap_u + F * dt

    conv_u_v = un * dt / dx * (vn - _roll_x(vn, 1))
    conv_v_v = torch.zeros_like(vn)
    conv_v_v[1:-1] = vn[1:-1] * dt / dy * (vn[1:-1] - vn[:-2])
    py = torch.zeros_like(p)
    py[1:-1] = dt / (2 * rho * dy) * (p[2:] - p[:-2])
    lap_v = torch.zeros_like(vn)
    lap_v[1:-1] = nu * (
        dt / dx ** 2 * (_roll_x(vn, -1) - 2 * vn + _roll_x(vn, 1))[1:-1]
        + dt / dy ** 2 * (vn[2:] - 2 * vn[1:-1] + vn[:-2]))
    v = vn - conv_u_v - conv_v_v - py + lap_v

    u[0], u[-1] = un[0], un[-1]
    v[0], v[-1] = vn[0], vn[-1]
    return u, v


def capture(body, warmup: int = 2):
    """`body()` (work on fixed CUDA buffers) captured as a CUDA graph after
    `warmup` calls on a side stream; returns the graph's `replay`.  The
    warm-up calls change the buffers, so the caller fills them after."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    return graph.replay


class _Solver:
    """The steady-state iteration on fixed buffers for one grid, dtype,
    device and set of constants: `u`, `v`, `p`, the wall values `bot`,
    `top`, the force `F`, the flag `go`, the count `it` and its `limit`.
    `step()` is one masked iteration: a CUDA graph on the card, eager on
    the CPU."""

    def __init__(self, shape, dtype, device, consts, nit, thre):
        z = dict(dtype=dtype, device=device)
        self.u, self.v, self.p = (torch.zeros(shape, **z) for _ in range(3))
        self.bot, self.top = (torch.zeros(shape[1], **z) for _ in range(2))
        self.F = torch.zeros((), **z)
        self.go = torch.zeros((), dtype=torch.bool, device=device)
        self.it = torch.zeros((), dtype=torch.int64, device=device)
        self.limit = torch.zeros((), dtype=torch.int64, device=device)
        self.consts, self.nit, self.thre = consts, nit, thre
        self.step = capture(self._iteration) if device.type == "cuda" \
            else self._iteration

    def _iteration(self):
        dx, dy, dt, rho, nu = self.consts
        un, vn = self.u.clone(), self.v.clone()
        un[0], un[-1] = 0.0, 0.0
        vn[0], vn[-1] = self.bot, self.top
        b = build_up_b(rho, dt, dx, dy, un, vn)
        p = pressure_poisson_periodic(self.p, dx, dy, b, self.nit)
        u, v = _momentum_update(un, vn, p, dx, dy, dt, rho, nu, self.F)
        udiff = ((u.sum() - un.sum()) / u.sum()).abs()
        go = self.go
        self.u.copy_(torch.where(go, u, self.u))
        self.v.copy_(torch.where(go, v, self.v))
        self.p.copy_(torch.where(go, p, self.p))
        self.it.add_(go.to(self.it.dtype))
        self.go.copy_(go & (udiff > self.thre) & (self.it < self.limit))

    def run(self, state, bc, F, limit: int, check_every: int):
        """The `while_loop` from `state`: iterations in chunks of
        `check_every`, the flag read after each chunk that leaves
        iterations to go.  Returns (u, v, p, steps) as new tensors."""
        self.u.copy_(state.u)
        self.v.copy_(state.v)
        self.p.copy_(state.p)
        if bc is None:
            self.bot.zero_()
            self.top.zero_()
        else:
            self.bot.copy_(bc[0])
            self.top.copy_(bc[1])
        self.F.copy_(_scalar(F, self.F))
        self.it.zero_()
        self.limit.fill_(limit)
        # the while_loop's first test: udiff starts at 1.0
        self.go.fill_(bool(1.0 > self.thre and limit > 0))
        done = 0
        while done < limit:
            for _ in range(min(check_every, limit - done)):
                self.step()
            done += min(check_every, limit - done)
            if done < limit and not host_read(self.go):
                break
        return self.u.clone(), self.v.clone(), self.p.clone(), \
            self.it.clone()


_SOLVERS = {}


def _solver(u, consts, nit, thre) -> _Solver:
    key = (tuple(u.shape), u.dtype, u.device, consts, nit, thre)
    if key not in _SOLVERS:
        _SOLVERS[key] = _Solver(tuple(u.shape), u.dtype, u.device, consts,
                                nit, thre)
    return _SOLVERS[key]


def solve(state: Channel2DState, bc, dx, dy, dt, rho, nu, F,
          nit: int = 50, max_step: int = -1, u_diff_thre: float = 1e-2,
          check_every: Optional[int] = None):
    """Iterate to steady state, at most `max_step` iterations (5000 when
    not given) (ns_control_2d.py:359-491).  bc = (bottom_v, top_v) or
    None; F a float or a 0-d tensor.  The flag is read every
    `check_every` iterations (None: 4 on the card, 1 on the CPU).
    Returns (state, bulk velocity, iterations), the last two 0-d tensors
    on the state's device."""
    limit = max_step if max_step > 0 else 5000
    if check_every is None:
        check_every = 4 if state.u.is_cuda else 1
    consts = tuple(float(c) for c in (dx, dy, dt, rho, nu))
    s = _solver(state.u, consts, nit, float(u_diff_thre))
    u, v, p, steps = s.run(state, bc, F, limit, check_every)
    return Channel2DState(u=u, v=v, p=p, F=_scalar(F, u)), u.abs().mean(), \
        steps


def solve_fixed_mass(state: Channel2DState, bc, target_flow, dx, dy, dt,
                     rho, nu, min_f: float = 0.0, max_f: float = 3.0,
                     n_bisect: int = 20, check_every: Optional[int] = None,
                     iterations: Optional[list] = None):
    """Bisection on the force F for the mass flow `target_flow`
    (ns_control_2d.py:493-536): `n_bisect` steady solves from `state`,
    the bounds on the device.  Returns (F, flow), 0-d tensors; each
    solve's iteration count is appended to `iterations` where given."""
    def flow_for(F):
        _, bulk, steps = solve(state, bc, dx, dy, dt, rho, nu, F,
                               check_every=check_every)
        if iterations is not None:
            iterations.append(steps)
        return bulk

    lo, hi = _scalar(min_f, state.u), _scalar(max_f, state.u)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        below = flow_for(mid) < target_flow
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    mid = 0.5 * (lo + hi)
    return mid, flow_for(mid)


class NSControlEnv2D:
    """Stateful wrapper with the reference's step / info contract
    (ns_control_2d.py:70-586), on `device` (None: the card) in `dtype`.
    `iterations` holds the step's steady-solve counts (device tensors:
    the step's solve, then the bisection's), `syncs` the host reads of
    the last step."""

    def __init__(self, detect_plane: int = -10, bc_type: str = "original",
                 Re: float = 100.0, fix_flow: bool = False, seed: int = 0,
                 dtype=torch.float64, device=None,
                 check_every: Optional[int] = None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.check_every = check_every
        self.detect_plane = detect_plane
        self.bc_type = bc_type
        self.fix_flow = fix_flow
        self.Re = Re
        self.nx = self.ny = 41
        self.nit = 50
        self.dx = 2.0 / (self.nx - 1)
        self.dy = 2.0 / (self.ny - 1)
        self.rho = 1.0
        self.F = 4.0
        self.dt = 0.01
        rng = np.random.default_rng(seed)
        u = np.ones((self.ny, self.nx))
        v = 0.15 + rng.random((self.ny, self.nx)) * 0.1
        p = v.copy()
        self.nu = float(u.max() / Re)
        z = dict(dtype=dtype, device=self.device)
        self.state = Channel2DState(
            u=torch.tensor(u, **z), v=torch.tensor(v, **z),
            p=torch.tensor(p, **z), F=torch.tensor(self.F, **z))
        self.state, _, steps = self._solve(None, self.F)
        self.iterations = [steps]
        self.bulk_v = float(host_read(self.state.u.abs().mean()))
        self.init_bulk_v = None
        self.info_init = None
        self.syncs = 0

    def _solve(self, bc, F, max_step=-1):
        return solve(self.state, bc, self.dx, self.dy, self.dt, self.rho,
                     self.nu, F, nit=self.nit, max_step=max_step,
                     check_every=self.check_every)

    @property
    def u(self):
        return host_read(self.state.u)

    @property
    def v(self):
        return host_read(self.state.v)

    @property
    def p(self):
        return host_read(self.state.p)

    def cal_bulk_v(self):
        return float(host_read(self.state.u.abs().mean()))

    def _div(self):
        s = self.state
        return (s.u[10, 10] - s.u[9, 10]) / self.dx \
            + (s.v[10, 10] - s.v[10, 9]) / self.dy

    def cal_div(self):
        return float(host_read(self._div()))

    def reward_div(self, bound=-100.0):
        return max(-abs(self.cal_div()), bound)

    def _speed_norm(self):
        return torch.linalg.norm(self.state.u) \
            + torch.linalg.norm(self.state.v)

    def cal_speed_norm(self):
        return float(host_read(self._speed_norm()))

    def _shear_stress(self):
        s = self.state
        dudy = (s.u[-1] - s.u[-2]) / self.dy
        tau = -s.u[-1] * s.v[-1] + self.nu * dudy
        return tau.mean().abs()

    def cal_shear_stress(self):
        return float(host_read(self._shear_stress()))

    def cal_velocity_mean(self, name="U", sample_index=None):
        a = self.state.u if name == "U" else self.state.v
        return float(host_read(a.abs().mean()))

    def get_top_pressure(self):
        return host_read(self.state.p[-1])

    def gt_control(self):
        """The opposition control: minus v on the detection rows, as
        (bottom, top) tensors on the env's device (no host read)."""
        return -self.state.v[-self.detect_plane].clone(), \
            -self.state.v[self.detect_plane].clone()

    def reset_init(self):
        self.init_bulk_v = self.cal_bulk_v()
        self.info_init = None

    def cal_relative_info(self, info):
        if not self.info_init:
            self.info_init = dict(info)
        rel = {}
        for k, value in info.items():
            if "divergence" in k or not k.startswith("drag_reduction/"):
                continue
            denom = self.info_init[k]
            rel[k.replace("drag_reduction", "drag_reduction_relative")] = \
                value / denom if denom else 0.0
        return rel

    def step(self, bc, print_info: bool = False):
        """One control step: 3 iterations from the state with the wall
        values `bc` = (bottom, top) (arrays or tensors) or None, then with
        `fix_flow` the bisection on F.  Returns (top pressure, reward,
        done, info) as the JAX env does.  The scoreboard and the top
        pressure come to the host in one read."""
        reads = host_read.count
        if bc is not None:
            z = dict(dtype=self.dtype, device=self.device)
            bc = (torch.as_tensor(bc[0], **z), torch.as_tensor(bc[1], **z))
        self.state, _, steps = self._solve(bc, self.state.F, max_step=3)
        self.iterations = [steps]
        if self.init_bulk_v is None:
            self.reset_init()
        if self.fix_flow:
            F, _ = solve_fixed_mass(
                self.state, bc, self.init_bulk_v, self.dx, self.dy, self.dt,
                self.rho, self.nu, max_f=3 * self.F,
                check_every=self.check_every, iterations=self.iterations)
            self.state = self.state._replace(F=F.to(self.dtype))
        s = self.state
        vals = host_read(torch.cat([torch.stack([
            self._shear_stress(), s.u.abs().mean(), s.v.abs().mean(),
            self._div(), self._speed_norm(), s.F]), s.p[-1]]))
        shear, mass, vmean, div, speed, F = (float(a) for a in vals[:6])
        pressure_top = vals[6:]
        info = {
            "drag_reduction/1_shear_stress": shear,
            "drag_reduction/2_1_mass_flow": mass,
            "drag_reduction/2_2_v_velocity": vmean,
            "drag_reduction/3_1_pressure_mean": float(pressure_top.mean()),
            "drag_reduction/3_2_dPdx_required": F if self.fix_flow else -1.0,
            "drag_reduction/4_1_-|divergence|": max(-abs(div), -100.0),
            "drag_reduction/4_2_speed_norm": speed,
        }
        self.syncs = host_read.count - reads
        if not np.isfinite(speed):
            raise RuntimeError("control exploded!")
        info.update(self.cal_relative_info(info))
        if print_info:
            print(info)
        return pressure_top, info["drag_reduction/4_1_-|divergence|"], \
            False, info
