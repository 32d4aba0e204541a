"""The channel DNS over the mesh: x-sharded stepping over the model group,
and data-parallel rollouts of an env batch over the data group.

Counterpart of `pde_policylearning_tpu/parallel/sharded_env.py`.  The JAX
package runs the unchanged `rk3_step` under sharding annotations and XLA
inserts the halo exchanges and the FFT re-layouts; here they are explicit
collectives around the port's plain functions.

x-sharded state (`shard_env_state`, `sharded_step`, `sharded_rollout`):
model rank r holds the x-slab [r L, (r + 1) L), L = Nx / P, of U, V, W;
dPdx and meanU0 are whole on every rank.  A substage pads each slab with
HALO planes of its periodic neighbours (one all-gather of the edge
planes), runs `channel_flow`'s `compute_rhs`, RK update, BCs, `divergence`
and `pressure_correction` unchanged, and crops.  HALO = 2: the momentum
RHS reaches one plane either side, the divergence of the updated fields
one more; the correction reaches one back into the pressure.  The
projection's solve: rfft over z on each slab, an all-to-all from x-slabs
to blocks of z wavenumbers (Nz // 2 + 1 is odd, so the blocks are uneven),
fft over x, the y eigen-solve of each mode with its refinement passes
(`poisson_cuda.spectral_solve`), and the inverse.  The mass-flow mean is a
float64 all-reduce taken in rank order, so dPdx has the same bits on every
rank.  The port's own rule: Nx % P == 0, Nx / P >= HALO and
P <= Nz // 2 + 1 (XLA's P <= sqrt(Nx) is not carried over).  These run
plain torch on either device and launch no kernel of the port, as the
JAX route runs the unfused XLA step.

Data-parallel rollout (`shard_env_batch`, `data_parallel_rollout`): each
data rank runs `channel_flow.batched_rollout` on its block of the env
batch, so on the card each step is one kernel-D launch per rank (or
kernels A, B and C with `rk3_cuda.FULLSTEP` off); the envs never
communicate.  `rand` draws are made for the whole batch and sliced, so
every policy gives what `batched_rollout` gives for those envs.  There is
no counterpart of `force_unfused_poisson`: each rank's kernels see whole
fields.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.distributed as dist

from ..envs import channel_flow as cf
from ..envs import rk3_cuda as rk
from ..envs.poisson_cuda import spectral_solve
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, axis_slice, gather,
                   ordered_sum)

HALO = 2
_STATE = ("U", "V", "W", "dPdx", "meanU0")


def check_x_split(grid: cf.ChannelGrid, P: int) -> None:
    """The port's rule for an x-split over P ranks."""
    Nzr = grid.Nz // 2 + 1
    if grid.Nx % P or grid.Nx // P < HALO or P > Nzr:
        raise ValueError(
            f"x-sharding over {P} ranks needs Nx % P == 0, Nx / P >= {HALO} "
            f"and P <= Nz // 2 + 1 = {Nzr}; the grid is {grid.Nx} x "
            f"{grid.Ny} x {grid.Nz}")


def _kz_blocks(Nzr: int, P: int):
    """(start, size) of each rank's block of z wavenumbers, the first
    Nzr % P ranks one larger."""
    sizes = [Nzr // P + (r < Nzr % P) for r in range(P)]
    starts = [sum(sizes[:r]) for r in range(P)]
    return list(zip(starts, sizes))


# ---------------------------------------------------------------------------
# collectives over the model group
# ---------------------------------------------------------------------------

def _halo(mesh: Mesh, arrays, h: int = HALO):
    """Each x-slab of `arrays` (x leading) with h planes of its periodic
    neighbours' before and after it, in one all-gather of the edge planes
    of all of them."""
    edges = torch.cat([torch.cat([a[:h], a[-h:]]).reshape(2 * h, -1)
                       for a in arrays], dim=1)
    P, r = mesh.mp, mesh.model_rank
    parts = gather(mesh, edges[None], MODEL_AXIS)   # (P, 2h, -1)
    left, right = parts[(r - 1) % P][h:], parts[(r + 1) % P][:h]
    out, i = [], 0
    for a in arrays:
        w = a[0].numel()
        out.append(torch.cat([left[:, i:i + w].reshape(h, *a.shape[1:]), a,
                              right[:, i:i + w].reshape(h, *a.shape[1:])]))
        i += w
    return out


def _crop(a, h: int = HALO):
    return a[h:a.shape[0] - h]


def _all_to_all(mesh: Mesh, send, recv_shapes):
    """send[q] to model rank q; from each rank q a tensor of
    recv_shapes[q]."""
    if mesh.model_group is None:
        return [send[0]]
    inp = torch.cat([s.reshape(-1) for s in send])
    sizes = [int(torch.Size(s).numel()) for s in recv_shapes]
    out = inp.new_empty(sum(sizes))
    dist.all_to_all_single(out, inp, output_split_sizes=sizes,
                           input_split_sizes=[s.numel() for s in send],
                           group=mesh.model_group)
    return [o.reshape(s) for o, s in zip(out.split(sizes), recv_shapes)]


def _sharded_spectral(mesh: Mesh, grid: cf.ChannelGrid, rhs, solve):
    """`solve(R, kz0)` of the x/z spectrum of the field whose x-slab is
    rhs (L, n, Nz), R real-stacked (2, Nx, n, k) over this rank's block of
    z wavenumbers from kz0; returns the x-slab (L, rows, Nz) of the
    inverse transform of what it returns (2, Nx, rows, k).  The transforms
    are those of `poisson_cuda.poisson_solve_plain` (rfft over z, fft over
    x, and back), around two all-to-alls."""
    P, r = mesh.mp, mesh.model_rank
    L, n, Nz = rhs.shape
    blocks = _kz_blocks(Nz // 2 + 1, P)
    k0, k = blocks[r]
    Rz = torch.view_as_real(torch.fft.rfft(rhs, dim=-1))       # (L, n, Nzr, 2)
    got = _all_to_all(mesh, [Rz[:, :, s:s + m] for s, m in blocks],
                      [(L, n, k, 2)] * P)
    X = torch.view_as_complex(torch.cat(got).contiguous())     # (Nx, n, k)
    Rc = torch.fft.fft(X, dim=0)
    Pm = solve(torch.stack([Rc.real, Rc.imag]), k0)
    Pr = torch.view_as_real(torch.fft.ifft(torch.complex(Pm[0], Pm[1]),
                                           dim=0))       # (Nx, rows, k, 2)
    rows = Pr.shape[1]
    got = _all_to_all(mesh, [Pr[q * L:(q + 1) * L] for q in range(P)],
                      [(L, rows, m, 2) for _, m in blocks])
    Pz = torch.view_as_complex(torch.cat(got, dim=2).contiguous())
    return torch.fft.irfft(Pz, n=Nz, dim=-1)


def _wall_rows(grid: cf.ChannelGrid, R, kz0: int):
    """The four wall-adjacent rows (0, 1, n-2, n-1) of the full-basis
    eigen-solve of R (2, Nx, n, k), the (0,0) mode through the
    equilibrated regularized solve: the JAX `_boundary_pressures_unfused`
    (channel_flow.py:576-599), which the JAX sharded rollout runs."""
    k = R.shape[-1]
    n = grid.Ny - 1
    kk = grid.kxx[:, None, None] + grid.kzz[None, None, kz0:kz0 + k]
    denom = grid.eig_lam[None, :, None] + kk
    denom = torch.where(denom.abs() < 1e-12, torch.ones_like(denom), denom)
    rows = [0, 1, n - 2, n - 1]
    P4 = grid.eig_A[rows] @ ((grid.eig_B @ R) / denom)        # (2, Nx, 4, k)
    if kz0 == 0:
        s = grid.s00
        p00 = s * ((s * R[:, 0, :, 0]) @ grid.Pinv00_eq.T)    # (2, n)
        P4[:, 0, :, 0] = p00[:, rows]
    return P4


def _mass_flow(mesh: Mesh, grid: cf.ChannelGrid, state: cf.ChannelState):
    """The mass-flow correction of x-slabs: the bulk velocity's profile an
    all-reduce of float64 slab sums in rank order, then the kernels'
    float64 trapezoid and d_new (`rk3_cuda.mass_flow_of_profile`)."""
    U = state.U
    prof = ordered_sum(mesh, U[:, 1:-1, :].double().sum(dim=(0, 2)),
                       MODEL_AXIS) / (grid.Nx * grid.Nz)
    half, dPdx = rk.mass_flow_of_profile(grid, prof, state.meanU0,
                                         state.dPdx, U.dtype)
    U = torch.cat([U[:, :1], U[:, 1:-1] + half, U[:, -1:]], 1)
    return state.replace(U=U, dPdx=dPdx)


# ---------------------------------------------------------------------------
# x-sharded state
# ---------------------------------------------------------------------------

def shard_env_state(mesh: Mesh, state: cf.ChannelState) -> cf.ChannelState:
    """This model rank's x-slab of U, V, W (dPdx, meanU0 whole), on the
    mesh's device."""
    sl = axis_slice(mesh, state.U.shape[0], MODEL_AXIS)
    return cf.ChannelState(
        *(a[sl].to(mesh.device).contiguous() for a in
          (state.U, state.V, state.W)),
        dPdx=state.dPdx.to(mesh.device), meanU0=state.meanU0.to(mesh.device))


def gather_x(mesh: Mesh, a: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The whole x axis of a tensor sharded along `dim` over the model
    group (an all-gather)."""
    return gather(mesh, a, MODEL_AXIS, dim)


def _step_slabs(mesh: Mesh, grid: cf.ChannelGrid, state: cf.ChannelState,
                op1, op2) -> cf.ChannelState:
    """One RK3 step of x-slabs; op1, op2 this rank's (L, Nz) planes."""
    U0, V0, W0, o1, o2 = _halo(mesh, (state.U, state.V, state.W, op1, op2))
    solve = partial(spectral_solve, grid)

    def project(U, V, W):
        div = _crop(cf.divergence(grid, U, V, W))
        p, = _halo(mesh, (_sharded_spectral(mesh, grid, div, solve),))
        U, V, W = cf.pressure_correction(grid, U, V, W, p)
        return _halo(mesh, [_crop(a) for a in (U, V, W)])

    U, V, W = cf._rk3_substages(grid, state.replace(U=U0, V=V0, W=W0), o1,
                                o2, project)
    return _mass_flow(mesh, grid, state.replace(
        U=_crop(U), V=_crop(V), W=_crop(W)))


def _boundary_pressures(mesh: Mesh, grid: cf.ChannelGrid,
                        state: cf.ChannelState):
    """(p1, p2), this rank's (L, Nz) slabs of the wall pressures of an
    x-sharded state."""
    U, V, W = _halo(mesh, (state.U, state.V, state.W))
    Fu, Fv, Fw = cf.compute_rhs(grid, U, V, W, state.dPdx)
    rhs = _crop(cf.divergence(grid, Fu, Fv, Fw))
    P4 = _sharded_spectral(mesh, grid, rhs, partial(_wall_rows, grid))
    return -0.5 * (P4[:, 0] + P4[:, 1]), -0.5 * (P4[:, 3] + P4[:, 2])


def sharded_step(mesh: Mesh, grid: cf.ChannelGrid, state: cf.ChannelState,
                 opV1, opV2) -> cf.ChannelState:
    """One RK3 step of an x-sharded state (`shard_env_state`): the JAX
    `rk3_step` on the whole fields, slab by slab.  opV1, opV2 are the
    whole (Nx, Nz) actuation planes."""
    check_x_split(grid, mesh.mp)
    sl = axis_slice(mesh, grid.Nx, MODEL_AXIS)
    return _step_slabs(mesh, grid, state, opV1.to(mesh.device)[sl],
                       opV2.to(mesh.device)[sl])


def sharded_rollout(mesh: Mesh, grid: cf.ChannelGrid,
                    state: cf.ChannelState, n_steps: int,
                    detect_plane: int = 25):
    """Opposition-control rollout of an x-sharded state.  Returns (this
    rank's final slabs, p2 (T, L, Nz) this rank's slab of each step's
    top-wall pressure; `gather_x(mesh, p2, dim=1)` gives the whole)."""
    check_x_split(grid, mesh.mp)
    p2s = []
    for _ in range(n_steps):
        o1, o2 = cf.gt_control(state, detect_plane)
        state = _step_slabs(mesh, grid, state, o1, o2)
        p2s.append(_boundary_pressures(mesh, grid, state)[1])
    return state, torch.stack(p2s)


# ---------------------------------------------------------------------------
# data-parallel env batch
# ---------------------------------------------------------------------------

def shard_env_batch(mesh: Mesh, states: cf.ChannelState) -> cf.ChannelState:
    """This data rank's block of a batched ChannelState (leading env axis
    on every leaf), on the mesh's device."""
    sl = axis_slice(mesh, states.U.shape[0], DATA_AXIS)
    return cf.ChannelState(**{k: getattr(states, k)[sl].to(mesh.device)
                              for k in _STATE})


def data_parallel_rollout(mesh: Mesh, grid: cf.ChannelGrid,
                          states: cf.ChannelState, n_steps: int,
                          detect_plane: int = 25, policy: str = "gt",
                          collect_fields: bool = False,
                          generator: Optional[torch.Generator] = None):
    """`channel_flow.batched_rollout` of the whole batch `states`, each
    data rank stepping its block of envs (no collective in the loop).
    Returns this rank's block of what `batched_rollout` returns for the
    whole batch (`parallel.gather(mesh, t, 'data')` on each gives the
    whole).
    `generator` as in `batched_rollout`, the same seed on every rank."""
    n = states.U.shape[0]
    sl = axis_slice(mesh, n, DATA_AXIS)
    return cf.batched_rollout(grid, shard_env_batch(mesh, states), n_steps,
                              detect_plane=detect_plane, policy=policy,
                              generator=generator,
                              collect_fields=collect_fields,
                              batch_of=(sl.start, n))
