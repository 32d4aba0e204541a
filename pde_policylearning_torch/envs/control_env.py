"""Stateful channel-flow control environment (the reference's method
surface), on the port's torch DNS core.

Counterpart of `pde_policylearning_tpu/envs/control_env.py:NSControlEnv`.
The state lives on `device` (None: the card) between steps; on a CUDA
device the Poisson solves, the wall pressures and the env step go through
the hand-written kernels (see `channel_flow.py`, `rk3_cuda.py`).  `step_n`
and the spin-up advance many steps with no host sync inside.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device, set_solver_precision
from . import channel_flow as cf


def default_snapshot_path() -> Optional[str]:
    """The developed-turbulence snapshot (Re_tau ~ 180, 32x130x32; U, V, W,
    dPdx) packaged with this package under data/assets.  None if
    absent."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                        "assets", "channel180_minchan.npz")
    return path if os.path.exists(path) else None


def _relative_loss(a, b):
    return torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(a)


def _scan_steps(grid, state, opV1_seq, opV2_seq, n_steps: int):
    """Advance n_steps with a per-step action sequence (`rk3_step`), then
    the wall pressures and the scoreboard of each step, all kept on the
    device.  Returns (state', p2s (n, Nx, Nz), {key: (n,) tensor})."""
    p2s = torch.empty((n_steps, grid.Nx, grid.Nz), dtype=state.U.dtype,
                      device=state.U.device)
    infos = []
    for i in range(n_steps):
        state = cf.rk3_step(grid, state, opV1_seq[i], opV2_seq[i])
        _, p2s[i] = cf.boundary_pressures(grid, state)
        infos.append(cf.step_metrics(grid, state, p2s[i]))
    return state, p2s, {k: torch.stack([info[k] for info in infos])
                        for k in infos[0]}


class NSControlEnv:
    """Channel-flow control env: step / gt_control / rand_control /
    get_boundary_pressures / reward_* / cal_* / dump_state / load_state
    (control_env.py:22-664 of the reference)."""

    def __init__(self, Nx=32, Ny=130, Nz=32, Re: float = -1.0,
                 detect_plane: int = 25, test_plane: int = 124,
                 dt: float = 1e-3, dtype=torch.float32,
                 init_cond_path: Optional[str] = None,
                 noise_scale: float = 0.0, seed: int = 0,
                 spinup_steps: int = 0, device=None):
        self.device = resolve_device(device)
        set_solver_precision()
        nu = cf.DEFAULT_NU
        default_re = 178.1899          # control_env.py:27
        if Re > 0:
            nu = nu * (default_re / Re)
        self.detect_plane = detect_plane
        self.test_plane = test_plane
        self.dtype = dtype
        self.grid = cf.make_channel_grid(Nx=Nx, Ny=Ny, Nz=Nz, nu=nu, dt=dt,
                                         dtype=dtype, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        if init_cond_path is None and Re <= 0 and (Nx, Ny, Nz) == (32, 130, 32):
            # start from the developed-turbulence snapshot
            # (control_env.py:149-180), with optional noise on top
            init_cond_path = default_snapshot_path()
        if init_cond_path is not None:
            self.load_state(init_cond_path)
            if noise_scale:
                self.add_random_noise(noise_scale)
                # re-admit the state: raw noise has divergence ~ noise/dy at
                # the graded wall cells, which one f32 RK3 substep cannot
                # cleanly project
                s = self.state
                zeros = torch.zeros((Nx, Nz), dtype=dtype, device=self.device)
                U, V, W = cf.apply_boundary_condition(s.U, s.V, s.W,
                                                      zeros, zeros)
                U, V, W = cf.projection_step(self.grid, U, V, W)
                U, V, W = cf.apply_boundary_condition(U, V, W, zeros, zeros)
                self.state = s.replace(U=U, V=V, W=W)
        else:
            self.state = cf.init_state(self.grid, generator=self.generator,
                                       noise=noise_scale)
        if spinup_steps:
            z = torch.zeros((spinup_steps, Nx, Nz), dtype=dtype,
                            device=self.device)
            self.state, _, _ = _scan_steps(self.grid, self.state, z, z,
                                           spinup_steps)

        self.U_gt = self.state.U.clone()
        self.V_gt = self.state.V.clone()
        self.W_gt = self.state.W.clone()
        self.meanU0 = float(self.state.meanU0)

        init_p = self.cal_pressure()
        self.speed_min = float(min(self.U.min(), self.V.min(), self.W.min()))
        self.speed_max = float(max(self.U.max(), self.V.max(), self.W.max()))
        self.p_min = max(-2.0, float(init_p.min()))
        self.p_max = min(float(init_p.max()), 1.5)
        self.info_init = self._fetch_info(self._device_info())

    # -- raw field access (host copies) -------------------------------------
    @property
    def U(self):
        return self.state.U.cpu().numpy()

    @property
    def V(self):
        return self.state.V.cpu().numpy()

    @property
    def W(self):
        return self.state.W.cpu().numpy()

    @property
    def dPdx(self):
        return float(self.state.dPdx)

    @property
    def nu(self):
        return self.grid.nu

    def _tensor(self, a):
        """Host array -> tensor on the env's device in its dtype."""
        return torch.as_tensor(np.asarray(a)).to(self.device, self.dtype)

    # -- state persistence (control_env.py:134-180) --------------------------
    def dump_state(self, save_path: str):
        g = self.grid
        data = {"y": g.y.cpu().numpy(), "ym": g.ym.cpu().numpy(),
                "U": self.U, "V": self.V, "W": self.W, "dPdx": self.dPdx}
        if save_path.endswith(".mat"):
            import scipy.io
            scipy.io.savemat(save_path, data)
        else:
            np.savez(save_path, **data)

    def load_state(self, load_path: str):
        if load_path.endswith(".mat"):
            import scipy.io
            data = scipy.io.loadmat(load_path, mat_dtype=True)
            if "UU" in data:  # raw solver snapshot with staggering offsets
                Nx, Nz = self.grid.Nx, self.grid.Nz
                U = data["UU"][0:Nx, :, 1:Nz + 1]
                V = data["VV"][1:Nx + 1, :, 1:Nz + 1]
                W = data["WW"][1:Nx + 1, :, 0:Nz]
            else:
                U, V, W = data["U"], data["V"], data["W"]
        else:
            data = dict(np.load(load_path))
            U, V, W = data["U"], data["V"], data["W"]
        # V may be stored with Ny+1 rows (file convention); keep Ny faces
        if V.shape[1] == self.grid.Ny + 1:
            V = V[:, :self.grid.Ny, :]
        dPdx = float(np.asarray(data.get("dPdx", cf.DEFAULT_DPDX)).ravel()[0])
        self.state = cf.init_state(self.grid, U=U, V=V, W=W, dPdx=dPdx,
                                   dtype=self.dtype)

    def add_random_noise(self, noise_scale, overwrite=False):
        s = self.state

        def draw(a):
            return noise_scale * torch.randn(a.shape, generator=self.generator,
                                             dtype=a.dtype, device=a.device)
        nU, nV, nW = draw(s.U), draw(s.V), draw(s.W)
        if overwrite:
            self.state = s.replace(U=nU, V=nV, W=nW)
        else:
            self.state = s.replace(U=s.U + nU, V=s.V + nV, W=s.W + nW)

    # -- scores (control_env.py:182-340) -------------------------------------
    def cal_div(self):
        return cf.divergence(self.grid, self.state.U, self.state.V,
                             self.state.W).cpu().numpy()

    def cal_pressure(self):
        return cf.compute_pressure(self.grid, self.state).cpu().numpy()

    def get_boundary_pressures(self):
        p1, p2 = cf.boundary_pressures(self.grid, self.state)
        return p1.cpu().numpy(), p2.cpu().numpy()

    def cal_bulk_v(self):
        return float(cf.calculate_mean_u(self.grid, self.state.U))

    def cal_speed_norm(self):
        return float(cf.speed_norm(self.state))

    def cal_shear_stress(self):
        return float(cf.shear_stress(self.grid, self.state))

    def reward_div(self, bound=-100.0):
        return float(cf.reward_divergence(self.grid, self.state, bound))

    def reward_gt(self, bound=-100.0):
        r = -(_relative_loss(self.U_gt, self.state.U)
              + _relative_loss(self.V_gt, self.state.V)
              + _relative_loss(self.W_gt, self.state.W))
        return max(float(r), bound)

    def reward_td(self, prev_U, prev_V, prev_W, bound=-100.0):
        r = -(_relative_loss(self._tensor(prev_U), self.state.U)
              + _relative_loss(self._tensor(prev_V), self.state.V)
              + _relative_loss(self._tensor(prev_W), self.state.W))
        return max(float(r), bound)

    def cal_relative_info(self, info):
        return {k.replace("drag_reduction", "drag_reduction_relative"):
                v / self.info_init[k]
                for k, v in info.items() if "divergence" not in k}

    # -- policies (control_env.py:404-421) -----------------------------------
    def reset_init(self):
        self.info_init = None

    def gt_control(self):
        opV1, opV2 = cf.gt_control(self.state, self.detect_plane)
        return opV1.cpu().numpy(), opV2.cpu().numpy()

    def rand_control(self, P=None):
        shape = (self.grid.Nx, self.grid.Nz)
        return cf.rand_control(self.generator, shape, dtype=self.dtype,
                               device=self.device).cpu().numpy()

    # -- physics-informed loss (control_env.py:627-633) ----------------------
    def pde_loss(self, U, Vgt, V, W, dPdx):
        U, Vgt, V, W = (self._tensor(a) for a in (U, Vgt, V, W))
        Fu_gt, Fv_gt, Fw_gt = cf.compute_rhs(self.grid, U, Vgt, W, dPdx)
        Fu_p, Fv_p, Fw_p = cf.compute_rhs(self.grid, U, V, W, dPdx)
        return (torch.linalg.vector_norm(Fu_gt - Fu_p)
                + torch.linalg.vector_norm(Fv_gt - Fv_p)
                + torch.linalg.vector_norm(Fw_gt - Fw_p))

    # -- stepping ------------------------------------------------------------
    def _device_info(self):
        _, p2 = cf.boundary_pressures(self.grid, self.state)
        return cf.step_metrics(self.grid, self.state, p2)

    @staticmethod
    def _fetch_info(info):
        # one host copy for the whole scoreboard
        vals = torch.stack([v.reshape(()) for v in info.values()]).cpu()
        return {k: float(v) for k, v in zip(info, vals)}

    def step(self, opV1, opV2):
        """Advance one step through `channel_flow.env_step`; returns
        (p2, div_reward, done, info) like control_env.py:639-664."""
        self.state, p2, _, info = cf.env_step(
            self.grid, self.state, self._tensor(opV1), self._tensor(opV2))
        host_info = self._fetch_info(info)
        if self.info_init:
            host_info.update(self.cal_relative_info(host_info))
        return (p2.cpu().numpy(), host_info["drag_reduction/4_1_-|divergence|"],
                False, host_info)

    def step_n(self, opV1_seq, opV2_seq):
        """Advance len(opV1_seq) steps with no host sync inside; returns the
        stacked wall pressures (n, Nx, Nz) and the metric time series
        {key: (n,)}, fetched to the host once."""
        n = int(np.asarray(opV1_seq).shape[0])
        self.state, p2s, infos = _scan_steps(
            self.grid, self.state, self._tensor(opV1_seq),
            self._tensor(opV2_seq), n)
        vals = torch.cat([p2s.reshape(-1),
                          torch.stack(list(infos.values())).reshape(-1)]
                         ).cpu().numpy()
        p2_host = vals[:p2s.numel()].reshape(p2s.shape)
        series = vals[p2s.numel():].reshape(len(infos), n)
        return p2_host, dict(zip(infos, series))
