"""The port's channel-flow core (pde_policylearning_torch/envs/
channel_flow.py) against the JAX package's, in float64 on the CPU, from
the same numpy inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.envs import channel_flow as jcf
from pde_policylearning_torch.envs import channel_flow as cf

RTOL = 1e-10


def grid_arrays(jgrid):
    return {f.name: np.asarray(getattr(jgrid, f.name))
            for f in dataclasses.fields(jgrid)}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-300))


def t2n(a):
    return a.detach().cpu().numpy()


@pytest.fixture(scope="module")
def setup():
    jgrid = jcf.make_channel_grid(Nx=8, Ny=33, Nz=8, dtype=jnp.float64)
    grid = cf.grid_from_arrays(grid_arrays(jgrid), dtype=torch.float64,
                               device="cpu")
    rng = np.random.default_rng(0)
    Nx, Ny, Nz = 8, 33, 8
    yg = np.asarray(jgrid.yg)
    u_lam = jcf.DEFAULT_DPDX / (2 * jgrid.nu) * yg * (2.0 - yg) / 2.0
    fields = {
        "U": u_lam[None, :, None] + 0.05 * rng.normal(size=(Nx, Ny + 1, Nz)),
        "V": 0.05 * rng.normal(size=(Nx, Ny, Nz)),
        "W": 0.05 * rng.normal(size=(Nx, Ny + 1, Nz)),
        "dPdx": np.asarray(jcf.DEFAULT_DPDX), "meanU0": np.asarray(1.0),
    }
    jstate = jcf.ChannelState(**{k: jnp.asarray(v) for k, v in
                                 fields.items()})
    state = cf.state_from_arrays(fields, dtype=torch.float64, device="cpu")
    return jgrid, grid, jstate, state


def test_grid_builder_matches_jax():
    jgrid = jcf.make_channel_grid(Nx=8, Ny=33, Nz=8, dtype=jnp.float64)
    grid = cf.make_channel_grid(Nx=8, Ny=33, Nz=8, dtype=torch.float64,
                                device="cpu")
    for name, ref in grid_arrays(jgrid).items():
        ours = getattr(grid, name)
        if isinstance(ours, torch.Tensor):
            ref = np.asarray(ref)
            np.testing.assert_allclose(
                t2n(ours), ref, rtol=1e-12,
                atol=1e-12 * float(np.abs(ref).max()), err_msg=name)
        else:
            assert ours == ref, name
    assert grid.refine_steps == 0
    assert cf.make_channel_grid(Nx=8, Ny=33, Nz=8,
                                device="cpu").refine_steps == 1


def test_compute_rhs_and_divergence(setup):
    jgrid, grid, js, s = setup
    ref = jcf._compute_rhs_unfused(jgrid, js.U, js.V, js.W, js.dPdx)
    out = cf.compute_rhs(grid, s.U, s.V, s.W, s.dPdx)
    for a, b in zip(out, ref):
        assert rel(t2n(a), b) < RTOL
    assert rel(t2n(cf.divergence(grid, s.U, s.V, s.W)),
               jcf.divergence(jgrid, js.U, js.V, js.W)) < RTOL


def test_projection_step_is_divergence_free(setup):
    jgrid, grid, js, s = setup
    ref = jcf.projection_step(jgrid, js.U, js.V, js.W)
    out = cf.projection_step(grid, s.U, s.V, s.W)
    for a, b in zip(out, ref):
        assert rel(t2n(a), b) < RTOL
    # with no net wall flux the projection leaves roundoff only
    zeros = torch.zeros((8, 8), dtype=torch.float64)
    U, V, W = cf.apply_boundary_condition(s.U, s.V, s.W, zeros, zeros)
    div0 = cf.divergence(grid, U, V, W).abs().max()
    out = cf.projection_step(grid, U, V, W)
    div = cf.divergence(grid, *out).abs().max()
    assert div < 1e-10 * div0


def test_mean_u_pressures_and_metrics(setup):
    jgrid, grid, js, s = setup
    np.testing.assert_allclose(float(cf.calculate_mean_u(grid, s.U)),
                               float(jcf.calculate_mean_u(jgrid, js.U)),
                               rtol=RTOL)
    p1_ref, p2_ref = jcf._boundary_pressures_unfused(jgrid, js)
    p1, p2 = cf.boundary_pressures(grid, s)
    assert rel(t2n(p1), p1_ref) < RTOL
    assert rel(t2n(p2), p2_ref) < RTOL
    ref = jcf.step_metrics(jgrid, js, p2_ref)
    out = cf.step_metrics(grid, s, torch.as_tensor(np.array(p2_ref)))
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=RTOL,
                                   atol=1e-12, err_msg=k)
