"""The port's Poisson solve (pde_policylearning_torch/envs/poisson_cuda.py)
against the JAX package's: the plain version on the CPU, the CUDA kernel
against the plain version on a card."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.envs import channel_flow as jcf
from pde_policylearning_tpu.envs import poisson_pallas as pp
from pde_policylearning_torch.envs import channel_flow as cf
from pde_policylearning_torch.envs import poisson_cuda as pc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check)")
    return torch.device("cuda")


def grid_arrays(jgrid):
    return {f.name: np.asarray(getattr(jgrid, f.name))
            for f in dataclasses.fields(jgrid)}


def test_plain_matches_pallas_kernel_f32():
    """Against the Pallas kernel in interpret mode, with the JAX kernel
    test's own tolerance (tests/test_pallas_kernels.py)."""
    jgrid = jcf.make_channel_grid(Nx=8, Ny=17, Nz=8, dtype=jnp.float32)
    grid = cf.grid_from_arrays(grid_arrays(jgrid), dtype=torch.float32,
                               device="cpu")
    rhs = np.random.default_rng(3).normal(size=(8, 16, 8)).astype(np.float32)
    ref = pp._solve_impl(jgrid, jnp.asarray(rhs), interpret=True)
    out = pc.poisson_solve_plain(grid, torch.as_tensor(rhs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=1e-6)


def test_plain_matches_unfused_f64():
    jgrid = jcf.make_channel_grid(Nx=8, Ny=17, Nz=8, dtype=jnp.float64)
    grid = cf.grid_from_arrays(grid_arrays(jgrid), dtype=torch.float64,
                               device="cpu")
    rhs = np.random.default_rng(4).normal(size=(8, 16, 8))
    ref = np.asarray(jcf._poisson_solve_unfused(jgrid, jnp.asarray(rhs)))
    out = cf.poisson_solve(grid, torch.as_tensor(rhs)).numpy()
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 1e-10


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    grid = cf.make_channel_grid(Nx=32, Ny=130, Nz=32, device=cuda_device)
    rhs = torch.as_tensor(np.random.default_rng(5).normal(
        size=(32, 129, 32)).astype(np.float32), device=cuda_device)
    before = pc.poisson_solve_kernel.launches
    out = cf.poisson_solve(grid, rhs)
    torch.cuda.synchronize()
    assert pc.poisson_solve_kernel.launches == before + 1
    ref = pc.poisson_solve_plain(grid, rhs)
    assert float((out - ref).norm() / ref.norm()) < 2e-5
    with pytest.raises(ValueError):
        pc.poisson_solve_kernel(grid, rhs.double())
