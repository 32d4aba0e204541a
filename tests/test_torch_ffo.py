"""The full-field `optimal-observer` of the port against the benchmark's
plain reference (`port_bench/reference/ffo.py`, which imports nothing of
the port), and its CUDA graph against its eager path on the card.

On the CPU: the eager policy in float64 on the 8x33x8 env with a seeded
observer at `test_torch_flagship.py`'s small widths, three closed-loop
control steps, each compared with the reference's control step from the
same state.  On the card: the case of the graph's capture fault, on the
benchmark cell's own inputs at full width (`drivers/ffo.py:
capture_case`): the replays once read a one-element tensor that only the
captured function's closure held, freed after the first control step, so
that the graph parted from the eager path by 6e-2 to 2e-1.
"""
import numpy as np
import pytest
import torch

from pde_policylearning_torch.control import make_fullfield_optimal_observer
from pde_policylearning_torch.envs import NSControlEnv
from pde_policylearning_torch.envs import channel_flow as cf
from pde_policylearning_torch.envs import rk3_cuda as rk
from pde_policylearning_torch.models import PINObserverFullField
from pde_policylearning_torch.ops.normalization import NormalizerGivenMeanStd
from port_bench import harness
from port_bench.reference import ffo as rffo

SMALL = dict(Nx=8, Ny=33, Nz=8, detect_plane=5)
# the widths of tests/test_torch_flagship.py
MODEL = dict(modes1=(2, 2), modes2=(2, 2), modes3=(1, 1), layers=(8, 8, 8),
             fc_dim=8, in_dim=1)
SETTINGS = dict(re=178.19, opt_lr=1e-3, opt_steps=10, reg_weight=0.1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_eager_policy_against_the_reference():
    """Both sides compute in float64 from the same state; they part by the
    rounding of their different orders of summation (~1e-16), which the
    ten Adam steps carry through m / sqrt(v): an entry's step is about
    lr whatever its gradient's size, so the gap scales with the gradient's
    rounding over its own size.  Read: 2e-15 on the actuation, 0 on the
    bottom wall's (`gt` alone); limits 1e-12 and 0.  A control step that
    left out a part of the descent parts by over 1e-2 (the test below)."""
    g = torch.Generator().manual_seed(2 ** 31 + 21)
    env = NSControlEnv(**SMALL, dtype=torch.float64, noise_scale=0.02,
                       seed=1, device="cpu")
    obs = PINObserverFullField(plane_num=3, **MODEL, device="cpu",
                               dtype=torch.float64, generator=g)
    mean = 0.01 * torch.randn(8, 8, generator=g, dtype=torch.float64)
    std = 0.5 + torch.rand(8, 8, generator=g, dtype=torch.float64)
    policy = make_fullfield_optimal_observer(
        env.grid, observer_model=obs,
        bound_v_norm=NormalizerGivenMeanStd(mean, std),
        detect_plane=SMALL["detect_plane"], **SETTINGS)
    weights = {k: v.detach() for k, v in obs.state_dict().items()}
    kw = dict(detect_plane=SMALL["detect_plane"], re=SETTINGS["re"],
              opt_steps=SETTINGS["opt_steps"], lr=SETTINGS["opt_lr"],
              reg_weight=SETTINGS["reg_weight"], n_layers=2, modes=(2, 2, 1),
              pad_ratio=obs.pad_ratio, max_re=obs.max_re)
    kst = rk.state_to_kstate(env.state)
    _, p2 = cf.boundary_pressures(env.grid, env.state)
    moved = []
    for _ in range(3):
        V = rk.kstate_to_state(env.grid, kst).V
        op1, op2, _ = policy((), kst, p2, None)
        r1, r2 = rffo.control_step(weights, V[None], mean, std, **kw)
        a1, a2 = op1.reshape(8, 8), op2.reshape(8, 8)
        assert rel(a2, r2[0]) < 1e-12
        assert torch.equal(a1, r1[0])
        assert abs(float(a2.mean())) < 1e-15
        moved.append(rel(a2, -V[:, V.shape[1] - SMALL["detect_plane"]]))
        kst, p2, _ = rk.env_step_k(env.grid, kst, op1, op2)
    # the descent moved the action off `gt`'s
    assert min(moved) > 1e-3


@pytest.mark.parametrize("part", ["inner_step", "regularizer", "normalizer"])
def test_the_limit_sees_every_part_of_the_descent(part):
    """The reference without one part of the descent, against itself whole:
    one inner step fewer (read 0.91), the regularizer left out (3.3), the
    action encoded and decoded by other statistics (1.3e-2).  Each is far
    over the 1e-12 that the program is held to above."""
    g = torch.Generator().manual_seed(2 ** 31 + 22)
    env = NSControlEnv(**SMALL, dtype=torch.float64, noise_scale=0.02,
                       seed=1, device="cpu")
    obs = PINObserverFullField(plane_num=3, **MODEL, device="cpu",
                               dtype=torch.float64, generator=g)
    weights = {k: v.detach() for k, v in obs.state_dict().items()}
    mean = torch.zeros(8, 8, dtype=torch.float64)
    std = torch.ones(8, 8, dtype=torch.float64)
    kw = dict(detect_plane=SMALL["detect_plane"], re=178.19, lr=1e-3,
              n_layers=2, modes=(2, 2, 1), pad_ratio=obs.pad_ratio,
              max_re=obs.max_re)
    whole = dict(opt_steps=10, reg_weight=0.1)
    cut = dict(whole, **{"inner_step": dict(opt_steps=9),
                         "regularizer": dict(reg_weight=0.0),
                         "normalizer": {}}[part])
    V = env.state.V[None]
    base = rffo.control_step(weights, V, mean, std, **whole, **kw)[1]
    if part == "normalizer":
        mean, std = mean + 0.01, 2 * std
    other = rffo.control_step(weights, V, mean, std, **cut, **kw)[1]
    assert rel(other, base) > 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA graph exists on an NVIDIA card only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_against_eager_and_reference_on_the_cells_inputs(cuda_device):
    """The graph's first actuation against the eager path's (1e-5: both
    step the same Adam kernel, so only the capture could part them; read
    0 on the H100) and against the float64 reference (the cell's limit),
    and two replays from one state agree bit for bit with 64 one-element
    tensors allocated between them."""
    from port_bench.drivers import ffo
    limit = harness.cell_files(
        "pino-fullfield-oo.ffo-loop", "pino-fullfield-oo")[0]["limits"]
    got = ffo.capture_case(2 ** 31 + 2121)
    assert got["replays_equal"], got
    assert got["graph_eager"] <= 1e-5, got
    assert got["graph_ref"] <= limit["opV2_rel"], got
    assert got["eager_ref"] <= limit["opV2_rel"], got
