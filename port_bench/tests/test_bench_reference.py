"""The plain references against the port's plain CPU versions at small
sizes, in float64."""
import numpy as np
import torch

from port_bench import harness
from port_bench.reference import channel as ref
from port_bench.reference import pino as rpino


def _rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


def test_dns_step_matches_the_ports_plain_step():
    from pde_policylearning_torch.envs import channel_flow as cf
    from pde_policylearning_torch.envs import rk3_cuda as rk
    f64 = torch.float64
    g = ref.make_grid(Nx=8, Ny=33, Nz=8)
    pg = cf.make_channel_grid(Nx=8, Ny=33, Nz=8, dtype=f64, device="cpu")
    gen = torch.Generator().manual_seed(3)
    U = 0.1 * torch.randn((2, 8, 34, 8), generator=gen, dtype=f64) + 1.0
    V = 0.1 * torch.randn((2, 8, 33, 8), generator=gen, dtype=f64)
    W = 0.1 * torch.randn((2, 8, 34, 8), generator=gen, dtype=f64)
    U, V, W = ref.admitted_state(g, U, V, W)
    assert float(ref.divergence(g, U, V, W).abs().max()) < 1e-9
    dP = torch.tensor([3e-3, 4e-3], dtype=f64)
    mU = ref.bulk(g, U) * 1.01
    op1, op2 = ref.opposition(V, 5)
    out = ref.step(g, U, V, W, dP, mU, op1, op2)
    pk = [rk._pack(a) for a in (U, V, W)]
    o1, o2 = (rk._pack(a[:, :, None, :]).reshape(1, -1) for a in (op1, op2))
    PU, PV, PW, PdP, pp = rk.env_step_full_kb_plain(pg, 2, *pk, dP, mU, o1,
                                                     o2)
    for a, b in zip((PU, PV, PW), out[:3]):
        assert _rel(rk._unpack(a, pg, 2), b) < 1e-11
    assert _rel(PdP, out[3]) < 1e-9
    assert _rel(pp[1].reshape(2, 8, 8), out[4]) < 1e-10


def test_pino_matches_the_ports_model():
    from pde_policylearning_torch.models import PINObserverFullField
    cfg = dict(width=8, fc_dim=16, n_layers=4, in_dim=1, modes=(4, 4, 4))
    w = harness.pino_weights(cfg, 3, 5, "cpu", torch.float64)
    m = PINObserverFullField(
        plane_num=3, pad_ratio=(0.0, 0.0625), modes1=(4,) * 4,
        modes2=(4,) * 4, modes3=(4,) * 4, layers=(8,) * 5, fc_dim=16,
        in_dim=1, device="cpu", dtype=torch.float64)
    m.load_state_dict(w)
    for T in (1, 16):
        x = torch.randn(2, 12, 10, T, 1, dtype=torch.float64)
        re = torch.tensor([178.19, 300.0], dtype=torch.float64)
        b = rpino.plane_model(w, x, re, n_layers=4, modes=(4, 4, 4),
                              pad_ratio=(0.0, 0.0625))
        assert _rel(m(x, re), torch.movedim(b, -1, 1)) < 1e-12


def test_adam_matches_torch():
    p = {"a": torch.randn(5, dtype=torch.float64)}
    q = torch.nn.Parameter(p["a"].clone())
    opt = torch.optim.Adam([q], lr=1e-3)
    m, v = {"a": torch.zeros(5, dtype=torch.float64)}, \
        {"a": torch.zeros(5, dtype=torch.float64)}
    for t in range(1, 4):
        g = torch.randn(5, dtype=torch.float64)
        q.grad = g.clone()
        opt.step()
        rpino.adam_step(p, {"a": g}, m, v, t, 1e-3)
    assert np.allclose(p["a"].numpy(), q.detach().numpy(), rtol=1e-12,
                       atol=1e-15)
