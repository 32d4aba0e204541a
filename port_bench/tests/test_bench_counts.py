"""The frozen counts against the bounds the port's kernel table gives
(PERF.md, the TPU-kernel table's bound column)."""
import pytest

from port_bench.counts import channel, peaks, pino


@pytest.mark.parametrize("name,B,ms", [
    ("rk3_fullstep", 1, 0.00837),
    ("eig_solve", 1, 0.00214),
    ("eig_solve", 8, 0.0171),
    ("rk3_substage", 1, 0.00160),
    ("rk3_substage", 8, 0.0128),
    ("poisson", 1, 0.00227),
    ("boundary_batched", 8, 0.00436),
])
def test_bound_column(name, B, ms):
    got = 1e3 * peaks.bound_s(*channel.work(name, B))
    assert got == pytest.approx(ms, rel=6e-3)


def test_pino_parameters():
    kw = dict(width=64, n_layers=4, modes=(12, 12, 12), fc_dim=128,
              in_dim=1)
    assert pino.n_params(out_dim=3, **kw) == 226526339
    assert pino.n_params(out_dim=1, **kw) == 226526081
    # the loop's policy at T = 1: 4 layers x 4 corners x 2 x 12 x 12 x 1
    # modes x 64 x 64, less 4 x 64 x 64 imaginary parts of the mean mode,
    # and the 33,665 parameters outside the spectral convs
    assert pino.n_live_params(out_dim=1, T=1, pad_ratio=(0.0, 0.0625),
                              **kw) == 18874368 - 16384 + 33665


@pytest.mark.parametrize("T", [1, 2, 8])
def test_live_parameters_are_those_with_a_gradient(T):
    """A small PolicyModel2D with seeded non-zero weights at the cell's
    pad ratio: one backward from random inputs gives a non-zero gradient
    to exactly `n_live_params` elements (T = 1 keeps one time mode of 4,
    T = 2 two with a real Nyquist mode, T = 8 all four)."""
    import torch

    from pde_policylearning_torch.models.pino import PolicyModel2D
    from port_bench import harness
    widths = dict(width=8, n_layers=2, fc_dim=16, in_dim=1)
    cfg = dict(widths, modes=[4, 4, 4])
    pad = harness.load_json(harness.BENCH, "configs",
                            "pino-fullfield.json")["pad_ratio"]
    model = PolicyModel2D(**harness.pino_model_kw(cfg), pad_ratio=pad,
                          device="cpu", dtype=torch.float64)
    g = torch.Generator().manual_seed(2 ** 31 + 7)
    std = {n: c or 0.1 for n, _, c in harness.pino_shapes(cfg, 1)}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(std[n] * torch.randn(p.shape, generator=g,
                                         dtype=p.dtype))
    x = torch.randn(2, 16, 16, T, 1, generator=g, dtype=torch.float64)
    out = model(x, torch.tensor([178.19, 400.0], dtype=torch.float64))
    (out * torch.randn(out.shape, generator=g, dtype=out.dtype)).sum() \
        .backward()
    live = sum(int((p.grad != 0).sum()) for p in model.parameters())
    assert live == pino.n_live_params(out_dim=1, T=T, pad_ratio=pad,
                                      modes=(4, 4, 4), **widths)
