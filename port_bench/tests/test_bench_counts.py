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
