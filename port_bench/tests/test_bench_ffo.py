"""The full-field optimal-observer cell on the CPU at a small size: a
sound run keeps its limits, each planted fault comes out not correct
through its own number, and its counted operations against
`torch.utils.flop_counter`.

As in `test_bench_faults.py`, each run skips the look for a card and
drives the rest on the CPU (the program's plain versions) with the
observer at small widths and the cell's committed limits.  The faults:
the policy hands back `gt`'s actuation unchanged, Adam's learning rate
twice the stated one, and an env step that returns its state unchanged.
"""
import math

import pytest
import torch

from port_bench import harness, run

CELL = "pino-fullfield-oo.ffo-loop"
SEED = 2 ** 31 + 4343
LOOP = dict(call_steps=3, warmup_seconds=0.01, check_steps=2)
SMALL = dict(width=8, n_layers=4, modes=[4, 4, 4], fc_dim=16)


def _run():
    return run.execute(harness.benchmark(), CELL, SEED, 0.5, False,
                       device="cpu", cell_overrides=LOOP,
                       config_overrides=SMALL)


def _plant(monkeypatch, fault):
    if fault == "gt":
        from pde_policylearning_torch.control import policies
        monkeypatch.setattr(policies, "FusedAdam", _NoStep)
    if fault == "wrong_lr":
        from pde_policylearning_torch.control import policies
        monkeypatch.setattr(policies, "FusedAdam", _Doubled)
    if fault == "unchanged":
        from pde_policylearning_torch.envs import rk3_cuda as rk
        step = rk.env_step_full_kb

        def broken(grid, B, U, V, W, dPdx, meanU0, op1, op2):
            p = step(grid, B, U, V, W, dPdx, meanU0, op1, op2)[-1]
            return U, V, W, dPdx, p
        monkeypatch.setattr(rk, "env_step_full_kb", broken)


def _fused():
    from pde_policylearning_torch.training.optimizers import FusedAdam
    return FusedAdam


class _NoStep:
    """An Adam whose step leaves the action as it is: the policy returns
    `gt`'s actuation less its plane mean."""

    def __init__(self, params, lr=1e-3, **kw):
        self.state = {}

    def step(self, closure=None):
        return None


class _Doubled:
    """The program's Adam at twice the stated learning rate."""

    def __new__(cls, params, lr=1e-3, **kw):
        return _fused()(params, lr=2 * lr, **kw)


# the number each fault reads over its limit
PLANTED = dict(gt="opV2_rel", wrong_lr="opV2_rel", unchanged="p2_rel")


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_ffo_fault_is_caught(monkeypatch, fault):
    _plant(monkeypatch, fault)
    out = _run()
    assert out["correct"] is False, out["check"]
    value, limit = out["check"][PLANTED[fault]]
    assert value > max(limit, 1e-6), out["check"]


def test_ffo_sound_run_keeps_its_limits():
    out = _run()
    limits = harness.cell_files(CELL, harness.workload(
        harness.benchmark(), CELL)["config"])[0]["limits"]
    assert set(out["check"]) == set(limits)
    assert out["correct"] is True, out["check"]
    assert list(out)[-1] == "check"


def test_ffo_counts_against_the_flop_counter():
    """`counts/ffo.py`'s descent of one control step against
    `FlopCounterMode` over the same forward and backward to the action of
    a small observer.  The counter counts the products alone: a complex
    product as 2 operations a multiply-add where the count takes 8, and
    no FFT.  Taken off the count, the FFTs and 6 of each 8 corner
    operations leave the counter's number to the operation, but for the
    Reynolds code's products; the count reads 2.316x the counter's at this
    size (the FFTs are the larger part)."""
    from torch.utils.flop_counter import FlopCounterMode

    from pde_policylearning_torch.models import PINObserverFullField
    from port_bench.counts import ffo, pino
    cfg = dict(harness.load_json(harness.BENCH, "configs",
                                 "pino-fullfield-oo.json"),
               Nx=16, Nz=16, opt_steps=1, **SMALL)
    obs = PINObserverFullField(
        plane_num=cfg["plane_num"], pad_ratio=tuple(cfg["pad_ratio"]),
        max_re=cfg["max_re"], **harness.pino_model_kw(cfg), device="cpu",
        dtype=torch.float64).requires_grad_(False)
    v = torch.randn(16, 16, dtype=torch.float64, requires_grad=True)
    re = torch.tensor([cfg["re"]], dtype=torch.float64)
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(obs(v[None, :, :, None, None], re).square()
                            .sum(), v)
    counted = ffo.descent_flops(cfg) - pino.ADAM_FLOPS_PER_PARAM * 16 * 16
    w, (m1, m2, m3) = cfg["width"], pino.kept_modes(cfg["modes"], 1)
    P = 16 * 16 * pino.padded_t(1, cfg["pad_ratio"])
    fft = 2 * 2.5 * P * math.log2(P) * w * cfg["n_layers"]
    corners = 4 * m1 * m2 * m3 * w * w * 8 * cfg["n_layers"]
    # and the counter takes the two multiplicative nets' products of the
    # Reynolds code (1 x 1 by 1 x w, forward only), which the count leaves
    # out: 2 x 2 w operations
    products = counted - 2 * (fft + corners * 6 / 8) + 2 * 2 * w
    assert fc.get_total_flops() == products
    assert counted / fc.get_total_flops() == pytest.approx(2.316, abs=1e-3)


def test_descent_time_is_what_the_span_launched():
    """`descent_ms.ffo`'s count on a synthetic slice (ns): inside the first
    span a graph launch whose three replayed kernels carry its correlation
    id (two overlapping: 15 ns, then 5) and a copy (4 ns); inside the
    second span one kernel (4 ns); outside both, a launch whose kernel
    runs between them, which does not count."""
    from port_bench.drivers import ffo
    spans = [(100, 200), (1000, 1100)]
    runtime = [(110, 150, 7), (160, 170, 8), (300, 310, 9), (1010, 1020, 11)]
    device = [(400, 410, 7), (405, 415, 7), (500, 505, 7), (600, 650, 9),
              (420, 424, 8), (1200, 1204, 11)]
    got = ffo.launched_inside(spans, runtime, device)
    assert got == pytest.approx((15 + 5 + 4 + 4) * 1e-9)
    assert ffo.launched_inside([], runtime, device) == 0.0
