"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run on the
CPU (the program's plain versions) at a size a test can hold, with one
fault planted in the program: a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced, and,
for the residual policy's inner Adam (`FusedAdam`, which the loop runs),
a step that leaves its parameters unchanged and a learning rate twice
the stated one.  The cells' limits are the committed ones.
"""
import pytest
import torch

from port_bench import harness, run

SEED = 2 ** 31 + 4242
COLLECT = dict(n_envs=2, chunk=3, check_steps=2, warmup_chunks=1)
LOOP = dict(call_steps=3, warmup_seconds=0.01, check_steps=2)
SMALL = dict(width=8, n_layers=4, modes=[4, 4, 4], fc_dim=16)


def _run(cell, monkeypatch, overrides):
    small = {}
    if cell.startswith("pino"):
        from pde_policylearning_torch.tools import drag_rows
        monkeypatch.setattr(drag_rows, "FULL_WIDTH", dict(
            modes1=(4,) * 4, modes2=(4,) * 4, modes3=(4,) * 4,
            layers=(8,) * 5, fc_dim=16, in_dim=1))
        small = SMALL
    return run.execute(harness.benchmark(), cell, SEED, 0.5, False,
                       device="cpu", cell_overrides=overrides,
                       config_overrides=small)


def _plant(monkeypatch, fault):
    from pde_policylearning_torch.envs import channel_flow as cf
    from pde_policylearning_torch.envs import rk3_cuda as rk
    step = rk.env_step_full_kb

    def broken(grid, B, U, V, W, dPdx, meanU0, op1, op2):
        U2, V2, W2, dP2, p = step(grid, B, U, V, W, dPdx, meanU0, op1, op2)
        if fault == "unchanged":
            return U, V, W, dPdx, p
        if fault == "half_batch":
            C = grid.Nx * grid.Nz
            h = (B // 2) * C
            return (torch.cat([U2[:, :h], U[:, h:]], 1),
                    torch.cat([V2[:, :h], V[:, h:]], 1),
                    torch.cat([W2[:, :h], W[:, h:]], 1),
                    torch.cat([dP2[:B // 2], dPdx[B // 2:]]), p)
        if fault == "altered":
            return U2, V2, W2, dP2, p * 1.01
        return U2, V2, W2, dP2, p
    monkeypatch.setattr(rk, "env_step_full_kb", broken)
    if fault == "actuation":
        gt = cf.gt_control
        monkeypatch.setattr(cf, "gt_control", lambda s, d: tuple(
            1.01 * a for a in gt(s, d)))
    if fault in ("optimizer", "wrong_lr"):
        from pde_policylearning_torch.training import optimizers
        adam = optimizers.FusedAdam
    if fault == "optimizer":
        monkeypatch.setattr(adam, "step", lambda self, closure=None: None)
    if fault == "wrong_lr":
        init = adam.__init__

        def doubled(self, params, lr=1e-3, **kw):
            init(self, params, lr=2 * lr, **kw)
        monkeypatch.setattr(adam, "__init__", doubled)


# the number each loop fault reads over its limit
PLANTED = dict(unchanged="p2_rel", actuation="opV2_rel",
               optimizer="param_gap", wrong_lr="param_gap")


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_collect_fault_is_caught(monkeypatch, fault):
    _plant(monkeypatch, fault)
    out = _run("channel180.collect-b8", monkeypatch, COLLECT)
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("cell,fault", [
    ("pino-fullfield.opo-loop", "unchanged"),
    ("pino-fullfield.opo-loop", "actuation"),
    ("pino-fullfield.opo-loop", "optimizer"),
    ("pino-fullfield.opo-loop", "wrong_lr"),
])
def test_loop_fault_is_caught(monkeypatch, cell, fault):
    """The run comes out not correct, and through the number that the
    fault plants: over its limit, and over the 1e-18 that rounding gives a
    sound run's `opV2_rel` on the CPU (exactly 0 on the card), so that no
    case passes on that alone."""
    _plant(monkeypatch, fault)
    out = _run(cell, monkeypatch, LOOP)
    assert out["correct"] is False, out["check"]
    value, limit = out["check"][PLANTED[fault]]
    assert value > max(limit, 1e-6), out["check"]


@pytest.mark.parametrize("cell,overrides", [
    ("channel180.collect-b8", COLLECT),
    ("pino-fullfield.opo-loop", LOOP),
])
def test_sound_run_reads_its_numbers(monkeypatch, cell, overrides):
    out = _run(cell, monkeypatch, overrides)
    limits = harness.cell_files(cell, harness.workload(
        harness.benchmark(), cell)["config"])[0]["limits"]
    assert set(out["check"]) == set(limits)
    assert list(out)[-1] == "check"
