"""The control comes out not correct: the plain reference put in the
program's place and computed in float32 with TF32 on (the configurations
state float32 with TF32 off) fails the committed limits, while the
program on the same seed keeps them.  On the card only: TF32 exists there
alone.  The DNS runs at its full size; the PINO models at small widths."""
import pytest

from port_bench import control, harness

SMALL = dict(width=8, n_layers=4, modes=[4, 4, 4], fc_dim=16)
CASES = [
    ("channel180.collect-b8", {}, None),
    ("pino-fullfield.opo-loop", dict(call_steps=10, warmup_seconds=0.5),
     SMALL),
]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,overrides,config", CASES)
def test_control_fails_the_limits(monkeypatch, cell, overrides, config):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("TF32, and so the control, exists on an NVIDIA card only")
    if config:
        from pde_policylearning_torch.tools import drag_rows
        monkeypatch.setattr(drag_rows, "FULL_WIDTH", dict(
            modes1=(4,) * 4, modes2=(4,) * 4, modes3=(4,) * 4,
            layers=(8,) * 5, fc_dim=16, in_dim=1))
    limits = harness.cell_files(cell, harness.workload(
        harness.benchmark(), cell)["config"])[0]["limits"]
    got = control.readings(cell, 2 ** 31 + 2024, 1.0, [True], "cuda",
                           overrides, config)
    assert harness.checked(got["program"], limits)[0], got["program"]
    assert not harness.checked(got["control"], limits)[0], got["control"]
