"""The port's measurement scripts (pde_policylearning_torch/tools) at a
small grid on the CPU: they run, write what they say, and the drag rows
agree between the staged step and kernel D's plain version."""
import json

import numpy as np
import pytest

from pde_policylearning_torch.envs import rk3_cuda as rk
from pde_policylearning_torch.native import cuda_build
from pde_policylearning_torch.tools import drag_rows, profile_paths
from pde_policylearning_torch.utils import resolve_device

GRID = ["--grid", "8", "33", "8", "--device", "cpu"]


def test_drag_rows_cli_writes_both_rows(tmp_path):
    before = rk.FULLSTEP
    res = drag_rows.main(["--steps", "6", *GRID, "--out", str(tmp_path)])
    assert rk.FULLSTEP == before and res["fullstep"] is False
    with open(tmp_path / "drag_rows.json") as f:
        assert json.load(f) == json.loads(json.dumps(res))
    series = np.load(tmp_path / "drag_rows_shear.npz")
    for name in ("unmanipulated", "gt"):
        shear = series[name]
        assert shear.shape == (6,) and np.isfinite(shear).all()
        assert res[name]["tail"] == pytest.approx(float(shear[3:].mean()))
        # plain versions on the CPU: no kernel launches
        assert res[name]["substage_launches"] == 0
        assert res[name]["kernel_d_launches"] == 0
    assert res["drag_change"] == pytest.approx(
        res["gt"]["tail"] / res["unmanipulated"]["tail"] - 1)


def test_drag_rows_staged_matches_kernel_d_plain():
    before = rk.FULLSTEP
    staged, s_series = drag_rows.drag_rows(5, False, "cpu", (8, 33, 8))
    full, f_series = drag_rows.drag_rows(5, True, "cpu", (8, 33, 8))
    assert rk.FULLSTEP == before
    for name in ("unmanipulated", "gt"):
        np.testing.assert_allclose(s_series[name], f_series[name],
                                   rtol=1e-5)


def test_profile_paths_needs_a_card(monkeypatch):
    monkeypatch.setattr(profile_paths.torch.cuda, "is_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        profile_paths.profile_paths()


def test_every_cuda_source_has_a_c_entry():
    """`cuda_build._ENTRIES` binds every `extern "C"` entry of every
    csrc/*.cu source (bar the error-string helper, bound on its own), and
    every source holds at least one."""
    import re
    sources = sorted(cuda_build.CSRC.glob("*.cu"))
    assert "corner_contract.cu" in [f.name for f in sources]
    declared = set()
    for f in sources:
        names = re.findall(r'extern "C" \w+\*? (\w+)\(', f.read_text())
        assert names, f.name
        declared.update(names)
    assert declared - {"pde_error_string"} == set(cuda_build._ENTRIES)
    assert "pde_corner_contract" in cuda_build._ENTRIES


def test_default_device_is_the_card(monkeypatch):
    """`resolve_device(None)` is the card and raises without one; only an
    explicit "cpu" runs on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    # a weight drawn with neither a generator nor a device is drawn on
    # the card too, not on torch's default device
    from pde_policylearning_torch.ops import factorized
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        factorized.init_factorized(None, (3, 3, 2, 2))
    w = factorized.init_factorized(torch.Generator(), (3, 3, 2, 2))
    assert w["mm2"].device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
