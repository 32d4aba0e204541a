"""The port's measurement scripts (pde_policylearning_torch/tools) at a
small grid on the CPU: they run, write what they say, and the drag rows
agree between the staged step and kernel D's plain version."""
import json

import numpy as np
import pytest

from pde_policylearning_torch.envs import rk3_cuda as rk
from pde_policylearning_torch.native import cuda_build
from pde_policylearning_torch.tools import (drag_rows, kernel_routes,
                                            profile_paths)
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


def test_profile_summary_reads_the_eigen_solve_and_kernel_a():
    """`summarize` on the kernels of one staged step of 8 envs: both
    eigen-solve kernels count as the tile, the plane pass or the
    point-by-point pass as kernel A, with their device us per launch."""
    ns = "(anonymous namespace)::"
    kernels = [
        (f"void {ns}eig_solve_rows_kernel<16>({ns}EigArgs)", 30, 2850.0),
        (f"void {ns}eig_solve_tile_kernel<4>({ns}EigArgs)", 10, 310.0),
        (f"{ns}substage_planes_kernel({ns}Grid, int const*, ...)", 30, 1350.0),
        (f"{ns}xz_fft_forward_kernel(int, int, ...)", 40, 500.0),
        (f"{ns}gemm_kernel(int, int, int, ...)", 20, 400.0),
        (f"{ns}correct_kernel({ns}Grid, ...)", 30, 420.0),
    ]
    res = profile_paths.summarize(kernels, wall=0.0075, n_env_steps=80,
                                  n_steps=10)
    assert res["eig_tile_launches_per_step"] == 4.0
    assert res["eig_tile_device_us_per_launch"] == pytest.approx(79.0)
    assert res["kernel_a_launches_per_step"] == 3.0
    assert res["kernel_a_device_us_per_launch"] == pytest.approx(45.0)
    assert res["divergence_launches_per_step"] == 0.0
    assert res["xz_fft_launches_per_step"] == 4.0
    assert res["gemm_launches_per_step"] == 2.0
    assert res["device_launches_per_step"] == 16.0
    assert res["device_ms_per_step"] == pytest.approx(0.583)
    assert res["busy_share"] == pytest.approx(5830.0 / 7500.0)
    assert res["env_steps_per_s"] == pytest.approx(80 / 0.0075)
    assert res["corner_launches_per_step"] == 0.0
    assert res["top"][0] == (kernels[0][0][:60], 48.9, 3.0)
    # the point-by-point pass and its divergence launch count as kernel A
    # and as the divergence
    old = [(f"{ns}substage_kernel({ns}Grid, ...)", 30, 1500.0),
           (f"{ns}divergence_kernel({ns}Grid, ...)", 30, 300.0)]
    res = profile_paths.summarize(old, wall=0.01, n_env_steps=10, n_steps=10)
    assert res["kernel_a_launches_per_step"] == 3.0
    assert res["kernel_a_device_us_per_launch"] == pytest.approx(50.0)
    assert res["divergence_launches_per_step"] == 3.0


def test_kernel_routes_forces_each_eigen_solve_route(monkeypatch):
    """`kernel_routes.forced_plans`: the warp-owned plan where the rule
    would take the row-owned kernel, and both tile widths of that one; the
    rule itself is left as it was.  The script needs a card."""
    from pde_policylearning_torch.envs import tile_plan
    rule = tile_plan.eig_rows_smem_bytes
    plans = kernel_routes.forced_plans(129, 1088, 8, 132)
    assert tile_plan.eig_rows_smem_bytes is rule
    assert tile_plan.eig_plan(129, 128, 8, 1088).tc == 16
    warp = plans["warp-owned"]
    assert (warp.tc, warp.resident, warp.blocks, warp.warps) == (0, 1, 116, 8)
    for tc in (8, 16):
        p = plans[f"row-owned, tiles of {tc}"]
        assert (p.tc, p.blocks, p.zero_blocks) == (tc, -(-8 * 1086 // tc), 16)
    assert set(kernel_routes.PLAN_FIELDS) == set(
        tile_plan.EigPlan.__dataclass_fields__)
    monkeypatch.setattr(kernel_routes.torch.cuda, "is_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        kernel_routes.kernel_routes()


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
