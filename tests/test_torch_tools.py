"""The port's measurement scripts (pde_policylearning_torch/tools) at a
small grid on the CPU: they run, write what they say, and the drag rows
agree between the staged step and kernel D's plain version."""
import json

import numpy as np
import pytest
import torch

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


def test_drag_rows_fno_row_serves_a_trained_checkpoint(tmp_path,
                                                      monkeypatch):
    """The `fno` row: a checkpoint of the observer (here a small one in
    the place of FNO2dObserver(12, 12, 32)), the normalizers of a folder's
    first planes, its drag change against `unmanipulated`."""
    from pde_policylearning_torch.data import generate_channel_dataset
    from pde_policylearning_torch.envs import NSControlEnv
    from pde_policylearning_torch.models import FNO2dObserver
    from pde_policylearning_torch.training import save_checkpoint

    def small(*_, **kw):
        return FNO2dObserver(4, 4, 6, **kw)
    monkeypatch.setattr(drag_rows, "FNO2dObserver", small)
    ckpt = save_checkpoint(str(tmp_path / "fno.pt"), small(
        device="cpu", generator=torch.Generator().manual_seed(0)))
    env = NSControlEnv(8, 33, 8, detect_plane=5, seed=0, device="cpu")
    data = generate_channel_dataset(str(tmp_path / "planes"), 5, env=env,
                                    detect_plane=5)
    res, series = drag_rows.drag_rows(4, False, "cpu", (8, 33, 8),
                                      fno=ckpt, data=data)
    assert set(series) == {"unmanipulated", "gt", "fno"}
    assert np.isfinite(series["fno"]).all()
    assert res["fno"]["drag_change"] == pytest.approx(
        res["fno"]["tail"] / res["unmanipulated"]["tail"] - 1)


def test_drag_rows_flagship_rows_over_matched_windows(tmp_path,
                                                     monkeypatch):
    """The two flagship rows (here with small models in the place of the
    full-width ones): the observer from a checkpoint, the full-field
    `optimal-observer` through the top plane's statistics of a full-field
    folder, and a row shorter than the others scored over the same steps
    of `unmanipulated` and `gt`.  The zeroed `PolicyModel2D` only ever
    moves a constant residual, which the zero-flux step removes, so
    `optimal-policy-observer` follows `gt`."""
    from pde_policylearning_torch.data import generate_channel_dataset
    from pde_policylearning_torch.envs import NSControlEnv
    from pde_policylearning_torch.training import save_checkpoint
    small = dict(modes1=(2, 2), modes2=(2, 2), modes3=(12, 12),
                 layers=(6, 6, 6), fc_dim=4, in_dim=1)
    monkeypatch.setattr(drag_rows, "FULL_WIDTH", small)
    ckpt = save_checkpoint(str(tmp_path / "ff.pt"),
                           drag_rows.fullfield_observer(
                               None, "cpu", torch.Generator().manual_seed(0)))
    env = NSControlEnv(8, 33, 8, detect_plane=5, seed=0, device="cpu")
    data = generate_channel_dataset(str(tmp_path / "ff"), 4, env=env,
                                    detect_plane=5, save_fields=True)
    res, series = drag_rows.drag_rows(
        6, True, "cpu", (8, 33, 8), fullfield=ckpt, fullfield_data=data,
        flagship_steps=(4, 6), out_dir=str(tmp_path / "out"))
    assert set(series) == {"unmanipulated", "gt", *drag_rows.FLAGSHIP}
    opo, ffoo = (res[k] for k in drag_rows.FLAGSHIP)
    assert opo["steps"] == 4 and ffoo["steps"] == 6 and "matched" not in ffoo
    m = opo["matched"]
    assert m["window"] == [2, 4]
    assert m["unmanipulated"] == pytest.approx(
        float(series["unmanipulated"][2:4].mean()))
    assert m["drag_change"] == pytest.approx(
        opo["tail"] / m["unmanipulated"] - 1)
    np.testing.assert_allclose(series["optimal-policy-observer"],
                               series["gt"][:4], rtol=1e-6)
    assert np.isfinite(series["optimal-observer"]).all()
    with open(tmp_path / "out" / "drag_rows.json") as f:
        assert set(json.load(f)) >= set(drag_rows.FLAGSHIP)
    with pytest.raises(ValueError, match="windows"):
        drag_rows.drag_rows(3, True, "cpu", (8, 33, 8), fullfield=ckpt,
                            fullfield_data=data, flagship_steps=(4, 6))


def test_fullfield_batch_encodes_its_planes():
    """The full-field training batch `profile_paths` times: the fields of
    a short rollout, the top plane and the chosen planes encoded by the
    top plane's statistics, shaped as `fullfield_losses` takes them."""
    from pde_policylearning_torch.envs import NSControlEnv
    env = NSControlEnv(8, 33, 8, detect_plane=5, seed=0, device="cpu")
    norm, (vp, vf, U, V, W, dpdx, re) = profile_paths.fullfield_batch(
        env, B=4, planes=(-2, -4))
    assert vp.shape == (4, 1, 8, 8) and vf.shape == (4, 1, 2, 8, 8)
    assert U.shape[:2] == V.shape[:2] == W.shape[:2] == (4, 1)
    assert dpdx.shape == (4, 1) and re.shape == (4,)
    torch.testing.assert_close(norm.decode(vf[:, :, 1]), V[..., -4, :])
    assert float(vp.mean(0).abs().max()) < 1e-5


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
    assert res["wall_launches_per_step"] == 0.0
    # the point-by-point pass and its divergence launch count as kernel A
    # and as the divergence
    old = [(f"{ns}substage_kernel({ns}Grid, ...)", 30, 1500.0),
           (f"{ns}divergence_kernel({ns}Grid, ...)", 30, 300.0)]
    res = profile_paths.summarize(old, wall=0.01, n_env_steps=10, n_steps=10)
    assert res["kernel_a_launches_per_step"] == 3.0
    assert res["kernel_a_device_us_per_launch"] == pytest.approx(50.0)
    assert res["divergence_launches_per_step"] == 3.0


def test_profile_summary_reads_the_wall_pair():
    """`summarize` on one kernel-D step of 8 envs: the wall pair's own two
    kernels (phase 1's plane pass, phase 2's column kernel) per step, each
    with its device us per launch; on the three-launch phase 1 the RHS
    fields kernel counts as phase 1 and its divergence as the divergence."""
    ns = "(anonymous namespace)::"
    kernels = [
        (f"{ns}boundary_planes_kernel({ns}Grid, int const*, ...)", 10, 380.0),
        (f"{ns}wall_solve_kernel(int, int, float, ...)", 10, 42.0),
        (f"{ns}xz_fft_inverse_kernel(int, int, ...)", 40, 500.0),
        (f"void {ns}eig_solve_rows_kernel<16>({ns}EigArgs)", 30, 2850.0),
    ]
    res = profile_paths.summarize(kernels, wall=0.007, n_env_steps=80,
                                  n_steps=10)
    assert res["wall_launches_per_step"] == 2.0
    assert res["wall_fwd_device_us_per_launch"] == pytest.approx(38.0)
    assert res["wall_solve_device_us_per_launch"] == pytest.approx(4.2)
    assert res["gemm_launches_per_step"] == 0.0
    three = [(f"{ns}rhs_fields_kernel({ns}Grid, ...)", 10, 300.0),
             (f"{ns}divergence_kernel({ns}Grid, ...)", 10, 100.0),
             (f"{ns}wall_solve_kernel(int, int, float, ...)", 10, 40.0)]
    res = profile_paths.summarize(three, wall=0.01, n_env_steps=10,
                                  n_steps=10)
    assert res["wall_launches_per_step"] == 2.0
    assert res["wall_fwd_device_us_per_launch"] == pytest.approx(30.0)
    assert res["divergence_launches_per_step"] == 1.0


def test_kernel_routes_reads_the_registers_ptxas_gave():
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121eig_solve_rows_kernelILi16EEEv7EigArgs' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121eig_solve_rows_kernelILi16EEEv7EigArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 352 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111gemm_kernelEv' for 'sm_90a'
ptxas info    : Used 90 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117wall_solve_kernelEv' for 'sm_90a'
ptxas info    : Used 40 registers"""
    regs = kernel_routes.kernel_registers(log)
    assert regs == {
        "_ZN12_GLOBAL__N_121eig_solve_rows_kernelILi16EEEv7EigArgs": 72,
        "_ZN12_GLOBAL__N_117wall_solve_kernelEv": 40}
    assert kernel_routes.kernel_registers("") == {}


def test_kernel_routes_forces_each_eigen_solve_route(monkeypatch):
    """`kernel_routes.forced_plans`: the warp-owned plan where the rule
    would take the row-owned kernel, and both builds of that one; the
    rule itself is left as it was.  The script needs a card."""
    from pde_policylearning_torch.envs import tile_plan
    rule = tile_plan.eig_rows_smem_bytes
    plans = kernel_routes.forced_plans(129, 1088, 8, 132)
    assert tile_plan.eig_rows_smem_bytes is rule
    assert tile_plan.eig_plan(129, 128, 8, 1088).lean == 1
    warp = plans["warp-owned"]
    assert (warp.tc, warp.resident, warp.blocks, warp.warps) == (0, 1, 116, 8)
    for regs, lean in ((48, 0), (40, 1)):
        p = plans[f"row-owned, {regs} registers"]
        assert (p.tc, p.blocks, p.zero_blocks, p.lean) == (8, 1086, 16, lean)
    assert len(plans) == 3 and plans["warp-owned"].lean == 0
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
