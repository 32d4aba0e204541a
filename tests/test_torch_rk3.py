"""The port's kernel-layout env step and wall pressures
(pde_policylearning_torch/envs/rk3_cuda.py) against the JAX package's
Pallas kernels in interpret mode (float32, CPU), and the CUDA kernels
against the plain versions on a card."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.envs import channel_flow as jcf
from pde_policylearning_tpu.envs import rk3_pallas as jrk
from pde_policylearning_torch.envs import channel_flow as cf
from pde_policylearning_torch.envs import rk3_cuda as rk

NX, NY, NZ = 8, 33, 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check)")
    return torch.device("cuda")


def grid_arrays(jgrid):
    return {f.name: np.asarray(getattr(jgrid, f.name))
            for f in dataclasses.fields(jgrid)}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def make_fields(seed, Nx=NX, Ny=NY, Nz=NZ):
    """A valid, noisy DNS state (numpy, float64) and zero-net-flux
    actuation planes, from one numpy seed."""
    rng = np.random.default_rng(seed)
    g64 = jcf.make_channel_grid(Nx=Nx, Ny=Ny, Nz=Nz, dtype=jnp.float64)
    yg = np.asarray(g64.yg)
    u_lam = jcf.DEFAULT_DPDX / (2 * g64.nu) * yg * (2.0 - yg) / 2.0
    U = u_lam[None, :, None] + 0.05 * rng.normal(size=(Nx, Ny + 1, Nz))
    V = 0.05 * rng.normal(size=(Nx, Ny, Nz))
    W = 0.05 * rng.normal(size=(Nx, Ny + 1, Nz))
    z = jnp.zeros((Nx, Nz))
    U, V, W = (jnp.asarray(a) for a in (U, V, W))
    U, V, W = jcf.apply_boundary_condition(U, V, W, z, z)
    U, V, W = jcf.projection_step(g64, U, V, W)
    U, V, W = jcf.apply_boundary_condition(U, V, W, z, z)
    ops = 0.01 * rng.normal(size=(2, Nx, Nz))
    ops -= ops.mean(axis=(1, 2), keepdims=True)
    fields = dict(U=np.asarray(U), V=np.asarray(V), W=np.asarray(W),
                  dPdx=np.asarray(jcf.DEFAULT_DPDX),
                  meanU0=np.asarray(jcf.calculate_mean_u(g64, U)))
    return fields, ops


@pytest.fixture(scope="module")
def setup():
    jgrid = jcf.make_channel_grid(Nx=NX, Ny=NY, Nz=NZ, dtype=jnp.float32,
                                  refine_steps=1)
    grid = cf.grid_from_arrays(grid_arrays(jgrid), dtype=torch.float32,
                               device="cpu")
    fields, ops = make_fields(0)
    return jgrid, grid, fields, ops.astype(np.float32)


def kstate(fields, dtype=torch.float32, device="cpu"):
    return rk.state_to_kstate(cf.state_from_arrays(fields, device=device,
                                                   dtype=dtype))


def test_layout_roundtrip():
    a = torch.as_tensor(np.random.default_rng(1).normal(size=(4, 5, 6)))
    np.testing.assert_array_equal(rk.from_k(rk.to_k(a), 4, 6).numpy(),
                                  a.numpy())
    np.testing.assert_array_equal(
        rk.to_k(a).numpy(), np.asarray(jrk.to_k(jnp.asarray(a.numpy()))))


def test_env_step_plain_matches_kernel_d(setup, monkeypatch):
    """env_step_full_k (plain) == the JAX kernel D in interpret mode, with
    the tolerances of tests/test_rk3_fused.py's kernel-D test."""
    jgrid, grid, fields, ops = setup
    monkeypatch.setattr(jrk, "INTERPRET", True)
    jst = jrk.state_to_kstate(jcf.ChannelState(
        **{k: jnp.asarray(v, jnp.float32) for k, v in fields.items()}))
    kst_ref, p2_ref, info_ref = jrk.env_step_full_k(
        jgrid, jst, jnp.asarray(ops[0]), jnp.asarray(ops[1]))
    kst, p2, info = rk.env_step_full_k(grid, kstate(fields),
                                       torch.as_tensor(ops[0]),
                                       torch.as_tensor(ops[1]))
    assert rel(kst.U, kst_ref.U) < 2e-6
    assert rel(kst.V, kst_ref.V) < 2e-5
    assert rel(kst.W, kst_ref.W) < 2e-5
    assert rel(p2, p2_ref) < 2e-5
    # dPdx = (dPdx + d_new/dt)/2 with d_new a difference of bulk velocities:
    # one float32 ulp of the bulk velocity moves it by several percent.  The
    # port takes that reduction in float64, the JAX kernel in float32, so
    # both are held against a float64 step from the same inputs: the port
    # must be at least as close to it as the reference kernel.
    g64 = jcf.make_channel_grid(Nx=NX, Ny=NY, Nz=NZ, dtype=jnp.float64)
    s64 = jcf.ChannelState(**{k: jnp.asarray(np.float32(v), jnp.float64)
                              for k, v in fields.items()})
    exact = float(jcf._rk3_step_unfused(g64, s64, jnp.asarray(ops[0]),
                                        jnp.asarray(ops[1])).dPdx)
    err_port = abs(float(kst.dPdx) / exact - 1)
    err_ref = abs(float(kst_ref.dPdx) / exact - 1)
    assert err_port <= max(err_ref, 1e-2), (err_port, err_ref)
    for k in info_ref:
        if k == "drag_reduction/3_3_dPdx_reverse_cal":
            continue
        atol = 1e-4 if "divergence" in k else 1e-6
        np.testing.assert_allclose(float(info[k]), float(info_ref[k]),
                                   rtol=5e-3, atol=atol, err_msg=k)


def test_boundary_pressures_plain_matches_pallas(setup):
    jgrid, grid, fields, _ = setup
    jst = jrk.state_to_kstate(jcf.ChannelState(
        **{k: jnp.asarray(v, jnp.float32) for k, v in fields.items()}))
    p1_ref, p2_ref = jrk.boundary_pressures_k(jgrid, jst.U, jst.V, jst.W,
                                              jst.dPdx, interpret=True)
    st = kstate(fields)
    p1, p2 = rk.boundary_pressures_k(grid, st.U, st.V, st.W,
                                     st.dPdx.reshape(1))
    assert rel(p1, p1_ref) < 2e-5
    assert rel(p2, p2_ref) < 2e-5


def _packed_step(grid, fa, fb, ops_a, ops_b, device="cpu", plain=False):
    """One B=2 packed step of envs a and b (env-major columns)."""
    sa, sb = kstate(fa, device=device), kstate(fb, device=device)

    def cat(a, b):
        return torch.cat([a, b], dim=1).contiguous()

    def row(o_a, o_b):
        return torch.as_tensor(np.concatenate([o_a.ravel(), o_b.ravel()])[
            None], device=device)
    step = rk.env_step_full_kb_plain if plain else rk.env_step_full_kb
    return step(grid, 2, cat(sa.U, sb.U), cat(sa.V, sb.V), cat(sa.W, sb.W),
                torch.stack([sa.dPdx, sb.dPdx]),
                torch.stack([sa.meanU0, sb.meanU0]),
                row(ops_a[0], ops_b[0]), row(ops_a[1], ops_b[1]))


def _single_steps(grid, fa, fb, ops_a, ops_b, device="cpu"):
    outs = []
    for f, o in ((fa, ops_a), (fb, ops_b)):
        st = kstate(f, device=device)
        C = grid.Nx * grid.Nz
        outs.append(rk.env_step_full_kb(
            grid, 1, st.U, st.V, st.W, st.dPdx.reshape(1),
            st.meanU0.reshape(1),
            torch.as_tensor(o[0].reshape(1, C), device=device),
            torch.as_tensor(o[1].reshape(1, C), device=device)))
    return outs


def _assert_packed_matches(grid, packed, singles, tol):
    C = grid.Nx * grid.Nz
    for b, single in enumerate(singles):
        sl = slice(b * C, (b + 1) * C)
        for a, s in zip(packed[:3], single[:3]):
            assert rel(a[:, sl].cpu(), s.cpu()) < tol
        np.testing.assert_allclose(float(packed[3][b]), float(single[3][0]),
                                   rtol=tol)
        assert rel(packed[4][:, sl].cpu(), single[4].cpu()) < tol


def test_packed_step_matches_single_env_steps(setup):
    _, grid, fields, ops = setup
    fields_b, ops_b = make_fields(1)
    fields_b = {k: np.asarray(v, np.float32) for k, v in fields_b.items()}
    ops_b = ops_b.astype(np.float32)
    packed = _packed_step(grid, fields, fields_b, ops, ops_b)
    singles = _single_steps(grid, fields, fields_b, ops, ops_b)
    _assert_packed_matches(grid, packed, singles, 1e-6)


def test_kernel_wrappers_take_cuda_float32_only(setup):
    """The kernel wrappers raise on CPU tensors (the dispatchers route
    those to the plain versions); nothing falls back."""
    _, grid, fields, ops = setup
    st = kstate(fields)
    C = NX * NZ
    op = torch.as_tensor(ops[0].reshape(1, C))
    with pytest.raises(ValueError, match="float32 CUDA"):
        rk.env_step_full_kb_kernel(grid, 1, st.U, st.V, st.W,
                                   st.dPdx.reshape(1), st.meanU0.reshape(1),
                                   op, op)
    with pytest.raises(ValueError, match="float32 CUDA"):
        rk.boundary_fwd_kernel(grid, st.U, st.V, st.W, st.dPdx.reshape(1))


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from pde_policylearning_torch.native import cuda_build
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    monkeypatch.setattr(cuda_build, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load()


@pytest.mark.parametrize("fail_on", ["", "rk3_staged.cu", "-shared"])
def test_kernel_build_compiles_each_source_then_links(monkeypatch, tmp_path,
                                                      fail_on):
    """One nvcc per source, then one link, into the hashed library path,
    nvcc's log beside it and read back when the library is reused; a
    failing compile or link raises with the log and leaves no library
    behind.  (A stand-in nvcc records its calls and writes its -o file.)"""
    import sys
    from pde_policylearning_torch.native import cuda_build
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        f"open({str(calls)!r}, 'a').write(' '.join(args) + '\\n')\n"
        f"if {fail_on!r} and any({fail_on!r} in a for a in args):\n"
        "    print('broken')\n"
        "    sys.exit(1)\n"
        "open(args[args.index('-o') + 1], 'w').close()\n"
        "print('ptxas info : Used 8 registers')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_build, "NVCC_DEFAULT", str(nvcc))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    so = cuda_build.library_path()
    if fail_on:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            cuda_build.build()
        assert "broken" in cuda_build.build_log
        assert not so.exists()
    else:
        assert cuda_build.build() == so and so.exists()
        assert "Used 8 registers" in cuda_build.build_log
        monkeypatch.setattr(cuda_build, "build_log", "")
        n_calls = len(calls.read_text().splitlines())
        assert cuda_build.build() == so      # reused: no nvcc, the same log
        assert "Used 8 registers" in cuda_build.build_log
        assert len(calls.read_text().splitlines()) == n_calls
    lines = calls.read_text().splitlines()
    sources = sorted(cuda_build.CSRC.glob("*.cu"))
    assert sorted(ln.split()[-1] for ln in lines if " -c " in ln) == \
        sorted(map(str, sources))
    assert sum("-shared" in ln for ln in lines) == (
        0 if fail_on == "rk3_staged.cu" else 1)
    assert sorted((tmp_path / "kernels").iterdir()) == (
        sorted([so, so.with_suffix(".log")]) if not fail_on else [])


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device, monkeypatch):
    """Kernel D (B = 1 and 2) and the wall-pressure pair against their
    plain versions at the bench grid; a CUDA tensor never reaches a plain
    version."""
    grid = cf.make_channel_grid(Nx=32, Ny=130, Nz=32, device=cuda_device)
    C = grid.Nx * grid.Nz
    fa, ops_a = make_fields(2, 32, 130, 32)
    fb, ops_b = make_fields(3, 32, 130, 32)
    fa, fb = ({k: np.asarray(v, np.float32) for k, v in f.items()}
              for f in (fa, fb))
    ops_a, ops_b = ops_a.astype(np.float32), ops_b.astype(np.float32)
    st = kstate(fa, device=cuda_device)
    dP = st.dPdx.reshape(1)
    ref = rk.env_step_full_kb_plain(
        grid, 1, st.U, st.V, st.W, dP, st.meanU0.reshape(1),
        torch.as_tensor(ops_a[0].reshape(1, C), device=cuda_device),
        torch.as_tensor(ops_a[1].reshape(1, C), device=cuda_device))
    ref_p = rk.boundary_solve_plain(grid, rk.boundary_fwd_plain(
        grid, st.U, st.V, st.W, dP))

    def forbidden(*args, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")
    for name in ("env_step_full_kb_plain", "boundary_fwd_plain",
                 "boundary_solve_plain"):
        monkeypatch.setattr(rk, name, forbidden)
    n0 = rk.env_step_full_kb_kernel.launches
    singles = _single_steps(grid, fa, fb, ops_a, ops_b, cuda_device)
    packed = _packed_step(grid, fa, fb, ops_a, ops_b, cuda_device)
    p1, p2 = rk.boundary_pressures_k(grid, st.U, st.V, st.W, dP)
    torch.cuda.synchronize()
    assert rk.env_step_full_kb_kernel.launches == n0 + 3

    out = singles[0]
    assert rel(out[0].cpu(), ref[0].cpu()) < 2e-6
    for a, b in zip(out[1:3], ref[1:3]):
        assert rel(a.cpu(), b.cpu()) < 2e-5
    assert rel(out[4][1].cpu(), ref[4][1].cpu()) < 2e-5
    _assert_packed_matches(grid, packed, singles, 1e-6)
    assert rel(p2.cpu(), ref_p[1:2].cpu()) < 2e-5
    with pytest.raises(ValueError):
        rk.env_step_full_kb_kernel(grid, 1, st.U.double(), st.V, st.W, dP,
                                   st.meanU0.reshape(1), p1, p2)
