"""The port's staged RK3 step (kernels A and B), the batched wall pressures
(kernel C) and the autograd Functions around the kernels
(pde_policylearning_torch/envs/rk3_cuda.py, channel_flow.py,
poisson_cuda.py) against the JAX package: the plain versions against the
Pallas kernels in interpret mode (float32, CPU), the gradients against
`jax.vjp` of the JAX unfused functions (float64, CPU), and the CUDA kernels
against the plain versions on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.envs import channel_flow as jcf
from pde_policylearning_tpu.envs import rk3_pallas as jrk
from pde_policylearning_torch.envs import channel_flow as cf
from pde_policylearning_torch.envs import poisson_cuda as pc
from pde_policylearning_torch.envs import rk3_cuda as rk
from test_torch_rk3 import grid_arrays, kstate, make_fields, rel

NX, NY, NZ = 8, 33, 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check)")
    return torch.device("cuda")


def f32(fields):
    return {k: np.asarray(v, np.float32) for k, v in fields.items()}


@pytest.fixture(scope="module")
def setup():
    """Grid (JAX and port, float32, one refinement pass), the step's
    initial fields, another valid state as the current stage's fields, a
    first-stage RHS and actuation rows, all from numpy seeds."""
    jgrid = jcf.make_channel_grid(Nx=NX, Ny=NY, Nz=NZ, dtype=jnp.float32,
                                  refine_steps=1)
    grid = cf.grid_from_arrays(grid_arrays(jgrid), dtype=torch.float32,
                               device="cpu")
    f0, ops = make_fields(0)
    f1, _ = make_fields(1)
    rng = np.random.default_rng(2)
    C = NX * NZ
    F1 = tuple(rng.normal(size=(r, C)).astype(np.float32)
               for r in (NY + 1, NY, NY + 1))
    ops = ops.astype(np.float32).reshape(2, 1, C)
    return jgrid, grid, f32(f0), f32(f1), F1, ops


def k_np(fields):
    """Kernel-layout numpy (U, V, W) of (x, y, z) fields."""
    st = kstate(fields)
    return tuple(a.numpy() for a in (st.U, st.V, st.W))


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_substage_plain_matches_pallas(setup, stage):
    jgrid, grid, f0, f1, F1, ops = setup
    c_cur, c_prev = rk._RK3_STAGES[stage]
    out_f = stage == 0
    cur = k_np(f0 if stage == 0 else f1)
    init = k_np(f0)
    dP = np.float32(f0["dPdx"])
    ref = jrk._substage_call(jgrid, *map(jnp.asarray, cur + init),
                             tuple(map(jnp.asarray, F1)),
                             jnp.asarray(ops[0]), jnp.asarray(ops[1]),
                             jnp.asarray(dP), c_cur, c_prev, out_f,
                             interpret=True)
    t = torch.as_tensor
    out = rk.substage_plain(grid, 1, *map(t, cur + init), tuple(map(t, F1)),
                            t(ops[0]), t(ops[1]), t(dP).reshape(1), c_cur,
                            c_prev, out_f)
    n = 7 if out_f else 4
    assert all(o is None for o in out[n:])
    for name, o, r in zip(("Un", "Vn", "Wn", "div", "Fu", "Fv", "Fw")[:n],
                          out, ref):
        assert rel(o, r) <= 1e-6, name


def test_solve_correct_plain_matches_pallas(setup):
    jgrid, grid, f0, f1, F1, ops = setup
    t = torch.as_tensor
    Un, Vn, Wn, div, *_ = rk.substage_plain(
        grid, 1, *map(t, k_np(f1) + k_np(f0)), tuple(map(t, F1)),
        t(ops[0]), t(ops[1]), t(np.float32(f0["dPdx"])).reshape(1),
        5 / 12, 1 / 4, False)
    ref = jrk._solve_correct_call(
        jgrid, *(jnp.asarray(a.numpy()) for a in (div, Un, Vn, Wn)),
        jnp.asarray(ops[0]), jnp.asarray(ops[1]), interpret=True)
    out = rk.solve_correct_plain(grid, 1, div, Un, Vn, Wn, t(ops[0]),
                                 t(ops[1]))
    for o, r, tol in zip(out, ref, (2e-6, 2e-5, 2e-5)):
        assert rel(o, r) <= tol


def f64_dpdx(fields, ops):
    """dPdx after one float64 unfused step from float32-rounded inputs."""
    g64 = jcf.make_channel_grid(Nx=NX, Ny=NY, Nz=NZ, dtype=jnp.float64)
    s64 = jcf.ChannelState(**{k: jnp.asarray(np.float32(v), jnp.float64)
                              for k, v in fields.items()})
    return float(jcf._rk3_step_unfused(
        g64, s64, jnp.asarray(ops[0].reshape(NX, NZ), jnp.float64),
        jnp.asarray(ops[1].reshape(NX, NZ), jnp.float64)).dPdx)


def test_rk3_step_k_plain_matches_pallas(setup):
    jgrid, grid, f0, _, _, ops = setup
    U, V, W = k_np(f0)
    ref = jrk.rk3_step_k(jgrid, *map(jnp.asarray, (U, V, W)),
                         jnp.asarray(f0["dPdx"]), jnp.asarray(f0["meanU0"]),
                         jnp.asarray(ops[0]), jnp.asarray(ops[1]),
                         interpret=True)
    st = kstate(f0)
    out = rk.rk3_step_k(grid, st.U, st.V, st.W, st.dPdx, st.meanU0,
                        torch.as_tensor(ops[0]), torch.as_tensor(ops[1]))
    for o, r, tol in zip(out[:3], ref[:3], (2e-6, 2e-5, 2e-5)):
        assert rel(o, r) <= tol
    # the mass-flow dPdx is held against a float64 step (see
    # test_torch_rk3.test_env_step_plain_matches_kernel_d)
    assert out[3].shape == st.dPdx.shape
    exact = f64_dpdx(f0, ops)
    err_port = abs(float(out[3]) / exact - 1)
    err_ref = abs(float(ref[3]) / exact - 1)
    assert err_port <= max(err_ref, 1e-2), (err_port, err_ref)


def test_batched_staged_matches_pallas():
    """16x33x8, B = 3 envs: rk3_step_kb and boundary_pressures_kb (plain)
    against the JAX batched Pallas kernels (interpret mode), with the
    tolerances of tests/test_rk3_fused.py's batched-kernel test."""
    Nx, Ny, Nz, B = 16, 33, 8, 3
    C = Nx * Nz
    jgrid = jcf.make_channel_grid(Nx=Nx, Ny=Ny, Nz=Nz, dtype=jnp.float32,
                                  refine_steps=1)
    grid = cf.grid_from_arrays(grid_arrays(jgrid), dtype=torch.float32,
                               device="cpu")
    made = [make_fields(s, Nx, Ny, Nz) for s in (3, 4, 5)]
    fields = [f32(f) for f, _ in made]
    ops = np.stack([o.astype(np.float32).reshape(2, C) for _, o in made], 1)
    op1, op2 = (o.reshape(1, B * C) for o in ops)
    states = cf.ChannelState(**{k: torch.as_tensor(np.stack(
        [f[k] for f in fields])) for k in fields[0]})
    kst = rk.batch_states(states)
    jin = [jnp.asarray(a.numpy()) for a in (kst.U, kst.V, kst.W, kst.dPdx,
                                            kst.meanU0)]
    ref = jrk.rk3_step_kb(jgrid, B, *jin, jnp.asarray(op1), jnp.asarray(op2),
                          interpret=True)
    out = rk.rk3_step_kb(grid, B, kst.U, kst.V, kst.W, kst.dPdx, kst.meanU0,
                         torch.as_tensor(op1), torch.as_tensor(op2))
    for b in range(B):
        sl = slice(b * C, (b + 1) * C)
        for o, r, tol in zip(out[:3], ref[:3], (1e-6, 1e-5, 1e-5)):
            assert rel(o[:, sl], np.asarray(r)[:, sl]) <= tol
        g64 = jcf.make_channel_grid(Nx=Nx, Ny=Ny, Nz=Nz, dtype=jnp.float64)
        s64 = jcf.ChannelState(**{k: jnp.asarray(v, jnp.float64)
                                  for k, v in fields[b].items()})
        exact = float(jcf._rk3_step_unfused(
            g64, s64, jnp.asarray(ops[0, b].reshape(Nx, Nz), jnp.float64),
            jnp.asarray(ops[1, b].reshape(Nx, Nz), jnp.float64)).dPdx)
        assert (abs(float(out[3][b]) / exact - 1)
                <= max(abs(float(ref[3][b]) / exact - 1), 1e-2))
    # the wall pressures of the same (JAX-stepped) state in both
    Uj, Vj, Wj, dPj = (np.array(a) for a in ref)
    p_ref = jrk.boundary_pressures_kb(jgrid, B, *map(jnp.asarray,
                                                     (Uj, Vj, Wj, dPj)),
                                      interpret=True)
    p = rk.boundary_pressures_kb(grid, B, *map(torch.as_tensor,
                                                (Uj, Vj, Wj, dPj)))
    for b in range(B):
        sl = slice(b * C, (b + 1) * C)
        for o, r in zip(p, p_ref):
            assert rel(o[:, sl], np.asarray(r)[:, sl]) <= 1e-5


@pytest.mark.parametrize("name", ["substage_kernel", "solve_correct_kernel",
                                  "mass_flow_kernel", "boundary_kernel"])
def test_staged_kernel_wrappers_take_cuda_float32_only(setup, name):
    """The new kernel wrappers raise on CPU tensors; nothing falls back."""
    _, grid, f0, _, _, ops = setup
    st = kstate(f0)
    op = torch.as_tensor(ops[0])
    dP = st.dPdx.reshape(1)
    div = torch.zeros((NY - 1, NX * NZ))
    args = {
        "substage_kernel": (grid, 1, st.U, st.V, st.W, st.U, st.V, st.W,
                            None, op, op, dP, 8 / 15, 0.0, True),
        "solve_correct_kernel": (grid, 1, div, st.U, st.V, st.W, op, op),
        "mass_flow_kernel": (grid, 1, st.U, st.meanU0.reshape(1), dP),
        "boundary_kernel": (grid, st.U, st.V, st.W, dP),
    }[name]
    before = getattr(rk, name).launches
    with pytest.raises(ValueError, match="float32 CUDA"):
        getattr(rk, name)(*args)
    assert getattr(rk, name).launches == before


@pytest.mark.parametrize("name", [
    "substage_kernel", "solve_correct_kernel", "mass_flow_kernel",
    "boundary_kernel", "env_step_full_kb_kernel", "boundary_fwd_kernel",
    "boundary_solve_kernel", "poisson_solve_kernel"])
def test_kernel_wrappers_refuse_inputs_that_need_grad(setup, name):
    """A kernel writes a fresh buffer; given an input that needs a gradient
    (grad mode on) it raises instead of dropping the gradient."""
    _, grid, f0, _, _, ops = setup
    st = kstate(f0)
    U = st.U.clone().requires_grad_()
    op = torch.as_tensor(ops[0])
    dP, mU = st.dPdx.reshape(1), st.meanU0.reshape(1)
    n, F2 = NY - 1, 2 * NX * (NZ // 2 + 1)
    args = {
        "substage_kernel": (grid, 1, U, st.V, st.W, st.U, st.V, st.W, None,
                            op, op, dP, 8 / 15, 0.0, True),
        "solve_correct_kernel": (grid, 1, torch.zeros((n, NX * NZ),
                                                      requires_grad=True),
                                 U, st.V, st.W, op, op),
        "mass_flow_kernel": (grid, 1, U, mU, dP),
        "boundary_kernel": (grid, U, st.V, st.W, dP),
        "env_step_full_kb_kernel": (grid, 1, U, st.V, st.W, dP, mU, op, op),
        "boundary_fwd_kernel": (grid, U, st.V, st.W, dP),
        "boundary_solve_kernel": (grid, torch.zeros((1, n, F2),
                                                    requires_grad=True)),
        "poisson_solve_kernel": (grid, torch.zeros((NX, n, NZ),
                                                   requires_grad=True)),
    }[name]
    fn = getattr(pc if name == "poisson_solve_kernel" else rk, name)
    before = fn.launches
    with pytest.raises(RuntimeError, match="passes no gradient"):
        fn(*args)
    assert fn.launches == before


# ---------------------------------------------------------------------------
# gradients through the kernels' autograd Functions (float64, CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f64_setup():
    jgrid = jcf.make_channel_grid(Nx=NX, Ny=NY, Nz=NZ, dtype=jnp.float64)
    grid = cf.grid_from_arrays(grid_arrays(jgrid), dtype=torch.float64,
                               device="cpu")
    fields, ops = make_fields(6)
    return jgrid, grid, fields, ops


def t64(a):
    return torch.as_tensor(np.array(a, np.float64)).requires_grad_()


def assert_grads_match(ours, ref, names):
    for name, a, b in zip(names, ours, ref):
        assert rel(a.detach(), b) <= 1e-5, name


def test_poisson_solve_grad_matches_jax(f64_setup):
    jgrid, grid, _, _ = f64_setup
    rng = np.random.default_rng(7)
    rhs = rng.normal(size=(NX, NY - 1, NZ))
    cot = rng.normal(size=rhs.shape)
    _, vjp = jax.vjp(lambda r: jcf._poisson_solve_unfused(jgrid, r),
                     jnp.asarray(rhs))
    (ref,) = vjp(jnp.asarray(cot))
    x = t64(rhs)
    p = cf.poisson_solve(grid, x)
    assert p.grad_fn is not None
    (g,) = torch.autograd.grad(p, x, torch.as_tensor(cot))
    assert_grads_match([g], [ref], ["rhs"])


def test_boundary_pressures_grad_matches_jax(f64_setup):
    jgrid, grid, fields, _ = f64_setup
    rng = np.random.default_rng(8)
    cots = rng.normal(size=(2, NX, NZ))
    jstate = jcf.ChannelState(**{k: jnp.asarray(v) for k, v in
                                 fields.items()})
    _, vjp = jax.vjp(lambda s: jcf._boundary_pressures_unfused(jgrid, s),
                     jstate)
    (ref,) = vjp((jnp.asarray(cots[0]), jnp.asarray(cots[1])))
    leaves = {k: t64(v) for k, v in fields.items()}
    p1, p2 = cf.boundary_pressures(grid, cf.ChannelState(**leaves))
    loss = (p1 * torch.as_tensor(cots[0])).sum() + (
        p2 * torch.as_tensor(cots[1])).sum()
    names = ("U", "V", "W")
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    assert_grads_match(grads, [getattr(ref, k) for k in names], names)


def test_rk3_step_grad_matches_jax(f64_setup):
    """The VJP of rk3_step is that of the unfused step, as the JAX
    rk3_pallas._rk3_bwd rule (tests/test_rk3_fused.py grad test)."""
    jgrid, grid, fields, ops = f64_setup
    rng = np.random.default_rng(9)
    shapes = {k: np.shape(v) for k, v in fields.items()}
    cot = {k: rng.normal(size=shapes[k]) for k in ("U", "V", "W", "dPdx")}
    jstate = jcf.ChannelState(**{k: jnp.asarray(v) for k, v in
                                 fields.items()})
    _, vjp = jax.vjp(lambda s, o1, o2: jcf._rk3_step_unfused(jgrid, s, o1,
                                                            o2),
                     jstate, jnp.asarray(ops[0]), jnp.asarray(ops[1]))
    jcot = jstate.replace(**{k: jnp.asarray(v) for k, v in cot.items()},
                          meanU0=jnp.zeros(()))
    ds, d1, d2 = vjp(jcot)
    leaves = {k: t64(v) for k, v in fields.items()}
    o1, o2 = t64(ops[0]), t64(ops[1])
    out = cf.rk3_step(grid, cf.ChannelState(**leaves), o1, o2)
    loss = sum((getattr(out, k) * torch.as_tensor(c)).sum()
               for k, c in cot.items())
    names = ("U", "V", "W", "dPdx", "meanU0")
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [o1, o2])
    assert_grads_match(grads, [getattr(ds, k) for k in names] + [d1, d2],
                       names + ("opV1", "opV2"))


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_staged_kernels_match_plain_on_card(cuda_device, monkeypatch):
    """Kernels A, B (every stage) and C (B = 2) against their plain
    versions at the bench grid; a CUDA tensor never reaches a plain
    version through the dispatchers."""
    grid = cf.make_channel_grid(Nx=32, Ny=130, Nz=32, device=cuda_device)
    C = grid.Nx * grid.Nz
    fa, ops = make_fields(10, 32, 130, 32)
    fb, _ = make_fields(11, 32, 130, 32)
    sa, sb = (kstate(f32(f), device=cuda_device) for f in (fa, fb))
    op1, op2 = (torch.as_tensor(o.reshape(1, C).astype(np.float32),
                                device=cuda_device) for o in ops)
    dP = sa.dPdx.reshape(1)
    U, V, W, F1 = sa.U, sa.V, sa.W, None
    for i, (c_cur, c_prev) in enumerate(rk._RK3_STAGES):
        a = (grid, 1, U, V, W, sa.U, sa.V, sa.W, F1, op1, op2, dP, c_cur,
             c_prev, i == 0)
        out, ref = rk.substage_kernel(*a), rk.substage_plain(*a)
        for o, r in zip(out, ref):
            assert (o is None) == (r is None)
            if r is not None:
                assert rel(o.cpu(), r.cpu()) <= 1e-6
        F1 = ref[4:] if i == 0 else F1
        b = (grid, 1, ref[3], *ref[:3], op1, op2)
        out, ref = rk.solve_correct_kernel(*b), rk.solve_correct_plain(*b)
        for o, r, tol in zip(out, ref, (2e-6, 2e-5, 2e-5)):
            assert rel(o.cpu(), r.cpu()) <= tol
        U, V, W = ref
    cat = [torch.cat([getattr(sa, k), getattr(sb, k)], 1).contiguous()
           for k in ("U", "V", "W")]
    dP2 = torch.stack([sa.dPdx, sb.dPdx])
    ref = rk.boundary_solve_plain(grid, rk.boundary_fwd_plain(grid, *cat,
                                                              dP2))

    def forbidden(*args, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")
    for name in ("rk3_step_kb_plain", "substage_plain", "solve_correct_plain",
                 "boundary_fwd_plain", "boundary_solve_plain"):
        monkeypatch.setattr(rk, name, forbidden)
    n0 = rk.boundary_kernel.launches
    p1, p2 = rk.boundary_pressures_kb(grid, 2, *cat, dP2)
    torch.cuda.synchronize()
    assert rk.boundary_kernel.launches == n0 + 1
    assert rel(p1.cpu(), ref[0:1].cpu()) <= 2e-5
    assert rel(p2.cpu(), ref[1:2].cpu()) <= 2e-5
    n0 = rk.substage_kernel.launches
    rk.rk3_step_kb(grid, 2, *cat, dP2, torch.stack([sa.meanU0, sb.meanU0]),
                   torch.cat([op1, op1], 1), torch.cat([op2, op2], 1))
    torch.cuda.synchronize()
    assert rk.substage_kernel.launches == n0 + 3


@pytest.mark.cuda
def test_projection_step_keeps_grad_fn_on_card(cuda_device):
    """On a card the projection runs the Poisson kernel and still
    differentiates, with the plain version's gradient."""
    grid = cf.make_channel_grid(Nx=32, Ny=130, Nz=32, device=cuda_device)
    fields, _ = make_fields(12, 32, 130, 32)
    U, V, W = (torch.as_tensor(np.asarray(fields[k], np.float32),
                               device=cuda_device).requires_grad_()
               for k in ("U", "V", "W"))
    n0 = pc.poisson_solve_kernel.launches
    out = cf.projection_step(grid, U, V, W)
    assert pc.poisson_solve_kernel.launches == n0 + 1
    assert all(o.grad_fn is not None for o in out)
    g = torch.autograd.grad(out[1].square().sum(), (U, V, W))
    Up, Vp, Wp = (a.detach().clone().requires_grad_() for a in (U, V, W))
    ref = cf.pressure_correction(grid, Up, Vp, Wp, pc.poisson_solve_plain(
        grid, cf.divergence(grid, Up, Vp, Wp)))
    g_ref = torch.autograd.grad(ref[1].square().sum(), (Up, Vp, Wp))
    for a, b in zip(g, g_ref):
        assert float((a - b).norm() / b.norm()) <= 1e-5


@pytest.mark.cuda
def test_env_step_on_card_differentiates_rollouts_refuse_grad(cuda_device):
    """On a card, env_step with a state that needs a gradient runs the
    staged kernels inside rk3_step's autograd Function and returns a
    differentiable state; the rollouts raise rather than drop it."""
    grid = cf.make_channel_grid(Nx=32, Ny=130, Nz=32, device=cuda_device)
    fields, ops = make_fields(13, 32, 130, 32)
    leaves = {k: torch.as_tensor(np.asarray(v, np.float32),
                                 device=cuda_device)
              for k, v in fields.items()}
    state = cf.ChannelState(**{**leaves, "U": leaves["U"].requires_grad_()})
    o1, o2 = (torch.as_tensor(np.asarray(o, np.float32), device=cuda_device)
              for o in ops)
    n0 = rk.substage_kernel.launches
    out, p2, _, _ = cf.env_step(grid, state, o1, o2)
    assert rk.substage_kernel.launches == n0 + 3
    assert out.U.grad_fn is not None and p2.grad_fn is not None
    (g,) = torch.autograd.grad(out.U.sum() + p2.sum(), state.U)
    assert torch.isfinite(g).all()
    with pytest.raises(RuntimeError, match="passes no gradient"):
        cf.rollout(grid, state, 1)
    batched = cf.ChannelState(**{k: v[None] for k, v in leaves.items()})
    assert batched.U.requires_grad
    with pytest.raises(RuntimeError, match="passes no gradient"):
        cf.batched_rollout(grid, batched, 1)
