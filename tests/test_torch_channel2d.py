"""The port's 2-D channel (`envs/channel2d.py`), its control loop under
`run_control` and `run_cfd_simulation` against the JAX package, in
float64 on the CPU (the tests turn JAX's x64 on).  The functions are held
at 1e-12 relative to the field's largest entry, the steady solves with
their iteration counts equal, and the device-side stop flag, read every
K iterations, against the `while_loop`'s state and count."""
import numpy as np
import pytest
import torch
import yaml

import run_cfd_simulation as jcfd
from pde_policylearning_tpu.envs import channel2d as J
from pde_policylearning_torch import run_cfd_simulation as tcfd
from pde_policylearning_torch import run_control as rc
from pde_policylearning_torch.envs import channel2d as T

TOL = 1e-12
DX = DY = 2.0 / 40
CONSTS = (DX, DY, 0.01, 1.0, 0.01)   # dx, dy, dt, rho, nu (Re 100)


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-300
    assert np.abs(got - want).max() <= tol * scale, \
        np.abs(got - want).max() / scale


def fields(seed=0):
    rng = np.random.default_rng(seed)
    u = 1.0 + 0.1 * rng.normal(size=(41, 41))
    v = 0.15 + 0.1 * rng.random((41, 41))
    p = rng.normal(size=(41, 41))
    return u, v, p


def jstate(u, v, p, F=4.0):
    return J.Channel2DState(u=u, v=v, p=p, F=np.float64(F))


def tstate(u, v, p, F=4.0):
    t = [torch.tensor(a) for a in (u, v, p)]
    return T.Channel2DState(*t, F=torch.tensor(F, dtype=torch.float64))


def test_kernels_match_jax():
    """build_up_b, the 50 Jacobi sweeps and the momentum update."""
    u, v, p = fields()
    dx, dy, dt, rho, nu = CONSTS
    tu, tv, tp = (torch.tensor(a) for a in (u, v, p))
    b = J.build_up_b(rho, dt, dx, dy, u, v)
    close(T.build_up_b(rho, dt, dx, dy, tu, tv), b)
    close(T.pressure_poisson_periodic(tp, dx, dy, torch.tensor(
        np.asarray(b)), 50), J.pressure_poisson_periodic(p, dx, dy, b, 50))
    close(T.pressure_poisson_periodic(tp, dx, dy, torch.tensor(
        np.asarray(b)), 3), J.pressure_poisson_periodic(p, dx, dy, b, 3))
    for F in (4.0, torch.tensor(1.5, dtype=torch.float64)):
        ju, jv = J._momentum_update(u, v, p, dx, dy, dt, rho, nu, float(F))
        tu2, tv2 = T._momentum_update(tu, tv, tp, dx, dy, dt, rho, nu, F)
        close(tu2, ju)
        close(tv2, jv)


@pytest.mark.parametrize("case", ["fresh", "bc", "max_step"])
def test_solve_matches_the_while_loop(case):
    """The steady solve from a fresh field (as the env's constructor), with
    wall values, and cut at max_step: fields, bulk velocity and the
    iteration count."""
    u, v, p = fields(1)
    bc = None
    kw = {}
    if case == "bc":
        rng = np.random.default_rng(2)
        bc = (0.01 * rng.normal(size=41), 0.01 * rng.normal(size=41))
    if case == "max_step":
        kw = dict(max_step=3)
    js, jbulk, jn = J.solve(jstate(u, v, p), bc, *CONSTS, 4.0, **kw)
    ts, tbulk, tn = T.solve(tstate(u, v, p), None if bc is None else tuple(
        torch.tensor(a) for a in bc), *CONSTS, 4.0, **kw)
    assert int(tn) == int(jn) and int(jn) > (2 if case == "max_step" else 5)
    for a, b in zip(ts, js):
        close(a, b)
    close(tbulk, jbulk)


@pytest.mark.parametrize("check_every", [1, 3, 7, 64])
def test_done_masking_gives_the_while_loops_count(check_every):
    """With the flag read every K iterations, the iterations past the stop
    leave the state as it was: the same fields and count as the
    `while_loop` for every K, and the flag read ceil(n / K) times (never
    past the limit)."""
    u, v, p = fields(3)
    js, _, jn = J.solve(jstate(u, v, p), None, *CONSTS, 4.0)
    ref, _, n1 = T.solve(tstate(u, v, p), None, *CONSTS, 4.0, check_every=1)
    reads = T.host_read.count
    ts, _, tn = T.solve(tstate(u, v, p), None, *CONSTS, 4.0,
                        check_every=check_every)
    assert int(tn) == int(jn) == int(n1)
    assert T.host_read.count - reads == -(-int(jn) // check_every)
    for a, b, c in zip(ts, ref, js):
        assert torch.equal(a, b)
        close(a, c)
    # a limit within one chunk: no read at all
    reads = T.host_read.count
    _, _, n3 = T.solve(tstate(u, v, p), None, *CONSTS, 4.0, max_step=3,
                       check_every=max(check_every, 3))
    assert int(n3) == 3 and T.host_read.count == reads


def test_solve_fixed_mass_matches_jax():
    env = J.NSControlEnv2D(Re=100.0, seed=0)
    target = float(np.mean(np.abs(np.asarray(env.state.u)))) * 1.01
    s = env.state
    jF, jflow = J.solve_fixed_mass(s, None, target, env.dx, env.dy, env.dt,
                                   env.rho, env.nu, max_f=12.0)
    counts = []
    tF, tflow = T.solve_fixed_mass(
        tstate(*(np.asarray(a) for a in (s.u, s.v, s.p))), None, target,
        env.dx, env.dy, env.dt, env.rho, env.nu, max_f=12.0,
        iterations=counts)
    assert len(counts) == 21
    close(tF, jF)
    close(tflow, jflow)


@pytest.mark.parametrize("fix_flow,policy", [(False, None), (False, "gt"),
                                             (True, "gt")])
def test_env_steps_match_jax(fix_flow, policy):
    """Construction and 10 steps of the env's info (with fix_flow each
    step holds a 21-solve bisection), the top pressure and the fields.
    Every info value at 1e-12 of itself, but the divergence, a difference
    quotient over dx of O(1) velocities, at 1e-12 absolute.  With the flag
    read every 8 iterations, a step reads the host once for its scoreboard
    (twice on the first, which also takes the initial mass flow) and once
    per 8 iterations of each bisection solve."""
    je = J.NSControlEnv2D(Re=100.0, seed=0, fix_flow=fix_flow)
    te = T.NSControlEnv2D(Re=100.0, seed=0, fix_flow=fix_flow, device="cpu",
                          check_every=8)
    assert int(te.iterations[0]) > 5
    close(te.u, je.u)
    close(te.p, je.p)
    for i in range(10):
        jbc = je.gt_control() if policy == "gt" else None
        tbc = te.gt_control() if policy == "gt" else None
        if policy == "gt":
            for a, b in zip(tbc, jbc):
                close(a, b)
        jp, jr, jd, ji = je.step(jbc)
        tp, tr, td, ti = te.step(tbc)
        assert td is jd is False and set(ti) == set(ji) and tr == ti[
            "drag_reduction/4_1_-|divergence|"]
        close(tp, jp)
        for k in ji:
            if "divergence" in k:
                assert abs(ti[k] - ji[k]) < 1e-12, k
            else:
                assert abs(ti[k] - ji[k]) <= TOL * abs(ji[k]), k
        assert len(te.iterations) == (22 if fix_flow else 1)
        flags = sum(-(-int(n) // 8) for n in te.iterations[1:])
        assert te.syncs == 1 + (i == 0) + flags
    close(te.u, je.u)
    close(te.v, je.v)


def write_yaml(path, **cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_run_control_2d_matches_jax(tmp_path):
    """`run_control` on a 2-D yaml: the JAX loop's series, key by key."""
    import run_control as jrc
    from pde_policylearning_tpu.utils import DotDict
    cfg = dict(env_name="NSControlEnv2D", policy_name="gt",
               control_timestep=6, detect_plane=-10, Re=-1, fix_flow=False)
    path = write_yaml(tmp_path / "control2d.yaml", **cfg)
    res = rc.main(["--control_yaml", path, "--device", "cpu"])
    ref = jrc.run_control(DotDict(cfg))
    assert set(res["series"]) == set(ref["series"])
    for k, v in ref["series"].items():
        assert res["series"][k].shape == (6,)
        if "divergence" in k:
            np.testing.assert_allclose(res["series"][k], v, atol=1e-12)
        else:
            np.testing.assert_allclose(res["series"][k], v, rtol=TOL)


def test_run_cfd_simulation_matches_jax(capsys):
    """Both cases of the script at a few steps: the channel's state, bulk
    velocity and count, the cavity's fields; the same printed lines."""
    js = jcfd.run_channel(30)
    jout = capsys.readouterr().out
    ts, bulk, n = tcfd.run_channel(30, device="cpu")
    assert capsys.readouterr().out == jout
    for a, b in zip(ts[:3], js[:3]):
        close(a, b)
    jc = jcfd.run_cavity(5)
    jout = capsys.readouterr().out
    tc = tcfd.main(["--case", "cavity", "--steps", "5", "--device", "cpu"])
    assert capsys.readouterr().out == jout
    for a, b in zip(tc, jc):
        close(a, b)


@pytest.mark.parametrize("policy", ["gt", None])
def test_env_blows_up_where_jax_does(policy):
    """At F = 4 without fix_flow the env's flow runs away: both packages
    raise "control exploded!" at the same step (the 86th under `gt`, the
    88th without actuation)."""
    def blow_up(env):
        for i in range(100):
            try:
                env.step(env.gt_control() if policy else None)
            except RuntimeError as e:
                assert "control exploded" in str(e)
                return i
        return None
    step = blow_up(J.NSControlEnv2D(Re=100.0))
    assert step == (85 if policy else 87)
    assert blow_up(T.NSControlEnv2D(Re=100.0, device="cpu")) == step
