"""The port's spans (`utils/profiling.span`) on the CPU: off by default and
free there, their nesting through the control loop and the batched
rollout, their clock against torch.profiler's, and the readings of a
profiled slice against them (`host_ms_per_step`, `device_idle`) on
synthetic slices with known answers, and the full-field
optimal-observer's descent span on its eager path.  The last two tests
need a card: the flagship policies' capture, replay and descent spans on
the graph path."""
import time
import tracemalloc
from collections import Counter

import pytest
import torch

from pde_policylearning_torch.control import (
    make_fullfield_optimal_observer, make_optimal_policy_observer,
    make_policy, run_closed_loop)
from pde_policylearning_torch.envs import NSControlEnv
from pde_policylearning_torch.envs import channel_flow as cf
from pde_policylearning_torch.models import PINObserverFullField, PolicyModel2D
from pde_policylearning_torch.ops.normalization import NormalizerGivenMeanStd
from pde_policylearning_torch.utils import profiling

SMALL = dict(Nx=8, Ny=17, Nz=8, detect_plane=3)
# a small full-field observer (the widths of tests/test_torch_flagship.py)
MODEL = dict(modes1=(2, 2), modes2=(2, 2), modes3=(1, 1), layers=(8, 8, 8),
             fc_dim=8, in_dim=1)
# where the program's span and the profiler's range of one name may part
CLOCK_TOLERANCE_NS = 20_000


@pytest.fixture
def env():
    return NSControlEnv(**SMALL, dtype=torch.float64, noise_scale=0.02,
                        seed=1, device="cpu")


def gt_loop(env, n_steps=6, chunk=3):
    return run_closed_loop(env, make_policy("gt", env.grid, detect_plane=3),
                           n_steps=n_steps, log_interval=chunk,
                           detect_plane=3, verbose=False)


def nested_right(records):
    """Every span closed, and inside its parent."""
    for name, s, e, parent in records:
        assert e is not None and s <= e, name
        if parent >= 0:
            _, ps, pe, _ = records[parent]
            assert ps <= s and e <= pe, name


# -- off ---------------------------------------------------------------------

def test_off_span_is_the_one_null_object_and_records_nothing(env,
                                                             monkeypatch):
    assert profiling.span("loop.step") is profiling.span("rollout.chunk")

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"an off span used {name}")

    # an off span reads no clock and calls nothing in torch
    monkeypatch.setattr(profiling, "time", Untouchable())
    monkeypatch.setattr(profiling, "torch", Untouchable())
    gt_loop(env)
    monkeypatch.undo()
    with profiling.spans() as records:
        assert records == []


def test_off_span_allocates_nothing():
    def run(n):
        for _ in range(n):
            with profiling.span("loop.step"):
                pass

    run(10)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        run(10_000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename in (profiling.__file__, __file__)
             and d.count_diff > 0]
    assert grown == []


def test_spans_block_turns_them_on_and_off():
    with profiling.spans() as outer:
        with profiling.span("loop.run"):
            with profiling.spans() as inner:
                assert inner is outer
                with profiling.span("loop.chunk"):
                    pass
        assert profiling.span("x") is not profiling.span("x")
    assert profiling.span("x") is profiling.span("y")
    assert [(n, p) for n, _, _, p in outer] == [("loop.run", -1),
                                                ("loop.chunk", 0)]


# -- on ----------------------------------------------------------------------

def test_closed_loop_spans_nest(env):
    with profiling.spans() as records:
        gt_loop(env, n_steps=6, chunk=3)
    nested_right(records)
    names = [r[0] for r in records]
    assert Counter(names) == {"loop.run": 1, "loop.chunk": 2, "loop.step": 6,
                              "loop.policy": 6, "loop.env_step": 6,
                              "loop.fetch": 2}
    parent = {i: names[p] if p >= 0 else None
              for i, (_, _, _, p) in enumerate(records)}
    want = {"loop.run": None, "loop.chunk": "loop.run",
            "loop.step": "loop.chunk", "loop.policy": "loop.step",
            "loop.env_step": "loop.step", "loop.fetch": "loop.run"}
    for i, name in enumerate(names):
        assert parent[i] == want[name], (i, name)
    # each step holds its policy, then its env step; a fetch ends a chunk
    for i, name in enumerate(names):
        if name == "loop.step":
            assert names[i + 1:i + 3] == ["loop.policy", "loop.env_step"]
        if name == "loop.chunk":
            j = i + 1 + 3 * 3
            assert names[j] == "loop.fetch" and records[j][1] >= records[i][2]


def test_batched_rollout_spans_nest():
    grid = cf.make_channel_grid(**{k: SMALL[k] for k in ("Nx", "Ny", "Nz")},
                                dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(0)
    states = cf.init_batched_states(grid, 2, gen, noise=0.02)
    with profiling.spans() as records:
        cf.batched_rollout(grid, states, 4, detect_plane=3, policy="gt")
    nested_right(records)
    assert [(n, p) for n, _, _, p in records] == \
        [("rollout.chunk", -1)] + [("rollout.step", 0)] * 4


def test_spans_share_the_profilers_clock(env):
    """Each span against the profiler's range of the same name, in order:
    both ends within CLOCK_TOLERANCE_NS."""
    from torch.profiler import ProfilerActivity, profile
    with profiling.spans() as records, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        gt_loop(env, n_steps=4, chunk=2)
    ranges = sorted((e.start_ns(), e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("loop."))
    assert len(records) == len(ranges) == 1 + 2 + 4 * 3 + 2
    for (name, s, e, _), (ps, pe, pname) in zip(
            sorted(records, key=lambda r: r[1]), ranges):
        assert name == pname
        assert abs(s - ps) <= CLOCK_TOLERANCE_NS, (name, s - ps)
        assert abs(e - pe) <= CLOCK_TOLERANCE_NS, (name, e - pe)


def test_trace_exports_the_spans(env, tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as path:
        gt_loop(env, n_steps=2, chunk=2)
    text = open(path).read()
    for name in ("loop.run", "loop.chunk", "loop.step", "loop.policy",
                 "loop.env_step", "loop.fetch"):
        assert f'"{name}"' in text, name
    assert profiling.span("x") is profiling.span("y")


# -- reading a slice ---------------------------------------------------------

MS = 1_000_000


def test_host_ms_per_step_less_the_blocked_parts():
    records = [("rollout.chunk", 0, 10 * MS, -1),
               ("rollout.step", 0, 1 * MS, 0),
               ("rollout.step", 2 * MS, 3.5 * MS, 0),
               ("loop.step", 5 * MS, 9 * MS, 0)]
    # blocked: 0.4 ms inside the first step, 0.5 ms across the second's
    # end, one interval outside every step
    blocked = [(0.2 * MS, 0.6 * MS), (3 * MS, 4 * MS), (4.2 * MS, 4.4 * MS)]
    got = profiling.host_ms_per_step(records, blocked, "rollout.step")
    assert got == pytest.approx(((1 - 0.4) + (1.5 - 0.5)) / 2)
    assert profiling.host_ms_per_step(records, [], "rollout.step") == \
        pytest.approx(1.25)
    assert profiling.host_ms_per_step(records, blocked, "loop.step") == \
        pytest.approx(4.0)


def test_host_ms_per_step_blocked_intervals_overlapping():
    records = [("loop.step", 0, 10, -1)]
    got = profiling.host_ms_per_step(records, [(2, 6), (4, 8), (9, 20)],
                                     "loop.step")
    assert got == pytest.approx((10 - 6 - 1) / 1e6)


def test_host_ms_per_step_without_the_span_is_none():
    assert profiling.host_ms_per_step([], [], "loop.step") is None
    assert profiling.host_ms_per_step([("loop.run", 0, 5, -1)], [],
                                      "loop.step") is None


def test_device_idle_splits_host_and_device_gaps():
    device = [(0, 100, 1),
              (150, 200, 2),     # gap 100-150: its call returned at 170
              (400, 500, 3),     # gap 200-400: the host issued it at 350
              (520, 600, 4),     # a graph: its launch returned at 510
              (650, 700, 4),     # a gap inside the graph: device-side
              (690, 720, 5)]     # overlaps: no gap
    runtime = [(0, 10, 1), (90, 170, 2), (340, 350, 3), (480, 510, 4),
               (515, 530, 5)]
    got = profiling.device_idle(device, runtime, 1000)
    busy = 100 + 50 + 100 + 80 + 70
    assert got["idle"] == pytest.approx(100 * (1 - busy / 1000))
    assert got["idle_host"] == pytest.approx(100 * (50 + 150 + 10) / 1000)
    assert got["unmatched"] == 0 and got["ops"] == 6
    assert got["idle_host"] <= got["idle"]


def test_device_idle_unmatched_counts_as_device_side():
    device = [(0, 100, 1), (300, 400, 9), (600, 700, 3)]
    runtime = [(0, 10, 1), (500, 650, 3)]
    got = profiling.device_idle(device, runtime, 1000)
    assert got["unmatched"] == 1
    assert got["idle_host"] == pytest.approx(100 * (600 - 400) / 1000)
    # most operations unmatched: no reading
    got = profiling.device_idle(device, runtime[:1], 1000)
    assert got["unmatched"] == 2 and got["idle_host"] is None
    assert got["idle"] == pytest.approx(70.0)


def test_device_idle_of_an_empty_slice():
    got = profiling.device_idle([], [], 1000)
    assert got["idle"] == 100.0 and got["idle_host"] is None


def test_profile_events_on_the_cpu(env):
    """A CPU profile holds no device operation and no runtime call; the
    readings of its spans still come out."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.time_ns()
    with profiling.spans() as records, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        gt_loop(env, n_steps=2, chunk=2)
    window = time.time_ns() - t0
    ev = profiling.profile_events(prof)
    assert ev["device"] == [] and ev["runtime"] == []
    ms = profiling.host_ms_per_step(records, ev["blocked"], "loop.step")
    assert 0 < ms < window / 1e6


def ffo_policy(env, device, detect_plane):
    """The full-field optimal-observer at small widths on `env`, two inner
    steps."""
    dtype = env.state.U.dtype
    gen = torch.Generator(device=device).manual_seed(0)
    observer = PINObserverFullField(plane_num=2, **MODEL, device=device,
                                    dtype=dtype, generator=gen)
    norm = NormalizerGivenMeanStd(
        torch.zeros(env.grid.Nx, env.grid.Nz, dtype=dtype, device=device),
        torch.ones(env.grid.Nx, env.grid.Nz, dtype=dtype, device=device))
    return make_fullfield_optimal_observer(
        env.grid, observer_model=observer, bound_v_norm=norm,
        detect_plane=detect_plane, opt_steps=2)


def test_descent_span_opens_once_a_control_step_eager(env):
    """`policy.descend` once a control step, inside `loop.policy`, on the
    eager path; off, the loop records nothing."""
    policy = ffo_policy(env, "cpu", 3)
    run_closed_loop(env, policy, n_steps=2, log_interval=2, detect_plane=3,
                    verbose=False)
    assert profiling._records == []
    with profiling.spans() as records:
        run_closed_loop(env, policy, n_steps=3, log_interval=3,
                        detect_plane=3, verbose=False)
    names = [r[0] for r in records]
    assert Counter(names)["policy.descend"] == 3
    assert "policy.replay" not in names and "policy.capture" not in names
    for n, _, _, p in records:
        if n == "policy.descend":
            assert names[p] == "loop.policy"
    nested_right(records)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flagship_policy_captures_once_then_replays(cuda_device):
    model = dict(modes1=(2, 2), modes2=(2, 2), modes3=(1, 1),
                 layers=(8, 8, 8), fc_dim=8, in_dim=1)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    env = NSControlEnv(detect_plane=25, noise_scale=0.05, seed=0,
                       device=cuda_device)
    observer = PINObserverFullField(plane_num=2, **model, device=cuda_device,
                                    generator=gen)
    residual = PolicyModel2D(**model, device=cuda_device,
                             generator=gen).zero_init_params()
    policy = make_optimal_policy_observer(
        env.grid, observer_model=observer, policy_model=residual,
        detect_plane=25, opt_steps=2)

    def names_under_policy(records):
        names = [r[0] for r in records]
        for n, _, _, p in records:
            if n.startswith("policy."):
                assert names[p] == "loop.policy", n
        return names

    with profiling.spans() as records:
        run_closed_loop(env, policy, n_steps=4, log_interval=2,
                        verbose=False)
    names = names_under_policy(records)
    assert Counter(names)["policy.capture"] == 1
    assert Counter(names)["policy.replay"] == 4
    first_policy = names.index("loop.policy")
    assert records[names.index("policy.capture")][3] == first_policy
    nested_right(records)
    with profiling.spans() as records:
        run_closed_loop(env, policy, n_steps=3, log_interval=3,
                        verbose=False)
    names = names_under_policy(records)
    assert "policy.capture" not in names
    assert Counter(names)["policy.replay"] == 3


@pytest.mark.cuda
def test_descent_span_inside_the_replay_once_a_control_step(cuda_device):
    """On the graph path `policy.descend` opens once a control step, inside
    `policy.replay`; the capture keeps `policy.capture`, outside both."""
    env = NSControlEnv(detect_plane=25, noise_scale=0.05, seed=0,
                       device=cuda_device)
    policy = ffo_policy(env, cuda_device, 25)
    with profiling.spans() as records:
        run_closed_loop(env, policy, n_steps=4, log_interval=2,
                        verbose=False)
    names = [r[0] for r in records]
    assert Counter(names)["policy.capture"] == 1
    assert Counter(names)["policy.replay"] == 4
    assert Counter(names)["policy.descend"] == 4
    for n, _, _, p in records:
        if n == "policy.descend":
            assert names[p] == "policy.replay"
        if n == "policy.capture":
            assert names[p] == "loop.policy"
    nested_right(records)
