"""`training/optimizers.py:FusedAdam` and its kernel (csrc/adam.cu).

On the CPU: the plain version against torch's Adam, step for step, across
a restart (`control.policies._restart`), zero gradients leaving their
leaves exactly as they were; a numpy walk of the update kernel's chunk
table, float4 bodies and scalar tails (the indices of
`multi_tensor_apply_adam_kernel`, one block a chunk, written out here)
covering every element of every leaf exactly once, at the flagship
policy's 36 leaves and at awkward lengths; the rule that splits the leaves
over launches.  On the
card (`cuda`): the kernel at full width against the plain version and
torch's capturable Adam, eagerly and replayed in a CUDA graph.
"""
from __future__ import annotations

import ctypes
import re
from functools import lru_cache

import numpy as np
import pytest
import torch

from pde_policylearning_torch.control.policies import _restart
from pde_policylearning_torch.models import PolicyModel2D
from pde_policylearning_torch.native import cuda_build
from pde_policylearning_torch.tools import drag_rows
from pde_policylearning_torch.training import optimizers as opt_mod
from pde_policylearning_torch.training.optimizers import FusedAdam

BLOCK, UNROLL = 256, 4


def full_width_sizes() -> list:
    """Element counts of the full-width `PolicyModel2D`'s 36 leaves, in
    their order (the flagship policy, out_dim 1), from its shapes alone."""
    return [p.numel() for p in PolicyModel2D(
        **drag_rows.FULL_WIDTH, device="meta").parameters()]


# ---------------------------------------------------------------------------
# The arithmetic: the plain version against torch's Adam
# ---------------------------------------------------------------------------

# lengths 1, 3, 5, 4096, 4097 and a full-width spectral leaf (2, m1, m2,
# m3, 64, 64) at 3 modes a direction
SHAPES = [(1,), (3,), (5,), (4096,), (4097,), (2, 3, 3, 3, 64, 64)]


@pytest.mark.parametrize("dtype,zero,lr", [
    (torch.float32, (), 1e-4),
    (torch.float32, (0, 2, 5), 1e-4),
    (torch.float64, (1, 3, 5), 1e-2),
    (torch.float32, (0, 1, 2, 3, 4, 5), 1e-3),
])
def test_plain_fused_adam_steps_as_torch_adam(dtype, zero, lr):
    """Five steps against `torch.optim.Adam`, then `_restart` and three
    more against a fresh torch Adam; the leaves in `zero` get an exactly
    zero gradient at every step and must not move at all."""
    g = torch.Generator().manual_seed(len(zero))
    start = [torch.randn(s, generator=g, dtype=dtype) for s in SHAPES]
    grads = [[torch.zeros(s, dtype=dtype) if i in zero else
              1e-3 * torch.randn(s, generator=g, dtype=dtype)
              for i, s in enumerate(SHAPES)] for _ in range(8)]
    ours = [p.clone().requires_grad_() for p in start]
    fused = FusedAdam(ours, lr=lr)

    def torch_adam():
        ref = [p.detach().clone().requires_grad_() for p in ours]
        return ref, torch.optim.Adam(ref, lr=lr)

    ref, adam = torch_adam()
    for k, gs in enumerate(grads):
        if k == 5:
            _restart(fused)
            ref, adam = torch_adam()
        for p, q, gk in zip(ours, ref, gs):
            p.grad, q.grad = gk, gk.clone()
        fused.step()
        adam.step()
        for i, (p, q) in enumerate(zip(ours, ref)):
            torch.testing.assert_close(p, q, rtol=1e-6, atol=0)
            st, sq = fused.state[p], adam.state[q]
            torch.testing.assert_close(st["exp_avg_sq"], sq["exp_avg_sq"],
                                       rtol=1e-6, atol=0)
            assert float(st["step"]) == float(sq["step"]) == (
                k + 1 if k < 5 else k - 4)
            if i in zero:
                assert torch.equal(p.detach(), start[i])
            else:
                assert not torch.equal(p.detach(), start[i])


def test_fused_adam_state_and_refusals():
    """`state[p]` holds torch Adam's keys, one step count shared by the
    leaves (zeroed by `_restart` with the moments); a leaf without a
    gradient raises rather than being skipped, and so do a second
    parameter group and a closure; on the CPU no kernel launches."""
    ps = [torch.ones(3, requires_grad=True), torch.ones(5, requires_grad=True)]
    with pytest.raises(ValueError, match="one parameter group"):
        FusedAdam([{"params": ps[:1]}, {"params": ps[1:]}])
    opt = FusedAdam(ps, lr=1e-2)
    ps[0].grad = torch.ones(3)
    with pytest.raises(ValueError, match="no gradient"):
        opt.step()
    with pytest.raises(ValueError, match="no closure"):
        opt.step(lambda: 0.0)
    ps[1].grad = torch.ones(5)
    n0 = opt_mod.fused_adam_kernel.launches
    opt.step()
    opt.step()
    assert opt_mod.fused_adam_kernel.launches == n0
    st = [opt.state[p] for p in ps]
    assert all(set(s) == {"step", "exp_avg", "exp_avg_sq"} for s in st)
    assert st[0]["step"] is st[1]["step"] and float(st[0]["step"]) == 2
    _restart(opt)
    assert float(st[0]["step"]) == 0
    assert all(not s["exp_avg"].any() and not s["exp_avg_sq"].any()
               for s in st)


# ---------------------------------------------------------------------------
# The kernel's indices, emulated
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _chunk_offsets(length: int) -> np.ndarray:
    """The element offsets within one chunk of `length` elements that the
    update kernel's 256 threads touch, every touch listed once, as
    `multi_tensor_apply_adam_kernel` computes them: thread t, unroll u the
    float4 t + 256 u below length // 4, then threads t < length % 4 the
    element 4 (length // 4) + t."""
    tid = np.arange(BLOCK)
    nv = length >> 2
    i = (tid[None, :] + BLOCK * np.arange(UNROLL)[:, None]).ravel()
    body = (4 * i[i < nv])[:, None] + np.arange(4)
    tail = (nv << 2) + tid
    return np.concatenate([body.ravel(), tail[tail < length]])


@lru_cache(maxsize=None)
def _chunk_covered_once(length: int) -> bool:
    """The kernel's threads touch each element of a chunk of `length`
    elements exactly once, and nothing past it."""
    return np.array_equal(np.sort(_chunk_offsets(length)),
                          np.arange(length))


def emulate_update(sizes) -> list:
    """The chunks the update visits in each leaf, (start, length), over the
    launches of `adam_plan`: block c of a launch finds its leaf by the
    kernel's binary search of the table, then its chunk in it."""
    chunk = cuda_build.ADAM_CHUNK
    visits = [[] for _ in sizes]
    for idx, chunk0, n_chunks in opt_mod.adam_plan(sizes):
        for c in range(n_chunks):
            lo, hi = 0, len(idx) - 1
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                if chunk0[mid] <= c:
                    lo = mid
                else:
                    hi = mid - 1
            start = (c - chunk0[lo]) * chunk
            visits[idx[lo]].append((start, min(chunk, sizes[idx[lo]] - start)))
    return visits


AWKWARD = [1, 3, 5, 0, 4095, 4096, 4097, 8191, 8192, 12289, 7, 1024, 1027]


@pytest.mark.parametrize("case", ["full_width", "awkward",
                                  "around_a_chunk", "many_leaves",
                                  "one_element", "leaves_of_whole_chunks"])
def test_update_kernel_touches_every_element_once(case):
    """Every element of every leaf once: the flagship policy's 36 leaves
    (226,526,081 parameters), lengths that end inside a float4 or a chunk,
    every length from a chunk less 5 to a chunk and 5, more leaves than
    one launch takes, a one-element leaf, leaves of whole chunks."""
    rng = np.random.default_rng(0)
    chunk = cuda_build.ADAM_CHUNK
    sizes = {"full_width": full_width_sizes, "awkward": lambda: AWKWARD,
             "around_a_chunk": lambda: list(range(chunk - 5, chunk + 6)),
             "many_leaves": lambda: [int(n) for n in
                                     rng.integers(0, 9000, 200)],
             "one_element": lambda: [1],
             "leaves_of_whole_chunks": lambda: [chunk * k for k in
                                                (1, 2, 5, 1)]}[case]()
    if case == "full_width":
        assert len(sizes) == 36 and sum(sizes) == 226_526_081
    for n, seen in zip(sizes, emulate_update(sizes)):
        assert sorted(seen) == [(s, min(chunk, n - s))
                                for s in range(0, n, chunk)]
        assert all(_chunk_covered_once(ln) for _, ln in seen)


@pytest.mark.parametrize("n_leaves", [1, 36, 84, 85, 200])
def test_plan_splits_at_the_kernel_parameter_limit(n_leaves):
    """Consecutive leaves, at most `ADAM_MAX_LEAVES` a launch, each
    non-empty leaf in exactly one launch with its chunks counted, and the
    table that carries them within 4 KB of kernel parameters."""
    cap = cuda_build.ADAM_MAX_LEAVES
    sizes = [(7 * i) % 10000 for i in range(n_leaves)]
    plan = opt_mod.adam_plan(sizes)
    assert len(plan) == -(-sum(n > 0 for n in sizes) // cap)
    seen = [i for idx, _, _ in plan for i in idx]
    assert seen == [i for i, n in enumerate(sizes) if n > 0]
    for idx, chunk0, n_chunks in plan:
        assert len(idx) <= cap
        ends = chunk0[1:] + [n_chunks]
        assert [e - s for s, e in zip(chunk0, ends)] == [
            -(-sizes[i] // cuda_build.ADAM_CHUNK) for i in idx]
    assert ctypes.sizeof(cuda_build.AdamTable) <= 4096


def test_kernel_constants_match_the_source():
    """The chunk, the launch's leaf cap and the leaf's size in csrc/adam.cu
    are the ctypes side's."""
    src = (cuda_build.CSRC / "adam.cu").read_text()

    def define(name):
        return re.search(r"#define %s (.+)" % name, src).group(1)
    assert int(define("ADAM_BLOCK")) == BLOCK
    assert int(define("ADAM_UNROLL")) == UNROLL
    assert int(define("ADAM_MAX_LEAVES")) == cuda_build.ADAM_MAX_LEAVES
    assert BLOCK * UNROLL * 4 == cuda_build.ADAM_CHUNK
    assert "sizeof(AdamLeaf) == %d" % ctypes.sizeof(cuda_build.AdamLeaf) \
        in src
    kernel = re.search(r"(\w+)\(const __grid_constant__ AdamTable",
                       src).group(1)
    assert "multi_tensor_apply" in kernel
    assert re.search(r"(\w+)<<<t->n_chunks", src).group(1) == kernel


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fused_adam_on_the_card_at_full_width(cuda_device):
    """The full-width policy's 36 leaves (226,526,081 parameters), one
    leaf in three with an exactly zero gradient: three steps of the
    kernel against three of the plain version and of torch's capturable
    Adam, eagerly; then the same three steps captured in one CUDA graph
    and replayed three times, each after `_restart` and the parameters
    put back, bit for bit the eager kernel's."""
    dev, lr = cuda_device, 1e-4
    sizes = full_width_sizes()
    g = torch.Generator(device=dev).manual_seed(0)
    start = [torch.randn(n, generator=g, device=dev) for n in sizes]
    grads = [[torch.zeros(n, device=dev) if i % 3 == 0 else
              1e-3 * torch.randn(n, generator=g, device=dev)
              for i, n in enumerate(sizes)] for _ in range(3)]

    def leaves():
        return [p.clone().requires_grad_() for p in start]

    ours, plain, ref = leaves(), leaves(), leaves()
    fused = FusedAdam(ours, lr=lr)
    adam = torch.optim.Adam(ref, lr=lr, capturable=True)
    pm = [torch.zeros_like(p) for p in plain]
    pv = [torch.zeros_like(p) for p in plain]
    pstep = torch.zeros((), device=dev)
    k0 = opt_mod.fused_adam_kernel.launches
    for gs in grads:
        for p, q, gk in zip(ours, ref, gs):
            p.grad = q.grad = gk
        fused.step()
        adam.step()
        with torch.no_grad():
            opt_mod.adam_plain_(plain, gs, pm, pv, pstep, lr=lr)
    torch.cuda.synchronize()
    assert opt_mod.fused_adam_kernel.launches - k0 == 3
    for i, (p, q, r) in enumerate(zip(ours, plain, ref)):
        st = fused.state[p]
        assert set(st) == {"step", "exp_avg", "exp_avg_sq"}
        # absolute room for rounding where a sum of steps cancels: p
        # (~1, moved ~1e-4 a step) and m (~1e-4); v sums squares.  Torch's
        # capturable route takes 1 - b2^t in float32 (0.999 is 0.99900001
        # there), which alone moves each step by up to ~6.4e-6 of its size:
        # ~2e-9 over three steps of 1e-4
        for a, b, atol in ((p, q, 1e-9), (p, r, 5e-9),
                           (st["exp_avg"], pm[i], 1e-10),
                           (st["exp_avg"], adam.state[r]["exp_avg"], 1e-10),
                           (st["exp_avg_sq"], pv[i], 0.0),
                           (st["exp_avg_sq"], adam.state[r]["exp_avg_sq"],
                            0.0)):
            torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-5,
                                       atol=atol)
        if i % 3 == 0:
            assert torch.equal(p.detach(), start[i]), i
        else:
            assert (p.detach() != start[i]).float().mean() > 0.99, i
    eager = [p.detach().clone() for p in ours]

    def three_steps():
        for gs in grads:
            for p, gk in zip(ours, gs):
                p.grad = gk
            fused.step()

    def put_back():
        with torch.no_grad():
            _restart(fused)
            for p, s in zip(ours, start):
                p.copy_(s)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        put_back()
        three_steps()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    k0, n0 = (opt_mod.fused_adam_kernel.launches,
              opt_mod.fused_adam_kernel.params)
    put_back()
    with torch.cuda.graph(graph):
        three_steps()
    assert opt_mod.fused_adam_kernel.launches - k0 == 3
    assert opt_mod.fused_adam_kernel.params - n0 == 3 * 226_526_081
    for _ in range(3):
        put_back()
        graph.replay()
        torch.cuda.synchronize()
        assert float(fused.state[ours[0]]["step"]) == 3
        for p, e in zip(ours, eager):
            assert torch.equal(p.detach(), e)
    # a leaf that starts off a 16-B boundary is refused, not misread
    off = torch.zeros(5, device=dev)[1:]
    with pytest.raises(ValueError, match="16-B"):
        opt_mod.fused_adam_kernel([off], [off.clone()], [off.clone()],
                                  [off.clone()], torch.zeros((), device=dev),
                                  torch.empty(2, device=dev), lr=lr)


@pytest.mark.cuda
def test_fused_adam_on_the_card_over_one_leaf(cuda_device):
    """The full-field optimal-observer's Adam: one 32 x 32 leaf (the top
    wall's action), its 10 steps of lr 1e-3 against the plain version
    `adam_plain_` on the card, gradients over five decades; after
    `_restart` the same steps again, bit for bit (a fresh optimizer).
    Both are float32 with the bias corrections in float64, so they part
    by a rounding of the update's last operations: the room of the
    full-width test above."""
    dev, lr = cuda_device, 1e-3
    g = torch.Generator(device=dev).manual_seed(2 ** 31 + 5)
    start = 1e-2 * torch.randn(32, 32, generator=g, device=dev)
    scale = 10.0 ** torch.randint(-6, -1, (32, 32), generator=g, device=dev)
    grads = [scale * torch.randn(32, 32, generator=g, device=dev)
             for _ in range(10)]
    v = start.clone().requires_grad_()
    fused = FusedAdam([v], lr=lr)
    plain = start.clone()
    pm, pv = torch.zeros_like(plain), torch.zeros_like(plain)
    pstep = torch.zeros((), device=dev)
    runs = []
    for _ in range(2):
        with torch.no_grad():
            _restart(fused)
            v.copy_(start)
        for gk in grads:
            v.grad = gk
            fused.step()
        runs.append(v.detach().clone())
    for gk in grads:
        opt_mod.adam_plain_([plain], [gk], [pm], [pv], pstep, lr=lr)
    assert torch.equal(runs[0], runs[1])
    st = fused.state[v]
    assert float(st["step"]) == 10
    for a, b, atol in ((runs[0], plain, 1e-9), (st["exp_avg"], pm, 1e-10),
                       (st["exp_avg_sq"], pv, 0.0)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)
