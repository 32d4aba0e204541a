"""The port's parallel layer (pde_policylearning_torch/parallel/) and the
Trainer's `mesh`, `patcher`, `compute_dtype` and `train_model_kwargs`
against the JAX package, in float64 on the CPU over gloo.

The multi-rank checks run in three groups of spawned ranks
(`parallel.launch.run_ranks`, each with a deadline): four ranks (the mesh's
groups, the data x model patched FNO step, the x-sharded step and rollout
at P = 2 and 4, the data-parallel rollouts), two ranks (the Trainer with a
mesh, and with a patcher splitting over the model group), and the dry run
on four ranks.  The JAX references are computed here, in the pytest
process, from numpy inputs that the ranks get as arguments; the ranks send
their results back as numpy arrays.  This module imports no JAX at its
top: the spawned ranks import it to find their functions.
"""
import multiprocessing
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pde_policylearning_torch.envs import channel_flow as cf
from pde_policylearning_torch.models import FNO, FNO2dObserver
from pde_policylearning_torch.ops.normalization import NormalizerGivenMeanStd
from pde_policylearning_torch.parallel import (MultigridPatching2D, Mesh,
                                               data_parallel_rollout,
                                               gather, gather_x,
                                               make_mesh, make_mg_patches,
                                               make_patches, replicate,
                                               shard_batch,
                                               shard_env_state,
                                               sharded_rollout, sharded_step,
                                               split_batch_size,
                                               stitch_patches)
from pde_policylearning_torch.parallel.dryrun import dryrun, patched_step
from pde_policylearning_torch.parallel.launch import run_ranks
from pde_policylearning_torch.parallel.mesh import (backend_for,
                                                    init_distributed)
from pde_policylearning_torch.training import Trainer
from pde_policylearning_torch.utils.transplant import load_jax_params

CPU64 = dict(device="cpu", dtype=torch.float64)
NX, NY, NZ, DP, T = 16, 17, 8, 3, 3
FNO_KW = dict(in_channels=2, out_channels=1, n_layers=2, lifting_channels=8,
              projection_channels=8)
DEADLINE = 120.0


def _jax():
    """The JAX modules, imported only in the pytest process."""
    import jax
    import jax.numpy as jnp
    import optax

    from pde_policylearning_tpu import models as jmodels
    from pde_policylearning_tpu import parallel as jpar
    from pde_policylearning_tpu.envs import channel_flow as jcf
    return jax, jnp, optax, jmodels, jpar, jcf


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


def _fno64(tree, cls=FNO, *args, **kw):
    if cls is FNO:
        args, kw = ((3, 3), 8), FNO_KW
    return load_jax_params(cls(*args, **kw, **CPU64), tree)


def _grid_state(env_in):
    grid = cf.grid_from_arrays(env_in["grid"], **CPU64)
    return grid, cf.state_from_arrays(env_in["fields"], **CPU64)


def _np(d):
    return {k: v.detach().numpy() for k, v in d.items()}


# ---------------------------------------------------------------------------
# rank functions (run in spawned processes)
# ---------------------------------------------------------------------------

def _rank_world4(rank, world, fno_in, env_in, batch_in):
    out = {}
    meshes = {mp: make_mesh(mp, device="cpu") for mp in (2, 4)}
    for mp, mesh in meshes.items():
        out[f"groups{mp}"] = (
            mesh.dp, mesh.mp, mesh.data_rank, mesh.model_rank,
            dist.get_process_group_ranks(mesh.data_group),
            dist.get_process_group_ranks(mesh.model_group))
    mesh = meshes[2]
    t = torch.full((3,), float(rank))
    replicate(mesh, [t])
    out["replicated"] = t.numpy()
    out["shard"] = shard_batch(mesh, torch.arange(8.0)).numpy()

    # the data x model patched FNO step
    tree, x, y = fno_in
    model = _fno64(tree)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss = patched_step(model, opt, MultigridPatching2D(1, 0.25, mesh), mesh,
                        *shard_batch(mesh, t64(x), t64(y)))
    out["fno"] = (float(loss),
                  {n: p.grad.numpy() for n, p in model.named_parameters()},
                  _np(dict(model.named_parameters())))

    # the x-sharded step and a rollout of it at P = 2 and 4
    grid, state = _grid_state(env_in)
    o1, o2 = (t64(a) for a in env_in["ops"])
    for P, m in meshes.items():
        st = sharded_step(m, grid, shard_env_state(m, state), o1, o2)
        fin, p2 = sharded_rollout(m, grid, shard_env_state(m, state), T,
                                  detect_plane=DP)
        out[f"step{P}"] = {k: gather_x(m, getattr(st, k)).numpy()
                           for k in "UVW"}
        out[f"step{P}"]["dPdx"] = st.dPdx.numpy()
        out[f"roll{P}"] = {k: gather_x(m, getattr(fin, k)).numpy()
                           for k in "UVW"}
        out[f"roll{P}"].update(dPdx=fin.dPdx.numpy(),
                               p2=gather_x(m, p2, dim=1).numpy())

    # data-parallel rollouts of four envs over 'data'
    states = cf.ChannelState(**{k: t64(v) for k, v in batch_in.items()})
    for policy in ("gt", "rand"):
        s, outs = data_parallel_rollout(mesh, grid, states, T,
                                        detect_plane=DP, policy=policy,
                                        collect_fields=policy == "gt")
        out[f"dp_{policy}"] = [gather(mesh, a, "data").numpy() for a in
                               (s.U, s.V, s.W, s.dPdx, *outs)]
        out[f"dp_{policy}_here"] = int(s.U.shape[0])
    if rank == 0:
        s, outs = cf.batched_rollout(grid, states, T, detect_plane=DP,
                                     policy="rand")
        out["rand_ref"] = [a.numpy() for a in (s.U, s.V, s.W, s.dPdx, *outs)]
    return out


def _rank_world2(rank, world, trainer_in, patch_in):
    out = {}
    tree, data, stats, common = trainer_in
    mesh = make_mesh(1, device="cpu")
    trainer = Trainer(_fno64(tree, FNO2dObserver, 4, 4, 6),
                      decoder=NormalizerGivenMeanStd(*map(t64, stats)),
                      mesh=mesh, **common)
    best, hist = trainer.train(*((t64(a), t64(b)) for a, b in data))
    out["mesh"] = (_np(best), hist)
    tree, data, common = patch_in
    mesh = make_mesh(2, device="cpu")
    trainer = Trainer(_fno64(tree), mesh=mesh,
                      patcher=MultigridPatching2D(1, 0.25, mesh), **common)
    best, hist = trainer.train(*((t64(a), t64(b)) for a, b in data))
    out["patched"] = (_np(best), hist)
    return out


def _rank_fails(rank, world):
    if rank == 1:
        raise ValueError("rank 1 stops here")
    dist.barrier()
    return rank


def _rank_sleeps(rank, world):
    time.sleep(600)


# ---------------------------------------------------------------------------
# the patch functions, in the pytest process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,n,p", [((2, 16, 16, 3), 4, 0),
                                       ((1, 4, 4, 1), 2, 1),
                                       ((2, 12, 8, 2), [3, 2], [2, 5]),
                                       ((1, 6, 6, 1), 1, 7)])
def test_make_and_stitch_patches_equal_jax(shape, n, p):
    """Pure copies: exactly the JAX arrays, wrap padding past the field's
    size included."""
    _, jnp, _, _, jpar, _ = _jax()
    x = np.random.default_rng(0).normal(size=shape)
    ours = make_patches(t64(x), n, p)
    ref = jpar.make_patches(jnp.asarray(x), n, p)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    if p == 0:
        np.testing.assert_array_equal(
            stitch_patches(ours, n).numpy(),
            np.asarray(jpar.stitch_patches(ref, n)))
        np.testing.assert_array_equal(stitch_patches(ours, n).numpy(), x)


@pytest.mark.parametrize("shape,levels,frac", [((2, 16, 16, 3), 2, 0.125),
                                               ((2, 8, 8, 1), 1, 0.25),
                                               ((1, 16, 8, 2), 1, [0.25, 0]),
                                               ((1, 8, 8, 1), 0, 0.25)])
def test_make_mg_patches_equals_jax(shape, levels, frac):
    _, jnp, _, _, jpar, _ = _jax()
    x = np.random.default_rng(1).normal(size=shape)
    np.testing.assert_array_equal(
        make_mg_patches(t64(x), levels, frac).numpy(),
        np.asarray(jpar.make_mg_patches(jnp.asarray(x), levels, frac)))


@pytest.mark.parametrize("levels,frac,stitching", [(1, 0.25, True),
                                                   (2, 0.125, True),
                                                   (1, 0.25, False)])
def test_patcher_patch_and_unpatch_equal_jax(levels, frac, stitching):
    """Without a mesh: patch, a stand-in model (the fine channels doubled),
    unpatch, and the evaluation unpatch, exactly the JAX arrays."""
    _, jnp, _, _, jpar, _ = _jax()
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=(2, 16, 16, 1)), rng.normal(size=(2, 16, 16, 1))
    ours = MultigridPatching2D(levels, frac, stitching=stitching)
    ref = jpar.MultigridPatching2D(levels, frac, stitching=stitching)
    px, py = ours.patch(t64(x), t64(y))
    jx, jy = ref.patch(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    for ev in (False, True):
        a, b = ours.unpatch(2.0 * px[..., :1], py, evaluation=ev)
        ja, jb = ref.unpatch(2.0 * jx[..., :1], jy, evaluation=ev)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    if stitching:
        np.testing.assert_array_equal(a.numpy(), 2.0 * x)


def test_unpatch_returns_patches_without_padding_as_jax_does():
    """The JAX quirk, kept: with padding_fraction <= 0, `unpatch` returns
    the patches as they came, neither cropped nor stitched
    (patching.py:159-161)."""
    _, jnp, _, _, jpar, _ = _jax()
    x = np.random.default_rng(3).normal(size=(2, 8, 8, 1))
    ours, ref = MultigridPatching2D(1, 0), jpar.MultigridPatching2D(1, 0)
    px, _ = ours.patch(t64(x), t64(x))
    out, _ = ours.unpatch(px[..., :1], t64(x))
    jx, _ = ref.patch(jnp.asarray(x), jnp.asarray(x))
    jout, _ = ref.unpatch(jx[..., :1], jnp.asarray(x))
    assert tuple(out.shape) == (8, 4, 4, 1) == jout.shape
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_split_batch_size_and_a_mesh_without_a_group():
    """JAX's divisibility contract and error text; without a process group
    a mesh has one rank and no collectives."""
    jax, _, _, _, jpar, _ = _jax()
    mesh = Mesh(4, 0, 2, 2, None, None, torch.device("cpu"), "gloo")
    jmesh = jpar.make_mesh(2, devices=jax.devices()[:4])
    assert split_batch_size(8, mesh) == jpar.split_batch_size(8, jmesh) == 4
    with pytest.raises(ValueError) as ours:
        split_batch_size(5, mesh)
    with pytest.raises(ValueError) as ref:
        jpar.split_batch_size(5, jmesh)
    assert str(ours.value) == str(ref.value)
    alone = make_mesh(device="cpu")
    assert (alone.world_size, alone.dp, alone.mp, alone.data_group) == \
        (1, 1, 1, None)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(2, device="cpu")


def test_nccl_without_a_card_raises():
    """The card's backend is asked for by the device and never falls back
    to gloo or the CPU: without a card (or NCCL), asking for it raises,
    and the dry run refuses to start."""
    if torch.cuda.is_available() and dist.is_nccl_available():
        pytest.skip("a card with NCCL is present")
    assert backend_for("cpu") == "gloo"
    for device in ("cuda", None):
        with pytest.raises(RuntimeError):
            backend_for(device)
        with pytest.raises(RuntimeError):
            init_distributed("file:///nonexistent", 2, 0, device=device)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dryrun(1, "cuda")
    assert init_distributed(world_size=1) is None


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_run_ranks_raises_a_childs_error_and_keeps_a_deadline():
    """A rank's exception comes back with its traceback, and past the
    deadline every child is killed and TimeoutError raised; no child is
    left either way."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed first.*"
                       "rank 1 stops here"):
        run_ranks(_rank_fails, 2, "cpu", timeout=DEADLINE)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks(_rank_sleeps, 2, "cpu", timeout=3.0)
    assert time.monotonic() - t0 < 30
    assert not multiprocessing.active_children()


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world4():
    """The four-rank results and the JAX references."""
    jax, jnp, optax, jmodels, jpar, jcf = _jax()
    from test_torch_rk3 import grid_arrays, make_fields
    rng = np.random.default_rng(4)
    refs = {}

    # the patched FNO step: JAX's unsharded step from the same tree
    x, y = rng.normal(size=(4, 8, 8, 1)), rng.normal(size=(4, 8, 8, 1))
    jfno = jmodels.FNO(n_modes=(3, 3), hidden_channels=8, **FNO_KW)
    jpatcher = jpar.MultigridPatching2D(levels=1, padding_fraction=0.25)
    px, _ = jpatcher.patch(jnp.asarray(x), jnp.asarray(y))
    shapes = jax.eval_shape(lambda a: jfno.init(jax.random.PRNGKey(0), a),
                            px)["params"]
    tree = jax.tree.map(lambda s: 0.3 * rng.normal(size=s.shape), shapes)

    def loss_fn(p):
        px, py = jpatcher.patch(jnp.asarray(x), jnp.asarray(y))
        sx, sy = jpatcher.unpatch(jfno.apply({"params": p}, px), py)
        return jnp.mean((sx - sy) ** 2)

    params = jax.tree.map(jnp.asarray, tree)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    tx = optax.adam(1e-3)
    upd, _ = tx.update(grads, tx.init(params))
    refs["fno"] = (float(loss), jax.tree.map(np.asarray, grads),
                   jax.tree.map(np.asarray, optax.apply_updates(params, upd)))

    # the x-sharded step and rollout: JAX rk3_step from the same state
    jgrid = jcf.make_channel_grid(Nx=NX, Ny=NY, Nz=NZ, dtype=jnp.float64)
    fields, ops = make_fields(10, NX, NY, NZ)
    jstate = jcf.ChannelState(**{k: jnp.asarray(v) for k, v in
                                 fields.items()})
    step = jcf.rk3_step(jgrid, jstate, jnp.asarray(ops[0]),
                        jnp.asarray(ops[1]))
    refs["step"] = {k: np.asarray(getattr(step, k)) for k in
                    ("U", "V", "W", "dPdx")}
    jmesh = jpar.make_mesh(2, devices=jax.devices()[:2])
    fin, p2s = jpar.sharded_rollout(jmesh, jgrid,
                                    jpar.shard_env_state(jmesh, jstate), T,
                                    detect_plane=DP)
    refs["roll"] = {k: np.asarray(getattr(fin, k)) for k in
                    ("U", "V", "W", "dPdx")}
    refs["roll"]["p2"] = np.asarray(p2s)

    # the data-parallel rollout: JAX batched_rollout of four envs
    made = [make_fields(s, NX, NY, NZ)[0] for s in (11, 12, 13, 14)]
    batch = {k: np.stack([f[k] for f in made]) for k in made[0]}
    s, outs = jcf.batched_rollout(
        jgrid, jcf.ChannelState(**{k: jnp.asarray(v) for k, v in
                                   batch.items()}), T, detect_plane=DP,
        policy="gt", collect_fields=True)
    refs["dp_gt"] = [np.asarray(a) for a in (s.U, s.V, s.W, s.dPdx, *outs)]
    refs["meanU0"] = float(np.abs(batch["meanU0"]).max())

    env_in = dict(grid=grid_arrays(jgrid), fields=fields, ops=ops)
    results = run_ranks(_rank_world4, 4, "cpu",
                        (((tree, x, y)), env_in, batch), timeout=DEADLINE)
    return results, refs


def dpdx_atol(meanU0):
    """One float64 rounding of the bulk velocity moves dPdx by ~eps *
    meanU0 / dt (1/dt = 1000), above 1e-10 of dPdx itself (the rule of
    tests/test_torch_rollout.py)."""
    return 4 * np.finfo(np.float64).eps * meanU0 / 1e-3


def test_make_mesh_groups_follow_the_jax_layout(world4):
    """Rank r is data index r // mp and model index r % mp: contiguous
    model groups, strided data groups."""
    results, _ = world4
    for r, out in enumerate(results):
        assert out["groups2"] == (2, 2, r // 2, r % 2,
                                  [r % 2, r % 2 + 2],
                                  [2 * (r // 2), 2 * (r // 2) + 1])
        assert out["groups4"] == (1, 4, 0, r, [r], [0, 1, 2, 3])


def test_replicate_and_shard_batch(world4):
    """`replicate` gives every rank rank 0's values; `shard_batch` gives a
    data rank its block of the leading axis (both model ranks of it the
    same block)."""
    results, _ = world4
    for r, out in enumerate(results):
        np.testing.assert_array_equal(out["replicated"], np.zeros(3))
        np.testing.assert_array_equal(out["shard"],
                                      np.arange(4.0) + 4 * (r // 2))


def test_patched_fno_step_matches_jax(world4):
    """dp 2 x mp 2: the loss, every gradient and the parameters after one
    Adam step against JAX's unsharded step, rtol 1e-10, on every rank."""
    results, refs = world4
    loss, grads, after = refs["fno"]
    g_ref = _fno64(grads).state_dict()
    p_ref = _fno64(after).state_dict()
    for out in results:
        l, g, p = out["fno"]
        np.testing.assert_allclose(l, loss, rtol=1e-10)
        assert set(g) == set(g_ref)
        for name in g_ref:
            np.testing.assert_allclose(g[name], g_ref[name].numpy(),
                                       rtol=1e-10, atol=1e-14,
                                       err_msg=name)
            np.testing.assert_allclose(p[name], p_ref[name].numpy(),
                                       rtol=1e-10, atol=1e-14,
                                       err_msg=name)


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_step_matches_jax_rk3_step(world4, P):
    results, refs = world4
    ref = refs["step"]
    for out in results:
        got = out[f"step{P}"]
        for k in "UVW":
            assert rel(got[k], ref[k]) <= 1e-10, k
        np.testing.assert_allclose(got["dPdx"], ref["dPdx"], rtol=1e-10,
                                   atol=dpdx_atol(refs["meanU0"]))


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_rollout_matches_jax(world4, P):
    """Three opposition-control steps of the x-sharded state and their
    top-wall pressures, against the JAX sharded rollout (its unsharded
    arithmetic)."""
    results, refs = world4
    ref = refs["roll"]
    for out in results:
        got = out[f"roll{P}"]
        assert got["p2"].shape == ref["p2"].shape == (T, NX, NZ)
        for k in ("U", "V", "W", "p2"):
            assert rel(got[k], ref[k]) <= 1e-10, k
        np.testing.assert_allclose(got["dPdx"], ref["dPdx"], rtol=1e-10,
                                   atol=dpdx_atol(refs["meanU0"]))


def test_sharded_dpdx_is_bitwise_the_same_on_every_rank(world4):
    results, _ = world4
    for key in ("step2", "step4", "roll2", "roll4"):
        assert len({out[key]["dPdx"].tobytes() for out in results}) == 1
        # the gathered fields are one array on every rank too
        assert len({out[key]["U"].tobytes() for out in results}) == 1


def test_data_parallel_rollout_matches_jax_batched_rollout(world4):
    """gt, four envs over two data ranks (two each), fields collected:
    against JAX batched_rollout at the port's rollout tolerance."""
    results, refs = world4
    for out in results:
        assert out["dp_gt_here"] == 2
        for i, (a, b) in enumerate(zip(out["dp_gt"], refs["dp_gt"])):
            assert a.shape == b.shape, i
            if i == 3:
                np.testing.assert_allclose(a, b, rtol=1e-8,
                                           atol=dpdx_atol(refs["meanU0"]))
            else:
                assert rel(a, b) <= 1e-8, i


def test_data_parallel_rollout_rand_is_batched_rollout_bit_for_bit(world4):
    """The random policy's draws are made for the whole batch on every
    rank and sliced: each rank's block is the whole batch's, bit for
    bit."""
    results, _ = world4
    ref = results[0]["rand_ref"]
    for out in results:
        for a, b in zip(out["dp_rand"], ref):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the Trainer: two ranks, and in this process
# ---------------------------------------------------------------------------

def _trainer_common():
    return dict(n_epochs=3, batch_size=4, learning_rate=3e-3,
                weight_decay=1e-3, step_size=1, gamma=0.5, log_interval=2,
                verbose=False)


@pytest.fixture(scope="module")
def world2():
    """Two-rank Trainer runs and the JAX Trainer's: with a mesh of two
    data ranks (the JAX mesh of two devices), and with a patcher whose
    mesh splits the patch batch over two model ranks (the JAX patcher
    unsharded).  One batch an epoch (n_train == batch_size), as in
    tests/test_torch_training.py."""
    jax, jnp, _, jmodels, jpar, _ = _jax()
    from pde_policylearning_tpu.models.observers import \
        FNO2dObserver as JFNO2dObserver
    from pde_policylearning_tpu.ops.normalization import \
        NormalizerGivenMeanStd as JNorm
    from pde_policylearning_tpu.training.trainer import Trainer as JTrainer
    rng = np.random.default_rng(5)
    refs = {}

    def data(n):
        x = rng.normal(size=(n, 8, 8, 1))
        return x, 0.5 * x + 0.1 * rng.normal(size=(n, 8, 8, 1))

    def jdata(d):
        return tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in d)

    # the global batch's summed loss and the clip after the all-reduce
    common = dict(_trainer_common(), loss_reduction="sum", grad_clip=0.05)
    d = (data(4), data(4))
    stats = 0.1 * rng.normal(size=(8, 8)), 0.5 + rng.random((8, 8))
    jm = JFNO2dObserver(4, 4, 6)
    shapes = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a),
                            jnp.zeros((1, 8, 8, 1)))["params"]
    tree = jax.tree.map(lambda s: 0.3 * rng.normal(size=s.shape), shapes)
    jbest, jhist = JTrainer(
        jm, decoder=JNorm(*map(jnp.asarray, stats)),
        mesh=jpar.make_mesh(1, devices=jax.devices()[:2]), **common).train(
        *jdata(d), params=jax.tree.map(jnp.asarray, tree))
    refs["mesh"] = (jax.tree.map(np.asarray, jbest), jhist)
    trainer_in = (tree, d, stats, common)

    pcommon = dict(_trainer_common(), batch_size=2)
    pd = (data(2), data(2))
    jfno = jmodels.FNO(n_modes=(3, 3), hidden_channels=8, **FNO_KW)
    jpatcher = jpar.MultigridPatching2D(levels=1, padding_fraction=0.25)
    px, _ = jpatcher.patch(jnp.zeros((1, 8, 8, 1)), None)
    shapes = jax.eval_shape(lambda a: jfno.init(jax.random.PRNGKey(0), a),
                            px)["params"]
    ptree = jax.tree.map(lambda s: 0.3 * rng.normal(size=s.shape), shapes)
    jbest, jhist = JTrainer(jfno, patcher=jpatcher, **pcommon).train(
        *jdata(pd), params=jax.tree.map(jnp.asarray, ptree))
    refs["patched"] = (jax.tree.map(np.asarray, jbest), jhist)
    patch_in = (ptree, pd, pcommon)
    results = run_ranks(_rank_world2, 2, "cpu", (trainer_in, patch_in),
                        timeout=DEADLINE)
    return results, refs, trainer_in, patch_in


def _assert_trained_like(best, hist, ref, model):
    jbest, jhist = ref
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(hist[k], jhist[k], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(hist["best_loss"], jhist["best_loss"],
                               rtol=1e-8, atol=1e-8)
    for name, p in load_jax_params(model, jbest).state_dict().items():
        np.testing.assert_allclose(best[name], p.numpy(), rtol=1e-8,
                                   atol=1e-8, err_msg=name)


def test_trainer_with_a_mesh_matches_jax(world2):
    """Two data ranks against the JAX Trainer on a two-device mesh, with
    the summed loss (scaled by the global batch) and the global-norm clip:
    the losses, the best loss and the best parameters, the same on both
    ranks."""
    results, refs, *_ = world2
    for out in results:
        best, hist = out["mesh"]
        _assert_trained_like(best, hist, refs["mesh"],
                             FNO2dObserver(4, 4, 6, **CPU64))
    assert results[0]["mesh"][1]["test_loss"] == \
        results[1]["mesh"][1]["test_loss"]


def test_trainer_with_a_patcher_matches_jax(world2):
    """The patch batch split over two model ranks (each forward on half
    of the patches, the gradients summed over the model group), and the
    patcher in one process, against the JAX Trainer with the patcher."""
    results, refs, _, (ptree, pd, pcommon) = world2
    for out in results:
        best, hist = out["patched"]
        _assert_trained_like(best, hist, refs["patched"],
                             FNO((3, 3), 8, **FNO_KW, **CPU64))
    best, hist = Trainer(_fno64(ptree), patcher=MultigridPatching2D(1, 0.25),
                         **pcommon).train(
        *((t64(a), t64(b)) for a, b in pd))
    _assert_trained_like(_np(best), hist, refs["patched"],
                         FNO((3, 3), 8, **FNO_KW, **CPU64))


def test_trainer_compute_dtype_bf16_matches_jax():
    """float32 master weights, a bf16 forward on casts of the parameters
    and the inputs, the loss in float32: against the JAX Trainer with
    compute_dtype bfloat16 (2e-2, the rule of the bf16 PINO test)."""
    jax, jnp, _, _, _, _ = _jax()
    from pde_policylearning_tpu.models.observers import \
        FNO2dObserver as JFNO2dObserver
    from pde_policylearning_tpu.training.trainer import Trainer as JTrainer
    rng = np.random.default_rng(6)
    x = rng.normal(size=(8, 8, 8, 1)).astype(np.float32)
    y = (0.5 * x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    jm = JFNO2dObserver(4, 4, 6)
    shapes = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a),
                            jnp.zeros((1, 8, 8, 1), jnp.float32))["params"]
    tree = jax.tree.map(
        lambda s: (0.3 * rng.normal(size=s.shape)).astype(np.float32), shapes)
    common = dict(_trainer_common(), batch_size=8)
    data = ((x, y), (x[:4], y[:4]))

    def jax_run(**kw):
        best, hist = JTrainer(jm, **kw, **common).train(
            *((jnp.asarray(a), jnp.asarray(b)) for a, b in data),
            params=jax.tree.map(jnp.asarray, tree))
        return _np(load_jax_params(FNO2dObserver(4, 4, 6, device="cpu"),
                                   jax.tree.map(np.asarray, best))
                   .state_dict()), hist

    def port_run(cast=lambda a: a, **kw):
        model = load_jax_params(FNO2dObserver(4, 4, 6, device="cpu"), tree)
        best, hist = Trainer(model, **kw, **common).train(
            *((cast(torch.tensor(a)), torch.tensor(b)) for a, b in data))
        assert all(p.dtype == torch.float32 for p in model.parameters())
        return _np(best), hist

    def departure(a, b):
        return max(rel(a[k], b[k]) for k in b)

    jbest, jhist = jax_run(compute_dtype=jnp.bfloat16)
    best, hist = port_run(compute_dtype=torch.bfloat16)
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(hist[k], jhist[k], rtol=2e-2)
    assert departure(best, jbest) <= 2e-2
    # bf16 rounding differs between implementations by about as much as
    # bf16 differs from float32, so the 2e-2 limit alone admits a float32
    # run.  What separates them: the bf16 run moves the parameters from
    # the same run in float32 as far as the JAX bf16 run moves them from
    # the JAX float32 run (within 2x; 0.93x at this seed), where casting
    # only the inputs moves them ~100x less
    jdep = departure(jbest, jax_run()[0])
    best32, _ = port_run()
    best_in, _ = port_run(cast=lambda a: a.bfloat16().float())
    assert 0.5 * jdep <= departure(best, best32) <= 2 * jdep
    assert departure(best_in, best32) <= 0.1 * jdep


def test_trainer_train_model_kwargs_turn_dropout_on_in_training_only():
    """`deterministic=False` in train_model_kwargs: the training passes
    drop out (another history than without), the evaluation passes do not
    (the recorded test loss is the dropout-free loss of those
    parameters)."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(8, 8, 8, 2, generator=gen, dtype=torch.float64)
    y = 0.5 * x[..., :1]

    def model():
        return FNO((3, 3), 8, **dict(FNO_KW, n_layers=1), use_mlp=True,
                   mlp_dropout=0.5, generator=torch.Generator().manual_seed(8),
                   **CPU64)

    m = model()
    with torch.no_grad():
        assert not torch.equal(m(x, deterministic=False), m(x))
        assert torch.equal(m(x), m(x))
    common = dict(_trainer_common(), n_epochs=1, batch_size=4)
    torch.manual_seed(0)
    on = Trainer(m, train_model_kwargs={"deterministic": False}, **common)
    _, hist_on = on.train((x, y), (x[:4], y[:4]))
    assert hist_on["test_loss"][0] == float(
        on.test_loss((x[:4], y[:4])).float())
    with torch.no_grad():
        plain = torch.mean(torch.stack([
            on.loss_fn(m(x[:4]).reshape(y[:4].shape), y[:4])]))
    assert hist_on["test_loss"][0] == float(plain.float())
    _, hist_off = Trainer(model(), **common).train((x, y), (x[:4], y[:4]))
    assert hist_on["train_loss"] != hist_off["train_loss"]


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_dryrun_on_four_gloo_ranks():
    """`python -m pde_policylearning_torch.parallel.dryrun --devices 4
    --device cpu`: dp 2 x mp 2, every part finite and the same on every
    rank, the patched loss exactly its unsharded computation, the sharded
    step's fields against `_rk3_step_unfused` on the whole state."""
    reports = dryrun(4, "cpu", timeout=DEADLINE)
    assert [(r["world"], r["dp"], r["mp"], r["backend"]) for r in reports] \
        == [(4, 2, 2, "gloo")] * 4
    for k in ("fno_loss", "sharded_dPdx", "pino_loss"):
        assert len({r[k] for r in reports}) == 1
        assert np.isfinite(reports[0][k])
    assert [r["rollout_envs_here"] for r in reports] == [2] * 4
    for r in reports:
        assert r["fno_loss_err"] == 0.0
        # against `_rk3_step_unfused`: V and W are its solve's bits; U
        # differs by its float32 mass flow against the float64 one
        assert (r["sharded_err"]["V"], r["sharded_err"]["W"]) == (0.0, 0.0)
        assert 0.0 < r["sharded_err"]["U"] <= 1e-6
