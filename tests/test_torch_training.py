"""Observer training in the port against the JAX package, float64 on the
CPU: every loss of `ops/losses.py`, the optimizers and schedules against
optax, the `Trainer` against the JAX `Trainer`, the sequence and
full-field datasets and `batch_arrays` on small numpy-written folders,
the checkpoint round trip, and the `run_pde_observers` entry on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pde_policylearning_tpu.data import channel as jchannel
from pde_policylearning_tpu.models.observers import \
    FNO2dObserver as JFNO2dObserver
from pde_policylearning_tpu.ops import losses as jl
from pde_policylearning_tpu.ops.normalization import \
    NormalizerGivenMeanStd as JNorm
from pde_policylearning_tpu.training import optimizers as jopt
from pde_policylearning_tpu.training.trainer import Trainer as JTrainer
from pde_policylearning_torch import run_pde_observers as rpo
from pde_policylearning_torch.data import (FullFieldNSDataset,
                                           SequentialPDEDataset,
                                           batch_arrays,
                                           generate_channel_dataset)
from pde_policylearning_torch.envs import NSControlEnv
from pde_policylearning_torch.models import FNO2dObserver, UNet
from pde_policylearning_torch.ops import losses as tl
from pde_policylearning_torch.ops.normalization import NormalizerGivenMeanStd
from pde_policylearning_torch.training import (Trainer, load_checkpoint,
                                               multistep_lr, negadam,
                                               save_checkpoint, step_lr)
from pde_policylearning_torch.training import adam_l2
from pde_policylearning_torch.utils import DotDict, load_yaml
from pde_policylearning_torch.utils.transplant import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU64 = dict(device="cpu", dtype=torch.float64)


def t64(a):
    """A float64 tensor of its own (torch updates parameters and clips
    gradients in place; a numpy buffer that JAX also reads must not
    move)."""
    return torch.tensor(np.asarray(a, np.float64))


def close(a, b, tol=1e-10):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(d=2), dict(d=1, p=3),
                                dict(d=2, reduce_dims=[0, 1],
                                     reductions=["sum", "mean"]),
                                dict(d=3, reduce_dims=None)])
def test_lp_loss_matches_jax(kw):
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(2, 3, 6, 5, 4)), rng.normal(size=(2, 3, 6, 5, 4))
    ours, ref = tl.LpLoss(**kw), jl.LpLoss(**kw)
    close(ours(t64(x), t64(y)), ref(jnp.asarray(x), jnp.asarray(y)))
    close(ours.abs(t64(x), t64(y)), ref.abs(jnp.asarray(x), jnp.asarray(y)))
    close(ours.abs(t64(x), t64(y), h=0.3),
          ref.abs(jnp.asarray(x), jnp.asarray(y), h=0.3))


@pytest.mark.parametrize("kw", [dict(), dict(size_average=False),
                                dict(reduction=False), dict(p=1)])
def test_simple_lp_loss_and_relative_l2_match_jax(kw):
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(3, 7, 5, 1)), rng.normal(size=(3, 7, 5, 1))
    ours, ref = tl.SimpleLpLoss(**kw), jl.SimpleLpLoss(**kw)
    close(ours(t64(x), t64(y)), ref(jnp.asarray(x), jnp.asarray(y)))
    close(ours.abs(t64(x), t64(y)), ref.abs(jnp.asarray(x), jnp.asarray(y)))
    close(tl.relative_l2(t64(x), t64(y)),
          jl.relative_l2(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("d,fix", [(1, ()), (1, ("x",)), (2, ()),
                                   (2, ("x", "y")), (3, ("y", "z"))])
def test_h1_loss_and_central_differences_match_jax(d, fix):
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=(2, 6, 5, 4)), rng.normal(size=(2, 6, 5, 4))
    kw = {f"fix_{a}_bnd": True for a in fix}
    ours, ref = tl.H1Loss(d=d, **kw), jl.H1Loss(d=d, **kw)
    close(ours(t64(x), t64(y)), ref(jnp.asarray(x), jnp.asarray(y)))
    close(ours.abs(t64(x), t64(y)), ref.abs(jnp.asarray(x), jnp.asarray(y)))
    close(ours.rel(t64(x), t64(y), h=0.2),
          ref.rel(jnp.asarray(x), jnp.asarray(y), h=0.2))
    fn = f"central_diff_{d}d"
    h = 0.3 if d == 1 else [0.3, 0.2, 0.1][:d]
    for a, b in zip(np.atleast_1d(getattr(tl, fn)(t64(x), h, **kw)),
                    np.atleast_1d(getattr(jl, fn)(jnp.asarray(x), h, **kw))):
        close(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(k=2, a=[0.5, 0.2]),
                                dict(size_average=False),
                                dict(reduction=False)])
def test_hs_loss_and_dissipative_loss_match_jax(kw):
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=(3, 8, 6, 1)), rng.normal(size=(3, 8, 6, 1))
    close(tl.HsLoss(**kw)(t64(x), t64(y)),
          jl.HsLoss(**kw)(jnp.asarray(x), jnp.asarray(y)))
    a, b = rng.random(5), rng.random(5)
    close(tl.dissipative_loss(t64(a), t64(b), 0.7, 2.0),
          jl.dissipative_loss(jnp.asarray(a), jnp.asarray(b), 0.7, 2.0))


def test_losses_are_differentiable():
    rng = np.random.default_rng(4)
    x = t64(rng.normal(size=(2, 6, 5))).requires_grad_()
    y = t64(rng.normal(size=(2, 6, 5)))
    loss = tl.H1Loss(d=2, fix_x_bnd=True)(x, y) + tl.LpLoss(d=2)(x, y)
    (g,) = torch.autograd.grad(loss, x)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

def _run_optimizer(make_torch, make_optax, n_steps=7):
    """n_steps updates of two parameter leaves under the same gradients
    (a numpy stream); the torch scheduler stepped after each update.
    1e-8: optax evaluates a schedule at its int32 step count in float32,
    so its learning rate carries a float32 rounding (~5e-9 here)."""
    rng = np.random.default_rng(5)
    p0 = [rng.normal(size=(3, 4)), rng.normal(size=(5,))]
    grads = [[3.0 * rng.normal(size=a.shape) for a in p0]
             for _ in range(n_steps)]
    params = [t64(a).requires_grad_() for a in p0]
    opt, sched = make_torch(params)
    jp = [jnp.asarray(a) for a in p0]
    tx = make_optax()
    state = tx.init(jp)
    for g in grads:
        for p, gi in zip(params, g):
            p.grad = t64(gi)
        opt.step()
        if sched is not None:
            sched.step()
        up, state = tx.update([jnp.asarray(gi) for gi in g], state, jp)
        jp = optax.apply_updates(jp, up)
    for a, b in zip(params, jp):
        close(a, b, 1e-8)


@pytest.mark.parametrize("decay,clip", [(0.0, None), (1e-2, None),
                                        (1e-2, 1.5)])
def test_adam_l2_matches_optax(decay, clip):
    """Seven steps across two StepLR boundaries (step_size 1 epoch of 3
    steps, gamma 0.5): the clip by optax's rule, the coupled decay."""
    _run_optimizer(
        lambda ps: (lambda o: (o, step_lr(o, 1, 0.5, 3)))(
            adam_l2(ps, 1e-2, decay, clip)),
        lambda: jopt.adam_l2(jopt.step_lr(1e-2, 1, 0.5, 3), decay, clip))


@pytest.mark.parametrize("decay", [0.0, 1e-2])
def test_negadam_matches_optax(decay):
    _run_optimizer(
        lambda ps: (lambda o: (o, step_lr(o, 1, 0.5, 3)))(
            negadam(ps, 1e-2, decay)),
        lambda: jopt.negadam(jopt.step_lr(1e-2, 1, 0.5, 3), decay))


def test_multistep_lr_matches_optax():
    _run_optimizer(
        lambda ps: (lambda o: (o, multistep_lr(o, [2, 5], 0.3)))(
            adam_l2(ps, 1e-2)),
        lambda: jopt.adam_l2(jopt.multistep_lr(1e-2, [2, 5], 0.3)))


def test_clip_follows_optax_not_clip_grad_norm():
    """optax scales by max / norm, torch's clip_grad_norm_ by
    max / (norm + 1e-6): the port follows optax, and leaves gradients
    under the max alone."""
    from pde_policylearning_torch.training.optimizers import \
        clip_by_global_norm_
    g = np.full(4, 3.0)
    ours = [t64(g)]
    clip_by_global_norm_(ours, 1.0)
    tx = optax.clip_by_global_norm(1.0)
    (ref,), _ = tx.update([jnp.asarray(g)], tx.init([jnp.asarray(g)]))
    close(ours[0], ref, 1e-15)
    p = torch.nn.Parameter(t64(np.zeros(4)))
    p.grad = t64(g)
    torch.nn.utils.clip_grad_norm_([p], 1.0)
    assert float((p.grad - ours[0]).abs().max()) > 1e-8
    small = [t64(np.full(4, 0.1))]
    clip_by_global_norm_(small, 1.0)
    close(small[0], np.full(4, 0.1), 0)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _fno_data(rng, n, size=8):
    x = rng.normal(size=(n, size, size, 1))
    y = 0.5 * x + 0.1 * rng.normal(size=(n, size, size, 1))
    return x, y


@pytest.mark.parametrize("kw", [
    dict(),
    dict(loss_reduction="sum", grad_clip=0.05, regularizer=True)])
def test_trainer_matches_jax_trainer(kw):
    """Three epochs of a tiny FNO observer, one batch an epoch
    (n_train == batch_size, so the batch order cannot matter), StepLR
    falling every epoch, the decoded loss: train_loss, test_loss,
    best_loss and the best parameters against the JAX Trainer, 1e-8."""
    rng = np.random.default_rng(6)
    (x, y), (xt, yt) = _fno_data(rng, 4), _fno_data(rng, 3)
    mean, std = 0.1 * rng.normal(size=(8, 8)), 0.5 + rng.random((8, 8))
    jm = JFNO2dObserver(4, 4, 6)
    shapes = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a),
                            jnp.zeros((1, 8, 8, 1)))["params"]
    tree = jax.tree.map(lambda s: 0.3 * rng.normal(size=s.shape), shapes)
    model = load_jax_params(FNO2dObserver(4, 4, 6, **CPU64), tree)
    common = dict(n_epochs=3, batch_size=4, learning_rate=3e-3,
                  weight_decay=1e-3, step_size=1, gamma=0.5,
                  log_interval=2, verbose=False,
                  grad_clip=kw.get("grad_clip"),
                  loss_reduction=kw.get("loss_reduction", "mean"))
    jreg = reg = None
    if kw.get("regularizer"):
        def jreg(p):
            return 1e-3 * sum(jnp.sum(a ** 2) for a in jax.tree.leaves(p))

        def reg(m):
            return 1e-3 * sum((p ** 2).sum() for p in m.parameters())
    jbest, jhist = JTrainer(
        jm, decoder=JNorm(jnp.asarray(mean), jnp.asarray(std)),
        regularizer=jreg, **common).train(
        (jnp.asarray(x), jnp.asarray(y)), (jnp.asarray(xt), jnp.asarray(yt)),
        params=jax.tree.map(jnp.asarray, tree))
    best, hist = Trainer(
        model, decoder=NormalizerGivenMeanStd(t64(mean), t64(std)),
        regularizer=reg, **common).train(
        (t64(x), t64(y)), (t64(xt), t64(yt)))
    for k in ("train_loss", "test_loss"):
        close(hist[k], jhist[k], 1e-8)
    close(hist["best_loss"], jhist["best_loss"], 1e-8)
    assert len(hist["epoch_time"]) == 2       # chunks of 2 and 1 epochs
    ref = load_jax_params(FNO2dObserver(4, 4, 6, **CPU64),
                          jax.tree.map(np.asarray, jbest))
    for name, p in ref.state_dict().items():
        close(best[name], p, 1e-8)
    # the best parameters are those of the epoch with the least test loss
    assert hist["best_loss"] == pytest.approx(min(hist["test_loss"]))


def test_trainer_refuses_what_jax_cannot_train():
    """The JAX Trainer applies the parameters alone, so a module with
    BatchNorm statistics (the UNet) cannot be trained by it; the port's
    refuses it.  `patcher` and `mesh`, which the JAX Trainer takes, are
    accepted (a mesh of one process without a process group, a patcher
    with and without it)."""
    from pde_policylearning_torch.parallel import (MultigridPatching2D,
                                                   make_mesh)
    from pde_policylearning_tpu.models.observers import UNet as JUNet
    jm = JUNet(modes=2)
    full = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                          jnp.zeros((1, 16, 16, 1)))
    assert "batch_stats" in full
    params = jax.tree.map(lambda s: jnp.zeros(s.shape), full["params"])
    with pytest.raises(Exception, match="batch_stats"):
        jm.apply({"params": params}, jnp.zeros((1, 16, 16, 1)))
    with pytest.raises(ValueError, match="BatchNorm"):
        Trainer(UNet(modes=2, **CPU64), n_epochs=1, batch_size=1)
    model = FNO2dObserver(4, 4, 6, **CPU64)
    mesh = make_mesh(device="cpu")
    for kw in (dict(patcher=MultigridPatching2D(1, 0.25)), dict(mesh=mesh),
               dict(mesh=mesh, patcher=MultigridPatching2D(1, 0.25, mesh))):
        trainer = Trainer(model, n_epochs=1, batch_size=1, **kw)
        assert (trainer.patcher, trainer.mesh) == (kw.get("patcher"),
                                                   kw.get("mesh"))
    with pytest.raises(ValueError, match="patcher's mesh"):
        Trainer(model, n_epochs=1, batch_size=1,
                patcher=MultigridPatching2D(1, 0.25, mesh))


def test_checkpoint_round_trip(tmp_path):
    """Model, optimizer and scheduler state and the epoch, in torch's
    format, back into fresh objects: the next update is the same."""
    gen = torch.Generator().manual_seed(0)
    model = FNO2dObserver(4, 4, 6, device="cpu", generator=gen)
    opt = adam_l2(model.parameters(), 1e-2, 1e-3, 1.0)
    sched = step_lr(opt, 1, 0.5, 2)
    x = torch.randn(2, 8, 8, 1, generator=gen)
    for _ in range(3):
        opt.zero_grad()
        (model(x) ** 2).mean().backward()
        opt.step()
        sched.step()
    path = save_checkpoint(str(tmp_path / "sub" / "c.pt"), model, opt, sched,
                           epoch=3)
    model2 = FNO2dObserver(4, 4, 6, device="cpu")
    opt2 = adam_l2(model2.parameters(), 1e-2, 1e-3, 1.0)
    sched2 = step_lr(opt2, 1, 0.5, 2)
    assert load_checkpoint(path, model2, opt2, sched2) == 3
    # the Trainer's resumable state is the same file
    trainer = Trainer(model2, n_epochs=1, batch_size=2)
    path2 = trainer.save_state(str(tmp_path / "t.pt"), opt2, sched2, epoch=3)
    assert Trainer(FNO2dObserver(4, 4, 6, device="cpu"), n_epochs=1,
                   batch_size=2).load_state(path2) == 3
    for m, o, s in ((model, opt, sched), (model2, opt2, sched2)):
        o.zero_grad()
        (m(x) ** 2).mean().backward()
        o.step()
        s.step()
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    assert sched2.get_last_lr() == sched.get_last_lr()


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def write_planes(folder, n, size=8, seed=7):
    """A small folder in the reference's format, written with numpy
    (float32 planes; float64 statistics, so that neither package rounds
    the normalizer's std + eps to float32 in a float64 comparison)."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    p = rng.normal(size=(n, size, size)).astype(np.float32) * 1e-2
    v = rng.normal(size=(n, size, size)).astype(np.float32)
    for i in range(n):
        np.save(os.path.join(folder, f"P_planes_{i:06d}.npy"), p[i])
        np.save(os.path.join(folder, f"V_planes_{i:06d}.npy"), v[i])
    p64, v64 = p.astype(np.float64), v.astype(np.float64)
    np.save(os.path.join(folder, "metadata.npy"), {
        "P_planes": {"mean": p64.mean(0), "std": p64.std(0) + 1e-8},
        "V_planes": {"mean": v64.mean(0), "std": v64.std(0) + 1e-8},
        "re": 178.1899})
    return folder


@pytest.mark.parametrize("timestep,kw", [(2, dict(x_range=8, y_range=8)),
                                         (3, dict(downsample_rate=2,
                                                  x_range=3, y_range=4))])
def test_sequential_dataset_matches_jax(tmp_path, timestep, kw):
    folder = write_planes(str(tmp_path / "ds"), 11)
    index = [0, 2, 3, 6, 7, 8, 9, 10]
    ref = jchannel.SequentialPDEDataset.from_folder(folder, index,
                                                    timestep=timestep, **kw)
    ours = SequentialPDEDataset.from_folder(folder, index, timestep=timestep,
                                            device="cpu",
                                            dtype=torch.float64, **kw)
    assert len(ours) == len(ref) == len(index) // timestep
    np.testing.assert_array_equal(ours.p, ref.p)
    for a, b in zip(ours.arrays(), ref.arrays(jnp.float64)):
        assert tuple(a.shape) == b.shape
        close(a, b, 1e-12)


def test_batch_arrays_matches_jax():
    rng = np.random.default_rng(8)
    a, b = rng.normal(size=(11, 3, 2)), rng.normal(size=(11, 4))
    for ours, ref in zip(batch_arrays([t64(a), t64(b)], 4),
                         jchannel.batch_arrays([jnp.asarray(a),
                                                jnp.asarray(b)], 4)):
        assert tuple(ours.shape) == ref.shape
        close(ours, ref, 0)
    # shuffled: the same rows of both arrays, a permutation of the first
    # whole batches' worth
    sa, sb = batch_arrays([t64(a), t64(np.arange(11.0))], 4,
                          generator=torch.Generator().manual_seed(0))
    rows = sb.reshape(-1).long()
    assert sa.shape == (2, 4, 3, 2) and len(set(rows.tolist())) == 8
    close(sa.reshape(8, 3, 2), a[rows.numpy()], 0)


def test_full_field_dataset_matches_jax(tmp_path):
    """A folder with the U/V/W fields of a few env steps (the port's
    generator on the CPU), read by both packages."""
    env = NSControlEnv(Nx=8, Ny=33, Nz=8, detect_plane=5, noise_scale=0.02,
                       seed=1, device="cpu")
    folder = generate_channel_dataset(str(tmp_path / "ff"), 6, env=env,
                                      detect_plane=5, save_fields=True)
    rows, planes = [0, 1, 3, 4, 5], [-2, -5]
    ref = jchannel.FullFieldNSDataset.from_folder(folder, rows, planes,
                                                  timestep=2)
    ours = FullFieldNSDataset.from_folder(folder, rows, planes, timestep=2,
                                          device="cpu")
    assert len(ours) == len(ref) == 2
    for k in ("U", "V", "W", "dpdx"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))
    assert ours.v_field.shape == ref.v_field.shape == (2, 2, 2, 8, 8)
    close(ours.v_plane, ref.v_plane, 1e-6)
    close(ours.v_field, ref.v_field, 1e-6)
    assert ours.re == ref.re
    close(ours.bound_v_norm.std, ref.bound_v_norm.std, 0)


# ---------------------------------------------------------------------------
# the entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config,over", [
    ("base_fno.yaml", dict(modes=4, width=6)),
    ("matlab_rno.yaml", dict(modes=3, width=5)),
    ("base_transformer.yaml", dict(modes=3, n_hidden=8, freq_dim=6))])
def test_entry_trains_on_the_cpu(tmp_path, capsys, config, over):
    """`run_pde_observers.main` on the repository's config (sizes cut to
    an 8x8 folder) with device='cpu': finite losses for each epoch, the
    checkpoint written and reloaded to the same test loss, bit for bit,
    and the entry's lines printed."""
    folder = write_planes(str(tmp_path / "ds"), 24)
    args = DotDict(load_yaml(os.path.join(ROOT, "configs", config)))
    args.update(DATA_FOLDER=folder, epochs=2, ntrain=16, ntest=8,
                batch_size=4, x_range=8, y_range=8, set_epoch=-1,
                out_dir=str(tmp_path / "out"), **over)
    best, hist = rpo.main(args, device="cpu")
    out = capsys.readouterr().out
    assert "Training done in" in out and "Best model saved at" in out
    assert len(hist["train_loss"]) == 2
    assert np.isfinite(hist["train_loss"] + hist["test_loss"]).all()
    model, _ = rpo.build_model(args, device="cpu")
    assert load_checkpoint(hist["checkpoint"], model) == 2
    train_ds, _, test = rpo.load_arrays(args, "cpu")
    trainer = rpo.make_trainer(args, model, train_ds.v_norm)
    assert float(trainer.test_loss(test).float()) == hist["best_loss"]


def test_entry_generates_a_missing_dataset_and_refuses_the_full_field(
        tmp_path, monkeypatch):
    """Without a dataset the entry rolls out `generate_steps` env steps
    on its device (recorded here, the folder written with numpy in its
    place), then splits the planes as the JAX entry does."""
    calls = []

    def fake(folder, n, policy, env_kwargs):
        calls.append((n, policy, env_kwargs))
        write_planes(folder, n)
    monkeypatch.setattr(rpo, "generate_channel_dataset", fake)
    args = DotDict(load_yaml(os.path.join(ROOT, "configs", "base_fno.yaml")))
    args.update(DATA_FOLDER=str(tmp_path / "gen"), generate_steps=10,
                ntrain=6, ntest=3)
    train_idx, test_idx = rpo.load_or_generate_data(args, "cpu")
    assert calls == [(10, "gt", {"spinup_steps": 0, "device": "cpu"})]
    args["random_split"] = True
    ref = np.arange(10)
    np.random.default_rng(0).shuffle(ref)
    np.testing.assert_array_equal(train_idx, ref[:6])
    np.testing.assert_array_equal(test_idx, ref[6:9])
    # a full-field config takes the full-field branch, which runs
    monkeypatch.undo()
    args = DotDict(load_yaml(os.path.join(ROOT, "configs",
                                          "fullfield_pi.yaml")))
    args.update(DATA_FOLDER=str(tmp_path / "ff"), x_range=8, y_range=8,
                Ny=33, generate_steps=6, ntrain=4, ntest=2, epochs=1,
                batch_size=2, layers=[6, 6], modes1=[2], modes2=[2],
                modes3=[12], fc_dim=4, set_epoch=-1,
                out_dir=str(tmp_path / "out"))
    _, hist = rpo.main(args, device="cpu")
    assert np.isfinite(hist["total"]).all() and hist["test_rel_l2"] > 0
