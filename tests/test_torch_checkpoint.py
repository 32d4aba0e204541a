"""The port's reader and writer of the JAX package's `.msgpack` files
against flax's serialization, on the CPU: every leaf kind both ways (and
the bytes of a rewritten file), chunked arrays, the legacy dense spectral
layout both ways, an `FNO2dObserver` written by each package and run by
the other (float64, 1e-10), `run_control` and `train_pino --ckpt` taking
a JAX file, and the extensions `load_checkpoint` refuses."""
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from pde_policylearning_tpu.models.observers import \
    FNO2dObserver as JFNO2dObserver
from pde_policylearning_tpu.training import checkpoint as jck
from pde_policylearning_torch import run_control as rc
from pde_policylearning_torch import train_pino
from pde_policylearning_torch.models import FNO2dObserver
from pde_policylearning_torch.training import checkpoint as ck
from pde_policylearning_torch.utils import load_yaml
from pde_policylearning_torch.utils.transplant import (jax_param_keys,
                                                       jax_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU64 = dict(device="cpu", dtype=torch.float64)


def leaf(kind, rng):
    return {
        "float32": lambda: rng.normal(size=(3, 4)).astype(np.float32),
        "float64": lambda: rng.normal(size=(2, 3, 2)),
        "int32": lambda: np.arange(-3, 4, dtype=np.int32),
        "bool": lambda: rng.uniform(size=(5,)) > 0.5,
        "complex64": lambda: (rng.normal(size=4) + 1j * rng.normal(size=4))
        .astype(np.complex64),
        "native_complex": lambda: complex(rng.normal(), rng.normal()),
        "numpy_scalar": lambda: np.float32(rng.normal()),
        "bfloat16": lambda: np.asarray(jnp.asarray(rng.normal(size=(4, 3)),
                                                   jnp.bfloat16)),
        "nested_tuple": lambda: (rng.normal(size=2), (np.int64(7), 1.5),
                                 [rng.normal(size=(1, 2))]),
    }[kind]()


def bits(x):
    """A leaf as comparable numpy bits (bfloat16 as uint16)."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def same(a, b):
    if isinstance(b, (tuple, list)):
        assert isinstance(a, dict) and len(a) == len(b)
        for i, v in enumerate(b):
            same(a[str(i)], v)
        return
    if isinstance(b, complex):
        assert isinstance(a, complex) and a == b
        return
    x, y = bits(a), bits(b)
    assert x.dtype == y.dtype and x.shape == y.shape
    np.testing.assert_array_equal(x, y)


KINDS = ["float32", "float64", "int32", "bool", "complex64",
         "native_complex", "numpy_scalar", "bfloat16", "nested_tuple"]


@pytest.mark.parametrize("kind", KINDS)
def test_each_leaf_kind_both_ways(tmp_path, kind):
    """flax writes, the port reads; the port writes back, flax reads; the
    port's file is flax's byte for byte.  bfloat16 comes back as a
    `torch.bfloat16` tensor, bit for bit."""
    rng = np.random.default_rng(KINDS.index(kind))
    tree = {"a": {"leaf": leaf(kind, rng)}, "b": rng.normal(size=(2,))}
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jck.save_msgpack(jpath, tree)
    got = ck.load_msgpack(jpath)
    same(got["a"]["leaf"], tree["a"]["leaf"])
    if kind == "bfloat16":
        assert got["a"]["leaf"].dtype == torch.bfloat16
    ck.save_msgpack(tpath, got)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    back = jck.load_msgpack(tpath)
    same(back["a"]["leaf"], tree["a"]["leaf"])


def test_torch_tensors_are_written_as_flax_arrays(tmp_path):
    t = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    path = ck.save_msgpack(str(tmp_path / "sub" / "t.msgpack"), t)
    back = jck.load_msgpack(path)
    np.testing.assert_array_equal(back["w"], t["w"].numpy())
    assert back["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["h"], np.float32),
                                  [1.5, -2.25])


def test_chunked_arrays_both_ways(tmp_path, monkeypatch):
    """With the chunk limit made small (flax's in this process only, and
    the port's), a float64 and a bfloat16 array each split into pieces
    and come back whole, in both directions."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(ck, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"x": rng.normal(size=(5, 7)),
            "h": np.asarray(jnp.asarray(rng.normal(size=(9, 11)),
                                        jnp.bfloat16))}
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jck.save_msgpack(jpath, tree)
    with open(jpath, "rb") as f:
        import msgpack
        raw = msgpack.unpackb(f.read(), ext_hook=lambda c, d: d, raw=False)
    assert raw["x"]["__msgpack_chunked_array__"] is True
    assert len(raw["x"]["chunks"]) == 5 * 7 * 8 // 64 + 1
    got = ck.load_msgpack(jpath)
    same(got["x"], tree["x"])
    same(got["h"], tree["h"])
    ck.save_msgpack(tpath, got)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    back = jck.load_msgpack(tpath)
    same(back["x"], tree["x"])
    same(back["h"], tree["h"])


def observer_tree(rng, modes=6, width=8, size=16):
    jm = JFNO2dObserver(modes, modes, width)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size)))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64)
                        + 0.1 * rng.normal(size=a.shape),
                        jax.tree.map(np.asarray, v["params"]))
    return jm, tree


def legacy(tree):
    """The tree with every dense spectral leaf in the legacy `tensor`
    layout, made by the JAX package's own adapter."""
    def tgt(t):
        if isinstance(t, dict):
            if any(k.startswith("mm") for k in t) and len(t) == 1:
                return {"tensor": None}
            return {k: tgt(v) for k, v in t.items()}
        return t
    return jck._adapt_dense_layout(tree, tgt(tree))


def test_dense_layout_adapts_both_ways(tmp_path):
    """A legacy `{'tensor': ...}` checkpoint loads into the port's `mmK`
    leaves (the forward equal to JAX's on the mode-major tree), and the
    port's adapter turns a tree either way as the JAX adapter does."""
    rng = np.random.default_rng(2)
    jm, tree = observer_tree(rng)
    old = legacy(tree)
    flat = str(jax.tree_util.tree_structure(old))
    assert "tensor" in flat and "mm2" not in flat
    for a, b in ((old, tree), (tree, old)):
        got = ck._adapt_dense_layout(a, b)
        want = jck._adapt_dense_layout(a, b)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(x, y)
    path = jck.save_msgpack(str(tmp_path / "legacy.msgpack"), old)
    model = FNO2dObserver(6, 6, 8, **CPU64)
    assert ck.load_checkpoint(path, model) == 0
    x = rng.normal(size=(2, 16, 16))
    ref = jm.apply({"params": jax.tree.map(jnp.asarray, tree)}, x)
    with torch.no_grad():
        out = model(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10, atol=1e-10)
    # and the keys the port adapts to are the module's flax tree
    keys = jax_param_keys(model)
    assert jax.tree_util.tree_structure(
        jax.tree.map(lambda _: None, tree)) == \
        jax.tree_util.tree_structure(keys)


def test_fno_observer_written_by_each_package_runs_in_the_other(tmp_path):
    rng = np.random.default_rng(3)
    jm, tree = observer_tree(rng)
    x = rng.normal(size=(2, 16, 16))
    ref = np.asarray(jm.apply({"params": jax.tree.map(jnp.asarray, tree)},
                              x))
    path = jck.save_msgpack(str(tmp_path / "jax.msgpack"), tree)
    model = FNO2dObserver(6, 6, 8, **CPU64)
    ck.load_checkpoint(path, model)
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.tensor(x)).numpy(), ref,
                                   rtol=1e-10, atol=1e-10)
    # the port's file through the JAX template load
    tpath = ck.save_checkpoint(str(tmp_path / "port.msgpack"), model)
    tmpl = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16)))["params"]
    back = jck.load_msgpack(tpath, tmpl)
    np.testing.assert_allclose(
        jm.apply({"params": back}, x), ref, rtol=1e-10, atol=1e-10)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # a JAX Trainer state ({'params', 'epoch'}) loads with its epoch
    spath = jck.save_msgpack(str(tmp_path / "state.msgpack"),
                             {"params": tree, "epoch": 3})
    assert ck.load_checkpoint(spath, FNO2dObserver(6, 6, 8, **CPU64)) == 3


@pytest.mark.parametrize("which", ["unet", "tucker_fno"])
def test_port_msgpack_round_trip_of_every_layout(tmp_path, which):
    """`jax_params` inverts `load_jax_params` for every layout: a UNet
    (Conv, ConvTranspose flipped, BatchNorm scale and statistics under
    `batch_stats`) and a Tucker FNO (the `factors` list) come back from
    their .msgpack equal, parameter and buffer."""
    from pde_policylearning_torch.models import FNO, UNet
    g = torch.Generator().manual_seed(5)
    if which == "unet":
        def make():
            return UNet(modes=4, bilinear=False, generator=g, **CPU64)
    else:
        def make():
            return FNO((6, 6), 8, in_channels=3, out_channels=1, n_layers=2,
                       factorization="tucker", rank=0.5, **CPU64)
    model, other = make(), make()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g, dtype=p.dtype))
        for n, b in model.named_buffers():
            if n.endswith(("running_mean", "running_var")):
                b.add_(torch.rand(b.shape, generator=g, dtype=b.dtype))
    path = ck.save_checkpoint(str(tmp_path / "m.msgpack"), model)
    ck.load_checkpoint(path, other)
    mine, theirs = model.state_dict(), other.state_dict()
    for k, v in mine.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(v, theirs[k]), k
    params, stats = jax_params(model)
    assert (stats is not None) == (which == "unet")
    if which == "tucker_fno":
        assert "factors" in str(jax.tree_util.tree_structure(params))


def test_unknown_extensions_and_optimizers_raise(tmp_path):
    model = FNO2dObserver(4, 4, 6, **CPU64)
    for name in ("c.ckpt", "c", "c.msgpack.bak", "c.pth"):
        with pytest.raises(ValueError, match="extension"):
            ck.save_checkpoint(str(tmp_path / name), model)
        with pytest.raises(ValueError, match="extension"):
            ck.load_checkpoint(str(tmp_path / name), model)
    opt = torch.optim.Adam(model.parameters())
    with pytest.raises(ValueError, match="parameters only"):
        ck.save_checkpoint(str(tmp_path / "c.msgpack"), model, opt)
    path = ck.save_checkpoint(str(tmp_path / "c.msgpack"), model)
    with pytest.raises(ValueError, match="no optimizer"):
        ck.load_checkpoint(path, model, opt)
    path = ck.save_checkpoint(str(tmp_path / "c.pt"), model, epoch=4)
    assert ck.load_checkpoint(path, model) == 4
    params, stats = jax_params(model)
    assert stats is None and "fno2d" in params


def write_planes(folder, n, size=32):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    p = rng.normal(size=(n, size, size)).astype(np.float32) * 1e-2
    v = rng.normal(size=(n, size, size)).astype(np.float32) * 1e-2
    for i in range(n):
        np.save(os.path.join(folder, f"P_planes_{i:06d}.npy"), p[i])
        np.save(os.path.join(folder, f"V_planes_{i:06d}.npy"), v[i])
    np.save(os.path.join(folder, "metadata.npy"), {
        "P_planes": {"mean": p.mean(0), "std": p.std(0) + 1e-8},
        "V_planes": {"mean": v.mean(0), "std": v.std(0) + 1e-8},
        "re": 178.1899})
    return folder


def test_run_control_takes_a_jax_observer(tmp_path, capsys):
    """`run_control` with `model_checkpoint` a .msgpack the JAX package
    wrote: the `fno` loop's series equal to the same observer's torch
    checkpoint, step for step."""
    rng = np.random.default_rng(4)
    jm = JFNO2dObserver(12, 12, 32)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + 0.01 * rng.normal(size=a.shape).astype(np.float32),
                        jax.tree.map(np.asarray, v["params"]))
    jpath = jck.save_msgpack(str(tmp_path / "fno.msgpack"), tree)
    model = FNO2dObserver(12, 12, 32, device="cpu")
    ck.load_checkpoint(jpath, model)
    tpath = ck.save_checkpoint(str(tmp_path / "fno.pt"), model)
    planes = write_planes(str(tmp_path / "planes"), 4)
    series = []
    for ckpt in (jpath, tpath):
        cfg = load_yaml(os.path.join(ROOT, "configs", "base_control.yaml"))
        cfg.update(DATA_FOLDER=planes, control_timestep=3, log_interval=3,
                   output_dir=str(tmp_path / "out"), model_checkpoint=ckpt)
        path = str(tmp_path / "control.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(dict(cfg), f)
        res = rc.main(["--control_yaml", path, "--policy_name", "fno",
                       "--device", "cpu"])
        series.append(res["series"])
    assert "Final shear" in capsys.readouterr().out
    for k in series[0]:
        np.testing.assert_array_equal(series[0][k], series[1][k])


def test_train_pino_ckpt_takes_a_jax_checkpoint(tmp_path, capsys,
                                                monkeypatch):
    """The JAX `train_pino.py` trains 2 iterations and writes its
    .msgpack; the port's `--test --ckpt` on it gives the JAX `--test`
    line's rel-L2 (float32 both, 1e-4)."""
    cfg = {
        "seed": 0, "ckpt_dir": str(tmp_path), "ckpt_name": "tiny.msgpack",
        "data": {"paths": [str(tmp_path / "kf.npy")], "Re": 40,
                 "raw_res": [16, 16, 3], "data_res": [16, 16, 3],
                 "pde_res": [16, 16, 3], "n_samples": 2, "n_test": 2,
                 "test_offset": 4, "t_duration": 1.0},
        "model": {"layers": [8, 8, 8], "modes1": [4, 4], "modes2": [4, 4],
                  "modes3": [2, 2], "fc_dim": 16, "in_dim": 4,
                  "out_dim": 1, "act": "gelu"},
        "train": {"batchsize": 2, "accum_steps": 1, "base_lr": 1e-3,
                  "milestones": [1, 2], "scheduler_gamma": 0.5,
                  "xy_loss": 5.0, "ic_loss": 1.0, "f_loss": 1.0,
                  "log_interval": 1, "iterations": 2},
    }
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    ckpt = str(tmp_path / "tiny.msgpack")

    def run_jax(*extra):
        monkeypatch.setattr(sys, "argv", ["train_pino.py", "--config",
                                          str(path), *extra])
        runpy.run_path(os.path.join(ROOT, "train_pino.py"),
                       run_name="__main__")

    run_jax()
    assert os.path.exists(ckpt)
    capsys.readouterr()
    run_jax("--test", "--ckpt", ckpt)
    ref = float(capsys.readouterr().out.split("test rel-L2:")[1].split()[0])
    res = train_pino.main(["--config", str(path), "--test", "--ckpt", ckpt,
                           "--device", "cpu"])
    assert "test rel-L2" in capsys.readouterr().out
    assert abs(res["test"] / ref - 1) < 1e-4
