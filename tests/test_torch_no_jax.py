"""The PyTorch port and its chip smoke script never import JAX and read no
file of the JAX package."""
import re
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
_IMPORT_JAX = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.MULTILINE)


def test_port_never_imports_jax():
    files = sorted((ROOT / "pde_policylearning_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _IMPORT_JAX.search(f.read_text())]
    assert not offenders, f"imports jax: {offenders}"


def test_snapshot_is_the_ports_own_copy():
    """The packaged Re_tau ~ 180 snapshot lies inside the port's package
    and holds the arrays of the JAX package's file, bit for bit."""
    from pde_policylearning_torch.envs.control_env import \
        default_snapshot_path
    path = Path(default_snapshot_path()).resolve()
    assert (ROOT / "pde_policylearning_torch") in path.parents
    ours = np.load(path)
    theirs = np.load(ROOT / "pde_policylearning_tpu" / "data" / "assets"
                     / "channel180_minchan_tpu.npz")
    assert sorted(ours.files) == sorted(theirs.files)
    for k in theirs.files:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_port_names_no_path_into_the_jax_package():
    """No source of the port builds a path into pde_policylearning_tpu
    (docstrings may cite its files as `pde_policylearning_tpu/...`)."""
    files = sorted((ROOT / "pde_policylearning_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    pat = re.compile(r"""["']pde_policylearning_tpu["']""")
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pat.search(f.read_text())]
    assert not offenders, f"build a path into the JAX package: {offenders}"


_IMPORT_TPU = re.compile(
    r"^\s*(import\s+pde_policylearning_tpu\b|from\s+pde_policylearning_tpu\b"
    r"|from\s+\.\.+\s*import\s+pde_policylearning_tpu\b)", re.MULTILINE)


def test_port_never_imports_the_jax_package():
    """No module of the port (the models, policies, training stack, data,
    native loader and entries of every slice, the flagship slice's PINO
    models and full-field training, PINO pretraining, DDPG, the parallel
    layer, the UNO, graph, spherical and DeepONet models and the 2-D
    channel, DINo, the .msgpack reader and the last ops, data and utils
    among them) nor the smoke script imports
    pde_policylearning_tpu."""
    files = sorted((ROOT / "pde_policylearning_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {f.name for f in files}
    assert {"rno.py", "transformer.py", "dispatcher.py", "trainer.py",
            "optimizers.py", "checkpoint.py", "losses.py", "loader.py",
            "config.py", "logging.py", "run_pde_observers.py", "mfn.py",
            "pino.py", "observer_fullfield.py", "run_control.py",
            "pde_losses.py", "synthetic.py", "pino_datasets.py",
            "pino_train.py", "train_pino.py", "ddpg.py", "gym_env.py",
            "main_ddpg.py", "mesh.py", "patching.py", "sharded_env.py",
            "launch.py", "dryrun.py", "graph.py", "uno.py", "channel2d.py",
            "run_cfd_simulation.py", "sht.py", "sfno.py", "deeponet.py",
            "run_learning_beta_to_k.py", "dino.py", "dino_train.py",
            "dino_datasets.py", "train_dino.py", "test_dino.py",
            "library.py", "preprocess.py", "fem.py",
            "fourier_continuation.py", "torch_init.py", "misc.py",
            "profiling.py", "visualization.py",
            "run_spec_visualization.py"} <= names
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _IMPORT_TPU.search(f.read_text())]
    assert not offenders, f"imports the JAX package: {offenders}"


def test_native_loader_is_the_ports_own_copy():
    """The parallel .npy loader lies inside the port's package, byte for
    byte the JAX package's source; its library is built at first use and
    never committed (`*.so` is ignored)."""
    ours = ROOT / "pde_policylearning_torch" / "native"
    theirs = ROOT / "pde_policylearning_tpu" / "native"
    for name in ("loader.py", "fastloader.c"):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes()
    from pde_policylearning_torch.native import loader
    assert Path(loader.__file__).resolve().parent == ours.resolve()
    assert "*.so" in (ROOT / ".gitignore").read_text().split()
