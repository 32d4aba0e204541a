"""The PyTorch port and its chip smoke script never import JAX."""
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_IMPORT_JAX = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.MULTILINE)


def test_port_never_imports_jax():
    files = sorted((ROOT / "pde_policylearning_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _IMPORT_JAX.search(f.read_text())]
    assert not offenders, f"imports jax: {offenders}"
