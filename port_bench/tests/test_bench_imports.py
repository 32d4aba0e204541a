"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names, and the references import nothing of the
program."""
import ast
import os

import pytest

from port_bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "pde_policylearning_tpu"}


def _sources(sub=""):
    top = os.path.join(harness.BENCH, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")))
def test_reference_stands_alone(path):
    mods = set(_imports(path))
    assert "pde_policylearning_torch" not in mods
    text = open(path).read()
    assert "from ..drivers" not in text and "pde_policylearning" not in \
        "".join(line for line in text.splitlines()
                if line.lstrip().startswith(("import", "from")))
