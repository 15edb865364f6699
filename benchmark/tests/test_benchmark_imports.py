"""What the benchmark may import: nothing under ``benchmark/`` imports JAX
or the JAX package ``sph_tpu`` (top-level names compared whole, so the
port ``sph_tpu_torch`` is not ``sph_tpu``), and nothing under
``benchmark/reference/`` imports the port."""
import ast
import os

import pytest

from benchmark import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREIGN = {"jax", "jaxlib", "flax", "sph_tpu"}


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    seen = {p: set(_imported(p)) for p in _sources(HERE)}
    assert len(seen) > 10
    bad = {os.path.relpath(p, HERE): sorted(m & FOREIGN)
           for p, m in seen.items() if m & FOREIGN}
    assert bad == {}
    # the port is imported, and it is not the JAX package
    assert any("sph_tpu_torch" in m for m in seen.values())


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(HERE, "reference")
    for p in _sources(ref):
        mods = set(_imported(p))
        assert not mods & (FOREIGN | {"sph_tpu_torch"}), p


@pytest.mark.parametrize("modules, found", [
    (["sph_tpu_torch", "sph_tpu_torch.engine.step", "torch"], []),
    (["sph_tpu.engine", "numpy"], ["sph_tpu"]),
    (["jax._src.core", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "sph_tpu_tools"], []),
])
def test_the_runs_own_look_compares_whole_names(modules, found):
    assert run.foreign(modules) == found
