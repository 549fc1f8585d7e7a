"""The port imports neither JAX, nor the JAX package, nor the JAX probes under ``bench/``
(they import JAX inside their functions).

An AST scan of the sources: the test process has JAX loaded already (the
tests compare against it), so ``sys.modules`` cannot show what the port
imports.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "image_lens_reproject_tpu", "bench")
SOURCES = sorted((ROOT / "image_lens_reproject_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None)) in (
            "import_module", "__import__",
        ):
            yield from (a.value for a in node.args if isinstance(a, ast.Constant) and isinstance(a.value, str))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_port():
    assert len(SOURCES) > 20
    assert list(_imported(ast.parse("import jax.numpy as jnp\nfrom image_lens_reproject_tpu.ops import remap"))) == [
        "jax.numpy", "image_lens_reproject_tpu.ops",
    ]
    assert list(_imported(ast.parse("from bench import dma_probe"))) == ["bench"]
