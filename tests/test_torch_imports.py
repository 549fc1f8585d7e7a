"""The port (its package, ``chip_smoke.py`` and its measurement scripts under
``tools/``) imports neither JAX, nor the JAX package, nor the JAX probes under
``bench/`` (they import JAX inside their functions).

An AST scan of the sources: the test process has JAX loaded already (the
tests compare against it), so ``sys.modules`` cannot show what the port
imports.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "image_lens_reproject_tpu", "bench")
SOURCES = (sorted((ROOT / "image_lens_reproject_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "tools").glob("*.py")))


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


def test_package_exports():
    """The JAX package's top-level names that have a counterpart, each the
    module function it names; the ``_jit`` names have none. The port's
    ``remap_tonemap_planned`` takes a ``make_plan`` plan where JAX's takes
    its TPU prepass arrays."""
    import image_lens_reproject_torch as ilr
    from image_lens_reproject_torch.ops import color, plan, remap, remap_fused

    assert ilr.__all__ == [
        "Equirectangular", "FisheyeEquidistant", "FisheyeEquisolid", "FisheyeStereographic",
        "LensSpec", "LensType", "Rectilinear", "full_equirectangular", "rotation_matrix",
        "rotation_matrix_degrees", "post_process", "remap_image", "make_plan", "remap_tonemap",
        "remap_tonemap_batch", "remap_tonemap_planned", "remap_tonemap_planned_batch",
    ]
    assert ilr.post_process is color.post_process
    assert ilr.remap_image is remap.remap_image
    assert ilr.make_plan is plan.make_plan
    assert ilr.remap_tonemap_planned_batch is remap_fused.remap_tonemap_planned_batch
    assert ilr.remap_tonemap_planned is remap_fused.remap_tonemap_planned
    assert ilr.remap_tonemap is remap_fused.remap_tonemap
    assert all(hasattr(ilr, name) for name in ilr.__all__)
    assert not any(name.endswith("_jit") for name in dir(ilr))
