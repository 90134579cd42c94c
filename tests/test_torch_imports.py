"""The port stands alone: no module of ``apdmvs_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the reference package (a static check of
every import statement, so a lazy import inside a function counts too)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "apdmvs_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "apdmvs_tpu")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_port_has_modules():
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("params", "geometry", "sampling", "rng", "hypotheses", "ncc", "propagation",
                "filters", "classify", "pipeline", "fusion", "scene", "convert", "__main__",
                "weak", "ops/volume", "ops/ncc_volume", "ops/cols", "ops/cost_volume",
                "ops/_build", "io/formats", "io/images",
                "io/render", "datasets/synthetic", "native/__init__"):
        assert f"apdmvs_tpu_torch/{mod}.py" in rel, mod


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_guard_catches_a_reference_import():
    src = "import apdmvs_tpu.ncc\nfrom jax import numpy\nimport apdmvs_tpu_torch.ncc\n"
    tree = ast.parse(src)
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert [m for m in mods if _forbidden(m)] == ["apdmvs_tpu.ncc", "jax"]
