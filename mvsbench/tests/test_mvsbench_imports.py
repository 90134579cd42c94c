"""Nothing the harness or its judge loads is JAX or the JAX package, by
whole top-level names (``apdmvs_tpu_torch`` begins with ``apdmvs_tpu``
and is not it), and the judge imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from mvsbench import catalog, run

FORBIDDEN = {"jax", "jaxlib", "flax", "apdmvs_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for dirpath, _, files in os.walk(catalog.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("module", ["reference", "scenes", "tracing", "roofline", "catalog"])
def test_judge_and_yardstick_import_nothing_of_the_program(module):
    assert "apdmvs_tpu_torch" not in set(_imports(os.path.join(catalog.HERE, module + ".py")))


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "apdmvs_tpu_torch_probe", sys)
    assert "apdmvs_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "apdmvs_tpu.probe", sys)
    assert "apdmvs_tpu" in run.forbidden_modules()


def test_loading_the_harness_and_the_program_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import mvsbench.run, mvsbench.calibrate, mvsbench.reference, mvsbench.scenes\n"
            "import apdmvs_tpu_torch.scene, apdmvs_tpu_torch.compiled, apdmvs_tpu_torch.fusion\n"
            "from mvsbench import catalog\n"
            "b = catalog.benchmark()\n"
            "[catalog.metric_reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
            "print(','.join(mvsbench.run.forbidden_modules()))\n") % catalog.ROOT
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=catalog.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
