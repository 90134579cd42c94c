"""The port's meshes at the surface: the device fusion's mesh mode, the
CLI's shard flags, the process-group entry and the device guard of the
kernel wrappers, on the CPU.

- ``fusion_device.fuse_eth_device(mesh=)`` with 2, 4 and 7 row shards of
  ``cpu`` equals the one-device call exactly (points and colours; the
  counterpart of tests/test_fusion_device.py:67-85).
- ``python -m apdmvs_tpu_torch <scene> --device cpu --batched`` with
  ``--space-shards 2`` and with ``--view-shards 2`` runs end to end: the
  four state files of every view equal one-shard ``run_scene_batched``'s
  byte for byte, and the cloud lies on the scene's planes
  (tests/test_torch_cli.py::_cloud_ok); a space mesh pins no volume set.
  Shard flags or a coordinator without ``--batched`` fail.
- ``multihost.maybe_initialize`` does nothing without a coordinator and
  refuses incomplete or contradictory requests.
- Every kernel launch of ``ops/volume.py``, ``ops/ncc_volume.py`` and
  ``ops/cols.py`` (a ``lib.<fn>(...)`` call) sits inside ``with
  _build.on_device(...)``, checked on the source; the check flags a launch
  outside it.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from apdmvs_tpu_torch import fusion as tfus, fusion_device as tfd, parallel
from apdmvs_tpu_torch.datasets import synthetic
from apdmvs_tpu_torch.io import formats
from apdmvs_tpu_torch.parallel import multihost
from test_torch_cli import _cloud_ok
from test_torch_fusion import _views

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE_FILES = ("depths.dmb", "normals.dmb", "weak.bin", "selected_views.bin")


@pytest.fixture(scope="module")
def fusion_views():
    views, src_ids, _ = _views(tfus)
    coords, colors = tfd.fuse_eth_device(views, src_ids, device="cpu")
    return views, src_ids, coords, colors


@pytest.mark.parametrize("shards", [2, 4, 7])
def test_fusion_mesh_mode_equals_one_device(fusion_views, shards):
    """Tolerance: exact (array_equal), points in the same order."""
    views, src_ids, want_c, want_k = fusion_views
    got_c, got_k = tfd.fuse_eth_device(views, src_ids,
                                       mesh=parallel.make_mesh(1, shards, device="cpu"))
    assert want_c.shape[0] > 10000
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_k, want_k)


def _cli(folder, *flags, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "apdmvs_tpu_torch", folder, "--device", "cpu",
                           "--num-slices", "32", *flags], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def one_shard_scene(tmp_path_factory):
    """The 64x48x3 ring scene's state files from ``run_scene_batched`` on
    one shard (32 slices), and the scene."""
    cams, planes = synthetic.make_ring_scene(num_views=3, width=64, height=48)
    folder = str(tmp_path_factory.mktemp("one_shard"))
    synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
    from apdmvs_tpu_torch import scene

    scene.run_scene_batched(folder, device="cpu", num_slices=32, verbose=False)
    return cams, planes, _state(folder)


def _state(folder):
    out = {}
    for v in range(3):
        for name in STATE_FILES:
            with open(os.path.join(folder, "APD", formats.to_format_index(v), name), "rb") as f:
                out[(v, name)] = f.read()
    return out


@pytest.mark.parametrize("flags,mesh", [(["--space-shards", "2"], "1x2 mesh"),
                                        (["--view-shards", "2"], "2x1 mesh")],
                         ids=["space-shards", "view-shards"])
def test_cli_sharded_end_to_end(tmp_path, one_shard_scene, flags, mesh):
    """The state files equal the one-shard run's byte for byte; the cloud
    lies on the scene's planes."""
    cams, planes, want = one_shard_scene
    folder = str(tmp_path / "scene")
    synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
    proc = _cli(folder, "--batched", *flags)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f"views batched over {mesh}" in proc.stdout
    assert ("volume cache" in proc.stdout) == (mesh == "2x1 mesh")
    got = _state(folder)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    _cloud_ok(folder, planes, min_points=100)


@pytest.mark.parametrize("flags", [["--view-shards", "2"], ["--space-shards", "2"],
                                   ["--coordinator", "127.0.0.1:1"]],
                         ids=["view-shards", "space-shards", "coordinator"])
def test_cli_shard_flags_need_batched(tmp_path, flags):
    proc = _cli(str(tmp_path), *flags, timeout=120)
    assert proc.returncode == 2 and "need --batched" in proc.stderr


def test_maybe_initialize_without_a_coordinator(monkeypatch):
    for name in ("APD_COORDINATOR", "APD_NUM_PROCESSES", "APD_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.maybe_initialize(device="cpu") is False
    assert multihost.world_size() == 1 and multihost.rank() == 0
    with pytest.raises(ValueError, match="coordinator address"):
        multihost.maybe_initialize(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="process count"):
        multihost.maybe_initialize("127.0.0.1:1", device="cpu")
    with pytest.raises(ValueError, match="outside"):
        multihost.maybe_initialize("127.0.0.1:1", 2, 2, device="cpu")
    with pytest.raises(ValueError, match="nccl needs a CUDA device"):
        multihost.maybe_initialize("127.0.0.1:1", 2, 0, backend="nccl", device="cpu")
    # in one process every exchange is the identity
    t = torch.arange(3.0)
    assert multihost.all_gather_rows(t, [3]) is t and multihost.all_reduce_max(7) == 7
    assert multihost.any_positive(t) and not multihost.any_positive(None)


def _unguarded_launches(src: str):
    """Line numbers of ``lib.<fn>(...)`` calls not inside ``with
    _build.on_device(...)``."""
    tree = ast.parse(src)
    guarded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.With) and any(
                isinstance(it.context_expr, ast.Call)
                and ast.unparse(it.context_expr.func) == "_build.on_device"
                for it in node.items):
            guarded |= {id(n) for n in ast.walk(node)}
    return [node.lineno for node in ast.walk(tree)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name) and node.func.value.id == "lib"
            and id(node) not in guarded]


@pytest.mark.parametrize("module", ["volume", "ncc_volume", "cols"])
def test_every_launch_runs_under_the_device_guard(module):
    with open(os.path.join(ROOT, "apdmvs_tpu_torch", "ops", f"{module}.py")) as f:
        src = f.read()
    assert src.count("lib = _build.load(") >= 2
    assert _unguarded_launches(src) == []


def test_device_guard_check_flags_a_bare_launch():
    src = ("def f(x):\n    lib = _build.load('k', {})\n"
           "    with _build.on_device(x):\n        err = lib.k_launch(x)\n"
           "    err = lib.k_launch(x)\n")
    assert _unguarded_launches(src) == [5]
