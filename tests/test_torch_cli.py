"""The port's CLI end to end on the CPU, on the verify scene (3 views,
128x96): ``python -m apdmvs_tpu_torch <scene> --device cpu`` writes the
per-view state files and a fused cloud that lies on the scene's planes
(> 1000 points, median point-to-plane distance < 0.05). With
``--min-rounds 2`` the 96x72 scene with a textureless window of
tests/test_scene.py runs two rounds, the second with the APD weak
machinery: its cloud lies on the planes as closely, and holds > 800
points (fewer pixels than the verify scene: the reference package's own
two-round run fuses 864 points on it, its CPU run with volumes).
Without ``--device`` the entry points target the CUDA card and refuse to
run when there is none."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from apdmvs_tpu_torch import __main__ as cli, scene
from apdmvs_tpu_torch.datasets import synthetic
from apdmvs_tpu_torch.io import formats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def verify_scene(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("torch_cli") / "scene")
    cams, planes = synthetic.make_ring_scene(num_views=3, width=128, height=96)
    synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
    return folder, planes


def test_cli_cpu_end_to_end(verify_scene):
    folder, planes = verify_scene
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "apdmvs_tpu_torch", folder, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    for v in range(3):
        for name in ("depths.dmb", "normals.dmb", "weak.bin", "selected_views.bin"):
            assert os.path.exists(os.path.join(folder, "APD", formats.to_format_index(v), name))
        depth = formats.read_bin_mat(
            os.path.join(folder, "APD", formats.to_format_index(v), "depths.dmb"))
        assert depth.shape == (96, 128) and np.isfinite(depth).all()
    _cloud_ok(folder, planes)


def _cloud_ok(folder, planes, min_points=1000):
    coords, _ = formats.read_point_cloud(os.path.join(folder, "APD", "APD.ply"))
    dist = np.full(coords.shape[0], np.inf)
    for pl in planes:
        dist = np.minimum(dist, np.abs((coords.astype(np.float64) - pl.p0) @ pl.n))
    assert len(coords) > min_points, len(coords)
    assert np.median(dist) < 0.05, np.median(dist)


def test_cli_cpu_two_rounds_with_apd(tmp_path):
    folder = str(tmp_path / "flat_scene")
    cams, planes = synthetic.make_ring_scene(num_views=3, width=96, height=72,
                                             include_flat_region=True)
    synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "apdmvs_tpu_torch", folder, "--device", "cpu", "--min-rounds", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "Round num: 2" in proc.stdout
    # every pass of round 1 (passes 4-7, 3 views) ran the weak machinery
    weak_in = [int(ln.rsplit("weak in ", 1)[1]) for ln in proc.stdout.splitlines()
               if ln.startswith("round 1 pass")]
    assert len(weak_in) == 12 and min(weak_in) > 0, proc.stdout
    _cloud_ok(folder, planes, min_points=800)


def test_entry_points_default_to_cuda_and_refuse_without_a_card(verify_scene, monkeypatch):
    folder, _ = verify_scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        scene.run_scene(folder)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([folder])
