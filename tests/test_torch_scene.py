"""The scene contract of the JAX package's tests/test_scene.py:104-242 on the
port's sequential runner, on the CPU:

- a blocks/mask_<id>.jpg file is picked up by ``run_fusion`` (reference
  APD.cpp:848-852): an all-keep mask leaves the cloud byte-equal, a mask
  over half of view 0 drops its masked reference pixels' points, for the
  host ``eth`` and the device ``eth-device`` fusion alike;
- a pass after FIRST_INIT without its prior state files raises (the
  reference exits, APD.cpp:514-518), and ``allow_missing_prior``
  re-initialises instead;
- a two-round schedule (REFINE_INIT with the weak machinery, a scale
  boundary) killed after pass 4 and resumed from the state files with a
  cold cache writes the uninterrupted run's state files byte for byte (the
  file contract is the checkpoint system, SURVEY.md §5). Marked slow, as
  tests/test_scene.py:18 marks its module: it runs over a minute.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from apdmvs_tpu_torch import scene
from apdmvs_tpu_torch.datasets import synthetic
from apdmvs_tpu_torch.io import formats, images as imio
from apdmvs_tpu_torch.params import PixelState, build_schedule

torch.set_num_threads(2)

STATE_FILES = ("depths.dmb", "normals.dmb", "weak.bin", "selected_views.bin")


@pytest.fixture(scope="module")
def fused_scene(tmp_path_factory):
    """The 3-view 96x72 ring scene through one round (its per-view state
    files stay for the fusion runs)."""
    folder = str(tmp_path_factory.mktemp("torch_scene") / "scene")
    cams, planes = synthetic.make_ring_scene(num_views=3, width=96, height=72)
    synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
    scene.run_scene(folder, device="cpu", num_slices=64, verbose=False)
    return folder


@pytest.mark.parametrize("variant", ["eth", "eth-device"])
def test_blocks_mask_file_suppresses_ref_pixels(fused_scene, variant):
    folder = fused_scene
    problems = scene.generate_sample_list(folder)

    def fuse(name):
        ply = scene.run_fusion(folder, problems, variant, out_name=f"{variant}_{name}.ply",
                               device="cpu")
        return formats.read_point_cloud(ply)[0]

    base = fuse("nomask")
    blocks = os.path.join(folder, "blocks")
    os.makedirs(blocks, exist_ok=True)
    try:
        imio.save_image_u8(os.path.join(blocks, "mask_0.jpg"), np.full((72, 96), 255, np.uint8))
        np.testing.assert_array_equal(fuse("keep"), base)  # all-keep: the same cloud
        m = np.full((72, 96), 255, np.uint8)
        m[:, :48] = 0
        imio.save_image_u8(os.path.join(blocks, "mask_0.jpg"), m)
        half = fuse("half")
    finally:
        shutil.rmtree(blocks, ignore_errors=True)
    lost = base.shape[0] - half.shape[0]
    print(f"{variant}: {base.shape[0]} points, {lost} lost to the half mask of view 0")
    # view 0 owns ~1/3 of the reference pixels; its masked half emits none
    assert base.shape[0] > 500 and lost > 0.02 * base.shape[0]


def test_missing_prior_fails_loudly(tmp_path):
    folder = str(tmp_path / "scene")
    cams, planes = synthetic.make_ring_scene(num_views=3, width=96, height=80)
    synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
    problems = scene.generate_sample_list(folder)
    cache = scene.SceneCache(folder)
    spec = build_schedule(1)[1]  # the first REFINE_ITER pass
    with pytest.raises(FileNotFoundError, match="prior state missing"):
        scene.process_problem(cache, problems[0], spec, (96, 80), 0, "cpu", num_slices=32)
    stats = scene.process_problem(cache, problems[0], spec, (96, 80), 0, "cpu", num_slices=32,
                                  allow_missing_prior=True)
    assert stats.seconds > 0
    d = formats.read_bin_mat(os.path.join(problems[0].result_folder, "depths.dmb"))
    assert d.shape == (80, 96)


@pytest.mark.slow  # 66 s on the CPU with two threads (24 + 12 view-passes)
def test_multi_round_resume_bit_compatible(tmp_path):
    folder = str(tmp_path / "scene")
    cams, planes = synthetic.make_ring_scene(num_views=3, width=96, height=72,
                                             include_flat_region=True)
    synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
    problems = scene.generate_sample_list(folder)
    schedule = build_schedule(2)  # scale 1/2, then 1/1
    kill_at = 4
    assert schedule[kill_at].state.name == "REFINE_INIT" and schedule[kill_at].use_APD
    V_pad = max(1 + len(p.src_image_ids) for p in problems)

    def run_passes(cache, specs):
        for spec in specs:
            for problem in problems:
                scene.process_problem(cache, problem, spec, (96, 72), 0, "cpu",
                                      num_views_pad=V_pad, num_slices=32)

    def state_files():
        out = {}
        for p in problems:
            for name in STATE_FILES:
                with open(os.path.join(p.result_folder, name), "rb") as f:
                    out[(p.ref_image_id, name)] = f.read()
        return out

    cache = scene.SceneCache(folder)
    run_passes(cache, schedule[:kill_at])
    snap = str(tmp_path / "snap")
    shutil.copytree(os.path.join(folder, "APD"), snap)
    run_passes(cache, schedule[kill_at:])
    final = state_files()
    # the "killed" run: the snapshot restored, resumed with a cold cache
    shutil.rmtree(os.path.join(folder, "APD"))
    shutil.copytree(snap, os.path.join(folder, "APD"))
    run_passes(scene.SceneCache(folder), schedule[kill_at:])
    resumed = state_files()
    assert sorted(resumed) == sorted(final)
    for key in final:
        assert resumed[key] == final[key], key
    # the weak machinery ran: the final round's outputs hold WEAK or UNKNOWN pixels
    weak = [formats.read_bin_mat(os.path.join(p.result_folder, "weak.bin")) for p in problems]
    assert any(((w == PixelState.WEAK) | (w == PixelState.UNKNOWN)).any() for w in weak)
