"""The scene contract of the JAX package's tests/test_scene.py:104-242 on the
port's sequential runner, on the CPU:

- a blocks/mask_<id>.jpg file is picked up by ``run_fusion`` (reference
  APD.cpp:848-852): an all-keep mask leaves the cloud byte-equal, a mask
  over half of view 0 drops its masked reference pixels' points, for the
  host ``eth`` and the device ``eth-device`` fusion alike;
- a pass after FIRST_INIT without its prior state files raises (the
  reference exits, APD.cpp:514-518), and ``allow_missing_prior``
  re-initialises instead;
- the scene's telemetry (``SceneRun.telemetry``) counts its view-passes,
  the program's spans, the volume cache's hits and pinned builds and each
  stage's time, on the one-round run the fusion tests read;
- every view of an APD pass runs one weak worklist capacity, the bucket
  of the largest WEAK count among the pass's views, where each view's own
  count would give two buckets: one weak key a pass, the weak counters,
  and state files bit-equal to the batched runner's, which sizes the
  capacity by the same rule;
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

from apdmvs_tpu_torch import compiled, ncc, pipeline, scene, telemetry
from apdmvs_tpu_torch.datasets import synthetic
from apdmvs_tpu_torch.io import formats, images as imio
from apdmvs_tpu_torch.params import PixelState, build_schedule

torch.set_num_threads(2)

STATE_FILES = ("depths.dmb", "normals.dmb", "weak.bin", "selected_views.bin")


@pytest.fixture(scope="module")
def fused_run(tmp_path_factory):
    """The 3-view 96x72 ring scene through one round (its per-view state
    files stay for the fusion runs): the folder and the ``SceneRun``."""
    folder = str(tmp_path_factory.mktemp("torch_scene") / "scene")
    cams, planes = synthetic.make_ring_scene(num_views=3, width=96, height=72)
    synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
    return folder, scene.run_scene(folder, device="cpu", num_slices=64, verbose=False)


@pytest.fixture(scope="module")
def fused_scene(fused_run):
    return fused_run[0]


def test_scene_run_carries_its_telemetry(fused_run):
    """One round of 3 views: a FIRST_INIT pass, then 3 geometric
    REFINE_ITER passes, each view's set built and pinned once (the CPU's
    budget is the host's memory) and hit on every later pass."""
    folder, run = fused_run
    tel = run.telemetry
    assert any(s is tel for s in telemetry.recent_scenes)
    assert tel["view_passes"] == len(run.passes) == 12 and tel["geom_view_passes"] == 9
    spans = {k: v["count"] for k, v in tel["spans"].items()}
    assert spans == {"scene.inputs": 12, "scene.prior": 9, "scene.src_depths": 9,
                     "cache.volume_set": 12, "depth_volumes": 9, "depth_volumes.consts": 9,
                     "depth_volumes.build": 9, "state.copy": 12, "state.write": 12,
                     "fusion.load": 1, "fusion.core": 1, "fusion.write": 1}
    set_bytes = ncc.image_volume_set_nbytes(3, 72, 96, 64, weak_cost_volumes=False)
    counters = dict(tel["counters"])
    # the ETH fusion's threads (this process's CPU affinity, at most one a
    # block of 4 rows) and candidates
    assert counters.pop("fusion.threads") == min(len(os.sched_getaffinity(0)), 72 // 4)
    assert counters.pop("fusion.candidates") >= counters.pop("fusion.candidates_consumed", 0)
    assert counters == {"view_passes": 12, "geom_view_passes": 9, "cache.hits": 9,
                        "cache.builds": 3, "cache.pinned_builds": 3,
                        "cache.pinned_bytes": 3 * set_bytes}
    # every pass's stages timed on the host clock (the CPU runs the body)
    assert tel["stage_passes"] == 12 and all(ms > 0 for ms in tel["stage_ms"].values())
    assert set(tel["stage_ms"]) == {"init", "recost", "strong_black", "strong_red", "readout",
                                    "median_filter", "depth_to_weak", "local_refine"}
    # the CPU launches no kernel, captures and replays no graph
    assert (tel["launches"], tel["work"], tel["captures"], tel["replays"]) == ({}, {}, 0, 0)
    assert tel["device"] == "cpu" and tel["device_allocs"] is None and not tel["profiled"]


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


def _init_then_apd(monkeypatch):
    """The two-round schedule cut to its FIRST_INIT pass at half size and
    the REFINE_INIT pass with APD at full size (passes 0 and 4): neither
    is geometric, so the sequential (Gauss-Seidel) and the batched
    (Jacobi) runner read the same priors, and their state files can be
    held equal."""
    full = build_schedule
    monkeypatch.setattr(scene, "build_schedule", lambda rounds: [full(rounds)[i] for i in (0, 4)])


def test_apd_pass_runs_one_weak_capacity(tmp_path, monkeypatch):
    """The 3-view 160x120 ring scene with its textureless window, two rounds:
    the views' WEAK counts entering pass 4 fall into two
    ``_bucket_capacity`` buckets, so sizing each view alone (the rule
    before one capacity a pass) would capture two weak keys in that pass.
    ``run_scene`` gives every view of the pass the bucket of the largest
    count, which is one compiled key, and counts it; its state files equal
    ``run_scene_batched``'s bit for bit, whose capacity is the batch's
    largest count's bucket (``test_torch_batched.py`` holds the batched
    runner to the reference package's)."""
    _init_then_apd(monkeypatch)
    folders = {}
    for name in ("seq", "bat"):
        folders[name] = str(tmp_path / name)
        cams, planes = synthetic.make_ring_scene(num_views=3, width=160, height=120,
                                                 include_flat_region=True)
        synthetic.write_mvsnet_dataset(folders[name], cams, planes, depth_ranges=(2.0, 8.0))
    calls = []
    real = pipeline.patchmatch_pass

    def spy(cams, src_valid, prior, draws, cfg, volumes=None, weak_capacity=0, **kw):
        if cfg.use_APD:
            calls.append((int(torch.sum(prior.pixel_state == PixelState.WEAK)), weak_capacity,
                          compiled.static_key(cams, prior, cfg, volumes, weak_capacity, False),
                          cams, prior, cfg, volumes))
        return real(cams, src_valid, prior, draws, cfg, volumes, weak_capacity=weak_capacity,
                    **kw)

    monkeypatch.setattr(pipeline, "patchmatch_pass", spy)
    run = scene.run_scene(folders["seq"], device="cpu", min_rounds=2, num_slices=32,
                          verbose=False)
    seq_calls, calls[:] = list(calls), []
    counts = [c[0] for c in seq_calls]
    assert len(seq_calls) == 3 and [st.weak_in for _, _, st in run.passes[3:]] == counts
    own = {scene._bucket_capacity(n, 160 * 120) for n in counts}
    assert len(own) == 2, counts  # each view alone: two buckets, two weak keys
    cap = scene._bucket_capacity(max(counts), 160 * 120)
    assert [c[1] for c in seq_calls] == [cap] * 3
    assert len({c[2] for c in seq_calls}) == 1
    assert len({compiled.static_key(c[3], c[4], c[5], c[6], scene._bucket_capacity(c[0], 160 * 120),
                                    False) for c in seq_calls}) == 2
    counters = run.telemetry["counters"]
    assert (counters["apd_view_passes"], counters["weak.in"], counters["weak.capacity"]) == (
        3, sum(counts), 3 * cap)
    assert run.telemetry["spans"]["scene.weak_capacity"]["count"] == 1
    assert counters.get("compiled.pool_bytes", 0) == 0  # the CPU captures nothing

    bat = scene.run_scene_batched(folders["bat"], device="cpu", min_rounds=2, num_slices=32,
                                  verbose=False)
    assert [c[1] for c in calls] == [cap] * 3 and [c[0] for c in calls] == counts
    assert (bat.telemetry["counters"]["weak.in"], bat.telemetry["counters"]["weak.capacity"]) == (
        sum(counts), 3 * cap)
    for p in scene.generate_sample_list(folders["seq"]):
        rel = os.path.relpath(p.result_folder, folders["seq"])
        for name in STATE_FILES:
            with open(os.path.join(p.result_folder, name), "rb") as f:
                a = f.read()
            with open(os.path.join(folders["bat"], rel, name), "rb") as f:
                assert f.read() == a, (rel, name)


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
