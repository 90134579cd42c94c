"""The port's telemetry (``apdmvs_tpu_torch/telemetry.py``) on the CPU:
span nesting and totals, scene snapshots and their differences, the
bounded ``recent_scenes``, the ``profiled`` flag under a running
``torch.profiler``, the volume cache's counters across passes and a change
of scale, the kernel wrappers' work counters by call shape and the stage
clock on the host, and the weak worklist's counters and the graph pool
of a scene with an APD pass. On a card (the ``chip`` marker; they skip here): a
replay whose graph holds the stage events stays bit-equal to the body,
and its stage times sum to at most its wall.

This file imports no JAX, so its card tests run on a machine without it:

    python3 -m pytest --noconftest -q tests/test_torch_telemetry.py -m chip
"""

import time

import pytest
import torch

from apdmvs_tpu_torch import compiled, ops, scene, telemetry
from apdmvs_tpu_torch.ops import cols, ncc_volume, volume

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: run with -m chip on a machine that has one")
    return torch.device("cuda")


def _scene(body, device="cpu", profiled=False):
    start = telemetry.scene_start(device)
    body()
    return telemetry.scene_end(start, profiled=profiled)


def test_spans_nest_and_add_their_totals():
    def body():
        for _ in range(2):
            with telemetry.span("t.outer"):
                time.sleep(0.002)
                with telemetry.span("t.inner"):
                    time.sleep(0.003)
        with telemetry.span("t.inner"):
            pass
        telemetry.count("t.things", 3)
        telemetry.count("t.things")

    snap = _scene(body)
    outer, inner = snap["spans"]["t.outer"], snap["spans"]["t.inner"]
    assert outer["count"] == 2 and inner["count"] == 3
    # an outer span's time holds its inner spans'
    assert outer["ms"] >= 2 * (2 + 3) and inner["ms"] >= 2 * 3
    assert outer["ms"] > inner["ms"] - 1.0
    assert snap["counters"] == {"t.things": 4}
    assert snap["profiled"] is False and snap["device"] == "cpu"
    assert snap["device_allocs"] is None and snap["device_frees"] is None


def test_snapshots_hold_only_what_changed_and_recent_scenes_is_bounded():
    telemetry.count("t.before", 5)
    with telemetry.span("t.before"):
        pass
    snaps = [_scene(lambda: telemetry.count("t.each")) for _ in range(telemetry.RECENT + 3)]
    assert all(s["counters"] == {"t.each": 1} and s["spans"] == {} for s in snaps)
    assert len(telemetry.recent_scenes) == telemetry.RECENT
    assert telemetry.recent_scenes[-1] is snaps[-1]
    assert telemetry.recent_scenes[0] is snaps[3]
    empty = _scene(lambda: None)
    assert (empty["counters"], empty["launches"], empty["work"], empty["stage_ms"]) == (
        {}, {}, {}, {})
    assert empty["view_passes"] == empty["geom_view_passes"] == empty["stage_passes"] == 0


def test_profiled_flag_follows_a_running_profiler():
    assert not telemetry.profiling()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert telemetry.profiling()
        inside = _scene(lambda: telemetry.count("t.p"))
    assert inside["profiled"] is True
    assert _scene(lambda: None)["profiled"] is False
    assert _scene(lambda: None, profiled=True)["profiled"] is True  # the caller profiled it


def test_scene_cache_counts_hits_builds_and_pins_per_scale():
    folder = "unused"
    cache = scene.SceneCache(folder, volume_cache_bytes=1000, expected_sets=2)

    def builder(n):  # a set of 2n bytes
        return lambda out: (torch.zeros(n, dtype=torch.uint8), torch.zeros(n // 4))

    def pass_over(width, n):
        for view in (0, 1):
            cache.image_volumes(view, width, builder(n), 2 * n)

    snap = _scene(lambda: (pass_over(96, 100), pass_over(96, 100)))
    assert cache.volume_stats == {"hits": 2, "builds": 2, "pinned_builds": 2,
                                  "pinned_bytes": 400}
    assert snap["counters"] == {"cache.hits": 2, "cache.builds": 2, "cache.pinned_builds": 2,
                                "cache.pinned_bytes": 400}
    assert snap["spans"]["cache.volume_set"]["count"] == 4
    # a new scale clears the sets and the counts; sets too large to pin for
    # both problems are built at every pass
    snap = _scene(lambda: (pass_over(48, 400), pass_over(48, 400)))
    assert cache.volume_stats == {"hits": 0, "builds": 4, "pinned_builds": 0, "pinned_bytes": 0}
    assert snap["counters"] == {"cache.builds": 4}


def test_apd_scene_counts_its_weak_worklist_and_no_pool_on_the_cpu(tmp_path, monkeypatch):
    """A 2-view 64x48 ring scene with its textureless window, two rounds cut
    to the FIRST_INIT pass and the APD pass (passes 0 and 4): ``weak.in``
    (WEAK pixels entering the worklist) is at most ``weak.capacity`` (its
    slots), ``apd_view_passes`` counts the view-passes that ran the weak
    machinery, and the graph pool holds nothing on the CPU, which captures
    no graph."""
    from apdmvs_tpu_torch.datasets import synthetic
    from apdmvs_tpu_torch.params import build_schedule

    full = build_schedule
    monkeypatch.setattr(scene, "build_schedule", lambda rounds: [full(rounds)[i] for i in (0, 4)])
    folder = str(tmp_path / "scene")
    cams, planes = synthetic.make_ring_scene(num_views=2, width=64, height=48,
                                             include_flat_region=True)
    synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
    run = scene.run_scene(folder, device="cpu", min_rounds=2, num_slices=32, verbose=False)
    counters = run.telemetry["counters"]
    apd = [stats for spec, _, stats in run.passes if spec.use_APD]
    assert len(apd) == 2 and counters["apd_view_passes"] == len(apd)
    assert counters["weak.in"] == sum(stats.weak_in for stats in apd)
    assert 0 < counters["weak.in"] <= counters["weak.capacity"]
    assert counters.get("compiled.pool_bytes", 0) == 0 and compiled.pool_bytes("cpu") == 0


def test_work_shapes_of_each_wrapper():
    E = torch.empty(10, 160, 592, 1024, dtype=torch.bfloat16, device="meta")
    planes = torch.empty(3, 4, 576, 768, device="meta")
    assert ncc_volume.ncc_work_shape(E, planes, 5, 2) == dict(
        views=10, fields=3, height=576, width=768, slices=160, samples=36, dtype="float32")
    assert ncc_volume.ncc_work_shape(E[:1], planes, 3, 1)["samples"] == 49
    D = torch.empty(4, 160, 576, 768, device="meta")
    assert ncc_volume.geom_work_shape(D, planes) == dict(
        views=4, fields=3, height=576, width=768, slices=160, dtype="float32")
    out = torch.empty(160, 576, 768, device="meta")
    assert volume.build_work_shape(out) == dict(views=1, slices=160, height=576, width=768,
                                                dtype="float32")
    assert volume.build_work_shape(out.to(torch.bfloat16))["dtype"] == "bfloat16"
    xs = torch.empty(24576, dtype=torch.int32, device="meta")
    assert cols.gather_work_shape(E, xs) == dict(views=10, slices=160, columns=24576,
                                                 dtype="bfloat16")
    ct = torch.empty(4, 160, 24576, device="meta")
    k = torch.empty(5, 24576, device="meta")
    assert cols.contract_work_shape(ct, k, True) == dict(
        views=4, slices=160, columns=24576, candidates=5, nearest=True, dtype="float32")


def test_work_counters_add_take_back_and_replay():
    """The arithmetic ``compiled`` does around a capture: counts taken
    back after it, the key's counts added at each replay."""
    counters = ops.launch_counters()
    with_work = {n for n, fn in counters.items() if hasattr(fn, "work")}
    assert with_work == {"build_volume", "ncc_cost", "ncc_cost_views", "geom_cost",
                         "geom_cost_views", "gather_cols", "contract_lookup",
                         "build_cost_volumes"}
    saved = telemetry.kernel_counts()
    try:
        fn = counters["ncc_cost_views"]
        a = dict(views=10, fields=1, height=576, width=768, slices=160, samples=36,
                 dtype="float32")
        b = dict(a, fields=3)
        before = telemetry.kernel_counts()
        for shape in (a, a, b):
            telemetry.count_launch(fn, **shape)
        telemetry.count_launch(counters["build_volume"], views=1, slices=160, height=576,
                               width=768, dtype="float32")
        delta = telemetry.kernel_delta(telemetry.kernel_counts(), before)
        assert delta["ncc_cost_views"] == {"launches": 3, "work": {tuple(a.items()): 2,
                                                                   tuple(b.items()): 1}}
        assert delta["build_volume"]["launches"] == 1 and delta["ncc_cost"]["launches"] == 0
        telemetry.set_kernel_counts(before)  # a capture launches nothing
        assert telemetry.kernel_delta(telemetry.kernel_counts(), before)[
            "ncc_cost_views"] == {"launches": 0, "work": {}}
        start = telemetry.scene_start("cpu")
        for _ in range(2):  # two replays of the key
            telemetry.add_kernel_counts(delta)
        snap = telemetry.scene_end(start)
        assert snap["launches"] == {"ncc_cost_views": 6, "build_volume": 2}
        assert sorted(snap["work"]["ncc_cost_views"], key=lambda w: w["fields"]) == [
            dict(a, launches=4), dict(b, launches=2)]
        assert snap["work"]["build_volume"] == [dict(views=1, slices=160, height=576,
                                                     width=768, dtype="float32", launches=2)]
    finally:
        telemetry.set_kernel_counts(saved)


def test_stage_clock_on_the_host_reads_each_stage_once():
    with telemetry.stage("recost"):  # no clock active: a profiler span only
        pass
    start = telemetry.scene_start("cpu")
    with telemetry.stage_clock("cpu") as clock:
        for stage in ("recost", "strong_black", "strong_black"):
            with telemetry.stage(stage):
                time.sleep(0.001)
    assert [m[0] for m in clock.marks] == ["recost", "strong_black", "strong_black"]
    assert clock.ready()
    telemetry.queue_stages(clock)  # complete: read at once
    telemetry.read_stages()
    snap = telemetry.scene_end(start)
    assert snap["stage_passes"] == 1 and set(snap["stage_ms"]) == {"recost", "strong_black"}
    assert snap["stage_ms"]["strong_black"] >= 2.0 and snap["stage_ms"]["recost"] >= 1.0


@pytest.mark.chip
def test_replay_with_stage_events_is_bit_equal_and_inside_its_wall(card):
    """The flagship pass at 320x240 through the compiled pass: its capture
    (the body under a stage clock, the replay held bit for bit against the
    warm-up by ``compiled``), then replays against the body on the same
    draws, every output bit-equal, and each replay's stage times, read
    after a synchronise, summing to at most its wall."""
    from apdmvs_tpu_torch import bench, compiled

    images, depths, normals, cams = bench.flagship_scene(320, 240, 5, card)
    vs, prior, cap, _ = bench.flagship_state(images, depths, normals, cams)
    bench.flagship_pass(cams, vs, prior, cap, 0)  # the capture
    entry = next(iter(compiled.entries(cams.device).values()))
    assert {m[0] for m in entry.stages.marks} >= {"recost", "strong_black", "local_refine"}
    try:
        for seed in (1, 2):
            torch.cuda.synchronize(card)
            _, passes0 = telemetry.stage_totals()
            before, _ = telemetry.stage_totals()
            t0 = time.perf_counter()
            out = bench.flagship_pass(cams, vs, prior, cap, seed)
            torch.cuda.synchronize(card)
            wall_ms = 1e3 * (time.perf_counter() - t0)
            telemetry.read_stages()
            after, passes1 = telemetry.stage_totals()
            stage_ms = sum(after.values()) - sum(before.values())
            ref = bench.flagship_pass(cams, vs, prior, cap, seed, eager=True)
            assert all(compiled._same_bits(a, b) for a, b in zip(out, ref))
            assert passes1 == passes0 + 1 and 0 < stage_ms <= wall_ms
    finally:
        compiled.drop(cams.device)
