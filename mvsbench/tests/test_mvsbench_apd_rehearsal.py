"""The harness on the CPU at a test size of an APD cell (``tests/data``:
``tiny_apd``, 64x48, three views, two rounds, the second with the APD weak
machinery over a flat card): a traced run through ``run.run_cell`` is
correct, every APD pass of its scene ran one weak capacity, and it reads
``weak_in_pct`` and the readers of the weak worklist, the weak device time
and the graph pool; the program's depth and normal maps in bfloat16 where
the pass returns them come out not correct; and those readers give None on
a card's record of a scene without an APD pass and, for the graph pool,
without its counter."""

import pytest

from mvsbench import catalog, controls, run

from conftest import DATA

APD_METRICS = ("weak_in_pct", "weak_device_ms_per_apd_pass", "weak_worklist_fill_pct",
               "graph_pool_gb")
CELL = "tiny_apd_scan"
SEED = 2 ** 31 + 19


@pytest.fixture
def apd_bench():
    """BENCHMARK.json with the test size's APD cell beside the real ones,
    and the APD metrics reported in it."""
    bench = catalog.benchmark()
    bench["workloads"] = bench["workloads"] + [
        {"name": CELL, "config": "tiny_apd", "traffic": CELL, "chips": 1, "why": "test size"}]
    bench["per_layer"] = [dict(m, workloads=m["workloads"] + [CELL]) if m["name"] in APD_METRICS
                          else m for m in bench["per_layer"]]
    return bench


def _run(bench, tmp_path, **kw):
    trace = kw.pop("trace", False)
    return run.run_cell(bench, CELL, SEED, 1e9, trace, device="cpu", base=DATA,
                        workdir=str(tmp_path), warmup=False, max_scenes=1, **kw)


def test_apd_run_is_correct_and_reads_the_apd_metrics(apd_bench, tmp_path):
    from apdmvs_tpu_torch import scene, telemetry

    line, record = _run(apd_bench, tmp_path, trace=True)
    assert line["correct"], line["compared"]
    got = {name: m["value"] for name, m in line["metrics"].items()}
    assert set(APD_METRICS) <= set(got), got
    assert 0 < got["weak_in_pct"] < 100 and 0 < got["weak_worklist_fill_pct"] <= 100
    assert got["weak_device_ms_per_apd_pass"] > 0  # the host's clock on the CPU
    assert got["graph_pool_gb"] == 0.0  # the CPU captures no graph
    # one capacity a pass: the bucket of the largest WEAK count of its views
    cfg = catalog.config("tiny_apd", DATA)
    by_pass = {}
    for p in record["scenes"][0]["passes"]:
        if p["use_apd"]:
            by_pass.setdefault(p["pass"], []).append(p["weak_in"])
    assert sorted(by_pass) == [4, 5, 6, 7]
    snap = [s for s in telemetry.recent_scenes if s.get("profiled")][-1]
    total = cfg["width"] * cfg["height"]
    assert snap["counters"]["weak.capacity"] == sum(
        len(n) * scene._bucket_capacity(max(n), total) for n in by_pass.values())
    assert snap["counters"]["apd_view_passes"] == 4 * cfg["num_views"]


def test_apd_maps_in_bfloat16_are_not_correct(apd_bench, tmp_path):
    spec = catalog.workload(CELL, DATA)["check"]["controls"]["bf16_maps"]
    line, _ = _run(apd_bench, tmp_path, plant=lambda truth: controls.planted(spec, truth))
    assert not line["correct"]
    assert any(c["value"] is None or c["value"] > c["limit"] for c in line["compared"].values())


def test_apd_readers_give_none_without_an_apd_pass(monkeypatch):
    """A traced one-round scene on a card: its view-passes ran no weak
    machinery, and the program's snapshot holds no weak counter and no
    weak stage, so the weak readers give None. The graph pool's reader
    reads ``compiled.pool_bytes`` whether or not an APD pass ran, and gives
    None on a card where the snapshot lacks it (a program that does not
    count it)."""
    telemetry = pytest.importorskip("apdmvs_tpu_torch.telemetry")
    monkeypatch.setattr(telemetry, "recent_scenes", type(telemetry.recent_scenes)(maxlen=4))
    telemetry.recent_scenes.append({
        "spans": {}, "counters": {"view_passes": 12, "geom_view_passes": 9},
        "stage_ms": {"init": 10.0, "strong_black": 40.0}, "stage_passes": 12,
        "view_passes": 12, "geom_view_passes": 9, "profiled": True,
        "device": "NVIDIA H100 80GB HBM3"})
    passes = [{"round": 0, "pass": i, "state": "REFINE_ITER", "use_apd": False, "scale": 1,
               "view": v, "seconds": 0.1, "weak_in": 0} for i in range(4) for v in range(3)]
    record = {"setup_s": 1.0, "scenes": [{"wall_s": 2.0, "passes": passes, "traced": True,
                                          "captures": 0}],
              "judged": [], "peak_bytes": None, "config": catalog.config("tiny_apd", DATA),
              "trace": {"by_name": {}, "view_passes": 12, "busy_s": 0.0, "window_s": 2.0,
                        "device_events": 0}}
    for name in APD_METRICS:
        assert catalog.metric_reader(name).read(record) is None, name
    telemetry.recent_scenes[-1]["counters"]["compiled.pool_bytes"] = 3 * 10 ** 9
    assert catalog.metric_reader("graph_pool_gb").read(record) == 3.0
