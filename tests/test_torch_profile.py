"""The port's profiling tools on the CPU: ``timeline``'s gap ledger on a
hand-written Chrome trace (exact busy time, idle share, per-stage split and
gap attribution), ``scene.run_scene(profile_dir=)`` writing a trace with
every ``apd.*`` stage span that ``timeline`` reads, and
``python -m apdmvs_tpu_torch.profile_stages --device cpu`` printing one
JSON line with every stage of the flagship pass."""

import json
import os

import pytest
import torch

from apdmvs_tpu_torch import params, pipeline, profile_stages, scene, timeline
from apdmvs_tpu_torch.datasets import synthetic

torch.set_num_threads(2)


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 7, "tid": tid,
            "args": args}


#: two stage spans on thread 1 ([0, 100] and [100, 160]); three kernels and
#: a copy, the copy launched outside every span and overlapping the third
#: kernel; times in microseconds, as torch.profiler writes them
TRACE = [
    _x("apd.recost", "user_annotation", 0, 100),
    _x("apd.strong_black", "user_annotation", 100, 60),
    _x("apd.recost", "gpu_user_annotation", 20, 60, tid=0),  # the device's copy of a span
    _x("aten::foo", "cpu_op", 40, 30),
    _x("aten::outer", "cpu_op", 75, 105),
    _x("aten::inner", "cpu_op", 78, 12),
    _x("cudaLaunchKernel", "cuda_runtime", 10, 2, correlation=1),
    _x("cuLaunchKernel", "cuda_driver", 50, 2, correlation=2),
    _x("cudaLaunchKernel", "cuda_runtime", 135, 2, correlation=3),
    _x("cudaMemcpyAsync", "cuda_runtime", 165, 2, correlation=4),
    _x("k1", "kernel", 20, 30, tid=0, correlation=1),
    _x("k2", "kernel", 60, 20, tid=0, correlation=2),
    _x("k3", "kernel", 150, 40, tid=0, correlation=3),
    _x("Memcpy DtoH", "gpu_memcpy", 170, 30, tid=0, correlation=4),
    {"ph": "s", "name": "ac2g", "cat": "ac2g", "id": 1, "ts": 10, "pid": 7, "tid": 1},
]


@pytest.fixture
def trace_file(tmp_path):
    path = str(tmp_path / "trace.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": TRACE}, f)
    return path


def test_timeline_ledger_of_a_known_trace(trace_file, capsys):
    timeline.main([trace_file, "--gaps-ms", "0.005", "--top", "5"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    led = json.loads(out[0])
    # window 20..200 us; busy [20, 50] + [60, 80] + [150, 200]
    assert led["device_events"] == 4 and led["unmatched"] == 0
    assert led["window_ms"] == pytest.approx(0.18)
    assert led["busy_ms"] == pytest.approx(0.1)
    assert led["idle_share"] == pytest.approx(1 - 100 / 180)
    st = led["stages"]
    assert set(st) == {"apd.recost", "apd.strong_black", "-"}
    assert st["apd.recost"] == pytest.approx({"busy_ms": 0.05, "idle_ms": 0.01, "events": 2})
    assert st["apd.strong_black"] == pytest.approx({"busy_ms": 0.04, "idle_ms": 0.07,
                                                    "events": 1})
    assert st["-"] == pytest.approx({"busy_ms": 0.01, "idle_ms": 0.0, "events": 1})
    assert sum(s["busy_ms"] for s in st.values()) == pytest.approx(led["busy_ms"])
    assert sum(s["idle_ms"] for s in st.values()) == pytest.approx(
        led["window_ms"] - led["busy_ms"])
    gaps = led["gaps"]
    assert gaps["count"] == 2 and gaps["sum_ms"] == pytest.approx(0.08)
    (g1, g2) = gaps["top"]
    # the longest: 80..150, ended by k3 (launched in strong_black); the host
    # was in aten::inner (nested in aten::outer) at 80
    assert g1 == pytest.approx({"ms": 0.07, "at_ms": 0.06, "stage": "apd.strong_black",
                                "host_op": "aten::inner", "next": "k3"})
    # 50..60, ended by k2 (launched by cuLaunchKernel in recost); host in aten::foo
    assert g2 == pytest.approx({"ms": 0.01, "at_ms": 0.03, "stage": "apd.recost",
                                "host_op": "aten::foo", "next": "k2"})
    assert [k["name"] for k in led["kernels"]] == ["k3", "k1", "Memcpy DtoH", "k2"]
    assert led["kernels"][0] == {"name": "k3", "ms": pytest.approx(0.04), "launches": 1}
    assert led["spans"] == {"apd.recost": {"count": 1, "host_ms": pytest.approx(0.1)},
                            "apd.strong_black": {"count": 1, "host_ms": pytest.approx(0.06)}}
    # the threshold: only the 70 us gap is at least 0.05 ms
    assert timeline.read(trace_file)["gaps"]["count"] == 1


def test_run_scene_profile_dir_writes_a_trace_timeline_reads(tmp_path, capsys, monkeypatch):
    """Two views and a schedule cut to round 0's FIRST_INIT pass and round
    1's REFINE_INIT pass with the weak machinery: every stage runs, and the
    trace stays small (on the CPU the kernels' plain versions make some
    300000 operator events a pass)."""
    schedule = params.build_schedule(2)
    monkeypatch.setattr(scene, "build_schedule", lambda rounds: [schedule[0], schedule[4]])
    folder = str(tmp_path / "scene")
    cams, planes = synthetic.make_ring_scene(num_views=2, width=64, height=48,
                                             include_flat_region=True)
    synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
    prof = str(tmp_path / "prof")
    run = scene.run_scene(folder, device="cpu", min_rounds=2, num_slices=32,
                          profile_dir=prof)
    trace = os.path.join(prof, "trace.json")
    assert f"Profiler trace: {trace}" in capsys.readouterr().out
    assert [spec.state.name for spec, _, _ in run.passes] == ["FIRST_INIT"] * 2 + [
        "REFINE_INIT"] * 2
    assert all(st.weak_in for _, _, st in run.passes[2:])  # round 1 ran the weak stages
    led = timeline.read(trace)
    assert set(led["spans"]) == {"apd." + s for s in pipeline.STAGES}
    assert led["spans"]["apd.init"]["count"] == 2 and led["spans"]["apd.recost"]["count"] == 2
    assert led["spans"]["apd.weak_sweep"]["count"] == 2 * 3  # once an iteration
    # a CPU run has no device events: nothing measured on a device
    assert led["device_events"] == 0 and led["busy_ms"] is None and led["idle_share"] is None


def test_profile_stages_prints_every_stage(capsys):
    profile_stages.main(["--device", "cpu", "--width", "64", "--height", "48", "--views", "3"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    row = json.loads(out[0])
    # the flagship pass is a REFINE_ITER pass with the weak machinery: every
    # stage but FIRST_INIT's
    assert list(row["stages_ms"]) == [s for s in pipeline.STAGES if s != "init"]
    assert all(ms > 0 for ms in row["stages_ms"].values()) and row["pass_ms"] > 0
    assert row["device"].startswith("cpu") and row["repeats"] == profile_stages.REPEATS
    assert (row["width"], row["height"], row["views"], row["volumes"]) == (64, 48, 3, True)
