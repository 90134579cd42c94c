"""The harness on the CPU at a test size (``tests/data``: 64x48, three
views, one round): a whole run prints its result line; and a run whose
timed path is broken underneath comes out not correct, once for each
fault such a cell can have. A cell of one card has no exchange between
cards to leave out."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from mvsbench import catalog, run

from conftest import DATA

KEYS = ("correct", "attempted", "failed", "metrics", "device")
CELL = catalog.benchmark()["workloads"][0]["name"]


def _run(bench, tmp_path, **kw):
    kw.setdefault("warmup", False)
    kw.setdefault("max_scenes", 1)
    trace = kw.pop("trace", False)
    return run.run_cell(bench, "tiny_scan", 20261017, 1e9, trace, device="cpu", base=DATA,
                        workdir=str(tmp_path), **kw)


def test_cpu_rehearsal_prints_the_result_line(tmp_path):
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from mvsbench import catalog, run\n"
            "b = catalog.benchmark()\n"
            "b['workloads'].append({'name': 'tiny_scan', 'traffic': 'tiny_scan', 'chips': 1})\n"
            "line, rec = run.run_cell(b, 'tiny_scan', 2**31 + 11, 1e9, False, device='cpu',\n"
            "                         base=%r, workdir=%r, max_scenes=1)\n"
            "sys.exit(run.emit(line, rec))\n") % (catalog.ROOT, DATA, str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=catalog.ROOT, timeout=900)
    assert out.returncode in (0, 1), out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == list(KEYS) and list(line)[-1] == "compared"
    assert line["attempted"] == 1
    assert set(line["metrics"]) == {"setup_s", "scene_s", "depth_good_pct"}
    assert line["device"]["platform"] == "cpu"
    assert all(set(c) == {"value", "limit"} for c in line["compared"].values())
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    assert line["correct"], line["compared"]


def test_cpu_trace_run_reads_the_layer_metrics(tiny_bench, tmp_path):
    line, record = _run(tiny_bench, tmp_path, trace=True)
    assert line["correct"], line["compared"]
    assert {"view_pass_ms_p90", "outside_passes_ms", "graph_captures"} <= set(line["metrics"])
    # no device on the CPU: the device's metrics are left out, not 0
    assert "device_idle_pct" not in line["metrics"]
    assert "h2_device_ms_per_view_pass" not in line["metrics"]
    assert record["trace"]["window_s"] > 0
    assert [n for n, _ in line["breakdown"]["idle_gaps"]][0].startswith("mvsbench.")


def test_sound_run_is_correct(tiny_bench, tmp_path):
    line, record = _run(tiny_bench, tmp_path)
    assert line["correct"], line["compared"]
    assert line["attempted"] == 1 and line["failed"] == 0


def test_state_returned_unchanged_is_not_correct(tiny_bench, tmp_path, monkeypatch):
    from apdmvs_tpu_torch import pipeline

    def unchanged(cams, src_valid, prior, *a, **kw):
        return pipeline.PassOutputs(prior.depth, prior.normal_world, prior.pixel_state,
                                    prior.selected, torch.zeros_like(prior.depth))

    monkeypatch.setattr(pipeline, "patchmatch_pass", unchanged)
    line, _ = _run(tiny_bench, tmp_path)
    assert not line["correct"] and line["failed"] == 1


def test_half_the_views_left_out_is_not_correct(tiny_bench, tmp_path, monkeypatch):
    from apdmvs_tpu_torch import scene

    listing = scene.generate_sample_list
    monkeypatch.setattr(scene, "generate_sample_list", lambda folder: listing(folder)[::2])
    line, _ = _run(tiny_bench, tmp_path)
    assert not line["correct"]
    assert line["compared"]["views_bad"]["value"] >= 1


def test_depth_altered_where_produced_is_not_correct(tiny_bench, tmp_path, monkeypatch):
    from apdmvs_tpu_torch import pipeline

    real = pipeline.patchmatch_pass

    def altered(*a, **kw):
        out = real(*a, **kw)
        return out._replace(depth=out.depth * 1.03)

    monkeypatch.setattr(pipeline, "patchmatch_pass", altered)
    line, _ = _run(tiny_bench, tmp_path)
    assert not line["correct"]
    assert line["compared"]["depth_err_p25"]["value"] > line["compared"]["depth_err_p25"]["limit"]


def test_one_view_altered_is_not_correct(tiny_bench, tmp_path, monkeypatch):
    from apdmvs_tpu_torch import scene

    real = scene._persist

    def altered(problem, spec, out, *a, **kw):
        if problem.ref_image_id == 1:
            out = out._replace(depth=out.depth * 1.03)
        return real(problem, spec, out, *a, **kw)

    monkeypatch.setattr(scene, "_persist", altered)
    line, _ = _run(tiny_bench, tmp_path)
    assert not line["correct"]
    c = line["compared"]["depth_err_p50_worst"]
    assert c["value"] > c["limit"]


def test_state_altered_where_produced_is_not_correct(tiny_bench, tmp_path, monkeypatch):
    from apdmvs_tpu_torch import pipeline

    real = pipeline.patchmatch_pass

    def all_weak(*a, **kw):
        out = real(*a, **kw)
        return out._replace(pixel_state=torch.zeros_like(out.pixel_state))  # WEAK

    monkeypatch.setattr(pipeline, "patchmatch_pass", all_weak)
    line, _ = _run(tiny_bench, tmp_path)
    assert not line["correct"]
    c = line["compared"]["weak_pct"]
    assert c["value"] > c["limit"]


def test_cloud_in_bfloat16_is_not_correct(tiny_bench, tmp_path):
    from mvsbench import controls

    spec = catalog.workload("tiny_scan", DATA)["check"]["controls"]["bf16_cloud"]
    line, _ = _run(tiny_bench, tmp_path, plant=lambda truth: controls.planted(spec, truth))
    assert not line["correct"]
    c = line["compared"]["cloud_unmatched_pct"]
    assert c["value"] > c["limit"]


def test_cloud_altered_where_produced_is_not_correct(tiny_bench, tmp_path, monkeypatch):
    from apdmvs_tpu_torch import fusion

    real = fusion.fuse_eth
    shift = 3 * catalog.workload("tiny_scan", DATA)["check"]["cloud_tol"]

    def altered(*a, **kw):
        coords, colors = real(*a, **kw)
        return np.asarray(coords) + np.float32(shift), colors

    monkeypatch.setattr(fusion, "fuse_eth", altered)
    line, _ = _run(tiny_bench, tmp_path)
    assert not line["correct"]
    c = line["compared"]["cloud_dist_p50"]
    assert c["value"] > c["limit"]


def test_a_scene_that_raises_is_a_failed_answer(tiny_bench, tmp_path, monkeypatch):
    from apdmvs_tpu_torch import scene

    def broken(*a, **kw):
        raise RuntimeError("planted")

    monkeypatch.setattr(scene, "run_fusion", broken)
    line, record = _run(tiny_bench, tmp_path)
    assert not line["correct"] and line["failed"] == 1
    assert line["compared"]["scene_raised"] == {"value": 1, "limit": 0}
    assert "planted" in record["errors"][0]


def test_without_the_program_the_run_gives_no_result(tmp_path):
    shutil.copy(os.path.join(catalog.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(catalog.HERE, tmp_path / "mvsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "sys.argv = ['mvsbench.run', '--workload', %r, '--seed', '1',\n"
            "            '--seconds', '1', '--trace', '0']\n"
            "runpy.run_module('mvsbench.run', run_name='__main__')\n") % CELL
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "apdmvs_tpu_torch" in out.stderr


def test_no_card_gives_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "mvsbench.run", "--workload", CELL,
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=catalog.ROOT, env=env, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
