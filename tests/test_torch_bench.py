"""The port's benchmark (``python -m apdmvs_tpu_torch.bench``) on the CPU at
64x48, one repeat, one batched problem: one JSON line with the benchmark's
keys (the batched row's included), the flagship
pass's setup as bench.py sets it up (weak box, worklist capacity, sample
count), and no run on a machine without a card unless the CPU is asked
for."""

import json

import numpy as np
import pytest
import torch

import bench as jax_bench
from apdmvs_tpu.scene import _bucket_capacity as jax_bucket_capacity
from apdmvs_tpu_torch import bench, trace_pass
from apdmvs_tpu_torch.params import PixelState

KEYS = {"metric", "value", "unit", "min", "spread_pct", "pass_ms", "image_build_ms",
        "depth_build_ms", "device", "batched_maps_per_sec", "batched_problems",
        "batched_pinned", "batched_ms", "batched_prebuild_ms"}


def test_bench_prints_one_json_line(capsys):
    torch.set_num_threads(2)
    bench.main(["--device", "cpu", "--width", "64", "--height", "48", "--repeats", "1",
                "--batched-problems", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    row = json.loads(out[0])
    assert set(row) == KEYS
    assert row["metric"] == "depth_maps_per_sec" and row["device"].startswith("cpu")
    assert row["value"] > 0 and row["min"] == row["value"] and row["spread_pct"] == 0.0
    build = row["image_build_ms"] / 4 + row["depth_build_ms"]
    assert row["value"] == pytest.approx(1e3 / (build + row["pass_ms"]))
    # the batched row (one copy of the flagship problem here, its set pinned)
    assert (row["batched_problems"], row["batched_pinned"]) == (1, 1)
    assert row["batched_maps_per_sec"] == pytest.approx(
        1e3 / (row["batched_ms"] + row["batched_prebuild_ms"] / 4))


def test_flagship_state_is_bench_py_s():
    W, H, V = 64, 48, 5
    images, depths, normals, cams = bench.flagship_scene(W, H, V, "cpu")
    vs, prior, cap, build_ms = bench.flagship_state(images, depths, normals, cams, 16)
    weak = (prior.pixel_state == PixelState.WEAK).numpy()
    assert weak.sum() == (H // 4) * (W // 4)
    assert weak[H // 2 - H // 8:H // 2 + H // 8, W // 2 - W // 8:W // 2 + W // 8].all()
    assert cap == jax_bucket_capacity((H // 4) * (W // 4), H * W)
    np.testing.assert_array_equal(prior.depth.numpy(), depths[0])
    assert vs.D is not None and vs.C36 is not None and min(build_ms) > 0
    assert (bench.DMIN, bench.DMAX) == (2.0 * 0.6, 8.0 * 1.2)
    assert bench.FLAGSHIP_RTH == 0.00875
    cfg = bench.FLAGSHIP_CFG
    assert (cfg.state.name, cfg.geom_consistency, cfg.use_APD, cfg.max_iterations,
            cfg.weak_peak_radius) == ("REFINE_ITER", True, True, 3, 4)
    # one definition: the trace takes its flagship pass from the benchmark
    assert trace_pass.flagship_state is bench.flagship_state
    assert trace_pass.flagship_pass is bench.flagship_pass


def test_sample_count_is_bench_py_s():
    for args in ((480, 640, 5, 3, 0.0625), (48, 64, 5, 3, 0.0625), (120, 160, 4, 2, 0.1)):
        assert bench.required_ncc_samples(*args) == jax_bench.required_ncc_samples(*args)


def test_bench_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--width", "64", "--height", "48", "--repeats", "1"])
