"""The port's copy of ``eval.py`` against the JAX package's: equal cloud
and depth metrics on seeded inputs (including the seeded subsampling above
``max_points``), equal ``main`` output, and tests/test_eval.py's cases run
on the copy."""

import json
import sys

import numpy as np
import pytest

from apdmvs_tpu import eval as jev
from apdmvs_tpu_torch import eval as tev
from apdmvs_tpu_torch.io import formats


def _clouds(seed):
    rng = np.random.RandomState(seed)
    gt = rng.rand(3000, 3)
    pred = np.concatenate([gt[:2000] + rng.randn(2000, 3) * 0.01, rng.rand(700, 3) * 2.0])
    return pred.astype(np.float32), gt


@pytest.mark.parametrize("seed, max_points", [(0, 2_000_000), (1, 2_000_000), (2, 1500)])
def test_cloud_metrics_equal(seed, max_points):
    pred, gt = _clouds(seed)
    kw = dict(thresholds=(0.005, 0.02, 0.05), max_points=max_points, seed=seed)
    a, b = jev.cloud_metrics(pred, gt, **kw), tev.cloud_metrics(pred, gt, **kw)
    assert list(a) == list(b)
    for t in a:
        assert a[t].to_dict() == b[t].to_dict()
    assert 0.0 < b[0.02].accuracy < 1.0 and 0.0 < b[0.02].completeness < 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_metrics_equal(seed):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(2.0, 8.0, (48, 64))
    gt[rng.rand(48, 64) < 0.1] = 0.0
    pred = gt * (1.0 + rng.randn(48, 64) * 0.01)
    pred[rng.rand(48, 64) < 0.05] = 0.0
    valid = rng.rand(48, 64) < 0.8
    for v in (None, valid & (gt > 0)):
        assert jev.depth_metrics(pred, gt, v) == tev.depth_metrics(pred, gt, v)


def test_main_prints_the_same_json(tmp_path, monkeypatch, capsys):
    pred, gt = _clouds(3)
    paths = [str(tmp_path / "pred.ply"), str(tmp_path / "gt.ply")]
    for p, c in zip(paths, (pred, gt)):
        formats.export_point_cloud(p, c.astype(np.float32), np.zeros((len(c), 3), np.uint8))
    outs = []
    for mod in (jev, tev):
        monkeypatch.setattr(sys, "argv", ["eval", *paths, "--thresholds", "0.01", "0.05"])
        mod.main()
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == outs[1] and set(outs[1]) == {"0.01", "0.05"}


# tests/test_eval.py's three cases, on the copy


def _identical():
    rng = np.random.RandomState(0)
    pts = rng.rand(5000, 3)
    m = tev.cloud_metrics(pts, pts, thresholds=(0.01,))[0.01]
    assert m.accuracy == 1.0 and m.completeness == 1.0 and m.f1 == 1.0


def _offset_and_partial():
    rng = np.random.RandomState(1)
    gt = rng.rand(4000, 3)
    # half the prediction matches GT, half is offset far away
    pred = np.concatenate([gt[:2000], gt[2000:] + 10.0])
    m = tev.cloud_metrics(pred, gt, thresholds=(0.005,))[0.005]
    assert abs(m.accuracy - 0.5) < 0.02
    # completeness: gt[:2000] covered exactly; the rest only by accident
    assert 0.45 < m.completeness < 0.6
    assert 0.45 < m.f1 < 0.6


def _depth():
    gt = np.full((10, 10), 4.0)
    pred = gt * 1.01
    pred[0, 0] = 0.0  # missing estimate
    m = tev.depth_metrics(pred, gt)
    assert abs(m["median_rel_err"] - 0.01) < 1e-6
    assert m["coverage"] == 0.99
    assert m["frac_lt_2pct"] == 1.0


@pytest.mark.parametrize("case", [_identical, _offset_and_partial, _depth],
                         ids=["cloud_metrics_identical", "cloud_metrics_offset_and_partial",
                              "depth_metrics"])
def test_eval_cases_on_the_copy(case):
    case()
