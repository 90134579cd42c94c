"""``python -m apdmvs_tpu_torch.eth3d_eval`` on the CPU at a toy size: a
COLMAP model written from a synthetic ring scene (3 views, 64x48; cameras,
poses and sparse points of its ground truth, as tests/test_torch_colmap.py
writes one) goes through the conversion, ``run_scene`` and
``eval.cloud_metrics`` against ``synthetic.gt_cloud``; ``--pred`` scores the
fused cloud again without running anything and gives ``cloud_metrics``'
numbers for it."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from apdmvs_tpu_torch import eth3d_eval, eval as eval_mod
from apdmvs_tpu_torch.datasets import colmap, synthetic
from apdmvs_tpu_torch.io import formats

torch.set_num_threads(2)

W, H, V = 64, 48, 3


def _write_colmap_scene(root):
    """The ring scene as an ETH3D-style folder (images/ and a text model
    under dslr_calibration_undistorted/) and its ground-truth cloud's PLY."""
    cams, planes = synthetic.make_ring_scene(num_views=V, width=W, height=H)
    images, depths, _ = synthetic.render_scene(cams, planes)
    gt = synthetic.gt_cloud(cams, depths, stride=2)
    model = os.path.join(root, "dslr_calibration_undistorted")
    os.makedirs(model)
    os.makedirs(os.path.join(root, "images"))
    pts = gt[np.random.RandomState(0).choice(len(gt), 300, replace=False)]
    with open(os.path.join(model, "cameras.txt"), "w") as f:
        for i, c in enumerate(cams):
            f.write(f"{i + 1} PINHOLE {W} {H} {c.K[0, 0]} {c.K[1, 1]} {c.K[0, 2]} {c.K[1, 2]}\n")
    with open(os.path.join(model, "images.txt"), "w") as f:
        for i, c in enumerate(cams):
            q = colmap.rotmat2qvec(c.R)
            f.write(f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} {c.t[0]} {c.t[1]} {c.t[2]} {i + 1} "
                    f"img_{i}.png\n")
            f.write(" ".join(f"{10.0 + j} {20.0 + j} {j + 1}" for j in range(len(pts))) + "\n")
            Image.fromarray(np.clip(images[i], 0, 255).astype(np.uint8)).save(
                os.path.join(root, "images", f"img_{i}.png"))
    with open(os.path.join(model, "points3D.txt"), "w") as f:
        for j, p in enumerate(pts):
            track = " ".join(f"{i + 1} {j}" for i in range(V))
            f.write(f"{j + 1} {p[0]} {p[1]} {p[2]} 128 128 128 0.5 {track}\n")
    gt_ply = os.path.join(root, "scan.ply")
    formats.export_point_cloud(gt_ply, gt, np.zeros((len(gt), 3), np.uint8))
    return gt_ply, gt


def test_eth3d_eval_reconstructs_and_scores(tmp_path, capsys):
    root = str(tmp_path / "ring")
    gt_ply, gt = _write_colmap_scene(root)
    work = str(tmp_path / "work")
    eth3d_eval.main([root, "--gt", gt_ply, "--work", work, "--scale-factor", "1",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    blob = json.loads(out[out.index("{\n"):])
    assert blob["scene"] == "ring" and blob["pred_ply"] == os.path.join(work, "APD", "APD.ply")
    assert set(blob["metrics"]) == {"0.02", "0.05"}
    for d in range(V):  # the converted dataset the run read
        assert os.path.exists(os.path.join(work, "cams", f"{d:08d}_cam.txt"))
    m = blob["metrics"]["0.05"]
    print(f"F1 at 0.05 {m['f1']:.4f} (accuracy {m['accuracy']:.4f}, completeness "
          f"{m['completeness']:.4f}, {m['num_points']} points)")
    assert m["num_gt"] == len(gt) and m["num_points"] > 500
    assert m["accuracy"] > 0.8 and m["f1"] > 0.5

    # --pred: the same cloud scored alone, as cloud_metrics scores it
    eth3d_eval.main([root, "--gt", gt_ply, "--pred", blob["pred_ply"],
                     "--thresholds", "0.05", "0.1"])
    out = capsys.readouterr().out
    again = json.loads(out[out.index("{\n"):])
    pred, _ = formats.read_point_cloud(blob["pred_ply"])
    want = eval_mod.cloud_metrics(pred, gt.astype(np.float32), thresholds=(0.05, 0.1))
    assert again["metrics"] == {str(t): pytest.approx(v.to_dict()) for t, v in want.items()}
    assert again["metrics"]["0.05"] == pytest.approx(m)
