"""ETH3D scene evaluation in one command: COLMAP model -> reconstruction -> F1.

    python -m apdmvs_tpu_torch.eth3d_eval DENSE_FOLDER --gt SCAN.ply [--work DIR]
        [--scale-factor 2] [--batched] [--fusion eth] [--thresholds 0.02 0.05]
        [--pred CLOUD.ply] [--device cuda]

The counterpart of ``scripts/eth3d_eval.py``. ETH3D's data is a download
(``<scene>_dslr_undistorted.7z`` for the images and the COLMAP model,
``<scene>_dslr_scan_eval.7z`` for the ground-truth scan); unpack both under
one folder and pass it as DENSE_FOLDER. Steps:

1. ``datasets/colmap.convert``: pair scores, cameras and resized images
   into ``--work`` (default ``DENSE_FOLDER/apdmvs_work``);
2. ``scene.run_scene`` (or ``run_scene_batched`` with ``--batched``) on
   ``--device`` (default the card; with no card it fails);
3. ``eval.cloud_metrics`` of the fused cloud against the scan at each
   threshold (ETH3D's 2 cm and 5 cm; its scans are in metres).

Prints one JSON blob. ``--pred`` scores a given PLY (the reference binary's
``APD.ply``, say) without running anything.
"""

from __future__ import annotations

import argparse
import json
import os

from apdmvs_tpu_torch import eval as eval_mod, scene
from apdmvs_tpu_torch.datasets import colmap
from apdmvs_tpu_torch.io import formats


def reconstruct(dense_folder: str, work: str, scale_factor: float = 2.0,
                batched: bool = False, fusion: str = "eth", device="cuda") -> str:
    """Steps 1 and 2: convert the COLMAP scene into ``work`` and reconstruct
    it; returns the fused cloud's path."""
    scene.resolve_device(device)
    model_dir = os.path.join(dense_folder, "dslr_calibration_undistorted")
    if not os.path.isdir(model_dir):
        model_dir = dense_folder  # already a sparse-model folder
    colmap.convert(dense_folder=dense_folder, save_folder=work, model_dir=model_dir,
                   image_dir=os.path.join(dense_folder, "images"), scale_factor=scale_factor)
    runner = scene.run_scene_batched if batched else scene.run_scene
    return runner(work, fusion_variant=fusion, device=device).ply


def score(ply: str, gt: str, thresholds=(0.02, 0.05)) -> dict:
    """Step 3: ``eval.cloud_metrics`` of the cloud at ``ply`` against the
    scan at ``gt``, by threshold."""
    pred, _ = formats.read_point_cloud(ply)
    ref, _ = formats.read_point_cloud(gt)
    metrics = eval_mod.cloud_metrics(pred, ref, thresholds=thresholds)
    return {str(t): m.to_dict() for t, m in metrics.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="apdmvs_tpu_torch.eth3d_eval",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("dense_folder", help="ETH3D undistorted scene folder "
                    "(dslr_calibration_undistorted/ and images/), or a sparse-model folder")
    ap.add_argument("--gt", required=True, help="ground-truth scan PLY")
    ap.add_argument("--work", default=None,
                    help="folder for the converted dataset and the outputs "
                    "(default DENSE_FOLDER/apdmvs_work)")
    ap.add_argument("--scale-factor", type=float, default=2.0,
                    help="image downscale of the conversion (ETH3D's DSLR images are "
                    "6048x4032; the reference protocol evaluates half size)")
    ap.add_argument("--batched", action="store_true", help="use the batched runner")
    ap.add_argument("--fusion", default="eth", choices=scene.FUSION_VARIANTS)
    ap.add_argument("--thresholds", type=float, nargs="+", default=[0.02, 0.05])
    ap.add_argument("--pred", default=None,
                    help="score this PLY instead of reconstructing (e.g. the reference "
                    "binary's APD.ply for the baseline row)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the reconstruction (default cuda; 'cpu' runs the "
                    "plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    ply = args.pred
    if ply is None:
        ply = reconstruct(args.dense_folder,
                          args.work or os.path.join(args.dense_folder, "apdmvs_work"),
                          args.scale_factor, args.batched, args.fusion, args.device)
    print(json.dumps({"scene": os.path.basename(os.path.normpath(args.dense_folder)),
                      "pred_ply": ply, "metrics": score(ply, args.gt, args.thresholds)},
                     indent=2))


if __name__ == "__main__":
    main()
