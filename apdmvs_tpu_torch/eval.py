"""Evaluation harness: point-cloud and depth-map metrics.

The reference publishes no benchmark numbers and ships no evaluator
(SURVEY.md §6); this module provides the standard MVS metrics used by the
ETH3D/Tanks&Temples protocols so parity can be measured against
reference-produced `APD.ply` files or ground-truth scans:

- accuracy(d): fraction of reconstructed points within d of the GT cloud
- completeness(d): fraction of GT points within d of the reconstruction
- F1(d): harmonic mean (the ETH3D headline metric)
- depth-map error statistics against ground truth
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class CloudMetrics:
    threshold: float
    accuracy: float
    completeness: float
    f1: float
    num_points: int
    num_gt: int

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _nn_dists(a: np.ndarray, b: np.ndarray, workers: int = -1) -> np.ndarray:
    """For each point in ``a``, distance to the nearest point of ``b``."""
    from scipy.spatial import cKDTree

    tree = cKDTree(b)
    d, _ = tree.query(a, k=1, workers=workers)
    return d


def cloud_metrics(
    pred: np.ndarray,
    gt: np.ndarray,
    thresholds: Sequence[float] = (0.02, 0.05),
    max_points: int = 2_000_000,
    seed: int = 0,
) -> Dict[float, CloudMetrics]:
    """Accuracy / completeness / F1 at each threshold (ETH3D protocol
    shape: symmetric nearest-neighbor distances). Clouds larger than
    ``max_points`` are uniformly subsampled for tractability."""
    rng = np.random.RandomState(seed)
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    n_pred, n_gt = len(pred), len(gt)
    if len(pred) > max_points:
        pred = pred[rng.choice(len(pred), max_points, replace=False)]
    if len(gt) > max_points:
        gt = gt[rng.choice(len(gt), max_points, replace=False)]
    d_pred = _nn_dists(pred, gt)
    d_gt = _nn_dists(gt, pred)
    out = {}
    for t in thresholds:
        acc = float(np.mean(d_pred <= t))
        comp = float(np.mean(d_gt <= t))
        f1 = 2 * acc * comp / max(acc + comp, 1e-12)
        out[t] = CloudMetrics(
            threshold=t, accuracy=acc, completeness=comp, f1=f1,
            num_points=n_pred, num_gt=n_gt,
        )
    return out


def depth_metrics(
    pred: np.ndarray,
    gt: np.ndarray,
    valid: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Relative depth-error statistics over valid GT pixels."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if valid is None:
        valid = gt > 0
    est = valid & (pred > 0)
    rel = np.abs(pred - gt)[est] / gt[est]
    return {
        "coverage": float(np.mean(est[valid])),
        "median_rel_err": float(np.median(rel)) if rel.size else float("nan"),
        "mean_rel_err": float(np.mean(rel)) if rel.size else float("nan"),
        "frac_lt_1pct": float(np.mean(rel < 0.01)) if rel.size else 0.0,
        "frac_lt_2pct": float(np.mean(rel < 0.02)) if rel.size else 0.0,
    }


def main() -> None:
    import argparse

    from apdmvs_tpu_torch.io import formats

    ap = argparse.ArgumentParser(
        description="Compare a reconstructed PLY against a ground-truth PLY"
    )
    ap.add_argument("pred_ply")
    ap.add_argument("gt_ply")
    ap.add_argument(
        "--thresholds", type=float, nargs="+", default=[0.02, 0.05],
        help="distance thresholds in scene units (ETH3D: meters)",
    )
    args = ap.parse_args()
    pred, _ = formats.read_point_cloud(args.pred_ply)
    gt, _ = formats.read_point_cloud(args.gt_ply)
    metrics = cloud_metrics(pred, gt, thresholds=args.thresholds)
    print(json.dumps({str(t): m.to_dict() for t, m in metrics.items()}, indent=2))


if __name__ == "__main__":
    main()
