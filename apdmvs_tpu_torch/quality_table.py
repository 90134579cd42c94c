"""The synthetic quality table of ``BASELINE.md`` through the port (the
counterpart of ``scripts/quality_table.py``).

    python -m apdmvs_tpu_torch.quality_table [--device cuda] [--families ring,curved]

Runs the four scene families of tests/test_quality.py through the port's
full pipeline (``scene.run_scene``: passes, fusion) and scores the fused
cloud with ``eval.cloud_metrics`` at 0.05 scene units against the oracle
cloud (``synthetic.gt_cloud``, stride 2):

- multiround: the 4-view 128x96 ring scene with a textureless window,
  clean images, two rounds forced (the second runs the APD weak machinery);
- occlusion: a card in front of a wall (``make_occlusion_scene(4)``);
- curved: a sphere in front of a wall (``make_curved_scene(4)``);
- ring: the 4-view 160x120 ring scene;

the last three with ``perturb_radiometric(seed=11)`` applied. Prints one
markdown row per family beside the round-4 F1 of ``BASELINE.md``, which
is the JAX package's F1 on a TPU, and ends with one JSON line
``{"device": ..., "families": [...]}``. Scenes are written under a
temporary directory and removed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

from apdmvs_tpu_torch import eval as eval_mod
from apdmvs_tpu_torch import scene
from apdmvs_tpu_torch.bench import device_name
from apdmvs_tpu_torch.datasets import synthetic
from apdmvs_tpu_torch.io import formats

FAMILIES = ("multiround", "occlusion", "curved", "ring")
#: BASELINE.md's round-4 F1 at 0.05: the JAX package on a TPU
ROUND4_F1 = {"multiround": 0.871, "occlusion": 0.572, "curved": 0.798, "ring": 0.902}
#: the JAX package's floors (tests/test_quality.py): points, accuracy, F1
FLOORS = {"multiround": (1500, 0.90, 0.78), "occlusion": (3000, 0.81, 0.54),
          "curved": (3000, 0.89, 0.72), "ring": (3000, 0.90, 0.81)}
THRESHOLD = 0.05


def family_scene(name: str):
    """(cameras, primitives, radiometric noise?, run_scene keywords) of a family."""
    if name == "multiround":
        cams, prims = synthetic.make_ring_scene(num_views=4, width=128, height=96,
                                                include_flat_region=True)
        return cams, prims, False, {"min_rounds": 2}
    if name == "occlusion":
        cams, prims = synthetic.make_occlusion_scene(num_views=4)
    elif name == "curved":
        cams, prims = synthetic.make_curved_scene(num_views=4)
    elif name == "ring":
        cams, prims = synthetic.make_ring_scene(num_views=4, width=160, height=120)
    else:
        raise ValueError(f"unknown family {name!r}; choose from {FAMILIES}")
    return cams, prims, True, {}


def run_family(name: str, root: str, device="cuda", seed: int = 0) -> dict:
    """Render a family into ``root/<name>``, reconstruct it on ``device`` and
    score it; the folder is removed afterwards."""
    cams, prims, noise, run_kw = family_scene(name)
    folder = os.path.join(root, name)
    shutil.rmtree(folder, ignore_errors=True)
    try:
        images, depths, _ = synthetic.render_scene(cams, prims)
        imgs_in = synthetic.perturb_radiometric(images, seed=11) if noise else images
        synthetic.write_mvsnet_dataset(folder, cams, prims, images=imgs_in)
        t0 = time.perf_counter()
        run = scene.run_scene(folder, seed=seed, device=device, verbose=False, **run_kw)
        seconds = time.perf_counter() - t0
        coords, _ = formats.read_point_cloud(run.ply)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    gt = synthetic.gt_cloud(cams, depths, stride=2)
    m = eval_mod.cloud_metrics(coords, gt, thresholds=(THRESHOLD,))[THRESHOLD]
    return {"family": name, "points": int(m.num_points), "accuracy": m.accuracy,
            "completeness": m.completeness, "f1": m.f1, "round4_f1": ROUND4_F1[name],
            "seconds": seconds}


def below_floors(row: dict) -> list:
    """The floors of tests/test_quality.py that ``row`` does not clear."""
    points, acc, f1 = FLOORS[row["family"]]
    return [f"{k} {row[k]} <= {floor}" for k, floor in
            (("points", points), ("accuracy", acc), ("f1", f1)) if not row[k] > floor]


def markdown(rows, device: str) -> str:
    lines = [f"| Scene family | Points | Accuracy | Completeness | F1 (port, {device}) "
             "| F1 round 4 (JAX package on a TPU) |", "|---|---|---|---|---|---|"]
    lines += [f"| {r['family']} | {r['points']} | {r['accuracy']:.4f} | {r['completeness']:.4f} "
              f"| {r['f1']:.4f} | {r['round4_f1']} |" for r in rows]
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="apdmvs_tpu_torch.quality_table",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; with no card it fails)")
    args = ap.parse_args(argv)
    device = scene.resolve_device(args.device)
    name = device_name(device)
    rows = []
    with tempfile.TemporaryDirectory(prefix="apd_quality_") as root:
        for fam in args.families.split(","):
            rows.append(run_family(fam.strip(), root, device))
            print(json.dumps(rows[-1]), flush=True)
    print(markdown(rows, name))
    print(json.dumps({"device": name, "families": rows}))


if __name__ == "__main__":
    main()
