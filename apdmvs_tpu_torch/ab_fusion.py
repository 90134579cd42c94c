"""Walls of the device fusion (``--fusion eth-device``) of the package found
under ROOT.

    python apdmvs_tpu_torch/ab_fusion.py ROOT FOLDER [REPEATS]

Imports ``apdmvs_tpu_torch`` from ROOT (a checkout, or a commit unpacked
with ``git archive``). FOLDER holds a scene whose views' outputs are
persisted; where it holds none yet, the script writes the 1280x960
five-view scene of ``chip_smoke.py``'s phases 7 and 8 (focal 1600, a
textureless window) there, with the ground truth persisted as every view's
outputs and a WEAK box in each view's state map. On the card, after one
warm-up call each, it times REPEATS calls (default 5) of:

- ``scene.run_fusion(variant="eth-device")``: the views loaded, fused and
  the PLY written, as phase 8 times it;
- ``fusion_device.fuse_eth_device`` alone on the views loaded once;

each with the host clock between two device synchronises. It prints one
line ``ABF ROOT {json}`` (every wall in milliseconds, the medians and the
point count), then the card's name and power limit. To compare two
commits on one card, run it in fresh processes, parent, change, change,
parent, on one FOLDER.
"""

import json
import os
import statistics
import subprocess
import sys
import time


def _write_scene(folder: str) -> None:
    import numpy as np

    from apdmvs_tpu_torch.datasets import synthetic
    from apdmvs_tpu_torch.io import formats
    from apdmvs_tpu_torch.params import PixelState

    W, H = 1280, 960
    cams, planes = synthetic.make_ring_scene(num_views=5, width=W, height=H, focal=1600.0,
                                             include_flat_region=True)
    images, depths, normals = synthetic.render_scene(cams, planes)
    synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0), images=images)
    weak = np.full((H, W), PixelState.STRONG, np.uint8)
    weak[H // 3:H // 2, W // 3:W // 2] = PixelState.WEAK
    for v in range(len(cams)):
        rf = os.path.join(folder, "APD", formats.to_format_index(v))
        os.makedirs(rf, exist_ok=True)
        formats.write_bin_mat(os.path.join(rf, "depths.dmb"), depths[v])
        formats.write_bin_mat(os.path.join(rf, "normals.dmb"), normals[v])
        formats.write_bin_mat(os.path.join(rf, "weak.bin"), weak)


def _walls(fn, repeats: int):
    import torch

    fn()
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def main(root: str, folder: str, repeats: int = 5) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from apdmvs_tpu_torch import fusion_device, scene
    from apdmvs_tpu_torch.io import formats

    if not scene.__file__.startswith(root):
        raise RuntimeError(f"imported {scene.__file__}, not the package under {root}")
    folder = os.path.abspath(folder)
    if not os.path.exists(os.path.join(folder, "APD")):
        _write_scene(folder)
    dev = torch.device("cuda", 0)
    problems = scene.generate_sample_list(folder)
    run = _walls(lambda: scene.run_fusion(folder, problems, "eth-device",
                                          out_name="ab_fusion.ply", device=dev), repeats)
    points = formats.read_point_cloud(os.path.join(folder, "APD", "ab_fusion.ply"))[0].shape[0]
    views, src_ids = scene._load_fusion_views(folder, problems)
    fuse = _walls(lambda: fusion_device.fuse_eth_device(views, src_ids, device=dev), repeats)
    times = {"run_fusion_ms": run, "run_fusion_median_ms": statistics.median(run),
             "fuse_eth_device_ms": fuse, "fuse_eth_device_median_ms": statistics.median(fuse),
             "points": points}
    print(f"ABF {sys.argv[1]} " + json.dumps(times), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    if len(sys.argv) not in (3, 4):
        sys.exit("usage: ab_fusion.py ROOT FOLDER [REPEATS]")
    main(sys.argv[1], sys.argv[2], *(int(a) for a in sys.argv[3:]))
