"""Time the one-round main path of the port found under ROOT.

    python apdmvs_tpu_torch/ab_main_path.py ROOT

Imports ``apdmvs_tpu_torch`` from ROOT (a checkout, or a commit unpacked
with ``git archive``), builds its kernels, renders the 5-view 640x480 ring
scene (the scene of ``chip_smoke.py`` phase 3), runs ``scene.run_scene``
on the card twice and prints the second run's wall (20 view-passes and
fusion, ending in a device sync) and its per-view-pass times. To compare
two commits on one card, run it in fresh processes, alternating which
root goes first, e.g. ten pairs::

    for i in 0 1 2 3 4 5 6 7 8 9; do
      if [ $((i % 2)) -eq 0 ]; then o="PARENT ."; else o=". PARENT"; fi
      for r in $o; do python3 apdmvs_tpu_torch/ab_main_path.py $r; done
    done
"""

import os
import shutil
import sys
import time


def main(root: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from apdmvs_tpu_torch import scene
    from apdmvs_tpu_torch.datasets import synthetic
    from apdmvs_tpu_torch.ops import _build

    if not _build.__file__.startswith(root):
        raise RuntimeError(f"imported {_build.__file__}, not the package under {root}")
    _build.build_all()
    folder = os.path.join(root, "_ab_scene")
    shutil.rmtree(folder, ignore_errors=True)
    try:
        cams, planes = synthetic.make_ring_scene(num_views=5, width=640, height=480)
        synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run = scene.run_scene(folder, device="cuda", verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ms = [st.seconds * 1e3 for _, _, st in run.passes]
        print(f"AB {sys.argv[1]}: 20 view-passes + fusion {wall:.3f} s; view-pass ms median "
              f"{np.median(ms):.1f} mean {np.mean(ms):.1f}; per pass "
              + ", ".join(f"{m:.1f}" for m in ms))
    finally:
        shutil.rmtree(folder, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1])
