"""Benchmark of the port: full PatchMatch-pass throughput on one card,
honestly costed (the counterpart of the repository's ``bench.py`` primary
metric).

    python -m apdmvs_tpu_torch.bench [--repeats 5] [--device cuda]

Measures the flagship program — one complete REFINE_ITER pass (strong
checkerboard propagation + APD weak machinery + geometric consistency +
classification + refinement) on the synthetic 5-view ring scene at
640x480 — and reports depth-maps/s *including amortized volume builds*:

  per-pass cost = image_volume_build / 4 + depth_volume_build + pass_time

which models one steady round (scene.py): image volumes (E, C36, C9) are
cached per (problem, scale) and reused across the round's 4 passes; depth
volumes are rebuilt every pass (charged on all 4 here, though the round's
init pass skips them — conservative). The prior is the ground truth with a
centred WEAK box of H/4 x W/4 pixels; the worklist capacity is the
runner's bucket for it. Both builders are timed once after a warm-up, the
pass ``--repeats`` times after one warm-up pass; every timed interval ends
in a device synchronise.

This module is the one definition of the flagship pass:
``trace_pass`` and ``chip_smoke.py`` take its state and pass from here.

Prints exactly one JSON line on stdout:
  {"metric": "depth_maps_per_sec", "value", "unit", "min", "spread_pct",
   "pass_ms", "image_build_ms", "depth_build_ms", "device"}
where ``device`` names the card and its power limit. On a card a
speed-of-light line goes to stderr: the NCC sample count one pass needs
against the card's float32 rate outside the tensor cores.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from apdmvs_tpu_torch import geometry, ncc, pipeline, rng, scene
from apdmvs_tpu_torch.datasets import synthetic
from apdmvs_tpu_torch.params import PassConfig, PixelState, RunState

#: the flagship pass: REFINE_ITER + geometric consistency + APD, ransac
#: threshold 0.00875 (bench.py:119-129)
FLAGSHIP_CFG = PassConfig(state=RunState.REFINE_ITER, geom_consistency=True, use_APD=True,
                          max_iterations=3, weak_peak_radius=4)
FLAGSHIP_RTH = 0.00875
#: depth range of the scene's cameras, 2 .. 8 widened by 0.6 / 1.2 (APD.cpp:454-455)
DMIN, DMAX = 2.0 * 0.6, 8.0 * 1.2

#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet, at
#: the full 700 W power limit); the NCC sums are float32 on CUDA cores
F32_FLOPS = 67e12
FLOPS_PER_SAMPLE = 10.0  # 5 NCC accumulate-FMAs + slice-interp/warp share


def required_ncc_samples(H: int, W: int, V: int, iters: int, weak_frac: float) -> float:
    """Analytic count of (pixel, candidate, view, window-sample) NCC
    sample-FMAs one REFINE_ITER pass fundamentally requires (reference
    kernel DAG, APD.cu:2386-2495). Window = 36 samples (radius 5 step 2),
    anchor patches = 9 (radius 5 step 5)."""
    hw = H * W
    vsrc = V - 1
    strong = iters * hw * (8 + 6) * 36 * vsrc  # 8 candidates + ~6 refine/recost
    classify = hw * 61 * 36 * min(vsrc, 4)  # DepthToWeak disparity sweep
    refine = hw * 11 * 36 * min(vsrc, 4)  # LocalRefine
    nweak = weak_frac * hw
    weak = iters * nweak * (8 + 7) * (36 + 8 * 9) * V  # candidates+fit+combos
    seed = hw * 36 * vsrc  # initial recost
    return float(strong + classify + refine + weak + seed)


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def flagship_scene(width: int = 640, height: int = 480, views: int = 5, device="cuda"):
    """The ring scene's renders (images, depths, normals [V, H, W(, 3)]
    numpy) and its cameras on ``device``, depth range DMIN .. DMAX."""
    cams_s, planes = synthetic.make_ring_scene(num_views=views, width=width, height=height)
    images, depths, normals = synthetic.render_scene(cams_s, planes)
    cams = geometry.make_cameras(
        np.stack([c.K for c in cams_s]), np.stack([c.R for c in cams_s]),
        np.stack([c.t for c in cams_s]), np.full(views, DMIN), np.full(views, DMAX),
        device=device)
    return images, depths, normals, cams


def flagship_state(images, depths, normals, cams, num_slices: int = 160):
    """Volumes (E, C36, C9 and the ground truth's depth volumes), prior
    (ground truth, WEAK box rows H/2 +- H/8 and cols W/2 +- W/8) and
    worklist capacity of the flagship pass, plus the two build times in
    ms (each ending in a device synchronise)."""
    dev = cams.device
    V_, H_, W_ = images.shape
    imgs = torch.as_tensor(images, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    vs = ncc.build_image_volume_set(imgs, cams, DMIN, DMAX, num_slices=num_slices,
                                    weak_cost_volumes=True)
    _sync(dev)
    t1 = time.perf_counter()
    vs = ncc.add_depth_volumes(vs, torch.as_tensor(depths, device=dev), cams, DMIN, DMAX)
    _sync(dev)
    t2 = time.perf_counter()
    ps = torch.full((H_, W_), int(PixelState.STRONG), dtype=torch.uint8, device=dev)
    ps[H_ // 2 - H_ // 8:H_ // 2 + H_ // 8, W_ // 2 - W_ // 8:W_ // 2 + W_ // 8] = int(
        PixelState.WEAK)
    cap = scene._bucket_capacity(int((ps == PixelState.WEAK).sum()), H_ * W_)
    prior = pipeline.PassState(
        depth=torch.as_tensor(depths[0], device=dev),
        normal_world=torch.as_tensor(normals[0], device=dev),
        pixel_state=ps,
        selected=(torch.arange(V_, device=dev) > 0)[:, None, None].expand(V_, H_, W_).contiguous(),
    )
    return vs, prior, cap, (1e3 * (t1 - t0), 1e3 * (t2 - t1))


def flagship_pass(cams, vs, prior, cap, seed: int) -> pipeline.PassOutputs:
    """One flagship pass over view 0 with draws seeded by ``seed``."""
    H_, W_ = prior.depth.shape
    sv = torch.arange(cams.K.shape[0], device=cams.device) > 0
    return pipeline.patchmatch_pass(cams, sv, prior, rng.TorchDraws(seed, H_, W_, cams.device),
                                    FLAGSHIP_CFG, vs, weak_capacity=cap,
                                    ransac_threshold=FLAGSHIP_RTH)


def device_name(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the
    CPU's name for a CPU run."""
    dev = torch.device(device)
    if dev.type != "cuda":
        import platform

        return f"cpu ({platform.processor() or platform.machine()})"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def measure(width: int = 640, height: int = 480, views: int = 5, repeats: int = 5,
            device="cuda"):
    """The benchmark's row (see the module docstring) and the last timed
    pass's outputs."""
    dev = scene.resolve_device(device)
    images, depths, normals, cams = flagship_scene(width, height, views, dev)
    flagship_state(images, depths, normals, cams)  # warm both builders
    vs, prior, cap, (img_build_ms, depth_build_ms) = flagship_state(images, depths, normals, cams)
    flagship_pass(cams, vs, prior, cap, 0)  # warm-up pass
    pass_ms, out = [], None
    for rep in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        out = flagship_pass(cams, vs, prior, cap, rep + 1)
        _sync(dev)
        pass_ms.append(1e3 * (time.perf_counter() - t0))
    build_ms = img_build_ms / 4.0 + depth_build_ms
    rates = sorted(1e3 / (build_ms + p) for p in pass_ms)
    value = float(np.median(rates))
    row = {
        "metric": "depth_maps_per_sec",
        "value": value,
        "unit": f"depth-maps/s ({width}x{height}x{views} views, REFINE_ITER + geom + APD pass "
                "+ image build / 4 + depth build)",
        "min": rates[0],
        "spread_pct": 100.0 * (rates[-1] - rates[0]) / value,
        "pass_ms": float(np.median(pass_ms)),
        "image_build_ms": img_build_ms,
        "depth_build_ms": depth_build_ms,
        "device": device_name(dev),
    }
    return row, out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="apdmvs_tpu_torch.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; with no card it fails)")
    args = ap.parse_args(argv)
    row, _ = measure(args.width, args.height, args.views, args.repeats, args.device)
    amortized_ms = row["image_build_ms"] / 4.0 + row["depth_build_ms"] + row["pass_ms"]
    print(f"pass {row['pass_ms']:.3f} ms + image-volume build {row['image_build_ms']:.3f} ms/4"
          f" + depth-volume build {row['depth_build_ms']:.3f} ms"
          f" => amortized {amortized_ms:.3f} ms/pass on {row['device']}", file=sys.stderr)
    if torch.device(args.device).type == "cuda":
        samples = required_ncc_samples(args.height, args.width, args.views,
                                       FLAGSHIP_CFG.max_iterations, 0.0625)
        sol_ms = 1e3 * samples * FLOPS_PER_SAMPLE / F32_FLOPS
        print(f"speed-of-light estimate: {samples / 1e9:.2f} G NCC samples/pass x "
              f"{FLOPS_PER_SAMPLE:.0f} flops / {F32_FLOPS:.1e} flops/s (H100 SXM float32, "
              f"CUDA cores) = {sol_ms:.3f} ms; achieved {amortized_ms:.3f} ms = "
              f"{100.0 * sol_ms / amortized_ms:.2f}% on {row['device']}", file=sys.stderr)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
