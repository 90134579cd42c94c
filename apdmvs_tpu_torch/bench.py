"""Benchmark of the port: full PatchMatch-pass throughput on one card,
honestly costed (the counterpart of the repository's ``bench.py`` primary
metric).

    python -m apdmvs_tpu_torch.bench [--repeats 5] [--device cuda]

Measures the flagship program — one complete REFINE_ITER pass, compiled
(``pipeline.patchmatch_pass``: on a card a CUDA graph replayed; strong
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

``--batched-problems N`` (default 4, as ``bench.py:72-78``; 0 disables)
also times the batched runner's volume path
(``parallel.sharded._volume_batched_pass``) on N copies of the flagship
problem, its image-volume sets pinned as ``run_scene_batched`` pins them by
default (within ``scene.volume_cache_budget``; at 640x480x5, 1.71 GB a set,
an 80 GB card pins all 4) and any rest built in the loop every pass, each
problem's depth volumes from the ground truth as the flagship's:

  batched_maps_per_sec = N / (median batch pass + pinned-set build / 4)

The primary ``value`` and its definition do not change.

Prints exactly one JSON line on stdout:
  {"metric": "depth_maps_per_sec", "value", "unit", "min", "spread_pct",
   "pass_ms", "image_build_ms", "depth_build_ms", "device"}, with
  "batched_maps_per_sec", "batched_problems", "batched_pinned",
  "batched_ms" and "batched_prebuild_ms" added when N > 0,
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
from typing import Optional

import numpy as np
import torch

from apdmvs_tpu_torch import geometry, ncc, parallel, pipeline, rng, scene
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
    prior, cap = flagship_prior(depths, normals, V_, dev)
    return vs, prior, cap, (1e3 * (t1 - t0), 1e3 * (t2 - t1))


def flagship_prior(depths, normals, views: int, device):
    """The flagship pass's prior (ground truth, WEAK box rows H/2 +- H/8
    and cols W/2 +- W/8) and worklist capacity."""
    H_, W_ = depths.shape[1:]
    ps = torch.full((H_, W_), int(PixelState.STRONG), dtype=torch.uint8, device=device)
    ps[H_ // 2 - H_ // 8:H_ // 2 + H_ // 8, W_ // 2 - W_ // 8:W_ // 2 + W_ // 8] = int(
        PixelState.WEAK)
    cap = scene._bucket_capacity(int((ps == PixelState.WEAK).sum()), H_ * W_)
    prior = pipeline.PassState(
        depth=torch.as_tensor(depths[0], device=device),
        normal_world=torch.as_tensor(normals[0], device=device),
        pixel_state=ps,
        selected=(torch.arange(views, device=device) > 0)[:, None, None].expand(
            views, H_, W_).contiguous(),
    )
    return prior, cap


def flagship_pass(cams, vs, prior, cap, seed: int, debug: bool = False, eager: bool = False):
    """One flagship pass over view 0 with draws seeded by ``seed``; with
    ``debug`` also its ``pipeline.DebugProbes``. The compiled pass
    (``pipeline.patchmatch_pass``), over a set or over row slabs on the
    pass's device; ``eager``, or slabs on several distinct devices, runs its
    body (``pipeline.patchmatch_pass_impl``), as profiling and stage timing
    need and as one CUDA graph cannot hold several devices' work."""
    H_, W_ = prior.depth.shape
    sv = torch.arange(cams.K.shape[0], device=cams.device) > 0
    spread = vs.spaced and len(set(vs.devices)) > 1
    run = pipeline.patchmatch_pass_impl if eager or spread else pipeline.patchmatch_pass
    return run(cams, sv, prior, rng.TorchDraws(seed, H_, W_, cams.device), FLAGSHIP_CFG, vs,
               weak_capacity=cap, ransac_threshold=FLAGSHIP_RTH, debug=debug)


def measure_batched(images, depths, normals, cams, n: int, repeats: int,
                    budget_gb: Optional[float] = None, num_slices: int = 160) -> dict:
    """The batched row: N copies of the flagship problem through the
    volume path's batch body, the pinned sets built (and timed) once after
    a warm-up build, the batch pass timed ``repeats`` times after one
    warm-up, each interval ending in a device synchronise. The sets are
    pinned within ``budget_gb`` (None: ``scene.volume_cache_budget``, the
    default of ``run_scene_batched``)."""
    dev = cams.device
    V_, H_, W_ = images.shape
    prior, cap = flagship_prior(depths, normals, V_, dev)
    imgs_b = torch.as_tensor(images, device=dev)[None].expand(n, V_, H_, W_)
    cams_b = geometry.Cameras(*(f[None].expand((n,) + tuple(f.shape)) for f in cams))
    prior_b = pipeline.PassState(*(f[None].expand((n,) + tuple(f.shape)) for f in prior))
    sv_b = (torch.arange(V_, device=dev) > 0)[None].expand(n, V_)
    src_index = np.tile(np.arange(V_), (n, 1))  # every copy reads the ground truth
    set_bytes = ncc.image_volume_set_nbytes(V_, H_, W_, num_slices, weak_cost_volumes=True)
    budget = (scene.volume_cache_budget(dev, V_, H_, W_, num_slices) if budget_gb is None
              else budget_gb * 1e9)
    M = parallel.pinned_count(set_bytes, n, budget)

    def prebuild():
        if M == 0:
            return None
        out = parallel.build_batch_image_volumes(
            imgs_b[:M], geometry.Cameras(*(f[:M] for f in cams_b)), num_slices)
        _sync(dev)
        return out

    prebuild()
    _sync(dev)
    t0 = time.perf_counter()
    pinned = prebuild()
    prebuild_ms = 1e3 * (time.perf_counter() - t0)
    depths_t = torch.as_tensor(depths, device=dev)

    def batch(seed0):
        draws = [rng.TorchDraws(seed0 + i, H_, W_, dev) for i in range(n)]
        return parallel.sharded_batch_pass(
            imgs_b, cams_b, sv_b, prior_b, draws, np.full(n, FLAGSHIP_RTH), FLAGSHIP_CFG,
            weak_capacity=cap, all_depths=depths_t, src_index=src_index, use_volumes=True,
            num_slices=num_slices, prebuilt=[pinned])

    batch(0)
    times = []
    for rep in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        batch((rep + 1) * n)
        _sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    batched_ms = float(np.median(times))
    return {"batched_maps_per_sec": 1e3 * n / (batched_ms + prebuild_ms / 4.0),
            "batched_problems": n, "batched_pinned": M, "batched_ms": batched_ms,
            "batched_prebuild_ms": prebuild_ms}


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
            device="cuda", batched_problems: int = 4):
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
    if batched_problems > 0:
        row.update(measure_batched(images, depths, normals, cams, batched_problems, repeats))
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
    ap.add_argument("--batched-problems", type=int, default=4,
                    help="also time the batched runner's volume path on this many copies of "
                    "the flagship problem (batched_maps_per_sec); 0 disables")
    args = ap.parse_args(argv)
    row, _ = measure(args.width, args.height, args.views, args.repeats, args.device,
                     args.batched_problems)
    amortized_ms = row["image_build_ms"] / 4.0 + row["depth_build_ms"] + row["pass_ms"]
    print(f"pass {row['pass_ms']:.3f} ms + image-volume build {row['image_build_ms']:.3f} ms/4"
          f" + depth-volume build {row['depth_build_ms']:.3f} ms"
          f" => amortized {amortized_ms:.3f} ms/pass on {row['device']}", file=sys.stderr)
    if args.batched_problems > 0:
        print(f"batched: {row['batched_problems']} problems, {row['batched_pinned']} sets pinned "
              f"(built in {row['batched_prebuild_ms']:.3f} ms, charged / 4), batch pass "
              f"{row['batched_ms']:.3f} ms => {row['batched_maps_per_sec']:.4f} depth-maps/s",
              file=sys.stderr)
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
