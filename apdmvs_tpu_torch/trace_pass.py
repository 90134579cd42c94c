"""Where one view-pass spends its time on the card.

    python -m apdmvs_tpu_torch.trace_pass [--out DIR]

Renders the 5-view 640x480 ring scene (the scene ``chip_smoke.py`` runs),
runs the one-round schedule once to warm up (kernel builds, cached image
volumes, state files), then re-runs one FIRST_INIT and one geometric
REFINE_ITER view-pass of view 0 under ``torch.profiler``. For each it prints
the wall time (host clock, ending in a device sync), the device busy time
(sum of kernel and copy times on the card), the device idle share, and the
kernels that take the most device time, with their launch counts. With
``--out`` it also writes each pass's Chrome trace there.

Needs a CUDA card; the scene is written under ``_trace_scene/`` in the
repository root and removed afterwards.
"""

from __future__ import annotations

import argparse
import collections
import os
import shutil
import time

import torch

from apdmvs_tpu_torch import scene
from apdmvs_tpu_torch.datasets import synthetic
from apdmvs_tpu_torch.params import build_schedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, V = 640, 480, 5


def _device_kernels(prof):
    """name -> [device microseconds, count] over the device-side events."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        out[e.name][0] += e.device_time_total
        out[e.name][1] += 1
    return out


def _profile_pass(cache, problem, spec, out_dir, tag, top):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        scene.process_problem(cache, problem, spec, (W, H), 0, "cuda", num_views_pad=V)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    launches = sum(n for _, n in kernels.values())
    print(f"{tag}: wall {wall_ms:.3f} ms, device busy "
          + (f"{busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.4f}), "
             f"{launches} device events" if busy_ms > 0 else "not measured (no device events)"))
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {us / 1e3:10.3f} ms {n:6d}x  {name[:110]}")
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, f"{tag}.json"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="apdmvs_tpu_torch.trace_pass",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="directory for the Chrome traces")
    ap.add_argument("--top", type=int, default=15, help="kernels listed per pass")
    args = ap.parse_args(argv)
    scene.resolve_device("cuda")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    folder = os.path.join(ROOT, "_trace_scene")
    shutil.rmtree(folder, ignore_errors=True)
    try:
        cams, planes = synthetic.make_ring_scene(num_views=V, width=W, height=H)
        synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
        scene.run_scene(folder, device="cuda", verbose=False)  # warm-up, writes the state files
        problems = scene.generate_sample_list(folder)
        cache = scene.SceneCache(folder, expected_sets=len(problems))
        first, geom = build_schedule(1)[:2]
        for p in problems:  # cache the image volumes, as a round does after its first pass
            scene.process_problem(cache, p, first, (W, H), 0, "cuda", num_views_pad=V)
        print(f"device: {torch.cuda.get_device_name(0)}; scene {V} views {W}x{H}, K=160")
        _profile_pass(cache, problems[0], first, args.out, "first_init_pass", args.top)
        _profile_pass(cache, problems[0], geom, args.out, "refine_iter_geom_pass", args.top)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


if __name__ == "__main__":
    main()
