"""Where one view-pass spends its time on the card.

    python -m apdmvs_tpu_torch.trace_pass [--out DIR]

Profiles, each under ``torch.profiler`` after a warm-up:

1. the 5-view 640x480 ring scene (the one-round scene ``chip_smoke.py``
   runs): one FIRST_INIT and one geometric REFINE_ITER view-pass of view 0;
2. bench.py's flagship pass (bench.py:89-160): a REFINE_ITER pass with
   geometric consistency and the APD weak machinery on that scene, the
   prior from the ground truth and a 19200-pixel weak box;
3. the 1280x960 five-view scene with a textureless window that
   ``chip_smoke.py`` runs in two rounds: after the two rounds, the last
   geometric APD view-pass of view 0 again, image-volume builds included
   (five sets at that size exceed the volume cache).

For each it prints the wall time (host clock, ending in a device sync), the
device busy time (sum of kernel and copy times on the card), the device
idle share, and the kernels that take the most device time, with their
launch counts. With ``--out`` it also writes each pass's Chrome trace there.

Needs a CUDA card; the scenes are written under ``_trace_scene/`` in the
repository root and removed afterwards.
"""

from __future__ import annotations

import argparse
import collections
import functools
import os
import shutil
import time

import numpy as np
import torch

from apdmvs_tpu_torch import geometry, ncc, pipeline, rng, scene, weak
from apdmvs_tpu_torch.datasets import synthetic
from apdmvs_tpu_torch.ops import cols
from apdmvs_tpu_torch.params import PassConfig, PixelState, RunState, build_schedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, V = 640, 480, 5

#: bench.py's flagship pass: REFINE_ITER + geometric consistency + APD,
#: ransac threshold 0.00875 (bench.py:119-129)
FLAGSHIP_CFG = PassConfig(state=RunState.REFINE_ITER, geom_consistency=True, use_APD=True,
                          max_iterations=3, weak_peak_radius=4)
FLAGSHIP_RTH = 0.00875


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def flagship_state(images, depths, normals, cams, num_slices: int = 160):
    """Volumes (E, C36, C9 and the ground truth's depth volumes), prior
    (ground truth, WEAK box rows H/2 +- H/8 and cols W/2 +- W/8) and
    worklist capacity of bench.py's flagship pass, plus the two build
    times in ms. Depth range 1.2 .. 9.6 (bench.py:96-100)."""
    dev = cams.device
    V_, H_, W_ = images.shape
    t0 = time.perf_counter()
    vs = ncc.build_image_volume_set(torch.as_tensor(images, device=dev), cams, 1.2, 9.6,
                                    num_slices=num_slices, weak_cost_volumes=True)
    _sync(dev)
    t1 = time.perf_counter()
    vs = ncc.add_depth_volumes(vs, torch.as_tensor(depths, device=dev), cams, 1.2, 9.6)
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


def weak_lookups(cams, vsf, prior, cap, num_slices: int):
    """The flagship pass's worklist [cap, 2], anchors [cap, 8, 2], resident
    columns (one ``build_weak_cols``) and lookup slices of the weak sweep's
    candidates: k_c [10, cap] at the weak pixels and k_a [10, 8 cap] at the
    anchors, from the prior's planes with 2 % depth noise (B=10: 8 anchor
    planes, current, fit; B=5 the first five), plane 9 zero (k = 0/0, a
    zero fit plane), and lanes of k NaN, +-inf, < 0, > K-1 and K-1."""
    dev = cams.K.device
    V, H, W = prior.selected.shape
    ctx = ncc.make_context(cams, torch.arange(V, device=dev) > 0, H, W, vsf)
    weak_xy = weak.compact_weak_pixels(prior.pixel_state, cap)
    anchors, _ = weak.generate_anchors(ctx, prior.depth, prior.pixel_state, weak_xy,
                                       rng.TorchDraws(0, H, W, dev), FLAGSHIP_CFG,
                                       FLAGSHIP_RTH)
    a = anchors.coords[:, 1:]
    wcols = weak.build_weak_cols(ctx, weak_xy, anchors)
    u_min, du = vsf.u_grid
    K0 = cams.K[0]
    wx, wy = weak_xy[:, 0].float(), weak_xy[:, 1].float()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    yc, xc = weak_xy[:, 1].clamp(min=0), weak_xy[:, 0].clamp(min=0)
    n = geometry.normal_world_to_cam(cams.R[0], prior.normal_world)[yc, xc]  # [N, 3]
    scale = 1 + 0.02 * torch.randn((10, cap), generator=gen, device=dev)
    wpl = geometry.dist_to_origin(K0, wx, wy, prior.depth[yc, xc] * scale, n[None])
    planes = torch.cat([n[None].expand(10, -1, -1), wpl[..., None]], -1)
    planes[9] = 0.0  # a zero fit plane: k = 0/0
    dirs_c = geometry.pixel_dirs(K0, wx, wy)
    adirs = geometry.pixel_dirs(K0, a[..., 0].float(), a[..., 1].float())
    k_c = (weak._inv_depth(planes, dirs_c) - u_min) / du  # [10, N]
    k_a = ((weak._inv_depth(planes, adirs) - u_min) / du).reshape(10, -1)  # [10, 8N]
    for kk in (k_c, k_a):
        kk[0, :4] = torch.tensor([float("nan"), float("inf"), -float("inf"), -5.0])
        kk[1, :2] = torch.tensor([num_slices + 10.0, num_slices - 1.0])
    return weak_xy, a, wcols, k_c, k_a


def flagship_h6_calls(cams, vs, prior, cap, seed: int):
    """One flagship pass with H6 watched: the inputs of the first
    ``contract_lookup`` call of each kind, ``"{table}_{mode}_B{B}"`` ->
    (columns, k, nearest), the table named by the columns' length (c36
    and d at the ``cap`` weak pixels, c9 at their 8 ``cap`` anchors).
    These are the lookups a real pass makes, wider than those of
    :func:`weak_lookups`."""
    kernel, seen = cols.contract_lookup, {}

    # wraps carries ``launches`` over: the wrapper counts its launches
    # through the module's name, which is the watcher here
    @functools.wraps(kernel)
    def watched(cols_t, k, nearest=False):
        table = "d" if nearest else {cap: "c36", 8 * cap: "c9"}[cols_t.shape[2]]
        kind = f"{table}_{'nearest' if nearest else 'tent'}_B{k.shape[0]}"
        seen.setdefault(kind, (cols_t, k.clone(), nearest))
        return kernel(cols_t, k, nearest)

    cols.contract_lookup = watched
    try:
        flagship_pass(cams, vs, prior, cap, seed)
    finally:
        cols.contract_lookup = kernel
    return seen


def _device_kernels(prof):
    """name -> [device microseconds, count] over the device-side events."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        out[e.name][0] += e.device_time_total
        out[e.name][1] += 1
    return out


def _profile_pass(run, out_dir, tag, top):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
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
        for spec, tag in ((first, "first_init_pass"), (geom, "refine_iter_geom_pass")):
            _profile_pass(lambda: scene.process_problem(cache, problems[0], spec, (W, H), 0,
                                                        "cuda", num_views_pad=V),
                          args.out, tag, args.top)
        del cache

        images, depths, normals = synthetic.render_scene(cams, planes)
        tcams = geometry.make_cameras(
            np.stack([c.K for c in cams]), np.stack([c.R for c in cams]),
            np.stack([c.t for c in cams]), np.full(V, 1.2), np.full(V, 9.6), device="cuda")
        vs, prior, cap, _ = flagship_state(images, depths, normals, tcams)
        flagship_pass(tcams, vs, prior, cap, 0)
        _profile_pass(lambda: flagship_pass(tcams, vs, prior, cap, 1), args.out,
                      "flagship_apd_pass", args.top)
        del vs, prior
        torch.cuda.empty_cache()

        shutil.rmtree(folder, ignore_errors=True)
        W2, H2 = 1280, 960
        cams, planes = synthetic.make_ring_scene(num_views=V, width=W2, height=H2, focal=1600.0,
                                                 include_flat_region=True)
        synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
        scene.run_scene(folder, device="cuda", verbose=False)  # both rounds, state files
        problems = scene.generate_sample_list(folder)
        cache = scene.SceneCache(folder, expected_sets=len(problems))
        last = build_schedule(2)[-1]
        _profile_pass(lambda: scene.process_problem(cache, problems[0], last, (W2, H2), 0, "cuda",
                                                    num_views_pad=V),
                      args.out, "round1_geom_apd_pass_1280x960", args.top)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


if __name__ == "__main__":
    main()
