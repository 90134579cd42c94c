"""Where one view-pass spends its time on the card.

    python -m apdmvs_tpu_torch.trace_pass [--out DIR]

Profiles, each under ``torch.profiler`` after a warm-up:

1. the 5-view 640x480 ring scene (the one-round scene ``chip_smoke.py``
   runs): one FIRST_INIT and one geometric REFINE_ITER view-pass of view 0;
2. the flagship pass of ``bench`` (bench.py:89-160): a REFINE_ITER pass
   with geometric consistency and the APD weak machinery on that scene,
   the prior from the ground truth and a 19200-pixel weak box;
3. the 1280x960 five-view scene with a textureless window that
   ``chip_smoke.py`` runs in two rounds: after the two rounds, the last
   geometric APD view-pass of view 0 again, image-volume builds included
   (five sets at that size exceed the volume cache).

Every pass here is the body, ``pipeline.patchmatch_pass_impl`` (the
sequential runner's ``eager``): its stage spans are what the ledger reads,
and a replay of the compiled pass records none.

For each it prints the wall time (host clock, ending in a device sync), the
device busy time (the union of kernel and copy intervals on the card) and
idle share over the device's window, the kernels that take the most device
time, with their launch counts, and then ``timeline``'s gap ledger of the
pass as one JSON line (busy and idle per ``apd.*`` stage, the longest gaps
with the stage and host operator around each). With ``--out`` it also
writes each pass's Chrome trace there.

Needs a CUDA card; the scenes are written under ``_trace_scene/`` in the
repository root and removed afterwards.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import tempfile
import time

import torch

from apdmvs_tpu_torch import geometry, ncc, rng, scene, timeline, weak
from apdmvs_tpu_torch.bench import (FLAGSHIP_CFG, FLAGSHIP_RTH, _sync, flagship_pass,
                                    flagship_scene, flagship_state)
from apdmvs_tpu_torch.datasets import synthetic
from apdmvs_tpu_torch.ops import cols
from apdmvs_tpu_torch.params import build_schedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, V = 640, 480, 5

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
    try:  # the body: a replay calls no wrapper
        flagship_pass(cams, vs, prior, cap, seed, eager=True)
    finally:
        cols.contract_lookup = kernel
    return seen


def profiled(run, path: str, top: int = 20, device="cuda"):
    """``run()`` on ``device`` under ``torch.profiler`` (as
    ``scene.run_scene(profile_dir=)`` records), its Chrome trace written to
    ``path``; returns (run's result, wall ms ending in a device synchronise,
    ``timeline``'s ledger of the trace)."""
    dev = torch.device(device)
    _sync(dev)
    with scene._profiler(dev) as prof:
        t0 = time.perf_counter()
        out = run()
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(path)
    return out, wall_ms, timeline.read(path, top=top)


def _profile_pass(run, out_dir, tag, top, device="cuda"):
    with tempfile.TemporaryDirectory() as tmp:
        _, wall_ms, led = profiled(run, os.path.join(out_dir or tmp, f"{tag}.json"), top,
                                   device)
    busy_ms = led["busy_ms"]
    print(f"{tag}: wall {wall_ms:.3f} ms, device busy "
          + (f"{busy_ms:.3f} ms of a {led['window_ms']:.3f} ms window (idle share "
             f"{led['idle_share']:.4f}), {led['device_events']} device events"
             if busy_ms else "not measured (no device events)"))
    for k in led["kernels"]:
        print(f"  {k['ms']:10.3f} ms {k['launches']:6d}x  {k['name']}")
    if not out_dir:  # the trace went with the temporary directory
        del led["trace"]
    print(json.dumps(dict(tag=tag, wall_ms=wall_ms, **led)))


def trace_flagship(out_dir, top: int, device="cuda", width: int = W, height: int = H,
                   views: int = V) -> None:
    """Part 2 of the module docstring: the flagship pass profiled after a
    warm-up, both the body."""
    images, depths, normals, tcams = flagship_scene(width, height, views, device)
    vs, prior, cap, _ = flagship_state(images, depths, normals, tcams)
    flagship_pass(tcams, vs, prior, cap, 0, eager=True)
    _profile_pass(lambda: flagship_pass(tcams, vs, prior, cap, 1, eager=True), out_dir,
                  "flagship_apd_pass", top, device)


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
            scene.process_problem(cache, p, first, (W, H), 0, "cuda", num_views_pad=V,
                                  eager=True)
        print(f"device: {torch.cuda.get_device_name(0)}; scene {V} views {W}x{H}, K=160")
        for spec, tag in ((first, "first_init_pass"), (geom, "refine_iter_geom_pass")):
            _profile_pass(lambda: scene.process_problem(cache, problems[0], spec, (W, H), 0,
                                                        "cuda", num_views_pad=V, eager=True),
                          args.out, tag, args.top)
        del cache

        trace_flagship(args.out, args.top)
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
                                                    num_views_pad=V, eager=True),
                      args.out, "round1_geom_apd_pass_1280x960", args.top)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


if __name__ == "__main__":
    main()
