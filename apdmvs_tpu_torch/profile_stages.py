"""Per-stage times of the flagship pass.

    python -m apdmvs_tpu_torch.profile_stages [--device cuda] [--width 640 --height 480
        --views 5] [--no-volumes]

The counterpart of ``scripts/profile_stages.py``. Runs ``bench``'s flagship
pass (``bench.flagship_scene``, ``flagship_state``, ``flagship_pass``: a
REFINE_ITER pass with geometric consistency and the APD weak machinery, the
prior from the ground truth with a centred WEAK box) once to warm up, then
3 passes with every stage (the ``apd.*`` spans of ``pipeline.STAGES``)
timed between two device synchronises, and 3 passes without them. Prints
one JSON line: per stage the least of the 3 passes' ms (a stage that runs
once an iteration is summed over the pass), ``pass_ms`` the least wall of
the passes without per-stage synchronises (ending in one), and the device
with its power limit (``bench.device_name``). ``--no-volumes`` runs the
pass on the direct-warp path (no volume, no kernel), as
``chip_smoke.py`` phase 12 does.

:func:`stage_timed` is what this module times with;
:func:`_stage_timed` times the functions of :data:`DIRECT_STAGES` the same
way (``chip_smoke.py`` phase 12).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import time

import torch

from apdmvs_tpu_torch import bench, pipeline, rng, scene

REPEATS = 3

#: the direct-warp pass's stages, by the module attribute the pass calls
DIRECT_STAGES = (("ncc", "initial_cost_and_views"), ("ncc", "recost_selected_views"),
                 ("weak", "generate_anchors"), ("propagation", "propagate_strong_color"),
                 ("weak", "propagate_weak"), ("classify", "depth_to_weak"),
                 ("classify", "local_refine"))


def _stage_timed(fn):
    """``fn`` timed per stage (a device synchronise before and after each
    call of a stage of DIRECT_STAGES); returns (fn's result, ms per stage)."""
    ms = {}
    saved = []
    for mod_name, attr in DIRECT_STAGES:
        mod = importlib.import_module(f"apdmvs_tpu_torch.{mod_name}")
        inner = getattr(mod, attr)

        def timed(*args, _inner=inner, _name=attr, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _inner(*args, **kwargs)
            torch.cuda.synchronize()
            ms[_name] = ms.get(_name, 0.0) + 1e3 * (time.perf_counter() - t0)
            return out

        saved.append((mod, attr, inner))
        setattr(mod, attr, timed)
    try:
        return fn(), ms
    finally:
        for mod, attr, inner in saved:
            setattr(mod, attr, inner)


def stage_timed(fn, device):
    """``fn`` with every ``apd.*`` span of the pass timed between two device
    synchronises (``device``'s; none on the CPU); returns (fn's result, ms
    per stage, summed over the stage's spans)."""
    ms = {}
    span = pipeline._span

    @contextlib.contextmanager
    def timed(stage):
        bench._sync(device)
        t0 = time.perf_counter()
        with span(stage):
            yield
        bench._sync(device)
        ms[stage] = ms.get(stage, 0.0) + 1e3 * (time.perf_counter() - t0)

    pipeline._span = timed
    try:
        return fn(), ms
    finally:
        pipeline._span = span


def measure(width: int = 640, height: int = 480, views: int = 5, device="cuda",
            use_volumes: bool = True) -> dict:
    """The JSON row of the module docstring."""
    dev = scene.resolve_device(device)
    images, depths, normals, cams = bench.flagship_scene(width, height, views, dev)
    if use_volumes:
        vs, prior, cap, _ = bench.flagship_state(images, depths, normals, cams)

        def run(seed):
            return bench.flagship_pass(cams, vs, prior, cap, seed)
    else:
        prior, cap = bench.flagship_prior(depths, normals, views, dev)
        sv = torch.arange(views, device=dev) > 0
        imgs, dms = torch.as_tensor(images, device=dev), torch.as_tensor(depths, device=dev)

        def run(seed):
            return pipeline.patchmatch_pass(
                cams, sv, prior, rng.TorchDraws(seed, height, width, dev), bench.FLAGSHIP_CFG,
                weak_capacity=cap, ransac_threshold=bench.FLAGSHIP_RTH, images=imgs,
                depth_maps=dms)

    run(0)  # warm-up
    stages, walls = {}, []
    for rep in range(REPEATS):
        _, ms = stage_timed(lambda: run(rep + 1), dev)
        for k, v in ms.items():
            stages[k] = min(stages.get(k, v), v)
    for rep in range(REPEATS):
        bench._sync(dev)
        t0 = time.perf_counter()
        run(rep + 1)
        bench._sync(dev)
        walls.append(1e3 * (time.perf_counter() - t0))
    return {"stages_ms": {k: stages[k] for k in pipeline.STAGES if k in stages},
            "pass_ms": min(walls), "repeats": REPEATS, "width": width, "height": height,
            "views": views, "volumes": use_volumes, "worklist": cap,
            "device": bench.device_name(dev)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="apdmvs_tpu_torch.profile_stages",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; with no card it fails)")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--no-volumes", action="store_true",
                    help="the direct-warp path: no volume, no kernel")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.width, args.height, args.views, args.device,
                             not args.no_volumes)))


if __name__ == "__main__":
    main()
