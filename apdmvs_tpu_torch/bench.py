"""The flagship fixture: one definition of the 640x480x5-view ring scene
and of the pass that the port's tools run on it.

The flagship pass is one complete REFINE_ITER pass (strong checkerboard
propagation, the APD weak machinery, geometric consistency,
classification and refinement) over view 0 of the synthetic 5-view ring
scene at 640x480, compiled (``pipeline.patchmatch_pass``: on a card a CUDA
graph replayed). Its prior is the ground truth with a centred WEAK box of
H/4 x W/4 pixels, and its worklist capacity is the runner's bucket for
that box. ``trace_pass``, ``profile_stages``, ``quality_table``,
``ab_kernels`` and ``chip_smoke.py`` take the scene, state and pass from
here. Nothing here measures: the benchmark is ``python3 -m mvsbench.run``
(``BENCHMARK.json``).
"""

from __future__ import annotations

import subprocess
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
    body (``pipeline.patchmatch_pass_impl``), as a profile of the stages'
    host spans needs and as one CUDA graph cannot hold several devices'
    work."""
    H_, W_ = prior.depth.shape
    sv = torch.arange(cams.K.shape[0], device=cams.device) > 0
    spread = vs.spaced and len(set(vs.devices)) > 1
    run = pipeline.patchmatch_pass_impl if eager or spread else pipeline.patchmatch_pass
    return run(cams, sv, prior, rng.TorchDraws(seed, H_, W_, cams.device), FLAGSHIP_CFG, vs,
               weak_capacity=cap, ransac_threshold=FLAGSHIP_RTH, debug=debug)


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
