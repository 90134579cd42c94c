"""The per-(view, pass) PatchMatch program (RunPatchMatch).

PyTorch counterpart of ``apdmvs_tpu/pipeline.py``. Stage order is the
reference's (APD.cu:2386-2495):

  [weak prep: worklist, anchors, reliability demotion, resident columns]
  RandomInitialization (FIRST_INIT) or recost of the loaded state
  for iter in range(max_iterations):
      strong black half-sweep ; strong red half-sweep
      [weak sweep: RANSAC fit planes, candidates, refinement]
  planes -> (world normal, depth)
  checkerboard median filter (black ; red)
  DepthToWeak reclassification
  LocalRefine

The weak stages (``weak.py``) run on passes with ``use_APD`` over a
worklist of the prior's WEAK pixels whose capacity the caller sizes
(``scene._bucket_capacity``).

Two entries, as in the JAX package: :func:`patchmatch_pass_impl` is the
pass's body, run operator by operator from Python (the counterpart of
``apdmvs_tpu.pipeline.patchmatch_pass_impl``), and :func:`patchmatch_pass`
the compiled pass, the counterpart of its ``jax.jit`` with static ``cfg``,
``weak_capacity`` and ``debug``: on a card the body is captured once per
static key as a CUDA graph and replayed (``compiled.py``); on the CPU it
is the body.

Each stage runs inside a ``torch.profiler.record_function`` span named
``apd.<stage>`` (:data:`STAGES`), which a profiler run of the body records
(``scene.run_scene(profile_dir=)``, ``trace_pass``) and ``timeline`` reads
back; a span adds no synchronisation, and without an active profiler it
costs a few microseconds. A replay records no span.

Two paths compute the pass: the volume path (``volumes``: the plane-sweep
volumes and the kernels H1-H6) and the direct-warp path (``volumes``
None: the images, and the source views' depth maps on geometric passes,
warped in plain PyTorch as the reference package does off the TPU,
``ncc.py``).

A divergence of design, not of results: the reference rebases its volumes
on the current depth before the recost and every iteration
(``apdmvs_tpu/pipeline.py:122-168``), so its TPU kernels read a narrow band
of slices. The port's NCC kernel reads E by address (``ncc.py``) and
builds no rebased volume; the costs are the same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from apdmvs_tpu_torch import classify, filters, geometry, hypotheses, ncc, propagation, weak
from apdmvs_tpu_torch.geometry import Cameras
from apdmvs_tpu_torch.params import PassConfig, PixelState, RunState
from apdmvs_tpu_torch.propagation import StrongState


class PassState(NamedTuple):
    """Inter-pass persistent state (depths.dmb / normals.dmb / weak.bin /
    selected_views.bin, main.cpp:117-124, as tensors)."""

    depth: torch.Tensor  # [H, W] f32
    normal_world: torch.Tensor  # [H, W, 3] f32
    pixel_state: torch.Tensor  # [H, W] u8
    selected: torch.Tensor  # [V, H, W] bool


class PassOutputs(NamedTuple):
    depth: torch.Tensor
    normal_world: torch.Tensor
    pixel_state: torch.Tensor
    selected: torch.Tensor
    costs: torch.Tensor


class DebugProbes(NamedTuple):
    """The reference's compiled-out debug probes (main.h:42-43) as extra pass
    outputs: the weak worklist and its anchors (DEBUG_NEIGHBOUR,
    APD.cu:2421-2438) and DepthToWeak's disparity cost sweep
    (DEBUG_COST_LINE, APD.cu:2084-2091). ``debug.dump_probes`` writes them."""

    weak_xy: Optional[torch.Tensor]  # [N, 2] (x, y), -1 padding; None without the weak stages
    anchor_coords: Optional[torch.Tensor]  # [N, 9, 2], slot 0 the pixel itself
    sweep: torch.Tensor  # [61, H, W] clamped cost curves


#: the stage spans of a pass, ``apd.<stage>`` (``scripts/profile_stages.py``'s
#: stages): weak_prep is the worklist, anchors with their RANSAC and the
#: resident columns; init or recost seeds the planes; strong_black,
#: strong_red and weak_sweep run once an iteration
STAGES = ("weak_prep", "init", "recost", "strong_black", "strong_red", "weak_sweep", "readout",
          "median_filter", "depth_to_weak", "local_refine")


def _span(stage: str):
    """The span of one stage; ``profile_stages`` swaps this function for one
    that synchronises the device around each stage to time it."""
    return torch.profiler.record_function("apd." + stage)


def patchmatch_pass(
    cams: Cameras,
    src_valid: torch.Tensor,
    prior: PassState,
    draws,
    cfg: PassConfig,
    volumes=None,
    weak_capacity: int = 0,
    ransac_threshold=0.005,
    images: Optional[torch.Tensor] = None,
    depth_maps: Optional[torch.Tensor] = None,
    debug: bool = False,
):
    """The compiled pass: :func:`patchmatch_pass_impl`'s signature and
    results. On a CUDA device the body is captured once per static key
    (``compiled.static_key``: the device, the shapes, ``cfg``,
    ``weak_capacity``, ``debug``, the path and the volumes present) as a
    CUDA graph and replayed from static input slots (``compiled.py``); a
    capture or replay that fails raises with its key, and nothing runs the
    body eagerly in its place. A spaced volume set is captured when its
    slabs all lie on the pass's device; slabs on several devices are
    refused on a card (one graph holds one device's work): call
    :func:`patchmatch_pass_impl` for them. Each process of a
    ``torch.distributed`` run captures on its own device. On the CPU this
    is the body, since CUDA graphs are a CUDA feature."""
    if cams.device.type != "cuda":
        return patchmatch_pass_impl(cams, src_valid, prior, draws, cfg, volumes, weak_capacity,
                                    ransac_threshold, images, depth_maps, debug)
    from apdmvs_tpu_torch import compiled

    return compiled.run(cams, src_valid, prior, draws, cfg, volumes, weak_capacity,
                        ransac_threshold, images, depth_maps, debug)


def patchmatch_pass_impl(
    cams: Cameras,  # ref depth range pre-scaled by 0.6/1.2 (APD.cpp:454-455)
    src_valid: torch.Tensor,  # [V] bool
    prior: PassState,
    draws,
    cfg: PassConfig,
    volumes=None,  # VolumeSet or SpacedVolumeSet (+ depth volumes on geom passes)
    weak_capacity: int = 0,
    ransac_threshold=0.005,  # a number or a 0-d float32 tensor on the pass's device
    images: Optional[torch.Tensor] = None,  # [V, H, W], the direct-warp path's input
    depth_maps: Optional[torch.Tensor] = None,  # [V, H, W], its geometric passes' input
    debug: bool = False,
):
    """One full pass over one reference view, run operator by operator
    (the body that :func:`patchmatch_pass` captures; the entry for a
    profiler run, whose spans a replay would not record). ``draws`` is a
    draw source (rng.py). On the volume path ``volumes`` must carry D when
    ``cfg.geom_consistency``, and C36 and C9 when the pass runs the weak
    machinery (``cfg.use_APD`` and ``weak_capacity`` > 0). Without volumes
    the pass reads ``images`` and, when ``cfg.geom_consistency``,
    ``depth_maps`` (entry 0 unused); they are ignored on the volume path.
    ``volumes`` may be a spaced set (``ncc.build_volume_set_spaced``, slab 0
    on the pass's device): every grid evaluation then runs slab by slab and
    the weak columns are gathered per slab (``apdmvs_tpu/pipeline.py:112-116``),
    with the outputs of the unsharded set.

    With ``debug`` it returns ``(PassOutputs, DebugProbes)``: the probes are
    tensors the pass builds anyway, so ``debug`` changes what is returned,
    never what is computed (no extra draw, no extra launch)."""
    if volumes is None:
        if images is None:
            raise ValueError("a pass without volumes needs the images (the direct-warp path)")
        if cfg.geom_consistency and depth_maps is None:
            raise ValueError("a geometric pass without volumes needs the source depth maps")
        ctx_inputs = dict(images=images, depth_maps=depth_maps if cfg.geom_consistency else None)
    else:
        if cfg.geom_consistency and ncc.first_slab(volumes).D is None:
            raise ValueError("a geometric pass needs depth volumes (ncc.add_depth_volumes)")
        ctx_inputs = {}
    H, W = prior.depth.shape
    ctx = ncc.make_context(cams, src_valid, H, W, volumes, **ctx_inputs)
    depth_min = cams.depth_min[0]
    depth_max = cams.depth_max[0]
    pixel_state = prior.pixel_state
    if not cfg.use_APD:
        # no weak machinery this pass: everything STRONG (APD.cpp:540-548)
        pixel_state = torch.full((H, W), int(PixelState.STRONG), dtype=torch.uint8,
                                 device=cams.device)

    # weak prep. Anchor 3-D points use the prior depth, as the reference's
    # GenNeighbours runs before RandomInitialization (APD.cu:2415-2440);
    # anchors are fixed for the pass, so on the volume path their volume
    # columns are gathered once (C36 and C9 required: the volume path never
    # takes the direct warp)
    weak_xy = anchors = wcols = None
    if cfg.use_APD and weak_capacity > 0:
        with _span("weak_prep"):
            weak_xy = weak.compact_weak_pixels(pixel_state, weak_capacity)
            anchors, pixel_state = weak.generate_anchors(
                ctx, prior.depth, pixel_state, weak_xy, draws, cfg, ransac_threshold)
            if volumes is not None:
                wcols = weak.build_weak_cols(ctx, weak_xy, anchors)

    # RandomInitialization (APD.cu:806-835)
    if cfg.state == RunState.FIRST_INIT:
        with _span("init"):
            u_depth, g_normal = draws.init_plane()
            planes = hypotheses.random_plane(
                u_depth, g_normal, cams.K[0], ctx.x, ctx.y, ctx.dirs, depth_min, depth_max
            )
            costs, selected = ncc.initial_cost_and_views(
                ctx, planes, cfg.strong_radius, cfg.strong_increment, cfg.top_k
            )
    else:
        with _span("recost"):
            planes = geometry.depth_normal_to_planes(cams, prior.depth, prior.normal_world,
                                                     H, W)
            costs, selected = ncc.recost_selected_views(
                ctx, planes, prior.selected, cfg.strong_radius, cfg.strong_increment
            )

    V = ctx.num_views
    st = StrongState(
        planes=planes, costs=costs, selected=selected,
        view_weights=torch.zeros((V, H, W), dtype=torch.float32, device=cams.device),
    )
    for it in range(cfg.max_iterations):
        with _span("strong_black"):
            st = propagation.propagate_strong_color(ctx, st, pixel_state, it, draws, cfg, 0)
        with _span("strong_red"):
            st = propagation.propagate_strong_color(ctx, st, pixel_state, it, draws, cfg, 1)
        if weak_xy is not None:
            with _span("weak_sweep"):
                st = weak.propagate_weak(ctx, st, pixel_state, weak_xy, anchors, it, draws,
                                         cfg, wcols)

    # readout: plane -> depth + world normal (APD.cu:1587-1602)
    with _span("readout"):
        depth, n_world = geometry.planes_to_depth_normal(cams, st.planes, H, W)
        planes_world = torch.cat([n_world, depth[..., None]], dim=-1)
    with _span("median_filter"):
        planes_world = filters.checkerboard_median_filter(planes_world, st.costs, pixel_state)
    with _span("depth_to_weak"):
        new_state = classify.depth_to_weak(
            ctx, planes_world, st.selected, st.view_weights, cfg.weak_peak_radius, cfg,
            return_sweep=debug,
        )
    if debug:
        new_state, sweep = new_state
    with _span("local_refine"):
        planes_world = classify.local_refine(ctx, planes_world, st.selected, st.view_weights,
                                             cfg)
    out = PassOutputs(
        depth=planes_world[..., 3],
        normal_world=planes_world[..., :3],
        pixel_state=new_state,
        selected=st.selected,
        costs=st.costs,
    )
    if debug:
        return out, DebugProbes(weak_xy=weak_xy,
                                anchor_coords=None if anchors is None else anchors.coords,
                                sweep=sweep)
    return out


def clamp_outputs(out: PassOutputs, depth_min: float, depth_max: float) -> PassOutputs:
    """Out-of-range depths -> 0 and UNKNOWN (main.cpp:105-115)."""
    bad = (out.depth < depth_min) | (out.depth > depth_max)
    return out._replace(
        depth=torch.where(bad, 0.0, out.depth),
        pixel_state=torch.where(
            bad, torch.full_like(out.pixel_state, int(PixelState.UNKNOWN)), out.pixel_state
        ),
    )


def selected_to_bitmask(selected: np.ndarray) -> np.ndarray:
    """[V, H, W] bool -> int32 bitmask with bit (v-1) for camera v
    (APD.cu:42-55)."""
    V = selected.shape[0]
    out = np.zeros(selected.shape[1:], np.int64)
    for v in range(1, V):
        out |= selected[v].astype(np.int64) << (v - 1)
    return out.astype(np.int32)


def bitmask_to_selected(mask: np.ndarray, num_views: int) -> np.ndarray:
    out = np.zeros((num_views,) + mask.shape, bool)
    m = mask.astype(np.int64) & 0xFFFFFFFF
    for v in range(1, num_views):
        out[v] = (m >> (v - 1)) & 1
    return out
