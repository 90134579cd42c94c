"""The per-(view, pass) PatchMatch program (RunPatchMatch).

PyTorch counterpart of ``apdmvs_tpu/pipeline.py``. Stage order is the
reference's (APD.cu:2386-2495):

  [weak prep: worklist, anchors, reliability demotion, resident columns]
  RandomInitialization (FIRST_INIT) or recost of the loaded state
  for iter in range(max_iterations):
      rebase the volumes on the current depth
      strong black half-sweep ; strong red half-sweep
      [weak sweep: RANSAC fit planes, candidates, refinement]
  planes -> (world normal, depth)
  checkerboard median filter (black ; red)
  DepthToWeak reclassification
  LocalRefine

The weak stages (``weak.py``) run on passes with ``use_APD`` over a
worklist of the prior's WEAK pixels whose capacity the caller sizes
(``scene._bucket_capacity``).
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


def patchmatch_pass(
    cams: Cameras,  # ref depth range pre-scaled by 0.6/1.2 (APD.cpp:454-455)
    src_valid: torch.Tensor,  # [V] bool
    prior: PassState,
    draws,
    cfg: PassConfig,
    volumes: ncc.VolumeSet,  # image volumes (+ depth volumes on geom passes)
    weak_capacity: int = 0,
    ransac_threshold: float = 0.005,
) -> PassOutputs:
    """One full pass over one reference view. ``draws`` is a draw source
    (rng.py); ``volumes`` must carry D when ``cfg.geom_consistency``, and
    C36 and C9 when the pass runs the weak machinery (``cfg.use_APD`` and
    ``weak_capacity`` > 0)."""
    if cfg.geom_consistency and volumes.D is None:
        raise ValueError("a geometric pass needs depth volumes (ncc.add_depth_volumes)")
    H, W = prior.depth.shape
    ctx = ncc.make_context(cams, src_valid, H, W, volumes)
    depth_min = cams.depth_min[0]
    depth_max = cams.depth_max[0]
    pixel_state = prior.pixel_state
    if not cfg.use_APD:
        # no weak machinery this pass: everything STRONG (APD.cpp:540-548)
        pixel_state = torch.full((H, W), int(PixelState.STRONG), dtype=torch.uint8,
                                 device=cams.device)

    # weak prep. Anchor 3-D points use the prior depth, as the reference's
    # GenNeighbours runs before RandomInitialization (APD.cu:2415-2440);
    # anchors are fixed for the pass, so their volume columns are gathered once
    weak_xy = anchors = wcols = None
    if cfg.use_APD and weak_capacity > 0:
        weak_xy = weak.compact_weak_pixels(pixel_state, weak_capacity)
        anchors, pixel_state = weak.generate_anchors(
            ctx, prior.depth, pixel_state, weak_xy, draws, cfg, ransac_threshold)
        wcols = weak.build_weak_cols(ctx, weak_xy, anchors)

    def rebased(planes_):
        """Context with volumes rebased on planes_' depth: exact results,
        coalesced loads (ops/ncc_volume.py)."""
        d = geometry.depth_from_plane(cams.K[0], planes_, ctx.x, ctx.y)
        return ctx._replace(volumes=ncc.rebase_volume_set(volumes, d))

    # RandomInitialization (APD.cu:806-835)
    if cfg.state == RunState.FIRST_INIT:
        u_depth, g_normal = draws.init_plane()
        planes = hypotheses.random_plane(
            u_depth, g_normal, cams.K[0], ctx.x, ctx.y, ctx.dirs, depth_min, depth_max
        )
        # no rebase for the random seed: its depth field is per-pixel random
        costs, selected = ncc.initial_cost_and_views(
            ctx, planes, cfg.strong_radius, cfg.strong_increment, cfg.top_k
        )
    else:
        planes = geometry.depth_normal_to_planes(cams, prior.depth, prior.normal_world, H, W)
        costs, selected = ncc.recost_selected_views(
            rebased(planes), planes, prior.selected, cfg.strong_radius, cfg.strong_increment
        )

    V = ctx.num_views
    st = StrongState(
        planes=planes, costs=costs, selected=selected,
        view_weights=torch.zeros((V, H, W), dtype=torch.float32, device=cams.device),
    )
    for it in range(cfg.max_iterations):
        ctx_it = rebased(st.planes)
        st = propagation.propagate_strong_color(ctx_it, st, pixel_state, it, draws, cfg, 0)
        st = propagation.propagate_strong_color(ctx_it, st, pixel_state, it, draws, cfg, 1)
        if weak_xy is not None:
            st = weak.propagate_weak(ctx_it, st, pixel_state, weak_xy, anchors, it, draws, cfg,
                                     wcols)

    # readout: plane -> depth + world normal (APD.cu:1587-1602)
    depth, n_world = geometry.planes_to_depth_normal(cams, st.planes, H, W)
    planes_world = torch.cat([n_world, depth[..., None]], dim=-1)
    planes_world = filters.checkerboard_median_filter(planes_world, st.costs, pixel_state)
    new_state = classify.depth_to_weak(
        ctx, planes_world, st.selected, st.view_weights, cfg.weak_peak_radius, cfg
    )
    planes_world = classify.local_refine(ctx, planes_world, st.selected, st.view_weights, cfg)
    return PassOutputs(
        depth=planes_world[..., 3],
        normal_world=planes_world[..., :3],
        pixel_state=new_state,
        selected=st.selected,
        costs=st.costs,
    )


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
