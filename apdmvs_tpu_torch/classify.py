"""Pixel-state classification (DepthToWeak) and local disparity refinement.

PyTorch counterpart of ``apdmvs_tpu/classify.py``:
- DepthToWeak (APD.cu:1990-2144): sweep 61 disparity steps around the
  current depth along the mean-baseline disparity, analyse the cost-curve
  peaks, classify each pixel STRONG / WEAK / UNKNOWN;
- LocalRefine (APD.cu:2146-2232): +-5 disparity polish of the depth,
  accepted when the cost improves by > 0.1.

The sweeps are evaluated in chunks of SWEEP_CHUNK candidates; each chunk's
NCC term goes through volumes rebased on the chunk's mid step
(ncc.sweep_cost_vector), its geometric term through the depth volumes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apdmvs_tpu_torch import geometry, ncc, sampling
from apdmvs_tpu_torch.ncc import COST_MAX, CostContext
from apdmvs_tpu_torch.params import PassConfig, PixelState

SWEEP_CHUNK = 8  # disparity steps per sweep evaluation (C=8)
_MIN_MARGIN = 6  # APD.cu:1998
_SWEEP_RADIUS = 30  # APD.cu:2055


def _weighted_sweep_cost(ctx, n_cam, depth, selected, view_weights, weight_norm, cfg):
    """Selected-view weighted NCC (+ geometric) cost of the plane with
    normal ``n_cam`` at ``depth`` per pixel (APD.cu:2069-2082)."""
    w = geometry.dist_to_origin(ctx.cams.K[0], ctx.x, ctx.y, depth, n_cam)
    plane = torch.cat([n_cam, w[..., None]], dim=-1)
    cv = ncc.cost_vector(ctx, plane, cfg.strong_radius, cfg.strong_increment)
    if cfg.geom_consistency:
        cv = cv + cfg.geom_factor * ncc.geom_cost_vector(ctx, plane)
    wsel = torch.where(selected, view_weights, 0.0)
    return torch.sum(wsel * cv, dim=0) / torch.clamp(weight_norm, min=1e-30)


def _weighted_sweep_costs_batched(ctx, n_cam, depths, selected, view_weights, weight_norm,
                                  cfg) -> torch.Tensor:
    """All S sweep depths [S, H, W] as chunked C=SWEEP_CHUNK evaluations.
    Returns the weighted costs [S, H, W]."""
    S = depths.shape[0]
    S_pad = ((S + SWEEP_CHUNK - 1) // SWEEP_CHUNK) * SWEEP_CHUNK
    if S_pad != S:
        depths = torch.cat([depths, depths[-1:].expand((S_pad - S,) + depths.shape[1:])])
    w = geometry.dist_to_origin(ctx.cams.K[0], ctx.x, ctx.y, depths, n_cam[None])
    planes = torch.cat([n_cam[None].expand(depths.shape + (3,)), w[..., None]], dim=-1)
    wsel = torch.where(selected, view_weights, 0.0)
    mid = SWEEP_CHUNK // 2
    out = []
    for c0 in range(0, S_pad, SWEEP_CHUNK):
        pl_chunk = planes[c0: c0 + SWEEP_CHUNK]
        cv = ncc.sweep_cost_vector(
            ctx, pl_chunk, depths[c0 + mid], cfg.strong_radius, cfg.strong_increment
        )
        if cfg.geom_consistency:
            cv = cv + cfg.geom_factor * ncc.geom_cost_vector(ctx, pl_chunk)
        out.append(torch.sum(wsel[:, None] * cv, dim=0)
                   / torch.clamp(weight_norm[None], min=1e-30))
    return torch.cat(out)[:S]


def _mean_baseline(ctx: CostContext, selected) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean camera-centre distance over each pixel's selected views and the
    selected count (APD.cu:2037-2052)."""
    d = ctx.cams.c - ctx.cams.c[0][None]
    dists = torch.sqrt(torch.sum(d * d, dim=-1))  # [V]
    cnt = torch.sum(selected, dim=0).to(torch.float32)
    total = torch.sum(torch.where(selected, dists[:, None, None], 0.0), dim=0)
    return total / torch.clamp(cnt, min=1.0), cnt


def _sweep_depths(ctx, baseline, origin_depth, radius: int):
    fx = ctx.cams.K[0, 0, 0]
    disp = fx * baseline / torch.where(origin_depth == 0, torch.ones_like(origin_depth),
                                       origin_depth)
    steps = torch.arange(-radius, radius + 1, dtype=torch.float32, device=disp.device)
    p_depths = fx * baseline[None] / (disp[None] + steps[:, None, None])
    in_range = (p_depths >= ctx.cams.depth_min[0]) & (p_depths <= ctx.cams.depth_max[0])
    return p_depths, in_range


def depth_to_weak(ctx: CostContext, planes_world, selected, view_weights,
                  weak_peak_radius: int, cfg: PassConfig) -> torch.Tensor:
    """Reclassify every pixel from its depth cost curve (APD.cu:1990-2144).
    planes_world: [H, W, 4] = (world normal, depth). Returns pixel_state u8."""
    H, W = ctx.height, ctx.width
    n_cam = geometry.normal_world_to_cam(ctx.cams.R[0], planes_world[..., :3])
    origin_depth = planes_world[..., 3]
    margin = (
        (ctx.x < _MIN_MARGIN) | (ctx.y < _MIN_MARGIN)
        | (ctx.x >= W - _MIN_MARGIN) | (ctx.y >= H - _MIN_MARGIN)
    )
    baseline, valid_cnt = _mean_baseline(ctx, selected)
    weight_norm = torch.sum(torch.where(selected, view_weights, 0.0), dim=0)
    p_depths, in_range = _sweep_depths(ctx, baseline, origin_depth, _SWEEP_RADIUS)
    raw = _weighted_sweep_costs_batched(
        ctx, n_cam, p_depths, selected, view_weights, weight_norm, cfg
    )
    p_costs = torch.where(in_range, torch.clamp(raw, max=COST_MAX), COST_MAX)  # [61, H, W]

    # peak analysis (APD.cu:2092-2142)
    S = 2 * _SWEEP_RADIUS + 1
    interior = p_costs[2: S - 2]
    is_peak = (p_costs[1: S - 3] > interior) & (p_costs[3: S - 1] > interior)
    pad = torch.zeros((2, H, W), dtype=torch.bool, device=is_peak.device)
    is_peak = torch.cat([pad, is_peak, pad])
    peak_count = torch.sum(is_peak, dim=0)
    peak_vals = torch.where(is_peak, p_costs, float("inf"))
    min_val = torch.min(peak_vals, dim=0).values
    min_peak = torch.where(min_val < COST_MAX, torch.argmin(peak_vals, dim=0), 0)
    min_cost = torch.clamp(min_val, max=COST_MAX)
    cost_at_min_peak = sampling.select_index(p_costs, min_peak)

    off_center = torch.abs(min_peak - _SWEEP_RADIUS) > weak_peak_radius
    weak_now = off_center | (cost_at_min_peak > 0.5)
    single_peak = peak_count == 1
    strong_single = cost_at_min_peak <= 0.15
    iota = torch.arange(S, device=p_costs.device).reshape(S, 1, 1)
    others = is_peak & (iota != min_peak[None])
    dev2 = p_costs - min_cost[None]
    var = torch.sqrt(torch.sum(torch.where(others, dev2 * dev2, 0.0), dim=0)) / torch.clamp(
        peak_count - 1, min=1).to(torch.float32)
    strong_multi = var > 0.2

    WEAK, STRONG = int(PixelState.WEAK), int(PixelState.STRONG)
    state = torch.where(
        weak_now, WEAK,
        torch.where(
            single_peak,
            torch.where(strong_single, STRONG, WEAK),
            torch.where(strong_multi, STRONG, WEAK),
        ),
    ).to(torch.uint8)
    unknown = margin | (origin_depth == 0) | (valid_cnt == 0)
    return torch.where(unknown, torch.full_like(state, int(PixelState.UNKNOWN)), state)


def local_refine(ctx: CostContext, planes_world, selected, view_weights,
                 cfg: PassConfig) -> torch.Tensor:
    """+-5 disparity depth polish (APD.cu:2146-2232): updates the depth
    channel where the swept cost beats the current cost by > 0.1."""
    n_cam = geometry.normal_world_to_cam(ctx.cams.R[0], planes_world[..., :3])
    origin_depth = planes_world[..., 3]
    baseline, valid_cnt = _mean_baseline(ctx, selected)
    weight_norm = torch.sum(torch.where(selected, view_weights, 0.0), dim=0)
    cost_now = _weighted_sweep_cost(
        ctx, n_cam, origin_depth, selected, view_weights, weight_norm, cfg
    )
    p_depths, in_range = _sweep_depths(ctx, baseline, origin_depth, 5)
    raw = _weighted_sweep_costs_batched(
        ctx, n_cam, p_depths, selected, view_weights, weight_norm, cfg
    )
    costs = torch.where(in_range, raw, COST_MAX)  # [11, H, W]
    best = torch.argmin(costs, dim=0)
    min_cost = sampling.select_index(costs, best)
    best_depth = sampling.select_index(p_depths, best)
    accept = (
        (cost_now - min_cost > 0.1) & (origin_depth != 0)
        & (weight_norm > 0) & (valid_cnt > 0)
    )
    out = planes_world.clone()
    out[..., 3] = torch.where(accept, best_depth, origin_depth)
    return out
