"""Red-black checkerboard PatchMatch propagation for strong-texture pixels.

PyTorch counterpart of the strong path of ``apdmvs_tpu/propagation.py``
(CheckerboardPropagationStrong: APD.cu:982-1321, red/black scheduling:
APD.cu:1547-1585, refinement: APD.cu:837-890):

- the "best pixel in strip" search is a running strict-< minimum over
  statically shifted cost maps per region (first minimum wins); every
  candidate offset has odd parity, so candidates always live in the other
  checkerboard colour and two masked half-sweeps reproduce the reference's
  in-place sweeps;
- Monte-Carlo joint view selection (APD.cu:1203-1259) counts the draws
  that land in each view's CDF bin.

Reference quirks kept as in the reference package: invalid candidate
regions contribute cost 0 to the view-selection statistics (the
``cost_array[8][32] = {2.0f}`` zero-fill), and pixels with zero view weight
keep their state instead of turning NaN.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from apdmvs_tpu_torch import geometry, hypotheses, ncc, sampling
from apdmvs_tpu_torch.ncc import CostContext
from apdmvs_tpu_torch.params import PassConfig, PixelState, RunState

INF = float("inf")
_F32_EPS = float(np.finfo(np.float32).eps)


def _region_offsets():
    """Candidate (dx, dy) strips of the 8 regions in the reference's scan
    order (APD.cu:1022-1199)."""
    regions = []
    r = [(0, -1)]  # 0: up_near
    for i in range(3):
        r += [(-(1 + i), -(2 + i)), (+(1 + i), -(2 + i))]
    regions.append(r)
    regions.append([(0, -(3 + 2 * i)) for i in range(11)])  # 1: up_far
    r = [(0, 1)]  # 2: down_near
    for i in range(3):
        r += [(-(1 + i), (2 + i)), (+(1 + i), (2 + i))]
    regions.append(r)
    regions.append([(0, (3 + 2 * i)) for i in range(11)])  # 3: down_far
    r = [(-1, 0)]  # 4: left_near
    for i in range(3):
        r += [(-(2 + i), -(1 + i)), (-(2 + i), +(1 + i))]
    regions.append(r)
    regions.append([(-(3 + 2 * i), 0) for i in range(11)])  # 5: left_far
    r = [(1, 0)]  # 6: right_near
    for i in range(3):
        r += [((2 + i), -(1 + i)), ((2 + i), +(1 + i))]
    regions.append(r)
    regions.append([((3 + 2 * i), 0) for i in range(11)])  # 7: right_far
    return regions


_REGIONS = _region_offsets()
_REACH = 23  # largest |offset| of any strip (far strips reach 3 + 2*10)


def checkerboard_candidates(costs: torch.Tensor):
    """Per region: the strip position with minimum current cost.

    costs: [H, W]. Returns (cand_x [8,H,W] int64, cand_y [8,H,W] int64,
    flag [8,H,W] bool); flag is the reference's base-offset bounds check
    (APD.cu:1022,1041,...). A strip with no in-bounds position returns the
    pixel itself."""
    H, W = costs.shape
    dev = costs.device
    P = _REACH
    padded = F.pad(costs[None, None], (P, P, P, P), value=INF)[0, 0]
    y, x = torch.meshgrid(
        torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij"
    )
    cand_x, cand_y, flags = [], [], []
    for offs in _REGIONS:
        best = torch.full((H, W), INF, dtype=costs.dtype, device=dev)
        bdx = torch.zeros((H, W), dtype=torch.int64, device=dev)
        bdy = torch.zeros((H, W), dtype=torch.int64, device=dev)
        for dx, dy in offs:
            c = padded[P + dy: P + dy + H, P + dx: P + dx + W]
            better = c < best
            best = torch.where(better, c, best)
            bdx = torch.where(better, dx, bdx)
            bdy = torch.where(better, dy, bdy)
        cand_x.append(x + bdx)
        cand_y.append(y + bdy)
        bx, by = offs[0]
        flags.append(((x + bx) >= 0) & ((x + bx) < W) & ((y + by) >= 0) & ((y + by) < H))
    return torch.stack(cand_x), torch.stack(cand_y), torch.stack(flags)


def neighbor_view_priors(selected, near_flags, src_valid) -> torch.Tensor:
    """View-selection priors from the 4-neighbourhood's selected views
    (APD.cu:1208-1222): +0.9 per neighbour that selected the view, +0.1 per
    neighbour that did not. selected: [V,H,W] bool; near_flags: [4,H,W]."""
    sel_hwv = selected.permute(1, 2, 0).to(torch.float32)
    priors = torch.zeros(selected.shape, dtype=torch.float32, device=selected.device)
    for i, (dx, dy) in enumerate([(0, -1), (0, 1), (-1, 0), (1, 0)]):
        nb = sampling.shift2d(sel_hwv, dx, dy, 0.0).permute(2, 0, 1)
        contrib = torch.where(nb > 0.5, 0.9, 0.1)
        priors = priors + torch.where(near_flags[i][None], contrib, 0.0)
    return priors * src_valid[:, None, None]


def joint_view_selection(cost_array, priors, iter_idx: int, u) -> Tuple[torch.Tensor, ...]:
    """Monte-Carlo joint view selection (APD.cu:1224-1271).

    cost_array: [8, V, H, W]; priors: [V, H, W]; u: [S, H, W] uniform draws
    in [0, 1). Returns (view_weights [V,H,W] counts, weight_norm [H,W],
    temp_selected [V,H,W] bool)."""
    it = torch.tensor(float(iter_idx), dtype=torch.float32, device=cost_array.device)
    thr = 0.8 * torch.exp(it ** 2 / -90.0)
    good = cost_array < thr
    count = torch.sum(good, dim=0).to(torch.float32)
    count_false = torch.sum(cost_array > 1.2, dim=0)
    tmpw = torch.sum(torch.where(good, torch.exp(cost_array ** 2 / -0.18), 0.0), dim=0)
    probs = torch.where(
        (count > 2) & (count_false < 3),
        tmpw / torch.clamp(count, min=1.0),
        torch.where(count_false < 3, torch.exp(thr ** 2 / -0.32), 0.0),
    )
    probs = probs * priors
    cum = torch.cumsum(probs, dim=0)
    total = cum[-1]
    cdf = cum / torch.clamp(total, min=1e-30)
    cdf = torch.where(total[None] > 0.0, cdf, 0.0)
    u = u - _F32_EPS
    below = torch.sum((cdf[:, None] > u[None]).to(torch.float32), dim=1)  # [V, H, W]
    weights = below - torch.cat([torch.zeros_like(below[:1]), below[:-1]], dim=0)
    weight_norm = torch.sum(weights, dim=0)
    return weights, weight_norm, weights > 0.0


def _weighted(cost_vec, weights, weight_norm):
    return torch.sum(weights * cost_vec, dim=0) / torch.clamp(weight_norm, min=1e-30)


class StrongState(NamedTuple):
    planes: torch.Tensor  # [H, W, 4] (ref-cam normal + dist-to-origin)
    costs: torch.Tensor  # [H, W]
    selected: torch.Tensor  # [V, H, W] bool
    view_weights: torch.Tensor  # [V, H, W] f32 (persistent MC counts)


def propagate_strong_color(ctx: CostContext, st: StrongState, pixel_state, iter_idx: int,
                           draws, cfg: PassConfig, color: int) -> StrongState:
    """One half-sweep (one checkerboard colour) of strong-pixel propagation.
    color 0 = "black" ((x+y) even), 1 = "red". Updates only non-WEAK pixels
    of that colour. ``draws`` is a draw source (rng.py)."""
    H, W = ctx.height, ctx.width
    r, inc = cfg.strong_radius, cfg.strong_increment
    planes, costs, selected, vw_store = st
    K0 = ctx.cams.K[0]
    depth_min = ctx.cams.depth_min[0]
    depth_max = ctx.cams.depth_max[0]

    cand_x, cand_y, flags = checkerboard_candidates(costs)
    x_i = ctx.x.to(torch.int64)
    y_i = ctx.y.to(torch.int64)
    moved = (cand_x != x_i[None]) | (cand_y != y_i[None])
    flat = planes.reshape(-1, 4)
    idx = cand_y.clamp(0, H - 1) * W + cand_x.clamp(0, W - 1)
    cand_planes = torch.where(moved[..., None], flat[idx], 0.0)  # [8, H, W, 4]

    # the 8 candidates + the current plane in one C=9 evaluation
    cv9 = ncc.cost_vector(ctx, torch.cat([cand_planes, planes[None]], dim=0), r, inc)
    cost_array = cv9[:, :8].transpose(0, 1)  # [8, V, H, W]
    cost_vec_now = cv9[:, 8]
    cost_array = torch.where(flags[:, None], cost_array, 0.0)

    near_flags = flags[[0, 2, 4, 6]]
    priors = neighbor_view_priors(selected, near_flags, ctx.src_valid)
    weights, weight_norm, temp_sel = joint_view_selection(
        cost_array, priors, iter_idx, draws.view_selection(iter_idx, color)
    )

    final_costs = torch.sum(weights[None] * cost_array, dim=1) / torch.clamp(
        weight_norm[None], min=1e-30
    )  # [8, H, W]
    min_idx = torch.argmin(final_costs, dim=0)
    cost_now = _weighted(cost_vec_now, weights, weight_norm)
    cost_pre = cost_now  # reference: costs[center] = cost_now (APD.cu:1295)

    best_flag = sampling.select_index(flags, min_idx)
    best_cost = sampling.select_index(final_costs, min_idx)
    best_plane = sampling.select_index(cand_planes, min_idx)
    depth_before = geometry.depth_from_plane(K0, best_plane, ctx.x, ctx.y)
    adopt = (
        best_flag & (depth_before >= depth_min) & (depth_before <= depth_max)
        & (best_cost < cost_now)
    )
    plane_now = torch.where(adopt[..., None], best_plane, planes)
    cost_now = torch.where(adopt, best_cost, cost_now)
    sel_now = torch.where(adopt[None], temp_sel, selected)

    # refinement: argmin over {current} U {5 perturbed combos}
    cur_depth = geometry.depth_from_plane(K0, plane_now, ctx.x, ctx.y)
    u_depth, g_normal, u_pert, u_angles = draws.refinement(iter_idx, color)
    depths5, normals5 = hypotheses.refinement_combos(
        u_depth, g_normal, u_pert, u_angles, K0, ctx.x, ctx.y, ctx.dirs,
        plane_now[..., :3], cur_depth, depth_min, depth_max,
    )
    w5 = geometry.dist_to_origin(K0, ctx.x, ctx.y, depths5, normals5)
    planes5 = torch.cat([normals5, w5[..., None]], dim=-1)  # [5, H, W, 4]
    # combos 0-2 carry a per-pixel random depth or normal, combos 3-4 stay
    # near the current estimate; the reference evaluates them with its full-K
    # and rebased kernels, which compute the same costs that H2 does from E
    cv_b = ncc.cost_vector(ctx, planes5[3:5], r, inc)
    cv_r = ncc.cost_vector(ctx, planes5[0:3], r, inc)
    cv5 = torch.cat([cv_r, cv_b], dim=1)  # [V, 5, H, W]
    c5 = torch.sum(weights[:, None] * cv5, dim=0) / torch.clamp(weight_norm[None], min=1e-30)
    d_chk = geometry.depth_from_plane(K0, planes5, ctx.x, ctx.y)
    c5 = torch.where((d_chk >= depth_min) & (d_chk <= depth_max), c5, INF)
    all_costs = torch.cat([cost_now[None], c5], dim=0)
    best_i = torch.argmin(all_costs, dim=0)
    cost_now = sampling.select_index(all_costs, best_i)
    plane_now = sampling.select_index(torch.cat([plane_now[None], planes5], dim=0), best_i)

    # acceptance by run state (APD.cu:1311-1320)
    if cfg.state == RunState.REFINE_INIT:
        accept = cost_now < cost_pre - 0.1
        plane_final = torch.where(accept[..., None], plane_now, planes)
        cost_final = torch.where(accept, cost_now, cost_pre)
    else:
        plane_final, cost_final = plane_now, cost_now

    parity = (x_i + y_i) % 2
    processed = (parity == color) & (pixel_state != PixelState.WEAK)
    upd = processed & (weight_norm > 0)
    return StrongState(
        planes=torch.where(upd[..., None], plane_final, planes),
        costs=torch.where(upd, cost_final, costs),
        selected=torch.where(upd[None], sel_now, selected),
        view_weights=torch.where(processed[None], weights, vw_store),
    )
