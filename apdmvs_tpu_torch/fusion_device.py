"""Depth-map fusion on the card: the ETH fusion of ``fusion.fuse_eth`` as
PyTorch tensor math on one device (reference RunFusion: APD.cpp:826-977).

The reference fuses on the CPU with sequential greedy dedup: views are
processed in order and each emitted point consumes its consistent source
pixels so later views cannot re-emit them (APD.cpp:955-959). That
cross-view chain is inherently sequential, but everything *inside* a view
is per-pixel parallel — so here a Python loop over reference views runs
dense whole-image math over H x W x J per step, and the consumed masks
[Nv, H*W + 1] (one sink slot a view for pixels that claim nothing) stay on
the device for the whole call. View order, and therefore the reference's
greedy semantics, is preserved exactly.

Same-view collisions (two raster pixels of one view claiming the same
source pixel) are resolved first-raster-pixel-wins by a scatter-min of the
raster index (``scatter_reduce_(..., "amin")``) — the same deterministic
rule as fusion.fuse_eth's vectorized backend. Consuming writes ``True``
only, at the claims of accepted pixels (the rest go to the sink slot), so
duplicate indices carry one value and the scatter is deterministic on the
card.

Float32 on the device vs float64 on the host: acceptance thresholds (2 px
reprojection, 1% depth, 10 deg normal) can flip for borderline pixels;
parity with the host backends is therefore at the decision level, not
bitwise.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from apdmvs_tpu_torch.params import PixelState
from apdmvs_tpu_torch.scene import resolve_device

_BIG = 2**31 - 1


class FusionArrays(NamedTuple):
    """Stacked per-view fusion inputs (all views at one resolution)."""

    K: torch.Tensor  # [Nv, 3, 3]
    R: torch.Tensor  # [Nv, 3, 3]
    t: torch.Tensor  # [Nv, 3]
    c: torch.Tensor  # [Nv, 3] camera centers
    depth: torch.Tensor  # [Nv, H, W]
    normal: torch.Tensor  # [Nv, H, W, 3]
    color: torch.Tensor  # [Nv, H, W, 3] f32 BGR
    factor: torch.Tensor  # [Nv, H, W] per-pixel acceptance factor
    valid0: torch.Tensor  # [Nv, H, W] depth>0 & block mask
    src_idx: torch.Tensor  # [Nv, J] int32, -1 padding


def pack_views(views, src_ids, device, weak_factor: float = 0.45,
               strong_factor: float = 0.3) -> FusionArrays:
    """Stack host FusionView structs into tensors on ``device``."""
    Nv = len(views)
    J = max((len(s) for s in src_ids), default=1) or 1
    src = np.full((Nv, J), -1, np.int32)
    for i, s in enumerate(src_ids):
        src[i, : len(s)] = s
    K = np.stack([v.K for v in views]).astype(np.float32)
    R = np.stack([v.R for v in views]).astype(np.float32)
    t = np.stack([v.t for v in views]).astype(np.float32)
    c = np.stack([v.c for v in views]).astype(np.float32)
    depth = np.stack([v.depth for v in views]).astype(np.float32)
    normal = np.stack([v.normal for v in views]).astype(np.float32)
    color = np.stack([v.image_bgr for v in views]).astype(np.float32)
    factor = np.full(depth.shape, strong_factor, np.float32)
    for i, v in enumerate(views):
        if v.weak is not None:
            factor[i] = np.where(v.weak == PixelState.WEAK, weak_factor, strong_factor)
    valid0 = depth > 0.0
    for i, v in enumerate(views):
        if v.block is not None:
            valid0[i] &= v.block >= 128

    def dev(a):
        return torch.as_tensor(a, device=device)

    return FusionArrays(
        K=dev(K), R=dev(R), t=dev(t), c=dev(c), depth=dev(depth), normal=dev(normal),
        color=dev(color), factor=dev(factor), valid0=dev(valid0), src_idx=dev(src),
    )


def _backproject_world(K, R, c, xs, ys, depth):
    """Get3DPointonWorld (APD.cpp:776-800)."""
    px = depth * (xs - K[0, 2]) / K[0, 0]
    py = depth * (ys - K[1, 2]) / K[1, 1]
    pts = torch.stack([px, py, depth], dim=-1)
    return pts @ R + c


def _project(K, R, t, X):
    """ProjectCamera (APD.cpp:802-812)."""
    xc = X @ R.T + t
    depth = xc @ K[2]
    px = (xc @ K[0]) / depth
    py = (xc @ K[1]) / depth
    return px, py, depth


def _angle(n1, n2):
    dot = torch.sum(n1 * n2, dim=-1)
    ang = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    return torch.where(torch.isnan(ang), 0.0, ang)


def fuse_eth_fields(fa: FusionArrays) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fusion program over the views in order. Returns per-view dense
    emission fields (accept [Nv, H, W], X [Nv, H, W, 3], color
    [Nv, H, W, 3], the colour not yet clipped)."""
    Nv, H, W = fa.depth.shape
    dev = fa.depth.device
    HW = H * W
    src = fa.src_idx.tolist()
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev), indexing="ij",
    )
    raster = (ys * W + xs).to(torch.int64)
    big = torch.full((H, W), _BIG, dtype=torch.int64, device=dev)
    sink = torch.full((H, W), HW, dtype=torch.int64, device=dev)
    masks = torch.zeros((Nv, HW + 1), dtype=torch.bool, device=dev)
    depth_flat = fa.depth.reshape(Nv, HW)
    normal_flat = fa.normal.reshape(Nv, HW, 3)
    color_flat = fa.color.reshape(Nv, HW, 3)
    accepts, Xs, colors = [], [], []
    for i in range(Nv):
        Ki, Ri, ti = fa.K[i], fa.R[i], fa.t[i]
        depth_i = fa.depth[i]
        valid = fa.valid0[i] & ~masks[i, :HW].view(H, W)
        X = _backproject_world(Ki, Ri, fa.c[i], xs, ys, depth_i)
        js = [j for j in src[i] if j >= 0]
        if not js:
            accepts.append(torch.zeros_like(valid))
            Xs.append(X)
            colors.append(fa.color[i])
            continue
        cons, scores, flats = [], [], []
        for j in js:
            px, py, _ = _project(fa.K[j], fa.R[j], fa.t[j], X)
            cc = torch.clamp((px + 0.5).to(torch.int32), 0, W - 1).to(torch.int64)
            rr = torch.clamp((py + 0.5).to(torch.int32), 0, H - 1).to(torch.int64)
            inb = (px + 0.5 >= 0) & (px + 0.5 < W) & (py + 0.5 >= 0) & (py + 0.5 < H)
            flat = rr * W + cc
            src_depth = depth_flat[j][flat]
            ok = inb & ~masks[j][flat] & (src_depth > 0.0)
            X2 = _backproject_world(fa.K[j], fa.R[j], fa.c[j], cc.float(), rr.float(),
                                    src_depth)
            bx, by, proj_depth = _project(Ki, Ri, ti, X2)
            err = torch.sqrt((xs - bx) ** 2 + (ys - by) ** 2)
            rel = torch.abs(proj_depth - depth_i) / torch.clamp(depth_i, min=1e-12)
            ang = _angle(fa.normal[i], normal_flat[j][flat])
            c_j = ok & (err < 2.0) & (rel < 0.01) & (ang < 0.174533) & valid
            cons.append(c_j)
            scores.append(torch.where(c_j, torch.exp(-(err + 200.0 * rel + 10.0 * ang)), 0.0))
            flats.append(flat)
        cons = torch.stack(cons)
        scores = torch.stack(scores)

        factor = fa.factor[i]
        num = cons.sum(dim=0)
        accept = valid & (num >= 1) & (scores.sum(dim=0) > factor * num)

        # same-view collision resolution, in source order: first raster pixel
        # wins a src pixel (scatter-min of the raster index, fusion.py's rule);
        # losers and non-claims scatter _BIG, which never wins
        for jj, flat in enumerate(flats):
            m = accept & cons[jj]
            order = torch.full((HW,), _BIG, dtype=torch.int64, device=dev)
            order.scatter_reduce_(0, flat.reshape(-1), torch.where(m, raster, big).reshape(-1),
                                  "amin")
            winner = (order[flat] == raster) & m
            cons[jj] = torch.where(m, winner, cons[jj])

        num = cons.sum(dim=0)
        dyn = torch.where(cons, scores, 0.0).sum(dim=0)
        accept = valid & (num >= 1) & (dyn > factor * num)

        # mark consumed source pixels (APD.cpp:955-959): True at the claims
        # of accepted pixels, every other lane into the sink slot
        csum = fa.color[i].clone()
        for jj, (j, flat) in enumerate(zip(js, flats)):
            m = accept & cons[jj]
            masks[j].index_fill_(0, torch.where(m, flat, sink).reshape(-1), True)
            # averaged BGR colour over {self} U consistent sources
            csum += torch.where(m[..., None], color_flat[j][flat], 0.0)
        accepts.append(accept)
        Xs.append(X)
        colors.append(csum / (num[..., None].to(torch.float32) + 1.0))
    return torch.stack(accepts), torch.stack(Xs), torch.stack(colors)


def fuse_eth_device(
    views: Sequence, src_ids: Sequence[Sequence[int]],
    weak_factor: float = 0.45, strong_factor: float = 0.3, device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Device fusion with fusion.fuse_eth's interface; requires all views
    at one resolution. Runs on the CUDA card unless ``device`` says
    otherwise (no card: raises); the emitted points are compacted on the
    device and copied to the host once."""
    if not all(v.depth.shape == views[0].depth.shape for v in views):
        raise ValueError("device fusion requires uniform depth-map shapes")
    device = resolve_device(device)
    fa = pack_views(views, src_ids, device, weak_factor, strong_factor)
    accepts, Xs, colors = fuse_eth_fields(fa)
    coords = Xs[accepts].cpu().numpy()
    cols = torch.clamp(colors[accepts], 0.0, 255.0).to(torch.uint8).cpu().numpy()
    if not len(coords):
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)
    return coords, cols
