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

from typing import List, NamedTuple, Optional, Sequence, Tuple

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


def _rows_times(pts, M):
    """pts [..., 3] @ M [3, 3] as elementwise products and sums, so every
    element rounds the same whatever the shape of ``pts`` (a row block of a
    mesh shard or the whole image)."""
    return pts[..., 0:1] * M[0] + pts[..., 1:2] * M[1] + pts[..., 2:3] * M[2]


def _backproject_world(K, R, c, xs, ys, depth):
    """Get3DPointonWorld (APD.cpp:776-800)."""
    px = depth * (xs - K[0, 2]) / K[0, 0]
    py = depth * (ys - K[1, 2]) / K[1, 1]
    pts = torch.stack([px, py, depth], dim=-1)
    return _rows_times(pts, R) + c


def _project(K, R, t, X):
    """ProjectCamera (APD.cpp:802-812)."""
    xc = _rows_times(X, R.T) + t
    kc = _rows_times(xc, K.T)
    depth = kc[..., 2]
    return kc[..., 0] / depth, kc[..., 1] / depth, depth


def _angle(n1, n2):
    dot = n1[..., 0] * n2[..., 0] + n1[..., 1] * n2[..., 1] + n1[..., 2] * n2[..., 2]
    ang = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    return torch.where(torch.isnan(ang), 0.0, ang)


class _Shard(NamedTuple):
    """One row block [r0, r1) of every view, on the device of ``fa`` (the
    fields, replicated: the sources are read at any pixel)."""

    fa: FusionArrays
    r0: int
    r1: int
    xs: torch.Tensor  # [r1 - r0, W] f32
    ys: torch.Tensor
    raster: torch.Tensor  # [r1 - r0, W] int64 global raster index


def _make_shards(fas: Sequence[FusionArrays], bounds) -> List[_Shard]:
    W = fas[0].depth.shape[2]
    shards = []
    for fa, (r0, r1) in zip(fas, bounds):
        dev = fa.depth.device
        ys, xs = torch.meshgrid(
            torch.arange(r0, r1, dtype=torch.float32, device=dev),
            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij",
        )
        shards.append(_Shard(fa, r0, r1, xs, ys, (ys * W + xs).to(torch.int64)))
    return shards


def _fuse_shards(shards: Sequence[_Shard], pixel_counts: Optional[Sequence[int]] = None):
    """The fusion program over the views in order, each view's pixel work
    split over the row blocks of ``shards``. Every shard keeps the consumed
    masks of its own rows; a view step reads the whole masks, combines the
    shards' scatter-min of the raster index over their claims with an
    elementwise minimum (so the first raster pixel of the whole image wins)
    and their claims with an elementwise OR.

    ``pixel_counts`` None: the shards are the whole image and nothing is
    exchanged between processes, whether or not a process group is up.
    Otherwise other processes hold the rest of the rows, ``pixel_counts``
    pixels each in rank order, and every view step exchanges the masks,
    the minimum and the OR through ``parallel.multihost`` (a collective).
    Returns per shard (accept [Nv, h, W], X [Nv, h, W, 3], colour
    [Nv, h, W, 3]) over its h rows, the colour not yet clipped."""
    if pixel_counts is None:
        def gather(local):
            return local
        reduce_min_ = reduce_or_ = gather
    else:
        from apdmvs_tpu_torch.parallel import multihost

        def gather(local):
            return multihost.all_gather_rows(local.T.contiguous(), pixel_counts).T
        reduce_min_, reduce_or_ = multihost.all_reduce_min_, multihost.all_reduce_or_

    fa0 = shards[0].fa
    Nv, H, W = fa0.depth.shape
    HW = H * W
    home = fa0.depth.device
    src = fa0.src_idx.tolist()
    masks = [torch.zeros((Nv, (sh.r1 - sh.r0) * W), dtype=torch.bool, device=sh.fa.depth.device)
             for sh in shards]
    out = [([], [], []) for _ in shards]
    for i in range(Nv):
        full = gather(masks[0] if len(masks) == 1
                      else torch.cat([m.to(home) for m in masks], dim=1))  # [Nv, HW]
        js = [j for j in src[i] if j >= 0]
        steps = []
        for sh in shards:
            fa = sh.fa
            full_d = full.to(fa.depth.device)
            rows = slice(sh.r0, sh.r1)
            depth_i = fa.depth[i, rows]
            valid = fa.valid0[i, rows] & ~full_d[i, sh.r0 * W:sh.r1 * W].view(-1, W)
            X = _backproject_world(fa.K[i], fa.R[i], fa.c[i], sh.xs, sh.ys, depth_i)
            cons, scores, flats = [], [], []
            for j in js:
                px, py, _ = _project(fa.K[j], fa.R[j], fa.t[j], X)
                cc = torch.clamp((px + 0.5).to(torch.int32), 0, W - 1).to(torch.int64)
                rr = torch.clamp((py + 0.5).to(torch.int32), 0, H - 1).to(torch.int64)
                inb = (px + 0.5 >= 0) & (px + 0.5 < W) & (py + 0.5 >= 0) & (py + 0.5 < H)
                flat = rr * W + cc
                src_depth = fa.depth[j].reshape(HW)[flat]
                ok = inb & ~full_d[j][flat] & (src_depth > 0.0)
                X2 = _backproject_world(fa.K[j], fa.R[j], fa.c[j], cc.float(), rr.float(),
                                        src_depth)
                bx, by, proj_depth = _project(fa.K[i], fa.R[i], fa.t[i], X2)
                err = torch.sqrt((sh.xs - bx) ** 2 + (sh.ys - by) ** 2)
                rel = torch.abs(proj_depth - depth_i) / torch.clamp(depth_i, min=1e-12)
                ang = _angle(fa.normal[i, rows], fa.normal[j].reshape(HW, 3)[flat])
                c_j = ok & (err < 2.0) & (rel < 0.01) & (ang < 0.174533) & valid
                cons.append(c_j)
                scores.append(torch.where(c_j, torch.exp(-(err + 200.0 * rel + 10.0 * ang)), 0.0))
                flats.append(flat)
            accept = valid & (_count(cons) >= 1) & (_total(scores) > fa.factor[i, rows]
                                                    * _count(cons))
            steps.append((valid, X, cons, scores, flats, accept))
        if not js:
            for (valid, X, *_), sh, o in zip(steps, shards, out):
                for field, v in zip(o, (torch.zeros_like(valid), X, sh.fa.color[i, sh.r0:sh.r1])):
                    field.append(v)
            continue

        # same-view collisions, in source order: the first raster pixel of
        # the whole image wins a source pixel (scatter-min of the raster
        # index, fusion.py's rule); losers and non-claims scatter _BIG
        order = None
        for (valid, X, cons, scores, flats, accept), sh in zip(steps, shards):
            o = torch.full((len(js), HW), _BIG, dtype=torch.int64, device=sh.raster.device)
            for jj, flat in enumerate(flats):
                m = accept & cons[jj]
                o[jj].scatter_reduce_(0, flat.reshape(-1),
                                      torch.where(m, sh.raster, _BIG).reshape(-1), "amin")
            order = o.to(home) if order is None else torch.minimum(order, o.to(home))
        reduce_min_(order)

        claims = None
        for (valid, X, cons, scores, flats, accept), sh, o in zip(steps, shards, out):
            fa = sh.fa
            order_d = order.to(fa.depth.device)
            for jj, flat in enumerate(flats):
                m = accept & cons[jj]
                cons[jj] = torch.where(m, (order_d[jj][flat] == sh.raster) & m, cons[jj])
            num = _count(cons)
            dyn = _total([torch.where(c, sc, 0.0) for c, sc in zip(cons, scores)])
            accept = valid & (num >= 1) & (dyn > fa.factor[i, sh.r0:sh.r1] * num)
            # the claims of accepted pixels (APD.cpp:955-959), every other
            # lane into a sink slot; the colour averaged over {self} U
            # consistent sources
            c = torch.zeros((len(js), HW + 1), dtype=torch.bool, device=fa.depth.device)
            csum = fa.color[i, sh.r0:sh.r1].clone()
            for jj, (j, flat) in enumerate(zip(js, flats)):
                m = accept & cons[jj]
                c[jj].index_fill_(0, torch.where(m, flat, HW).reshape(-1), True)
                csum += torch.where(m[..., None], fa.color[j].reshape(HW, 3)[flat], 0.0)
            claims = c[:, :HW].to(home) if claims is None else claims | c[:, :HW].to(home)
            for field, v in zip(o, (accept, X, csum / (num[..., None].to(torch.float32) + 1.0))):
                field.append(v)
        reduce_or_(claims)
        for m, sh in zip(masks, shards):
            own = claims[:, sh.r0 * W:sh.r1 * W].to(m.device)
            for jj, j in enumerate(js):
                m[j] |= own[jj]
    return [tuple(torch.stack(field) for field in o) for o in out]


def _count(cons) -> torch.Tensor:
    """The number of true masks per pixel, summed in source order."""
    n = torch.zeros(cons[0].shape, dtype=torch.int64, device=cons[0].device) if cons else 0
    for c in cons:
        n = n + c
    return n


def _total(vals) -> torch.Tensor:
    """The sum of float fields per pixel, in source order."""
    t = torch.zeros_like(vals[0]) if vals else 0.0
    for v in vals:
        t = t + v
    return t


def fuse_eth_fields(fa: FusionArrays) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fusion program over the views in order on one device. Returns
    per-view dense emission fields (accept [Nv, H, W], X [Nv, H, W, 3],
    color [Nv, H, W, 3], the colour not yet clipped)."""
    (fields,) = _fuse_shards(_make_shards([fa], [(0, fa.depth.shape[1])]))
    return fields


def _row_bounds(H: int, shards: int):
    """Row blocks [r0, r1) of ceil(H / shards) rows (the last ones may be
    short or empty)."""
    hs = -(-H // shards)
    return [(min(g * hs, H), min((g + 1) * hs, H)) for g in range(shards)]


def fuse_eth_device(
    views: Sequence, src_ids: Sequence[Sequence[int]],
    weak_factor: float = 0.45, strong_factor: float = 0.3, device="cuda", mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Device fusion with fusion.fuse_eth's interface; requires all views
    at one resolution. Runs on the CUDA card unless ``device`` says
    otherwise (no card: raises); the emitted points are compacted on the
    device and copied to the host once.

    ``mesh`` (``parallel.make_mesh``; ``apdmvs_tpu/fusion_device.py:219-296``)
    row-shards each view's pixel work and the consumed masks over the
    devices of this process's first view row, and over the processes in
    rank order (a collective: every process calls it). The view loop stays
    in order, each shard reads the replicated source fields, and the
    shards' claims combine as one image's would: the output equals the
    one-device call's exactly, on every process."""
    if not all(v.depth.shape == views[0].depth.shape for v in views):
        raise ValueError("device fusion requires uniform depth-map shapes")
    H, W = views[0].depth.shape
    if mesh is None:
        fa = pack_views(views, src_ids, resolve_device(device), weak_factor, strong_factor)
        shards, counts = _make_shards([fa], [(0, H)]), None
    else:
        from apdmvs_tpu_torch.parallel import multihost

        devs = mesh.devices[mesh.local_rows()[0]]
        world, me = multihost.world_size(), multihost.rank()
        bounds = _row_bounds(H, world * len(devs))
        packed = {}
        fas = [packed.setdefault(d, pack_views(views, src_ids, resolve_device(d), weak_factor,
                                               strong_factor)) for d in devs]
        shards = _make_shards(fas, bounds[me * len(devs):(me + 1) * len(devs)])
        counts = [W * (bounds[(p + 1) * len(devs) - 1][1] - bounds[p * len(devs)][0])
                  for p in range(world)]
    fields = _fuse_shards(shards, counts)
    home = shards[0].fa.depth.device
    # this process's rows of every view, each view in raster order
    accept, X, color = (fields[0][k] if len(fields) == 1
                        else torch.cat([f[k].to(home) for f in fields], dim=1) for k in range(3))
    coords = X[accept].cpu().numpy()
    colors = torch.clamp(color[accept], 0.0, 255.0).to(torch.uint8).cpu().numpy()
    if counts is not None and len(counts) > 1:  # every process's rows, view by view
        cuts = np.cumsum(accept.sum(dim=(1, 2)).cpu().numpy())[:-1]
        parts = multihost.all_gather_objects((np.split(coords, cuts), np.split(colors, cuts)))
        coords, colors = (np.concatenate([part[k][v] for v in range(len(views))
                                          for part in parts]) for k in range(2))
    return coords, colors
