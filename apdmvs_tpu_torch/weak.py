"""Weak-texture (APD) machinery: anchors, RANSAC planes, deformed NCC.

PyTorch counterpart of ``apdmvs_tpu/weak.py``, the paper's adaptive patch
deformation for textureless regions:

- FindNearestStrongPoint (APD.cu:2234-2270): jump flooding over the grid,
  then the reference's |dx|, |dy| <= 100 acceptance box.
- GenNeighbours (APD.cu:1750-1969): 8 x rotate_time probe directions
  marched over ``radius_schedule`` with jittered rays; non-STRONG landings
  snap to the nearest strong pixel; the first hit inside the angular cone
  is kept. A 50-triangle RANSAC over the hits picks the anchor plane, and
  the 8 inliers nearest it become the anchors. Pixels without a reliable
  plane are demoted to UNKNOWN (NeigbourUpdate, APD.cu:1971-1987).
- RANSACToGetFitPlane (APD.cu:2272-2384): per-iteration plane fit over the
  anchors' current 3-D points.
- ComputeBilateralNCCNew (APD.cu:400-528): deformed NCC = 0.25 * centre
  patch + 0.75 * mean of the anchor patches, all at the candidate plane's
  depth. On the volume path it reads the per-pass resident columns of the
  cost volumes C36 and C9 (``ops/cols.py``: H5 gathers them, H6 looks them
  up); without volumes every patch is warped directly
  (``ncc.ncc_cost_view`` in point mode). The reference package's third
  branch, C36 and C9 without resident columns, reads the cost volumes
  point by point (``ncc.point_cost_volume``); no pass of the port takes
  it.
- CheckerboardPropagationWeak (APD.cu:1323-1508): candidates are the 8
  anchors' planes (STRONG anchors only), then the fit plane, the random
  refinement and the plain-NCC cost rewrite.

All weak-pixel work runs over a compacted worklist [N] of WEAK pixels in
raster order, padded with -1. Random numbers come from a draw source
(``rng.py``). On a spaced volume set (``parallel/spaced.py``) the resident
columns are gathered slab by slab and combined on the pass's device
(:func:`_build_weak_cols_spaced`); everything after that is unchanged.

One deliberate divergence: the reference package scatters worklist
results with ``.at[iy, ix].set(..., mode="drop")`` and -1 for "no write",
but JAX wraps negative indices before dropping, so every such entry writes
pixel (H-1, W-1). Here only the pixels that are meant to change are
written (the CUDA reference writes only weak pixels).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from apdmvs_tpu_torch import geometry, hypotheses, ncc, sampling
from apdmvs_tpu_torch.ncc import COST_MAX, GEOM_COST_MAX, CostContext
from apdmvs_tpu_torch.ops import cols as colsmod, ncc_volume
from apdmvs_tpu_torch.ops.ncc_volume import fma
from apdmvs_tpu_torch.params import NEIGHBOUR_NUM, PassConfig, PixelState, RunState
from apdmvs_tpu_torch.propagation import StrongState, joint_view_selection

_MIN_MARGIN = 6  # APD.cu:1765
_NEAREST_RADIUS = 100  # APD.cu:2250
_RANSAC_ITERS = 50  # APD.cu:1880, 2316
_RANSAC_CHUNK = 10  # triangles drawn per step; folded in draw order
_RANSAC_STEPS = _RANSAC_ITERS // _RANSAC_CHUNK
_NUM_ANCHORS = NEIGHBOUR_NUM - 1  # 8
_JITTERS_PER_RADIUS = 2  # the reference uses 4 (APD.cu:1812); see radius_schedule
# Max gap between probe radii: a landing snaps to the nearest STRONG pixel
# within a +-100 px box (APD.cu:1822-1828), whose reach along the ray is
# >= 70 px a side, so 125 px steps leave no strong region unreachable.
_MAX_RADIUS_GAP = 125


def radius_schedule(width: int, height: int) -> Tuple[int, ...]:
    """Probe radii equivalent in coverage to the reference march: its
    doubling phase r = 2, min(2r, r + 25) up to 107, then steps of
    _MAX_RADIUS_GAP, capped at the image diagonal (the reference breaks at
    the image boundary, APD.cu:1808-1812)."""
    limit = min(4096, int(math.hypot(width, height)))
    radii = []
    r = 2
    while r <= limit and r < 125:
        radii.append(r)
        r = min(2 * r, r + 25)
    last = radii[-1] if radii else 2
    radii.extend(range(last + _MAX_RADIUS_GAP, limit + 1, _MAX_RADIUS_GAP))
    return tuple(radii)


def compact_weak_pixels(pixel_state: torch.Tensor, capacity: int) -> torch.Tensor:
    """Coordinates of the first ``capacity`` WEAK pixels in raster order as a
    worklist [capacity, 2] (x, y) int64, padded with -1 (the reference's
    neighbours_map compaction, APD.cpp:526-538). Static shapes throughout,
    the counterpart of ``jnp.nonzero(size=capacity, fill_value=-1)``: each
    WEAK pixel's slot is the running count before it, and pixels past the
    capacity, like every other pixel, go to a sink slot that is cut off, so
    the compaction needs no host read (a CUDA graph captures it)."""
    H, W = pixel_state.shape
    weak_px = (pixel_state == PixelState.WEAK).reshape(-1)
    slot = torch.cumsum(weak_px, 0) - 1
    slot = torch.where(weak_px & (slot < capacity), slot, capacity)
    flat = torch.arange(H * W, device=pixel_state.device)
    out = torch.full((capacity + 1, 2), -1, dtype=torch.int64, device=pixel_state.device)
    out.index_put_((slot,), torch.stack([flat % W, flat // W], dim=-1))
    return out[:capacity]


def write_worklist(grid: torch.Tensor, weak_xy: torch.Tensor, write: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """A copy of ``grid`` [H, W, ...] with ``values[n]`` at pixel
    ``weak_xy[n]`` where ``write[n]`` ([N] bool). Static shapes: the entries
    not written go to a sink row that is cut off, so no boolean index (which
    reads a count back to the host) is needed. Worklist pixels are
    distinct, so every written pixel gets exactly its own value."""
    H, W = grid.shape[:2]
    rest = tuple(grid.shape[2:])
    flat = torch.cat([grid.reshape((H * W,) + rest), grid.new_zeros((1,) + rest)])
    idx = torch.where(write, weak_xy[:, 1] * W + weak_xy[:, 0], H * W)
    flat.index_put_((idx,), values.to(grid.dtype))
    return flat[:H * W].reshape(grid.shape)


def nearest_strong_map(pixel_state: torch.Tensor) -> torch.Tensor:
    """Per-pixel coordinates [H, W, 2] int32 (x, y) of the nearest STRONG
    pixel within the 100 px box, (-1, -1) if none: jump flooding with steps
    128 .. 1, 1, the 8 neighbours visited in the reference package's order.
    The arithmetic is int32 as there; squared distances stay below 2^26 and
    the empty-lane sentinel is 2^30."""
    H, W = pixel_state.shape
    dev = pixel_state.device
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.int32, device=dev),
                          torch.arange(W, dtype=torch.int32, device=dev), indexing="ij")
    strong = pixel_state == PixelState.STRONG
    neg = torch.full_like(x, -1)
    bx = torch.where(strong, x, neg)
    by = torch.where(strong, y, neg)
    sentinel = torch.full((), 1 << 30, dtype=torch.int32, device=dev)

    def dist2(bx_, by_):
        dx = bx_ - x
        dy = by_ - y
        return torch.where(bx_ >= 0, dx * dx + dy * dy, sentinel)

    for step in (s for s in (128, 64, 32, 16, 8, 4, 2, 1, 1) if s < max(H, W)):
        cur_d = dist2(bx, by)
        bx0, by0 = bx, by
        for dy_s, dx_s in ((-1, -1), (-1, 0), (-1, 1), (0, -1),
                           (0, 1), (1, -1), (1, 0), (1, 1)):
            nbx = sampling.shift2d(bx0, dx_s * step, dy_s * step, -1)
            nby = sampling.shift2d(by0, dx_s * step, dy_s * step, -1)
            nd = dist2(nbx, nby)
            better = nd < cur_d
            bx = torch.where(better, nbx, bx)
            by = torch.where(better, nby, by)
            cur_d = torch.where(better, nd, cur_d)
    in_box = ((bx >= 0) & (torch.abs(bx - x) <= _NEAREST_RADIUS)
              & (torch.abs(by - y) <= _NEAREST_RADIUS))
    return torch.stack([torch.where(in_box, bx, neg), torch.where(in_box, by, neg)], dim=-1)


#: host-made constants of the probe stage on the device, made once per
#: (kind, shape, device) outside any capture: a copy from host memory cannot
#: be captured into a CUDA graph
_DEVICE_CONSTANTS: dict = {}


def _device_constant(key, device, make) -> torch.Tensor:
    """``make()`` (a numpy array) on ``device``, made on first use and
    reused; never written."""
    key = (key, torch.device(device))
    if key not in _DEVICE_CONSTANTS:
        _DEVICE_CONSTANTS[key] = torch.as_tensor(make(), device=device)
    return _DEVICE_CONSTANTS[key]


def _base_directions(rotate_time: int) -> np.ndarray:
    """The 8 x rotate_time probe directions in the reference's order
    (APD.cu:1797-1851): base directions from the (dx, dy) double loop, each
    rotated rotate_time times by 45/rotate_time degrees."""
    dirs = []
    angle = 45.0 / rotate_time
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            if ox == 0 and oy == 0:
                continue
            d = np.array([ox, oy], np.float64)
            d /= np.linalg.norm(d)
            for r in range(rotate_time):
                a = math.radians(angle * r)
                ca, sa = math.cos(a), math.sin(a)
                dirs.append([d[0] * ca - d[1] * sa, d[0] * sa + d[1] * ca])
    return np.asarray(dirs, np.float32)  # [8 * rotate_time, 2]


class AnchorData(NamedTuple):
    """Per-weak-pixel anchors: coords [N, 9, 2] (slot 0 = the pixel itself,
    (-1, -1) = missing), the reference's neighbours_cuda layout
    (APD.cu:1774-1781)."""

    coords: torch.Tensor


class WeakCols(NamedTuple):
    """Per-pass resident K-columns of the volumes at the worklist, positions
    minor (``ops/cols.py``):

    c36: [Vs, K, N] bf16, C36 at the weak pixels (slot v-1 = camera v);
    c9: [Vs, K, N * 8] bf16, C9 at the anchors (position n * 8 + anchor);
    d: [Vs, K, N] f32 or None, the depth volumes at the weak pixels
      (geometric passes).
    """

    c36: torch.Tensor
    c9: torch.Tensor
    d: Optional[torch.Tensor]


def build_weak_cols(ctx: CostContext, weak_xy: torch.Tensor, anchors: AnchorData) -> WeakCols:
    """Gather the pass's column sets (one H5 launch per volume; per slab on
    a spaced set)."""
    vs = ctx.volumes
    if ncc.first_slab(vs).C36 is None or ncc.first_slab(vs).C9 is None:
        raise ValueError("the weak machinery needs the cost volumes C36 and C9 "
                         "(ncc.build_image_volume_set(weak_cost_volumes=True))")
    if vs.spaced:
        return _build_weak_cols_spaced(ctx, weak_xy, anchors)
    PY, PX = ncc_volume.PAD_Y, ncc_volume.PAD_X
    c36 = colsmod.gather_cols(vs.C36, weak_xy[:, 0], weak_xy[:, 1], PY, PX)
    a = anchors.coords[:, 1:]
    c9 = colsmod.gather_cols(vs.C9, a[..., 0].reshape(-1), a[..., 1].reshape(-1), PY, PX)
    d = None
    if vs.D is not None:
        d = colsmod.gather_cols(vs.D, weak_xy[:, 0], weak_xy[:, 1], 0, 0)
    return WeakCols(c36=c36, c9=c9, d=d)


def _build_weak_cols_spaced(ctx: CostContext, weak_xy: torch.Tensor,
                            anchors: AnchorData) -> WeakCols:
    """The columns of :func:`build_weak_cols` from a spaced set
    (``apdmvs_tpu/weak.py:214-287``): each slab gathers every position
    through H5 in place with slab-local rows ``ys - row0`` (the reference
    package reads K8's table entry instead), and each position takes the
    value of the slab that owns its row (``parallel.spaced.slab_owner``).
    The owner's rows, halos at the grid's edges included, equal the
    unsharded volume's, and a selection keeps every bit where a sum over
    the slabs, as the reference package's ``psum``, would turn -0.0 into
    +0.0: the columns equal :func:`build_weak_cols`' bit for bit."""
    from apdmvs_tpu_torch.parallel.spaced import slab_owner

    vs = ctx.volumes
    PY, PX = ncc_volume.PAD_Y, ncc_volume.PAD_X
    a = anchors.coords[:, 1:]
    home = weak_xy.device

    def gather(field, xs, ys, pad_y, pad_x):
        owner = slab_owner(ys, vs.Hs, vs.S)
        out = None
        for s, slab in enumerate(vs.slabs):
            vol = getattr(slab, field)
            r0 = vs.slab_rows(s)[0]
            cols = colsmod.gather_cols(vol, xs.to(vol.device), (ys - r0).to(vol.device),
                                       pad_y, pad_x).to(home)
            out = cols if out is None else torch.where(owner == s, cols, out)
        return out

    c36 = gather("C36", weak_xy[:, 0], weak_xy[:, 1], PY, PX)
    c9 = gather("C9", a[..., 0].reshape(-1), a[..., 1].reshape(-1), PY, PX)
    d = None
    if vs.slabs[0].D is not None:
        d = gather("D", weak_xy[:, 0], weak_xy[:, 1], 0, 0)
    return WeakCols(c36=c36, c9=c9, d=d)


# The RANSAC geometry below rounds like the reference package's compiled
# code, which contracts each sum of products into fused multiply-adds (as
# nvcc does for the CUDA reference). It matters: the anchor plane passes
# through its three vertices, so their distances to it are rounding noise
# (~1e-7), and that noise orders them among the anchors.


def _dot3(u, v):
    """sum(u * v) over the last axis of 3, as a chain of fused
    multiply-adds in index order."""
    return fma(u[..., 2], v[..., 2], fma(u[..., 1], v[..., 1], u[..., 0] * v[..., 0]))


def _cross(a, b):
    """a x b, each component a_i b_j - a_j b_i as one fused multiply-add."""
    return torch.stack([fma(a[..., i], b[..., j], -(a[..., j] * b[..., i]))
                        for i, j in ((1, 2), (2, 0), (0, 1))], dim=-1)


def _plane_dist(plane, P):
    """|n . P + w| of planes [..., 4] at points [..., 3] (broadcast)."""
    return torch.abs(_dot3(plane[..., :3], P) + plane[..., 3])


def _plane_from_triangle(A, B, C):
    """Unit plane (n, w) through 3 points and a degeneracy mask
    (APD.cu:1897-1907)."""
    n = _cross(A - C, B - C)
    norm = torch.sqrt(_dot3(n, n))[..., None]
    degenerate = (norm[..., 0] < 1e-12) | ~torch.isfinite(norm[..., 0])
    n = n / torch.clamp(norm, min=1e-30)
    w = -_dot3(n, A)
    return torch.cat([n, w[..., None]], dim=-1), degenerate


def _point_in_triangle(A, B, C, P):
    """2-D containment with the reference's degeneracy rejection
    (PointinTriangle, APD.cu:91-112). A, B, C, P: [..., 2] float."""
    def length(d):
        return torch.sqrt(torch.sum(d * d, dim=-1))

    ab, bc, ca = length(B - A), length(C - B), length(A - C)
    ok = (ab > 2.0) & (bc > 2.0) & (ca > 2.0)
    ok &= (ab + bc > ca) & (bc + ca > ab) & (ab + ca > bc)

    def cross2(u, v):
        return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]

    pa, pb, pc = A - P, B - P, C - P
    t1, t2, t3 = cross2(pa, pb), cross2(pb, pc), cross2(pc, pa)
    return ok & (t1 * t2 >= 0) & (t1 * t3 >= 0)


def probe_strong_points(pixel_state: torch.Tensor, weak_xy: torch.Tensor, draws,
                        rotate_time: int):
    """Directional probe stage of GenNeighbours (APD.cu:1793-1851). The
    jitter of a probe step is drawn once per (step, direction) and shared
    by every pixel (``draws.anchor_probes``), as in the reference package.
    Each worklist pixel (padding entries as pixel (0, 0)) marches the
    schedule and keeps its first accepted landing.

    Returns (found [N, D] bool, spx [N, D], spy [N, D]), D = 8*rotate_time,
    with -1 where nothing was found."""
    H, W = pixel_state.shape
    dev = pixel_state.device
    nearest = nearest_strong_map(pixel_state)
    snap_flat = torch.where(nearest[..., 0] >= 0, nearest[..., 1] * W + nearest[..., 0],
                            torch.full_like(nearest[..., 0], -1)).reshape(-1)

    base = _device_constant(("directions", rotate_time), dev,
                            lambda: _base_directions(rotate_time))  # [D, 2]
    D = base.shape[0]
    angle = 45.0 / rotate_time
    cos_threshold = math.cos(math.radians(angle / 2.0))
    shift_range = max(int(math.tan(math.radians(angle / 2.0)) * 20), 1)
    radii = _device_constant(("radii", W, H), dev, lambda: np.repeat(
        np.asarray(radius_schedule(W, H), np.float32), _JITTERS_PER_RADIUS))
    shifts = draws.anchor_probes(radii.shape[0], D, shift_range)  # [P, D, 2]
    d = base[None] * 20.0 + shifts.to(torch.float32)
    d = d / torch.clamp(torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True)), min=1e-12)
    off = torch.floor(d * radii[:, None, None]).to(torch.int64)

    # worklist pixels, clamped like the reference package's final gather
    px = torch.clamp(weak_xy[:, 0], 0, W - 1)[None]  # [1, N]
    py = torch.clamp(weak_xy[:, 1], 0, H - 1)[None]
    pxf, pyf = px.to(torch.float32), py.to(torch.float32)
    bx, by = base[:, 0:1], base[:, 1:2]  # [D, 1]
    found = torch.full((D, weak_xy.shape[0]), -1, dtype=torch.int64, device=dev)
    for p in range(radii.shape[0]):
        lx = px + off[p, :, 0:1]  # [D, N]
        ly = py + off[p, :, 1:2]
        in_margin = ((lx >= _MIN_MARGIN) & (ly >= _MIN_MARGIN)
                     & (lx < W - _MIN_MARGIN) & (ly < H - _MIN_MARGIN))
        s = snap_flat[torch.clamp(ly, 0, H - 1) * W + torch.clamp(lx, 0, W - 1)]
        has_pt = in_margin & (s >= 0)
        tdx = torch.remainder(s, W).to(torch.float32) - pxf
        tdy = torch.div(s, W, rounding_mode="floor").to(torch.float32) - pyf
        tn = torch.clamp(torch.sqrt(tdx * tdx + tdy * tdy), min=1e-12)
        cos_a = (tdx * bx + tdy * by) / tn
        accept = has_pt & (cos_a > cos_threshold) & (found < 0)
        found = torch.where(accept, s, found)
    s_at = found.T  # [N, D]
    ok = s_at >= 0
    neg = torch.full_like(s_at, -1)
    return (ok, torch.where(ok, torch.remainder(s_at, W), neg),
            torch.where(ok, torch.div(s_at, W, rounding_mode="floor"), neg))


def _fold_best(better, best, values):
    """Replace ``best`` rows by ``values`` where ``better`` ([N] bool)."""
    return torch.where(better.reshape(better.shape + (1,) * (best.dim() - 1)), values, best)


def generate_anchors(ctx: CostContext, prior_depth: torch.Tensor, pixel_state: torch.Tensor,
                     weak_xy: torch.Tensor, draws, cfg: PassConfig, ransac_threshold):
    """Anchor search and RANSAC reliability filter (GenNeighbours,
    APD.cu:1750-1969; NeigbourUpdate, APD.cu:1971-1987). Anchor 3-D points
    use the pass-input depth ``prior_depth``, as the reference reads
    plane_hypotheses[...].w before RandomInitialization.
    ``ransac_threshold`` is a number or a 0-d float32 tensor on the pass's
    device (a per-pass input, never a constant of a captured pass).

    Returns (AnchorData, pixel_state with unreliable WEAK pixels demoted to
    UNKNOWN). Only worklist pixels change state."""
    K0 = ctx.cams.K[0]
    N = weak_xy.shape[0]
    wx = weak_xy[:, 0].to(torch.float32)
    wy = weak_xy[:, 1].to(torch.float32)
    alive = weak_xy[:, 0] >= 0

    found, spx, spy = probe_strong_points(pixel_state, weak_xy, draws, cfg.rotate_time)
    D = found.shape[1]
    num_found = torch.sum(found, dim=1)

    # compact the valid strong points to the front of the D slots
    order = torch.argsort((~found).to(torch.uint8), dim=1, stable=True)
    spx = torch.gather(spx, 1, order)
    spy = torch.gather(spy, 1, order)
    found = torch.gather(found, 1, order)

    # 3-D points from the prior depth (APD.cu:1866-1877)
    depth_at = sampling.gather_grid(prior_depth, spx, spy)  # [N, D]
    pts3d = geometry.pixel_dirs(K0, spx.to(torch.float32), spy.to(torch.float32)) \
        * depth_at[..., None]
    center_depth = sampling.gather_grid(prior_depth, weak_xy[:, 0], weak_xy[:, 1])
    center3d = geometry.pixel_dirs(K0, wx, wy) * center_depth[..., None]
    depth_diff = ctx.cams.depth_max[0] - ctx.cams.depth_min[0]
    thr = torch.as_tensor(ransac_threshold, dtype=torch.float32, device=K0.device)
    pw = torch.stack([wx, wy], -1)[:, None]  # [N, 1, 2]

    # RANSAC for the anchor plane (APD.cu:1879-1945): _RANSAC_CHUNK triangles
    # a step, folded into the running best in draw order (first wins ties)
    best_count = torch.full((N,), 3, dtype=torch.int64, device=K0.device)  # APD.cu:1882
    best_center_dist = torch.full((N,), math.inf, device=K0.device)
    best_plane = torch.zeros((N, 4), device=K0.device)
    best_abc = torch.full((N, 3), -1, dtype=torch.int64, device=K0.device)
    has_plane = torch.zeros((N,), dtype=torch.bool, device=K0.device)
    ridx = draws.anchor_ransac((_RANSAC_STEPS, N, _RANSAC_CHUNK, 3))
    spxy = torch.stack([spx, spy], -1)  # [N, D, 2]
    for step in range(_RANSAC_STEPS):
        idx = torch.remainder(ridx[step], torch.clamp(num_found, min=1)[:, None, None])
        ia, ib, ic = idx[..., 0], idx[..., 1], idx[..., 2]  # [N, T]
        distinct = (ia != ib) & (ib != ic) & (ia != ic)
        A3, B3, C3 = (sampling.select_axis1(pts3d, i) for i in (ia, ib, ic))
        A2, B2, C2 = (sampling.select_axis1(spxy, i).to(torch.float32) for i in (ia, ib, ic))
        contains = _point_in_triangle(A2, B2, C2, pw)
        plane, degen = _plane_from_triangle(A3, B3, C3)  # [N, T, 4]
        ok = distinct & contains & ~degen
        dist = _plane_dist(plane[:, :, None], pts3d[:, None])  # [N, T, D]
        count = torch.sum(found[:, None] & (dist / depth_diff < thr), dim=2)  # [N, T]
        ok &= count >= 6  # APD.cu:1918
        center_dist = _plane_dist(plane, center3d[:, None])  # [N, T]
        abc = torch.stack([ia, ib, ic], -1)
        for t in range(_RANSAC_CHUNK):
            better = ok[:, t] & ((count[:, t] > best_count)
                                 | ((count[:, t] == best_count)
                                    & (center_dist[:, t] < best_center_dist)))
            best_count = _fold_best(better, best_count, count[:, t])
            best_center_dist = _fold_best(better, best_center_dist, center_dist[:, t])
            best_plane = _fold_best(better, best_plane, plane[:, t])
            best_abc = _fold_best(better, best_abc, abc[:, t])
            has_plane = has_plane | better

    # the 8 inliers nearest the best plane, its vertices first (APD.cu:1950-1967)
    dist = _plane_dist(best_plane[:, None], pts3d)
    inlier = found & (dist / depth_diff < thr)
    slot = torch.arange(D, device=K0.device)[None]
    is_vertex = ((slot == best_abc[:, 0:1]) | (slot == best_abc[:, 1:2])
                 | (slot == best_abc[:, 2:3]))
    weight = torch.where(inlier, dist - is_vertex.to(torch.float32), math.inf)
    order2 = torch.argsort(weight, dim=1, stable=True)[:, :_NUM_ANCHORS]
    neg = torch.full_like(spx, -1)
    ax = torch.gather(torch.where(inlier, spx, neg), 1, order2)
    ay = torch.gather(torch.where(inlier, spy, neg), 1, order2)

    reliable = has_plane & (num_found > 3) & alive
    ax = torch.where(reliable[:, None], ax, -1)
    ay = torch.where(reliable[:, None], ay, -1)
    coords = torch.cat([weak_xy[:, None, :], torch.stack([ax, ay], -1)], dim=1)  # [N, 9, 2]

    demote = alive & ~reliable
    ps = write_worklist(pixel_state, weak_xy, demote,
                        torch.full_like(demote, int(PixelState.UNKNOWN), dtype=torch.uint8))
    return AnchorData(coords=coords), ps


def deformed_cost_vector(ctx: CostContext, weak_xy, plane, anchors: AnchorData, selected_grid,
                         wcols: Optional[WeakCols] = None, sel_at_anchor=None,
                         cfg: Optional[PassConfig] = None) -> torch.Tensor:
    """Deformed (APD) NCC per view, [V, ..., N], of candidate planes
    [..., N, 4] (ComputeBilateralNCCNew, APD.cu:400-528): from the resident
    columns ``wcols``; without them from C36 / C9 point by point when the
    context carries them, else by direct warping (both read the windows of
    ``cfg``). ``sel_at_anchor`` [Vs, N, 8]: the selected views at the
    anchors (gathered from ``selected_grid`` when not given; the resident
    columns' branch only)."""
    if wcols is not None:
        if sel_at_anchor is None:
            sel_at_anchor = _sel_at_anchors(selected_grid, anchors.coords[:, 1:])[1:]
        return _deformed_cost_vector_cols(ctx, weak_xy, plane, anchors, sel_at_anchor, wcols)
    if cfg is None:
        raise ValueError("the deformed cost without resident columns needs the pass's cfg")
    if ctx.volumes is not None and ncc.first_slab(ctx.volumes).C36 is not None:
        return _deformed_cost_vector_volume(ctx, weak_xy, plane, anchors, selected_grid)
    return _deformed_cost_vector_direct(ctx, weak_xy, plane, anchors, selected_grid, cfg)


def _anchor_terms(center, a_cost, a_oob, valid, sel_a):
    """0.25 * centre + 0.75 * mean of the included anchor terms; an anchor
    that warps out of the source counts COST_MAX where the view is selected
    at the anchor and is left out otherwise (APD.cu:438-521). a_cost,
    a_oob: [..., N, 8], the centre without the last axis; valid: [N, 8];
    sel_a: the selected views at the anchors, broadcasting against a_oob."""
    include = valid & (~a_oob | sel_a)
    costs_a = torch.where(include, torch.where(a_oob, COST_MAX, a_cost), 0.0)
    cnt = torch.sum(include, dim=-1).to(torch.float32)
    strong_cost = torch.clamp(torch.sum(costs_a, dim=-1) / torch.clamp(cnt, min=1.0),
                              max=COST_MAX)
    return torch.where(cnt > 0, 0.25 * center + 0.75 * strong_cost, center)


def _per_view_axis(sel, ndim: int):
    """[V', N, 8] -> [V', 1, ..., N, 8] with ``ndim`` axes in all."""
    return sel.reshape(sel.shape[:1] + (1,) * (ndim - sel.dim()) + sel.shape[1:])


def _sel_at_anchors(selected_grid, a):
    """[V, N, 8] selected views at the anchors a [N, 8, 2]."""
    return sampling.gather_grid(selected_grid.permute(1, 2, 0), a[..., 0], a[..., 1]).permute(
        2, 0, 1)


def _deformed_cost_vector_direct(ctx: CostContext, weak_xy, plane, anchors: AnchorData,
                                 selected_grid, cfg: PassConfig) -> torch.Tensor:
    """Deformed NCC by direct warping, all source views at once: the centre
    patch (strong window) at the weak pixel and the eight anchor patches
    (weak window) at the anchors, warped by the candidate plane; an anchor's
    out-of-bounds test warps the anchor point itself."""
    wx = weak_xy[..., 0].to(torch.float32)
    wy = weak_xy[..., 1].to(torch.float32)
    H, W = ctx.height, ctx.width
    a = anchors.coords[:, 1:]  # [N, 8, 2]
    axf, ayf = a[..., 0].to(torch.float32), a[..., 1].to(torch.float32)
    views = ncc._source_views(ctx)
    center = ncc.ncc_cost_view(ctx, views, plane, cfg.strong_radius, cfg.strong_increment,
                               xs=wx, ys=wy)  # [Vs, ..., N]
    plane_b = plane[..., None, :]  # [..., N, 1, 4]
    adirs = geometry.pixel_dirs(ctx.cams.K[0], axf, ayf)  # [N, 8, 3]
    q, _, _ = ncc._warp_basis(ctx, views, plane_b, adirs)  # [Vs, ..., N, 8, 3]
    qx, qy = ncc._project(q)
    a_oob = (qx < 0) | (qy < 0) | (qx >= W) | (qy >= H)
    a_cost = ncc.ncc_cost_view(ctx, views, plane_b, cfg.weak_radius, cfg.weak_increment,
                               xs=axf, ys=ayf)  # [Vs, ..., N, 8]
    total = _anchor_terms(center, a_cost, a_oob, a[..., 0] >= 0,
                          _per_view_axis(_sel_at_anchors(selected_grid, a)[1:], a_cost.dim()))
    return ncc._with_ref_view(ctx, total, COST_MAX)


def _deformed_cost_vector_volume(ctx: CostContext, weak_xy, plane, anchors: AnchorData,
                                 selected_grid) -> torch.Tensor:
    """Deformed NCC through the cost volumes point by point: the centre term
    from C36 at the weak pixel, the anchor terms from C9 at each anchor, all
    at the candidate plane's depth there (``ncc.point_cost_volume``)."""
    a = anchors.coords[:, 1:]  # [N, 8, 2]
    center, _ = ncc.point_cost_volume(ctx, plane, weak_xy[..., 0], weak_xy[..., 1], "C36")
    a_cost, a_oob = ncc.point_cost_volume(ctx, plane[..., None, :], a[..., 0], a[..., 1], "C9")
    total = _anchor_terms(center, a_cost, a_oob, a[..., 0] >= 0,
                          _per_view_axis(_sel_at_anchors(selected_grid, a), a_cost.dim()))
    shape = (ctx.num_views,) + (1,) * (total.dim() - 1)
    return torch.where(ctx.src_valid.reshape(shape), total, COST_MAX)


def _warp_oob_batched(ctx: CostContext, Md: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Out-of-source-bounds test for all source views at once. Md:
    [Vs, *pos, 3] = M_v @ dir per position; u: [B, *pos] inverse depths.
    Returns [B, Vs, *pos] bool (APD.cu:546-556)."""
    cons = ncc.view_consts(ctx.volumes)  # [Vs, 21]
    shape_v = (1, -1) + (1,) * (Md.dim() - 2)
    q = Md[None] + cons[:, 15:18].reshape(shape_v + (3,)) * u[:, None, ..., None]
    px = q[..., 0] / q[..., 2]
    py = q[..., 1] / q[..., 2]
    return ((px < 0.0) | (px >= cons[:, 18].reshape(shape_v))
            | (py < 0.0) | (py >= cons[:, 19].reshape(shape_v)))


def _inv_depth(p, dirs):
    """u = -(n . dir) / w of planes p [B, N, 4] at directions [N, 3] or
    [N, A, 3] (-> [B, N] or [B, N, A])."""
    if dirs.dim() == 2:
        return -torch.sum(p[..., :3] * dirs, dim=-1) / p[..., 3]
    return -torch.sum(p[:, :, None, :3] * dirs, dim=-1) / p[..., 3:4]


def _batch(plane, N):
    lead = tuple(plane.shape[:-2])
    B = int(np.prod(lead)) if lead else 1
    return lead, plane.reshape(B, N, 4)


def _to_views(ctx, per_src, lead, N, pad_value):
    """[B, Vs, N] source-view costs -> [V, *lead, N] with view 0 and
    invalid views at ``pad_value``."""
    B = per_src.shape[0]
    out = torch.cat([torch.full((B, 1, N), pad_value, device=per_src.device), per_src], dim=1)
    out = out.movedim(1, 0).reshape((ctx.num_views,) + lead + (N,))
    return torch.where(ctx.src_valid.reshape((-1,) + (1,) * (out.dim() - 1)), out, pad_value)


def _deformed_cost_vector_cols(ctx: CostContext, weak_xy, plane, anchors: AnchorData,
                               sel_at_anchor, wcols: WeakCols) -> torch.Tensor:
    """Deformed NCC via the resident columns: two H6 launches (C36 at the
    pixel, C9 at its anchors) whatever the number of candidates. Anchors
    warping out of a source view count COST_MAX if the view is selected at
    the anchor and are left out otherwise (APD.cu:438-521)."""
    vs = ctx.volumes
    u_min, du = vs.u_grid
    N = weak_xy.shape[0]
    lead, p = _batch(plane, N)
    B = p.shape[0]
    K0 = ctx.cams.K[0]
    wx = weak_xy[:, 0].to(torch.float32)
    wy = weak_xy[:, 1].to(torch.float32)
    a = anchors.coords[:, 1:]  # [N, 8, 2]
    valid = a[..., 0] >= 0
    M = ncc.view_consts(vs)[:, 6:15].reshape(-1, 3, 3)

    # centre term
    dirs_c = geometry.pixel_dirs(K0, wx, wy)  # [N, 3]
    u_c = _inv_depth(p, dirs_c)  # [B, N]
    center = colsmod.contract_lookup(wcols.c36, (u_c - u_min) / du)  # [B, Vs, N]
    oob_c = _warp_oob_batched(ctx, geometry.mat3_vec(M[:, None], dirs_c[None]), u_c)
    center = torch.where(oob_c, COST_MAX, center)

    # anchor terms
    adirs = geometry.pixel_dirs(K0, a[..., 0].to(torch.float32), a[..., 1].to(torch.float32))
    u_a = _inv_depth(p, adirs)  # [B, N, 8]
    a_val = colsmod.contract_lookup(
        wcols.c9, ((u_a - u_min) / du).reshape(B, N * _NUM_ANCHORS)
    ).reshape(B, -1, N, _NUM_ANCHORS)  # [B, Vs, N, 8]
    a_oob = _warp_oob_batched(ctx, geometry.mat3_vec(M[:, None, None], adirs[None]), u_a)

    total = _anchor_terms(center, a_val, a_oob, valid, sel_at_anchor[None])  # [B, Vs, N]
    return _to_views(ctx, total, lead, N, COST_MAX)


def _geom_cost_vector_cols(ctx: CostContext, weak_xy, plane, wcols: WeakCols) -> torch.Tensor:
    """Geometric-consistency costs [V, ..., N] via the resident depth
    columns: one nearest-slice H6 launch, then the reprojection of H4
    (APD.cu:752-789)."""
    vs = ctx.volumes
    u_min, du = vs.u_grid
    N = weak_xy.shape[0]
    lead, p = _batch(plane, N)
    wx = weak_xy[:, 0].to(torch.float32)
    wy = weak_xy[:, 1].to(torch.float32)
    dirs_c = geometry.pixel_dirs(ctx.cams.K[0], wx, wy)  # [N, 3]
    g = ncc.view_geom_consts(vs)  # [Vs, 33]
    M = g[:, 6:15].reshape(-1, 3, 3)
    b = g[:, 15:18]
    A = g[:, 18:27].reshape(-1, 3, 3)
    t2 = g[:, 27:30]

    u = _inv_depth(p, dirs_c)  # [B, N]
    sd = colsmod.contract_lookup(wcols.d, (u - u_min) / du, nearest=True)  # [B, Vs, N]
    q = geometry.mat3_vec(M[:, None], dirs_c[None])[None] \
        + b[None, :, None, :] * u[:, None, :, None]  # [B, Vs, N, 3]
    px = q[..., 0] / q[..., 2]
    py = q[..., 1] / q[..., 2]
    oob = ((px < 0.0) | (px >= g[:, 30][None, :, None])
           | (py < 0.0) | (py >= g[:, 31][None, :, None]))
    # reproject (source pixel, source depth) into the reference view
    r = (A[None, :, None, :, 0] * px[..., None] + A[None, :, None, :, 1] * py[..., None]
         + A[None, :, None, :, 2])  # [B, Vs, N, 3]
    q2 = sd[..., None] * r + t2[None, :, None, :]
    bx = q2[..., 0] / q2[..., 2]
    by = q2[..., 1] / q2[..., 2]
    err = torch.sqrt((wx - bx) ** 2 + (wy - by) ** 2)
    cost = torch.clamp(err, max=GEOM_COST_MAX)
    cost = torch.where((sd == 0.0) | oob, GEOM_COST_MAX, cost)
    return _to_views(ctx, cost, lead, N, GEOM_COST_MAX)


def ransac_fit_planes(ctx: CostContext, planes_grid, weak_xy, anchors: AnchorData,
                      ridx: torch.Tensor) -> torch.Tensor:
    """Per-iteration RANSAC plane fit over the anchors' current 3-D points
    (RANSACToGetFitPlane, APD.cu:2272-2384). ``ridx``: the iteration's
    triangle draws [5, N, 10, 3]. Returns [N, 4]; all zero where no valid
    plane was found."""
    K0 = ctx.cams.K[0]
    N = weak_xy.shape[0]
    wx = weak_xy[:, 0].to(torch.float32)
    wy = weak_xy[:, 1].to(torch.float32)
    a = anchors.coords[:, 1:]  # [N, 8, 2]
    valid = a[..., 0] >= 0
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    a = torch.gather(a, 1, order[..., None].expand(-1, -1, 2))
    valid = torch.gather(valid, 1, order)
    cnt = torch.sum(valid, dim=1)

    axf, ayf = a[..., 0].to(torch.float32), a[..., 1].to(torch.float32)
    anchor_planes = sampling.gather_grid(planes_grid, a[..., 0], a[..., 1])  # [N, 8, 4]
    adirs = geometry.pixel_dirs(K0, axf, ayf)
    pts3d = adirs * (-anchor_planes[..., 3] / _dot3(anchor_planes[..., :3], adirs))[..., None]
    af = a.to(torch.float32)
    pw = torch.stack([wx, wy], -1)[:, None]
    slot = torch.arange(valid.shape[1], device=K0.device)[None, None]

    best_cost = torch.full((N,), math.inf, device=K0.device)
    best_plane = torch.zeros((N, 4), device=K0.device)
    has = torch.zeros((N,), dtype=torch.bool, device=K0.device)
    for step in range(_RANSAC_STEPS):
        idx = torch.remainder(ridx[step], torch.clamp(cnt, min=1)[:, None, None])
        ia, ib, ic = idx[..., 0], idx[..., 1], idx[..., 2]  # [N, T]
        distinct = (ia != ib) & (ib != ic) & (ia != ic)
        A3, B3, C3 = (sampling.select_axis1(pts3d, i) for i in (ia, ib, ic))
        A2, B2, C2 = (sampling.select_axis1(af, i) for i in (ia, ib, ic))
        contains = _point_in_triangle(A2, B2, C2, pw)
        plane, degen = _plane_from_triangle(A3, B3, C3)  # [N, T, 4]
        chosen = (slot == ia[..., None]) | (slot == ib[..., None]) | (slot == ic[..., None])
        dist = torch.where(valid[:, None] & ~chosen, _plane_dist(plane[:, :, None], pts3d[:, None]),
                           0.0)  # [N, T, 8]
        cost = dist[..., 0]
        for j in range(1, dist.shape[-1]):  # summed in anchor order
            cost = cost + dist[..., j]
        ok = distinct & contains & ~degen & (cnt >= 3)[:, None]
        for t in range(_RANSAC_CHUNK):
            better = ok[:, t] & (cost[:, t] < best_cost)
            best_cost = _fold_best(better, best_cost, cost[:, t])
            best_plane = _fold_best(better, best_plane, plane[:, t])
            has = has | better

    # orient toward the camera (APD.cu:2368-2380)
    flip = _dot3(best_plane[:, :3], geometry.pixel_dirs(K0, wx, wy)) > 0
    best_plane = torch.where(flip[:, None], -best_plane, best_plane)
    return torch.where(has[:, None], best_plane, 0.0)


def propagate_weak(ctx: CostContext, st: StrongState, pixel_state, weak_xy,
                   anchors: AnchorData, iter_idx: int, draws, cfg: PassConfig,
                   wcols: Optional[WeakCols] = None) -> StrongState:
    """One weak-pixel sweep (CheckerboardPropagationWeak, weak refinement
    and plain-NCC cost rewrite; APD.cu:1323-1508, 892-980). Writes only the
    weak pixels that are still WEAK and drew a view. The volume path reads
    the resident columns ``wcols``; without volumes (``wcols`` None) the
    deformed and geometric costs warp directly at the worklist."""
    planes_grid, costs_grid, selected_grid, vw_grid = st
    K0 = ctx.cams.K[0]
    N = weak_xy.shape[0]
    xi, yi = weak_xy[:, 0], weak_xy[:, 1]
    wx, wy = xi.to(torch.float32), yi.to(torch.float32)
    alive = xi >= 0
    still_weak = alive & (sampling.gather_grid(pixel_state, xi, yi) == PixelState.WEAK)
    depth_min = ctx.cams.depth_min[0]
    depth_max = ctx.cams.depth_max[0]
    if ctx.volumes is not None and (wcols is None or (cfg.geom_consistency and wcols.d is None)):
        raise ValueError("a weak sweep on the volume path needs the resident columns, with "
                         "depth volumes on geometric passes (ncc.add_depth_volumes)")

    fit_planes = ransac_fit_planes(ctx, planes_grid, weak_xy, anchors,
                                   draws.fit_ransac(iter_idx, (_RANSAC_STEPS, N, _RANSAC_CHUNK, 3)))
    dirs_c = geometry.pixel_dirs(K0, wx, wy)

    # candidates: the 8 anchors' planes, STRONG anchors only
    acoords = anchors.coords[:, 1:]  # [N, 8, 2]
    a_state = sampling.gather_grid(pixel_state, acoords[..., 0], acoords[..., 1])
    flag = (acoords[..., 0] >= 0) & (a_state == PixelState.STRONG)  # [N, 8]
    cand_planes = sampling.gather_grid(planes_grid, acoords[..., 0], acoords[..., 1])
    sel_hwv = selected_grid.permute(1, 2, 0)
    a_sel = sampling.gather_grid(sel_hwv, acoords[..., 0], acoords[..., 1])  # [N, 8, V]
    sel_at_anchor = a_sel.permute(2, 0, 1)[1:]  # [Vs, N, 8]

    def deformed(plane):
        return deformed_cost_vector(ctx, weak_xy, plane, anchors, selected_grid, wcols,
                                    sel_at_anchor=sel_at_anchor, cfg=cfg)

    def geom(plane):
        if wcols is not None:
            return _geom_cost_vector_cols(ctx, weak_xy, plane, wcols)
        return ncc.geom_cost_vector(ctx, plane, xs=wx, ys=wy)

    def total(plane):
        """Deformed cost plus the geometric term on geometric passes."""
        cv = deformed(plane)
        if cfg.geom_consistency:
            cv = cv + cfg.geom_factor * geom(plane)
        return cv

    # the 8 anchor candidates, the current plane and the fit plane in one batch
    cur_plane = sampling.gather_grid(planes_grid, xi, yi)  # [N, 4]
    planes10 = torch.cat([cand_planes.movedim(1, 0), cur_plane[None], fit_planes[None]], dim=0)
    d10 = deformed(planes10)  # [V, 10, N]
    g10 = geom(planes10) if cfg.geom_consistency else None

    flag_t = flag.T[:, None, :]  # [8, 1, N]
    cost_array = torch.where(flag_t, d10[:, :8].movedim(0, 1), 0.0)  # [8, V, N]
    # priors from the anchors' selected views (APD.cu:1370-1384)
    a_valid = (acoords[..., 0] >= 0)[..., None]
    priors = torch.sum(torch.where(a_valid, torch.where(a_sel, 0.9, 0.1), 0.0), dim=1).T
    priors = priors * ctx.src_valid[:, None]
    weights, weight_norm, temp_sel = joint_view_selection(
        cost_array, priors, iter_idx, draws.weak_view_selection(iter_idx, N))

    def weighted(cv):
        return torch.sum(weights * cv, dim=0) / torch.clamp(weight_norm, min=1e-30)

    if cfg.geom_consistency:  # APD.cu:1441-1447; a missing candidate costs 3
        geom_arr = torch.where(flag_t, g10[:, :8].movedim(0, 1), GEOM_COST_MAX)
        total_arr = cost_array + cfg.geom_factor * geom_arr
    else:
        total_arr = cost_array
    final_costs = torch.sum(weights[None] * total_arr, dim=1) / torch.clamp(
        weight_norm[None], min=1e-30)  # [8, N]
    min_idx = torch.argmin(final_costs, dim=0)

    tot10 = d10 if g10 is None else d10 + cfg.geom_factor * g10
    cost_now = weighted(tot10[:, 8])
    cost_pre = cost_now

    best_flag = sampling.select_axis1(flag, min_idx)
    best_cost = sampling.select_index(final_costs, min_idx)
    best_plane = sampling.select_axis1(cand_planes, min_idx)
    depth_before = geometry.depth_from_plane(K0, best_plane, wx, wy)
    adopt = (best_flag & (depth_before >= depth_min) & (depth_before <= depth_max)
             & (best_cost < cost_now))
    plane_now = torch.where(adopt[:, None], best_plane, cur_plane)
    cost_now = torch.where(adopt, best_cost, cost_now)
    sel_now = torch.where(adopt[None], temp_sel, sampling.gather_grid(sel_hwv, xi, yi).T)

    # weak refinement (APD.cu:892-980): the fit plane first; a zero fit
    # plane ends the refinement (APD.cu:910-914)
    fit_zero = torch.all(fit_planes[:, :3] == 0.0, dim=-1)
    fit_cost = weighted(tot10[:, 9])
    fit_depth = geometry.depth_from_plane(K0, fit_planes, wx, wy)
    fit_ok = (~fit_zero & (fit_depth >= depth_min) & (fit_depth <= depth_max)
              & (fit_cost < cost_now))
    plane_now = torch.where(fit_ok[:, None], fit_planes, plane_now)
    cost_now = torch.where(fit_ok, fit_cost, cost_now)

    # argmin over {current} U {5 combos} (first minimum wins)
    cur_depth = geometry.depth_from_plane(K0, plane_now, wx, wy)
    u_depth, g_normal, u_pert, u_angles = draws.weak_refinement(iter_idx, N)
    depths5, normals5 = hypotheses.refinement_combos(
        u_depth, g_normal, u_pert, u_angles, K0, wx, wy, dirs_c,
        plane_now[..., :3], cur_depth, depth_min, depth_max,
    )
    w5 = geometry.dist_to_origin(K0, wx, wy, depths5, normals5)
    planes5 = torch.cat([normals5, w5[..., None]], dim=-1)  # [5, N, 4]
    c5 = torch.sum(weights[:, None] * total(planes5), dim=0) / torch.clamp(
        weight_norm, min=1e-30)  # [5, N]
    d_chk = geometry.depth_from_plane(K0, planes5, wx, wy)
    c5 = torch.where(~fit_zero[None] & (d_chk >= depth_min) & (d_chk <= depth_max), c5,
                     math.inf)
    all_costs = torch.cat([cost_now[None], c5], dim=0)
    best_i = torch.argmin(all_costs, dim=0)
    cost_now = sampling.select_index(all_costs, best_i)
    plane_now = sampling.select_index(torch.cat([plane_now[None], planes5], dim=0), best_i)

    # acceptance by run state (APD.cu:1488-1497)
    if cfg.state == RunState.REFINE_INIT:
        plane_final = torch.where((cost_now < cost_pre - 0.1)[:, None], plane_now, cur_plane)
    else:
        plane_final = plane_now

    # write the adopted planes first, so the cost rewrite reads the updated
    # field; only pixels still WEAK that drew a view are written
    upd = still_weak & (weight_norm > 0)
    planes_grid = write_worklist(planes_grid, weak_xy, upd, plane_final)
    # plain-NCC cost rewrite for strong/weak comparability (APD.cu:1499-1507):
    # on the volume path through the same exact grid evaluator as the strong
    # path, without volumes by direct warping at the worklist
    if ctx.volumes is not None:
        cv_grid = ncc.cost_vector(ctx, planes_grid, cfg.strong_radius, cfg.strong_increment)
        cv_plain = cv_grid[:, yi.clamp(0, ctx.height - 1), xi.clamp(0, ctx.width - 1)]
    else:
        cv_plain = ncc.cost_vector(ctx, plane_final, cfg.strong_radius, cfg.strong_increment,
                                   xs=wx, ys=wy)
    cost_final = weighted(cv_plain)
    costs_grid = write_worklist(costs_grid, weak_xy, upd, cost_final)

    def write_views(grid, values):  # [V, H, W] grids, [V, N] values
        return write_worklist(grid.permute(1, 2, 0), weak_xy, upd, values.T).permute(
            2, 0, 1).contiguous()

    return StrongState(planes=planes_grid, costs=costs_grid,
                       selected=write_views(selected_grid, sel_now),
                       view_weights=write_views(vw_grid, weights))
