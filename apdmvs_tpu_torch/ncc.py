"""Multi-view NCC cost evaluation — the hot path.

PyTorch counterpart of ``apdmvs_tpu/ncc.py`` (reference:
ComputeBilateralNCCOld APD.cu:530-614, cost vectors APD.cu:696-716,
initial cost + top-k view seeding APD.cu:616-693, geometric consistency
APD.cu:752-789). Two paths evaluate the same costs:

- the volume path (a context with ``volumes``): every grid evaluation goes
  through the volume kernels of ``ops/``: the exact NCC (H2, every source
  view in one launch, read from E alone) and the geometric cost (H4, every
  source view in one launch). The reference package routes its NCC
  evaluations through rebased volumes, banded and full-K kernels; they all
  compute the one function that H2 computes from E, so the port has one
  NCC evaluator and builds no rebased volume. Point-mode evaluations with
  the standard windows read the cost volumes C36 / C9
  (:func:`point_cost_volume`).
- the direct-warp path (a context without volumes, ``--no-volumes``): the
  homography warp of every window sample and a bilinear read of the
  images, in plain PyTorch, as the reference package computes it outside
  any Pallas kernel. All source views are evaluated in one tensor op per
  window offset, and only five accumulators of the output's shape live
  across the offsets. Grid mode reads the f32 images (the reference patch
  from edge-padded shifted slices), point mode (worklists, anchors) their
  bf16 copy, as the reference package does. The volume path never falls
  back to it: a volume context carries no images.

The space-sharded volumes of the reference package are not ported.

Costs are "1 - NCC" clamped to [0, 2]; degenerate patches and out-of-view
warps cost 2. Index v of every per-view result is camera v; entry 0 (the
reference view) and invalid padding views are COST_MAX.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from apdmvs_tpu_torch import geometry, sampling
from apdmvs_tpu_torch.geometry import Cameras, WarpConstants
from apdmvs_tpu_torch.ops import cost_volume, ncc_volume, volume as vol

COST_MAX = ncc_volume.COST_MAX
GEOM_COST_MAX = ncc_volume.GEOM_COST_MAX
MIN_VAR = 1e-5


class VolumeSet(NamedTuple):
    """Per-source-view plane-sweep volumes (index v-1 for camera v).

    E: [V-1, K, Hp+2*PAD_Y, Wp+2*PAD_X] bf16, (Hp, Wp) padded to
      (NCC_TILE_H, TILE_W) multiples.
    consts: [V-1, 1, 21] f32 (ncc_volume.pack_consts per source view).
    ref_pad: [Hp+2*PAD_Y, Wp+2*PAD_X] f32 edge-padded reference image.
    D / geom_consts: source-view depth volumes [V-1, K, Hp, Wp] f32 and
      their reprojection constants, for geometric passes.
    C36 / C9: NCC cost volumes [V-1, K, PH, PW] bf16 of the weak machinery
      (ops/cost_volume.py): the strong window (radius 5, step 2) and the
      anchor window (radius 5, step 5), built for rounds that use APD.
    """

    E: torch.Tensor
    consts: torch.Tensor
    ref_pad: torch.Tensor
    D: Optional[torch.Tensor] = None
    geom_consts: Optional[torch.Tensor] = None
    C36: Optional[torch.Tensor] = None
    C9: Optional[torch.Tensor] = None

    @property
    def num_slices(self) -> int:
        return self.E.shape[1]

    @property
    def u_grid(self):
        """(u_min, du) of the slice grid as 0-d tensors."""
        return self.consts[0, 0, 4], self.consts[0, 0, 5]


class CostContext(NamedTuple):
    """Per-pass immutable inputs to all cost evaluations.

    src_valid: [V] bool — True for real source views; view 0 and padding
      views always cost COST_MAX (the reference's 2.0-initialised cost
      vectors, APD.cu:626-627).
    volumes: the volume path's plane-sweep volumes, or None for the
      direct-warp path, which reads ``images`` [V, H, W] f32 (index 0 = the
      reference view), their bf16 copy ``images_bf16`` (point mode) and,
      on geometric passes, ``depth_maps`` [V, H, W] (the source views'
      depths; entry 0 unused).
    """

    cams: Cameras
    wc: WarpConstants
    dirs: torch.Tensor  # [H, W, 3] ref pixel directions K_ref^{-1} p
    x: torch.Tensor  # [H, W]
    y: torch.Tensor  # [H, W]
    src_valid: torch.Tensor  # [V] bool
    volumes: Optional[VolumeSet] = None
    images: Optional[torch.Tensor] = None
    images_bf16: Optional[torch.Tensor] = None
    depth_maps: Optional[torch.Tensor] = None

    @property
    def height(self) -> int:
        return self.x.shape[0]

    @property
    def width(self) -> int:
        return self.x.shape[1]

    @property
    def num_views(self) -> int:
        return self.src_valid.shape[0]


def make_context(cams: Cameras, src_valid, height: int, width: int,
                 volumes: Optional[VolumeSet] = None, images=None,
                 depth_maps=None) -> CostContext:
    """The pass's cost context: with ``volumes`` the volume path, without
    them the direct-warp path over ``images`` (and ``depth_maps`` on
    geometric passes)."""
    dev = cams.device
    x, y = geometry.pixel_grid(height, width, dev)
    if images is not None:
        images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    if depth_maps is not None:
        depth_maps = torch.as_tensor(depth_maps, dtype=torch.float32, device=dev)
    return CostContext(
        cams=cams,
        wc=geometry.warp_constants(cams),
        dirs=geometry.pixel_dirs(cams.K[0], x, y),
        x=x,
        y=y,
        src_valid=torch.as_tensor(src_valid, dtype=torch.bool, device=dev),
        volumes=volumes,
        images=images,
        images_bf16=None if images is None else images.to(torch.bfloat16),
        depth_maps=depth_maps,
    )


def _ceil_to(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _edge_pad(img: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    return F.pad(img[None, None], (left, right, top, bottom), mode="replicate")[0, 0]


def build_image_volume_set(images: torch.Tensor, cams: Cameras, depth_min, depth_max,
                           num_slices: int = 160, weak_cost_volumes: bool = True) -> VolumeSet:
    """Image volumes E (one H1 launch per source view), consts, the padded
    reference image and, with ``weak_cost_volumes``, the cost volumes C36
    and C9 of the weak machinery. They depend only on (images, cameras,
    depth grid), so the scene runner builds them once per (problem, scale)
    and reuses them across the round's passes."""
    V, H, W = images.shape
    Hp = _ceil_to(H, ncc_volume.NCC_TILE_H)
    Wp = _ceil_to(W, ncc_volume.TILE_W)
    wc = geometry.warp_constants(cams)
    u_min, du = vol.inv_depth_grid(depth_min, depth_max, num_slices)
    Es, consts = [], []
    for v in range(1, V):
        Es.append(vol.build_volume(
            images[v], wc.M[v], wc.b[v], cams.K[0], Hp, Wp, u_min, du, num_slices,
            pad_y=ncc_volume.PAD_Y, pad_x=ncc_volume.PAD_X, dtype=torch.bfloat16,
        ))
        consts.append(ncc_volume.pack_consts(cams.K[0], wc.M[v], wc.b[v], u_min, du, W, H))
    ref_pad = _edge_pad(
        images[0].float(), ncc_volume.PAD_Y, ncc_volume.PAD_Y + Hp - H,
        ncc_volume.PAD_X, ncc_volume.PAD_X + Wp - W,
    )
    C36 = C9 = None
    if weak_cost_volumes:
        C36 = torch.stack([cost_volume.build_cost_volume(E, ref_pad, 5, 2) for E in Es])
        C9 = torch.stack([cost_volume.build_cost_volume(E, ref_pad, 5, 5) for E in Es])
    return VolumeSet(E=torch.stack(Es), consts=torch.stack(consts), ref_pad=ref_pad,
                     C36=C36, C9=C9)


def image_volume_set_nbytes(num_views: int, height: int, width: int, num_slices: int = 160,
                            weak_cost_volumes: bool = True) -> int:
    """Device bytes of the set :func:`build_image_volume_set` builds for V
    views of H x W: E (and C36, C9) [V-1, K, PH, PW] bf16, consts and the
    padded reference image."""
    PH = _ceil_to(height, ncc_volume.NCC_TILE_H) + 2 * ncc_volume.PAD_Y
    PW = _ceil_to(width, ncc_volume.TILE_W) + 2 * ncc_volume.PAD_X
    volumes = 3 if weak_cost_volumes else 1
    return (volumes * (num_views - 1) * num_slices * PH * PW * 2
            + (num_views - 1) * 21 * 4 + PH * PW * 4)


def add_depth_volumes(vs: VolumeSet, depth_maps: torch.Tensor, cams: Cameras,
                      depth_min, depth_max) -> VolumeSet:
    """Attach the per-pass source-view depth volumes (H1 in trunc mode) and
    reprojection constants for geometric consistency."""
    V, H, W = depth_maps.shape
    K = vs.num_slices
    Hp = vs.ref_pad.shape[0] - 2 * ncc_volume.PAD_Y
    Wp = vs.ref_pad.shape[1] - 2 * ncc_volume.PAD_X
    wc = geometry.warp_constants(cams)
    u_min, du = vol.inv_depth_grid(depth_min, depth_max, K)
    K_ref, R_ref = cams.K[0], cams.R[0]
    KR = geometry.mat3_mat3(K_ref, R_ref)
    Ds, gconsts = [], []
    for v in range(1, V):
        Ds.append(vol.build_volume(
            depth_maps[v], wc.M[v], wc.b[v], K_ref, Hp, Wp, u_min, du, K,
            pad_y=0, pad_x=0, dtype=torch.float32, trunc=True,
        ))
        A = geometry.mat3_mat3(
            geometry.mat3_mat3(KR, cams.R[v].transpose(-1, -2)),
            geometry.k_inverse_zero_skew(cams.K[v]),
        )
        t2 = geometry.mat3_vec(KR, cams.c[v] - cams.c[0])
        gconsts.append(ncc_volume.pack_geom_consts(
            K_ref, wc.M[v], wc.b[v], A, t2, u_min, du, W, H))
    return vs._replace(D=torch.stack(Ds), geom_consts=torch.stack(gconsts))


def _base_slice_map(vs: VolumeSet, depth: torch.Tensor) -> torch.Tensor:
    """Fractional slice of ``depth`` per pixel (K/2 where depth <= 0),
    edge-padded onto the volume grid: the base of the reference package's
    rebased volumes (``ncc_volume.build_rebased_view``)."""
    u_min, du = vs.u_grid
    K = vs.num_slices
    H, W = depth.shape
    PH, PW = vs.ref_pad.shape
    valid = depth > 0.0
    k = (1.0 / torch.where(valid, depth, torch.ones_like(depth)) - u_min) / du
    k = torch.where(valid, torch.clamp(k, 0.0, K - 1.0), torch.full_like(k, K / 2.0))
    return _edge_pad(k, ncc_volume.PAD_Y, PH - H - ncc_volume.PAD_Y,
                     ncc_volume.PAD_X, PW - W - ncc_volume.PAD_X)


def _pad_planes_cf(plane: torch.Tensor, Hp: int, Wp: int) -> torch.Tensor:
    """[C, H, W, 4] -> channel-first [C, 4, Hp, Wp], padded with a benign
    fronto-parallel plane (0, 0, -1, 1) whose results are sliced off."""
    C, H, W, _ = plane.shape
    out = torch.zeros((C, 4, Hp, Wp), dtype=torch.float32, device=plane.device)
    out[:, 2] = -1.0
    out[:, 3] = 1.0
    out[:, :, :H, :W] = plane.permute(0, 3, 1, 2)
    return out


def _grid_eval(ctx: CostContext, plane: torch.Tensor, evaluate, pad_value=COST_MAX):
    """Shared harness of the volume path: pad the plane fields onto the
    kernel grid, evaluate every source view (``evaluate(planes_cf) ->
    [V-1, C, Hp, Wp]``), slice back and put COST_MAX (``pad_value``) at
    view 0 and the invalid views: [V, (C,) H, W]."""
    vs = ctx.volumes
    H, W = ctx.height, ctx.width
    Hp = vs.ref_pad.shape[0] - 2 * ncc_volume.PAD_Y
    Wp = vs.ref_pad.shape[1] - 2 * ncc_volume.PAD_X
    squeeze = plane.dim() == 3
    if squeeze:
        plane = plane[None]
    outs = evaluate(_pad_planes_cf(plane, Hp, Wp))[:, :, :H, :W]
    costs = _with_ref_view(ctx, outs, pad_value)
    return costs[:, 0] if squeeze else costs


def _with_ref_view(ctx: CostContext, per_src: torch.Tensor, pad_value) -> torch.Tensor:
    """[V-1, ...] source-view results -> [V, ...] with ``pad_value`` at view
    0 and at the invalid views."""
    out = torch.cat([torch.full_like(per_src[:1], pad_value), per_src])
    shape = (ctx.num_views,) + (1,) * (out.dim() - 1)
    return torch.where(ctx.src_valid.reshape(shape), out, pad_value)


def _source_views(ctx: CostContext) -> torch.Tensor:
    return torch.arange(1, ctx.num_views, device=ctx.x.device)


# ---------------------------------------------------------------------------
# The direct-warp path (no volumes): ``apdmvs_tpu/ncc.py:396-517, 520-573,
# 661-687``. ``v`` is a 1-D tensor of view indices, the leading axis of
# every result.
# ---------------------------------------------------------------------------


def _per_view(x: torch.Tensor, v: torch.Tensor, nd: int) -> torch.Tensor:
    """Per-camera rows ``x[v]`` ([Vs, k] or [Vs, 3, 3]) shaped to broadcast
    against ``nd`` position axes after the leading view axis."""
    xv = x[v]
    return xv.reshape((xv.shape[0],) + (1,) * nd + tuple(xv.shape[1:]))


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the type the direct path takes multiply-adds in: float64 on
    the CPU, where the product of two float32 is exact, so one rounding to
    float32 gives the fused result the reference package's compiled code
    computes (the plain path then agrees with it where the NCC is rounding
    noise: constant patches); float32 on the card (one multiply-add
    kernel)."""
    return x.to(torch.float64 if x.device.type == "cpu" else torch.float32)


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 (``a`` may be a number), taken in
    the wide type; operands already wide are not converted again."""
    if isinstance(a, (int, float)):
        return torch.add(_wide(c), _wide(b), alpha=a).float()
    return torch.addcmul(_wide(c), _wide(a), _wide(b)).float()


def _warp_basis(ctx: CostContext, v: torch.Tensor, plane: torch.Tensor, dirs: torch.Tensor):
    """Hp, He0, He1 homogeneous warp vectors [Vs, ..., 3] of ``plane`` at
    pixels with directions ``dirs`` (geometry.py docstring identities),
    their multiply-adds contracted as the reference package's compiled CPU
    code contracts them (measured bit-equal on the CPU): the warp decides
    the bilinear weights, and in a constant patch their rounding is the
    whole NCC."""
    n = plane[..., :3]
    w = plane[..., 3]
    ndir = _fma(n[..., 2], dirs[..., 2], _fma(n[..., 1], dirs[..., 1], n[..., 0] * dirs[..., 0]))
    nd = ndir.dim()
    Mv = _per_view(ctx.wc.M, v, nd)
    bv = _per_view(ctx.wc.b, v, nd)
    Md = torch.stack([_fma(Mv[..., r, 2], dirs[..., 2],
                           _fma(Mv[..., r, 0], dirs[..., 0], Mv[..., r, 1] * dirs[..., 1]))
                      for r in range(3)], dim=-1)
    Hp = _fma(-bv, (ndir / w)[..., None], Md)
    He0 = _fma(-bv, (n[..., 0] / w)[..., None], Mv[..., :, 0]) * ctx.wc.inv_fx
    He1 = _fma(-bv, (n[..., 1] / w)[..., None], Mv[..., :, 1]) * ctx.wc.inv_fy
    return Hp, He0, He1


def _project(q: torch.Tensor):
    return q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]


def _ncc_from_sums(s_r, s_rr, s_s, s_ss, s_rs, count: int) -> torch.Tensor:
    """cost = clamp(1 - cov / sqrt(var_r var_s), 0, 2), rsqrt form;
    degenerate patches -> COST_MAX (APD.cu:592-610). The moments round as
    the volume path's (``ncc_volume.ncc_moments``)."""
    inv = torch.tensor(1.0 / count, dtype=torch.float32, device=s_s.device)
    mr = s_r * inv
    ms = s_s * inv
    var_r, var_s, cov = ncc_volume.ncc_moments(s_rr, s_ss, s_rs, mr, ms, inv)
    cost = 1.0 - cov * torch.rsqrt(torch.clamp(var_r * var_s, min=1e-30))
    cost = torch.clamp(cost, 0.0, COST_MAX)
    return torch.where((var_r < MIN_VAR) | (var_s < MIN_VAR), COST_MAX, cost)


def _bilinear_views(images_w: torch.Tensor, base, x: torch.Tensor, y: torch.Tensor,
                    top_fuses_left: bool) -> torch.Tensor:
    """``sampling.bilinear_sample`` of a stack of images [V, H, W] (held in
    the wide type, :func:`_wide`), each sample from the image whose flat
    offset ``base`` (a multiple of H * W, broadcasting against x and y)
    names; f32 out. The three lerps are multiply-adds contracted as the
    reference package's compiled CPU code contracts them; it fuses the left
    product of the top row for bf16 images and the right one for f32
    (``top_fuses_left``; measured bit-equal)."""
    _, H, W = images_w.shape
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = x - x0f
    wy = y - y0f
    x0 = torch.clamp(x0f.to(torch.int64), 0, W - 1)  # NaN converts out of range
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y0 = torch.clamp(y0f.to(torch.int64), 0, H - 1)
    r0 = y0 * W + base
    r1 = torch.clamp(y0 + 1, max=H - 1) * W + base
    v00, v01, v10, v11 = torch.take(images_w, torch.stack([r0 + x0, r0 + x1, r1 + x0, r1 + x1]))
    omx = 1.0 - wx

    def lerp(a, wa, b, wb):  # a * wa + b * wb, the product b * wb rounded first
        return _fma(a, wa, (b * wb).float())

    top = lerp(v00, omx, v01, wx) if top_fuses_left else lerp(v01, wx, v00, omx)
    bot = lerp(v10, omx, v11, wx)
    return lerp(top, 1.0 - wy, bot, wy)


def _view_base(v: torch.Tensor, height: int, width: int, nd: int) -> torch.Tensor:
    """Flat offset of each view's image, shaped like :func:`_per_view`."""
    return (v * (height * width)).reshape((-1,) + (1,) * nd)


def _require_images(ctx: CostContext):
    if ctx.images is None:
        raise ValueError("the direct-warp evaluators need the context's images "
                         "(a volume-path context carries none)")


def ncc_cost_view(ctx: CostContext, v: torch.Tensor, plane: torch.Tensor, radius: int,
                  increment: int, xs: Optional[torch.Tensor] = None,
                  ys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain NCC costs [Vs, ...] of ``plane`` against the source views ``v``
    (a 1-D tensor) by direct warping (ComputeBilateralNCCOld,
    APD.cu:530-614); a patch centre that warps out of the source costs
    COST_MAX.

    Grid mode (``xs`` None): every pixel of the [H, W] grid, the reference
    patch from static shifted slices of the edge-padded f32 reference image.
    Point mode: at float coordinates (``xs``, ``ys``) of any shape, sampling
    the bf16 images; ``plane`` may carry leading batch dims relative to the
    coordinates ([C, N, 4] with xs [N], or [..., N, 1, 4] with xs [N, 8])
    and the result has the broadcast shape. The window's offsets are a
    Python loop holding five accumulators; the reference patch's sums do
    not depend on the plane or the view and are taken once."""
    _require_images(ctx)
    offsets = sampling.patch_offsets(radius, increment).tolist()
    H, W = ctx.height, ctx.width
    grid = xs is None
    if grid:
        images = ctx.images
        xs_, ys_, dirs = ctx.x, ctx.y, ctx.dirs
        ref_padded = _edge_pad(images[0], radius, radius, radius, radius)
    else:
        images = ctx.images_bf16
        xs_, ys_ = xs, ys
        dirs = geometry.pixel_dirs(ctx.cams.K[0], xs, ys)
    bf16 = images.dtype == torch.bfloat16
    images_w = _wide(images)
    Hp, He0, He1 = _warp_basis(ctx, v, plane, dirs)
    cx, cy = _project(Hp)
    center_oob = (cx < 0.0) | (cx >= W) | (cy < 0.0) | (cy >= H)
    base = _view_base(v, H, W, cx.dim() - 1)
    Hp, He0, He1 = _wide(Hp), _wide(He0), _wide(He1)  # loop-invariant

    s_r = s_rr = s_s = s_ss = s_rs = None
    for di, dj in offsets:
        if grid:
            ref_pix = ref_padded[dj + radius:dj + radius + H, di + radius:di + radius + W]
        else:
            ref_pix = _bilinear_views(images_w[:1], 0, xs_ + di, ys_ + dj, bf16)
        sx, sy = _project(_fma(dj, He1, _fma(di, He0, Hp)))
        src = _bilinear_views(images_w, base, sx, sy, bf16)
        if s_s is None:
            s_r, s_rr = ref_pix, ref_pix * ref_pix
            s_s, s_ss, s_rs = src, src * src, ref_pix * src
        else:
            s_r = s_r + ref_pix
            s_rr = _fma(ref_pix, ref_pix, s_rr)
            s_s = s_s + src
            s_ss = _fma(src, src, s_ss)
            s_rs = _fma(ref_pix, src, s_rs)
    cost = _ncc_from_sums(s_r.expand_as(s_s), s_rr.expand_as(s_s), s_s, s_ss, s_rs,
                          len(offsets))
    return torch.where(center_oob, COST_MAX, cost)


def point_warp_oob(ctx: CostContext, v_consts: torch.Tensor, dirs: torch.Tensor,
                   u: torch.Tensor) -> torch.Tensor:
    """Analytic out-of-source-bounds test of a warped point from one view's
    packed consts [21] (the texture-bounds checks, APD.cu:546-556)."""
    M = v_consts[6:15].reshape(3, 3)
    b = v_consts[15:18]
    q = geometry.mat3_vec(M, dirs) + b * u[..., None]
    px = q[..., 0] / q[..., 2]
    py = q[..., 1] / q[..., 2]
    return (px < 0.0) | (px >= v_consts[18]) | (py < 0.0) | (py >= v_consts[19])


def point_cost_volume(ctx: CostContext, plane: torch.Tensor, xs: torch.Tensor,
                      ys: torch.Tensor, which: str):
    """Point-mode patch NCC through the cost volumes (``which``: 'C36' for
    radius 5 step 2, 'C9' for radius 5 step 5; the fronto-parallel-at-centre
    approximation of ``ops/cost_volume.py``) at integer coordinates ``xs``,
    ``ys`` ([P] or [P, A]) of planes [..., P(, 1), 4]. Returns (costs,
    oob), each [V, ..., P(, A)]; view 0 and the invalid views cost
    COST_MAX, view 0 counts as out of bounds."""
    vs = ctx.volumes
    C = vs.C36 if which == "C36" else vs.C9
    u_min, du = vs.u_grid
    dirs = geometry.pixel_dirs(ctx.cams.K[0], xs.to(torch.float32), ys.to(torch.float32))
    u = -torch.sum(plane[..., :3] * dirs, dim=-1) / plane[..., 3]
    k = (u - u_min) / du
    costs, oobs = [], []
    for v in range(1, ctx.num_views):
        c = cost_volume.fetch_cost(C[v - 1], xs, ys, k, ncc_volume.PAD_Y, ncc_volume.PAD_X)
        o = point_warp_oob(ctx, vs.consts[v - 1, 0], dirs, u)
        costs.append(torch.where(o, COST_MAX, c))
        oobs.append(o)
    oob_all = torch.cat([torch.ones_like(oobs[0])[None], torch.stack(oobs)])
    return _with_ref_view(ctx, torch.stack(costs), COST_MAX), oob_all


def cost_vector(ctx: CostContext, plane: torch.Tensor, radius: int, increment: int,
                xs: Optional[torch.Tensor] = None, ys: Optional[torch.Tensor] = None):
    """Per-view NCC costs [V, ...] (ComputeMultiViewCostVectorOld,
    APD.cu:707-716). On the volume path a grid evaluation [(C,) H, W, 4] is
    one H2 launch over all source views (the reference package's rebased,
    full-K and sweep evaluators compute these same costs), and a point
    evaluation with a standard window reads C36 / C9. Without volumes every
    evaluation warps directly (:func:`ncc_cost_view`), all source views at
    once."""
    vs = ctx.volumes
    if xs is None and vs is not None:
        return _grid_eval(ctx, plane, lambda planes_cf: ncc_volume.ncc_cost_views(
            vs.E, vs.ref_pad, planes_cf, vs.consts, vs.num_slices,
            radius=radius, increment=increment))
    if (xs is not None and vs is not None and vs.C36 is not None
            and (radius, increment) in ((5, 2), (5, 5))):
        costs, _ = point_cost_volume(ctx, plane, xs, ys,
                                     "C36" if (radius, increment) == (5, 2) else "C9")
        return costs
    return _with_ref_view(
        ctx, ncc_cost_view(ctx, _source_views(ctx), plane, radius, increment, xs, ys), COST_MAX)


def geom_cost_view(ctx: CostContext, v: torch.Tensor, plane: torch.Tensor,
                   xs: Optional[torch.Tensor] = None,
                   ys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Geometric consistency [Vs, ...] by direct reprojection through the
    depth maps of the source views ``v`` (a 1-D tensor; truncating nearest
    read), clamped at GEOM_COST_MAX;
    a zero source depth costs GEOM_COST_MAX (ComputeGeomConsistencyCost,
    APD.cu:752-789). Grid or point mode as :func:`ncc_cost_view`."""
    if ctx.depth_maps is None:
        raise ValueError("a geometric cost without depth volumes needs the context's "
                         "depth_maps")
    if xs is None:
        xs_, ys_, dirs = ctx.x, ctx.y, ctx.dirs
    else:
        xs_, ys_ = xs, ys
        dirs = geometry.pixel_dirs(ctx.cams.K[0], xs, ys)
    depth = -plane[..., 3] / torch.sum(plane[..., :3] * dirs, dim=-1)
    nd = depth.dim()
    cams = ctx.cams
    X = geometry.backproject_world(xs_, ys_, depth, cams.K[0], cams.R[0], cams.c[0])
    Kv, Rv = _per_view(cams.K, v, nd), _per_view(cams.R, v, nd)
    px, py, _ = geometry.project_camera(X, Kv, Rv, _per_view(cams.t, v, nd))
    H, W = ctx.height, ctx.width
    src_depth = sampling.nearest_sample_trunc_flat(ctx.depth_maps, _view_base(v, H, W, nd),
                                                   px, py)
    X2 = geometry.backproject_world(px, py, src_depth, Kv, Rv, _per_view(cams.c, v, nd))
    bx, by, _ = geometry.project_camera(X2, cams.K[0], cams.R[0], cams.t[0])
    err = torch.sqrt((xs_ - bx) ** 2 + (ys_ - by) ** 2)
    return torch.where(src_depth == 0.0, GEOM_COST_MAX, torch.clamp(err, max=GEOM_COST_MAX))


def geom_cost_vector(ctx: CostContext, plane: torch.Tensor,
                     xs: Optional[torch.Tensor] = None, ys: Optional[torch.Tensor] = None):
    """Per-view geometric-consistency costs [V, ...]
    (ComputeGeomConsistencyCost, APD.cu:752-789): on the volume path a grid
    evaluation is one H4 launch over all source views; without volumes
    every evaluation reprojects directly (:func:`geom_cost_view`)."""
    vs = ctx.volumes
    if xs is None and vs is not None:
        if vs.D is None:
            raise ValueError("a geometric pass needs depth volumes (add_depth_volumes)")
        return _grid_eval(ctx, plane, lambda planes_cf: ncc_volume.geom_cost_views(
            vs.D, planes_cf, vs.geom_consts, vs.num_slices), pad_value=GEOM_COST_MAX)
    return _with_ref_view(ctx, geom_cost_view(ctx, _source_views(ctx), plane, xs, ys),
                          GEOM_COST_MAX)


def initial_cost_and_views(ctx: CostContext, plane, radius: int, increment: int,
                           top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """FIRST_INIT seeding: mean of the top-k (<= 4) view costs below 2 and
    the selected-view mask [V, H, W] (APD.cu:616-662)."""
    costs = cost_vector(ctx, plane, radius, increment)  # [V, H, W]
    V = ctx.num_views
    num_valid = torch.sum(costs < COST_MAX, dim=0)
    k = torch.clamp(num_valid, max=top_k)
    sorted_costs = torch.sort(costs, dim=0).values
    ranks = torch.arange(V, device=costs.device).reshape(V, 1, 1)
    topk_sum = torch.sum(torch.where(ranks < k[None], sorted_costs, 0.0), dim=0)
    mean_cost = topk_sum / torch.clamp(k, min=1)
    kth = torch.gather(sorted_costs, 0, torch.clamp(k - 1, min=0)[None])[0]
    selected = (costs <= kth[None]) & ctx.src_valid.reshape(V, 1, 1)
    cost = torch.where(k > 0, mean_cost, COST_MAX)
    selected = selected & (k > 0)[None]
    return cost, selected


def recost_selected_views(ctx: CostContext, plane, selected, radius: int, increment: int):
    """REFINE_* re-seeding: cost the loaded hypothesis over the loaded
    selected views, dropping views that now fail (APD.cu:664-693; only the
    failing bit is cleared)."""
    costs = cost_vector(ctx, plane, radius, increment)
    ok = selected & (costs < COST_MAX)
    count = torch.sum(ok, dim=0)
    total = torch.sum(torch.where(ok, costs, 0.0), dim=0)
    cost = torch.where(count > 0, total / torch.clamp(count, min=1), COST_MAX)
    return cost, ok


def view_consts(vs: VolumeSet) -> torch.Tensor:
    """[V-1, 21] per-source-view warp constants (row v-1 = camera v)."""
    return vs.consts[:, 0]


def view_geom_consts(vs: VolumeSet) -> torch.Tensor:
    """[V-1, 33] per-source-view reprojection constants."""
    return vs.geom_consts[:, 0]
