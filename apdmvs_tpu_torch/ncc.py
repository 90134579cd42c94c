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

A spaced set (``parallel/spaced.py``: one VolumeSet per row slab, each
on its own device; ``apdmvs_tpu/ncc.py:788-1136``) is built by
:func:`build_volume_set_spaced` and evaluated slab by slab through the
same kernels (:func:`_spaced_grid_call`); the results are stitched back
on the pass's device and equal the unsharded evaluation bit for bit. The
reference package's ``rebase_volume_set_spaced`` (``:1083-1136``) has no
counterpart: the port builds no rebased volume, and H2 from each slab's E
gives the same costs.

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
    def spaced(self) -> bool:
        """False: one set over the whole image (``parallel.spaced`` holds
        the row-slab form)."""
        return False

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
    and C9 of the weak machinery: the one slab of :func:`_volume_slabs` on
    the device of ``images``. They depend only on (images, cameras, depth
    grid), so the scene runner builds them once per (problem, scale) and
    reuses them across the round's passes."""
    return _volume_slabs(images, cams, depth_min, depth_max, [images.device], num_slices,
                         None, weak_cost_volumes)[0][0]


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
    Hp = vs.ref_pad.shape[0] - 2 * ncc_volume.PAD_Y
    Wp = vs.ref_pad.shape[1] - 2 * ncc_volume.PAD_X
    u_min, du = vol.inv_depth_grid(depth_min, depth_max, vs.num_slices)
    wc = geometry.warp_constants(cams)
    return vs._replace(
        D=_depth_volumes(depth_maps, wc.M, wc.b, cams.K[0], u_min, du, vs.num_slices, Hp, Wp),
        geom_consts=_geom_consts(cams, u_min, du, W, H))


def _depth_volumes(depth_maps, M, b, K_ref, u_min, du, K: int, Hp: int, Wp: int,
                   row0: int = 0) -> torch.Tensor:
    """[V-1, K, Hp, Wp] f32 depth volumes of the source views (H1, trunc
    mode; warp constants M, b [V, ...]) over the rows [row0, row0 + Hp)."""
    return torch.stack([vol.build_volume(
        depth_maps[v], M[v], b[v], K_ref, Hp, Wp, u_min, du, K,
        pad_y=0, pad_x=0, dtype=torch.float32, trunc=True, row0=row0,
    ) for v in range(1, depth_maps.shape[0])])


def _geom_consts(cams: Cameras, u_min, du, W: int, H: int) -> torch.Tensor:
    """[V-1, 1, 33] reprojection constants of the source views (row0 0)."""
    wc = geometry.warp_constants(cams)
    K_ref, R_ref = cams.K[0], cams.R[0]
    KR = geometry.mat3_mat3(K_ref, R_ref)
    gconsts = []
    for v in range(1, cams.K.shape[0]):
        A = geometry.mat3_mat3(
            geometry.mat3_mat3(KR, cams.R[v].transpose(-1, -2)),
            geometry.k_inverse_zero_skew(cams.K[v]),
        )
        t2 = geometry.mat3_vec(KR, cams.c[v] - cams.c[0])
        gconsts.append(ncc_volume.pack_geom_consts(
            K_ref, wc.M[v], wc.b[v], A, t2, u_min, du, W, H))
    return torch.stack(gconsts)


# ---------------------------------------------------------------------------
# Space-sharded (row-slab) volumes: ``apdmvs_tpu/ncc.py:788-1136``,
# ``parallel/spaced.py``
# ---------------------------------------------------------------------------


def _with_row0(consts: torch.Tensor, row0: int, device) -> torch.Tensor:
    """Packed constants [V-1, 1, n] with their last entry (row0) set, on
    ``device``: every other constant is computed once, so all slabs carry
    the same bits."""
    out = consts.clone()
    out[..., -1] = float(row0)
    return out.to(device)


def build_volume_set_spaced(images: torch.Tensor, cams: Cameras, depth_min, depth_max,
                            devices, num_slices: int = 160,
                            depth_maps: Optional[torch.Tensor] = None,
                            weak_cost_volumes: bool = True):
    """The volumes of :func:`build_image_volume_set` (and, with
    ``depth_maps``, of :func:`add_depth_volumes`) as ``S = len(devices)``
    row slabs, slab s on ``devices[s]`` (``apdmvs_tpu/ncc.py:824-963``);
    returns a ``parallel.spaced.SpacedVolumeSet``. ``devices[0]`` must be
    the device of ``images``, where the pass runs."""
    from apdmvs_tpu_torch.parallel.spaced import SpacedVolumeSet

    devices = [torch.device(d) for d in devices]
    if devices[0] != images.device:
        raise ValueError(f"slab 0 must live on the pass's device {images.device}, "
                         f"not {devices[0]}")
    slabs, Hs, Hp, Wp = _volume_slabs(images, cams, depth_min, depth_max, devices, num_slices,
                                      depth_maps, weak_cost_volumes)
    return SpacedVolumeSet(slabs=tuple(slabs), Hs=Hs, Hp=Hp, Wp=Wp)


def _volume_slabs(images, cams: Cameras, depth_min, depth_max, devices, num_slices: int,
                  depth_maps, weak_cost_volumes: bool):
    """One VolumeSet per row slab, slab s on ``devices[s]``; returns
    (slabs, Hs, Hp, Wp). Slab s owns the interior rows [s*Hs, (s+1)*Hs) of
    the padded grid, Hp = ceil(H, NCC_TILE_H * S), Wp = ceil(W, TILE_W),
    and stores PAD_Y halo rows on each side: E (and D, with
    ``depth_maps``) through H1 with ``row0 = s*Hs`` (exact: an integer
    below 2^24 in float32), the consts with row0 at their last index, the
    reference slab cut from the globally edge-padded reference image, C36
    and C9 built on the slab. E, D and the interior rows of C36 and C9
    equal the rows of one slab over the whole grid bit for bit; C36 and C9
    rows within the window radius of an inner slab edge carry the slab's
    own clamped sums, and no lookup reads them (``weak.build_weak_cols``
    takes each row from the slab that owns it)."""
    V, H, W = images.shape
    S = len(devices)
    PAD_Y, PAD_X = ncc_volume.PAD_Y, ncc_volume.PAD_X
    Hp = _ceil_to(H, ncc_volume.NCC_TILE_H * S)
    Hs = Hp // S
    Wp = _ceil_to(W, ncc_volume.TILE_W)
    u_min, du = vol.inv_depth_grid(depth_min, depth_max, num_slices)
    wc = geometry.warp_constants(cams)
    consts = torch.stack([ncc_volume.pack_consts(cams.K[0], wc.M[v], wc.b[v], u_min, du, W, H)
                          for v in range(1, V)])
    ref_pad = _edge_pad(images[0].float(), PAD_Y, PAD_Y + Hp - H, PAD_X, PAD_X + Wp - W)
    gconsts = None if depth_maps is None else _geom_consts(cams, u_min, du, W, H)
    slabs = []
    for s, dev in enumerate(devices):
        row0 = s * Hs
        M, b, K_ref = wc.M.to(dev), wc.b.to(dev), cams.K[0].to(dev)
        E = torch.stack([vol.build_volume(
            images[v].to(dev), M[v], b[v], K_ref, Hs, Wp, u_min, du, num_slices,
            pad_y=PAD_Y, pad_x=PAD_X, dtype=torch.bfloat16, row0=row0,
        ) for v in range(1, V)])
        ref_slab = ref_pad[row0:row0 + Hs + 2 * PAD_Y].to(dev, copy=True)
        C36 = C9 = None
        if weak_cost_volumes:
            C36 = torch.stack([cost_volume.build_cost_volume(e, ref_slab, 5, 2) for e in E])
            C9 = torch.stack([cost_volume.build_cost_volume(e, ref_slab, 5, 5) for e in E])
        slab = VolumeSet(E=E, consts=_with_row0(consts, row0, dev), ref_pad=ref_slab,
                         C36=C36, C9=C9)
        if depth_maps is not None:
            slab = slab._replace(
                D=_depth_volumes(depth_maps.to(dev), M, b, K_ref, u_min, du, num_slices, Hs,
                                 Wp, row0=row0),
                geom_consts=_with_row0(gconsts, row0, dev))
        slabs.append(slab)
    return slabs, Hs, Hp, Wp


def first_slab(vs) -> VolumeSet:
    """``vs`` itself, or slab 0 of a spaced set: the copy of the fields
    that are the same in every slab (every constant but row0, the slice
    grid, which volumes the set carries), on the pass's device."""
    return vs.slabs[0] if vs.spaced else vs


def _spaced_grid_call(ctx: CostContext, plane: torch.Tensor, evaluate, pad_value=COST_MAX):
    """The spaced form of :func:`_grid_eval` (``apdmvs_tpu/ncc.py:966-1026``):
    pad the plane fields onto the (Hp, Wp) grid, cut each slab's rows, move
    them to the slab's device, evaluate (``evaluate(slab, planes_cf) ->
    [V-1, C, Hs, Wp]``), move the result back to the pass's device and
    stitch the rows. Slabs that hold no image row are not evaluated."""
    vs = ctx.volumes
    H, W = ctx.height, ctx.width
    squeeze = plane.dim() == 3
    if squeeze:
        plane = plane[None]
    planes_cf = _pad_planes_cf(plane, vs.Hp, vs.Wp)
    outs = []
    for s, slab in enumerate(vs.slabs):
        r0, r1 = vs.slab_rows(s)
        if r0 >= H:
            break
        outs.append(evaluate(slab, planes_cf[:, :, r0:r1].to(slab.E.device)).to(plane.device))
    costs = _with_ref_view(ctx, torch.cat(outs, dim=2)[:, :, :H, :W], pad_value)
    return costs[:, 0] if squeeze else costs


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
    if vs.spaced:
        raise ValueError("point-mode cost-volume reads index whole volumes; a spaced set's "
                         "weak machinery reads its resident columns (weak.build_weak_cols)")
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
        def views(sl, planes_cf):
            return ncc_volume.ncc_cost_views(sl.E, sl.ref_pad, planes_cf, sl.consts,
                                             sl.num_slices, radius=radius, increment=increment)

        if vs.spaced:  # one H2 launch per slab (apdmvs_tpu/ncc.py:1029-1062)
            return _spaced_grid_call(ctx, plane, views)
        return _grid_eval(ctx, plane, lambda planes_cf: views(vs, planes_cf))
    if xs is not None and vs is not None and vs.spaced:
        raise ValueError("a spaced set evaluates full grids only")
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
        if first_slab(vs).D is None:
            raise ValueError("a geometric pass needs depth volumes (add_depth_volumes)")

        def views(sl, planes_cf):
            return ncc_volume.geom_cost_views(sl.D, planes_cf, sl.geom_consts, sl.num_slices)

        if vs.spaced:  # one H4 launch per slab (apdmvs_tpu/ncc.py:1065-1080)
            return _spaced_grid_call(ctx, plane, views, pad_value=GEOM_COST_MAX)
        return _grid_eval(ctx, plane, lambda planes_cf: views(vs, planes_cf),
                          pad_value=GEOM_COST_MAX)
    if xs is not None and vs is not None and vs.spaced:
        raise ValueError("a spaced set evaluates full grids only")
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


def view_consts(vs) -> torch.Tensor:
    """[V-1, 21] per-source-view warp constants (row v-1 = camera v); of a
    spaced set slab 0's copy (``apdmvs_tpu/ncc.py:792-801``): only row0
    (index 20) differs between slabs, and no caller of this reads it."""
    return first_slab(vs).consts[:, 0]


def view_geom_consts(vs) -> torch.Tensor:
    """[V-1, 33] per-source-view reprojection constants (slab 0's copy of a
    spaced set, as :func:`view_consts`)."""
    return first_slab(vs).geom_consts[:, 0]
