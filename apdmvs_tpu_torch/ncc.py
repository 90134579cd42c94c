"""Multi-view NCC cost evaluation over plane-sweep volumes — the hot path.

PyTorch counterpart of the volume path of ``apdmvs_tpu/ncc.py``
(reference: ComputeBilateralNCCOld APD.cu:530-614, cost vectors
APD.cu:696-716, initial cost + top-k view seeding APD.cu:616-693, geometric
consistency APD.cu:752-789). Every grid evaluation goes through the volume
kernels of ``ops/``: the exact NCC (H2, every source view in one launch, read
from E alone) and the geometric cost (H4). The reference package routes its
NCC evaluations through rebased volumes, banded and full-K kernels
(``apdmvs_tpu/ncc.py``); they all compute the one function that H2 computes
from E, so the port has one NCC evaluator and builds no rebased volume. The
direct-warp path, the point mode and the space-sharded volumes of the
reference package are not ported.

Costs are "1 - NCC" clamped to [0, 2]; degenerate patches and out-of-view
warps cost 2. Index v of every per-view result is camera v; entry 0 (the
reference view) and invalid padding views are COST_MAX.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from apdmvs_tpu_torch import geometry
from apdmvs_tpu_torch.geometry import Cameras, WarpConstants
from apdmvs_tpu_torch.ops import cost_volume, ncc_volume, volume as vol

COST_MAX = ncc_volume.COST_MAX
GEOM_COST_MAX = ncc_volume.GEOM_COST_MAX


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
    """

    cams: Cameras
    wc: WarpConstants
    dirs: torch.Tensor  # [H, W, 3] ref pixel directions K_ref^{-1} p
    x: torch.Tensor  # [H, W]
    y: torch.Tensor  # [H, W]
    src_valid: torch.Tensor  # [V] bool
    volumes: VolumeSet

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
                 volumes: VolumeSet) -> CostContext:
    x, y = geometry.pixel_grid(height, width, cams.device)
    return CostContext(
        cams=cams,
        wc=geometry.warp_constants(cams),
        dirs=geometry.pixel_dirs(cams.K[0], x, y),
        x=x,
        y=y,
        src_valid=torch.as_tensor(src_valid, dtype=torch.bool, device=cams.device),
        volumes=volumes,
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
    """Shared harness: pad the plane fields onto the kernel grid, evaluate
    every source view (``evaluate(planes_cf) -> [V-1, C, Hp, Wp]``), slice
    back and put COST_MAX (``pad_value``) at view 0 and the invalid views:
    [V, (C,) H, W]."""
    vs = ctx.volumes
    if vs is None:
        raise ValueError("the port's cost path needs plane-sweep volumes")
    H, W = ctx.height, ctx.width
    Hp = vs.ref_pad.shape[0] - 2 * ncc_volume.PAD_Y
    Wp = vs.ref_pad.shape[1] - 2 * ncc_volume.PAD_X
    squeeze = plane.dim() == 3
    if squeeze:
        plane = plane[None]
    outs = evaluate(_pad_planes_cf(plane, Hp, Wp))[:, :, :H, :W]
    costs = torch.cat([torch.full_like(outs[0], pad_value)[None], outs])
    shape = (ctx.num_views,) + (1,) * (costs.ndim - 1)
    costs = torch.where(ctx.src_valid.reshape(shape), costs, pad_value)
    return costs[:, 0] if squeeze else costs


def cost_vector(ctx: CostContext, plane: torch.Tensor, radius: int, increment: int):
    """Per-view NCC costs [V, (C,) H, W] of plane fields [(C,) H, W, 4]
    (ComputeMultiViewCostVectorOld, APD.cu:707-716): one H2 launch over all
    source views. The reference package's rebased, full-K and sweep
    evaluators (``cost_vector``, ``cost_vector_full``, ``sweep_cost_vector``
    in ``apdmvs_tpu/ncc.py``) compute these same costs."""
    vs = ctx.volumes
    return _grid_eval(ctx, plane, lambda planes_cf: ncc_volume.ncc_cost_views(
        vs.E, vs.ref_pad, planes_cf, vs.consts, vs.num_slices,
        radius=radius, increment=increment))


def geom_cost_vector(ctx: CostContext, plane: torch.Tensor):
    """Per-view geometric-consistency costs [V, (C,) H, W]
    (ComputeGeomConsistencyCost, APD.cu:752-789)."""
    vs = ctx.volumes
    if vs.D is None:
        raise ValueError("a geometric pass needs depth volumes (add_depth_volumes)")

    def evaluate(planes_cf):
        return torch.stack([
            ncc_volume.geom_volume_cost_view(vs.D[v], planes_cf, vs.geom_consts[v],
                                             vs.num_slices)
            for v in range(vs.D.shape[0])
        ])

    return _grid_eval(ctx, plane, evaluate, pad_value=GEOM_COST_MAX)


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
