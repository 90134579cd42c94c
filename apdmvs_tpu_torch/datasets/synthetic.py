"""Synthetic multi-view plane scenes with exact ground truth.

The reference has no test suite (SURVEY.md §4); we build oracle scenes
instead: textured world planes rendered through real pinhole cameras, so
every view is photometrically consistent and depth/normal ground truth is
closed-form. The port's copy of the reference package's module, the same
code line for line, so the renders are bit-identical: the plane, card and
sphere scenes and their radiometric perturbation feed the port's tests,
``bench``, ``quality_table`` and ``chip_smoke.py``.

Rendering is pure NumPy (host-side, offline — mirrors the role of the
reference's dataset prep layer, colmap2mvsnet.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from apdmvs_tpu_torch.io import formats


@dataclasses.dataclass
class PlanePrim:
    """A textured world plane: points X with n . (X - p0) = 0."""

    p0: np.ndarray  # [3]
    n: np.ndarray  # [3] unit normal
    # texture basis vectors in the plane
    u: np.ndarray  # [3]
    v: np.ndarray  # [3]
    seed: int = 0
    texture_scale: float = 1.0
    flat: bool = False  # if True: constant intensity (weak texture)
    # textureless window in plane (u, v) coordinates: (u0, v0, u1, v1).
    # Because texture lives in plane space, the flat window is
    # photometrically consistent across views — a true weak-texture region
    # for exercising the APD anchor machinery.
    flat_box: Optional[Tuple[float, float, float, float]] = None


def _orthobasis(n: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    return u, v


def make_plane(p0, n, seed=0, texture_scale=1.0, flat=False, flat_box=None) -> PlanePrim:
    n = np.asarray(n, np.float64)
    n = n / np.linalg.norm(n)
    u, v = _orthobasis(n)
    return PlanePrim(
        p0=np.asarray(p0, np.float64),
        n=n,
        u=u,
        v=v,
        seed=seed,
        texture_scale=texture_scale,
        flat=flat,
        flat_box=flat_box,
    )


def _texture(plane: PlanePrim, uu: np.ndarray, vv: np.ndarray) -> np.ndarray:
    """Deterministic band-limited texture in [0, 255]."""
    if plane.flat:
        return np.full_like(uu, 128.0)
    rng = np.random.RandomState(plane.seed)
    val = np.zeros_like(uu)
    s = plane.texture_scale
    for _ in range(12):
        fx, fy = rng.uniform(0.5, 8.0, 2) * s
        ph = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.3, 1.0)
        val = val + amp * np.sin(2 * np.pi * (fx * uu + fy * vv) + ph)
    val = val / np.max(np.abs(val))
    tex = (val * 0.5 + 0.5) * 220.0 + 20.0
    if plane.flat_box is not None:
        u0, v0, u1, v1 = plane.flat_box
        inside = (uu >= u0) & (uu <= u1) & (vv >= v0) & (vv <= v1)
        tex = np.where(inside, 128.0, tex)
    return tex


@dataclasses.dataclass
class SpherePrim:
    """A textured sphere: |X - center| = radius. Curved-surface oracle
    (non-planar depth/normal fields; PatchMatch's local plane model must
    approximate it patch-wise)."""

    center: np.ndarray  # [3]
    radius: float
    seed: int = 0
    # lat/lon frequency scale: the visible normal field spans ~pi rad of
    # lon across the disk, so max freq 4*scale must stay under ~half a
    # cycle per pixel at the disk center (Nyquist for cross-view NCC)
    texture_scale: float = 8.0

    def intersect(self, origin: np.ndarray, dirs: np.ndarray):
        """Smallest positive ray parameter t (inf if miss) + hit normal.

        ``dirs`` need not be unit: the full quadratic a t^2 + 2 b t + c = 0
        with a = d.d is solved, so t stays in the caller's ray
        parameterization (same convention as the plane intersections)."""
        oc = origin - self.center
        a = np.sum(dirs * dirs, axis=-1)
        b = dirs @ oc
        c = oc @ oc - self.radius**2
        disc = b * b - a * c
        ok = disc > 0
        sq = np.sqrt(np.where(ok, disc, 0.0))
        t0 = (-b - sq) / a
        t1 = (-b + sq) / a
        tt = np.where(t0 > 1e-6, t0, t1)
        tt = np.where(ok & (tt > 1e-6), tt, np.inf)
        X = origin + dirs * np.where(np.isfinite(tt), tt, 0.0)[..., None]
        n = X - self.center
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        return tt, n

    def texture(self, X: np.ndarray) -> np.ndarray:
        """Band-limited texture in spherical (lat, lon) coordinates."""
        d = X - self.center
        d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        lat = np.arcsin(np.clip(d[..., 1], -1, 1))
        lon = np.arctan2(d[..., 0], d[..., 2])
        rng = np.random.RandomState(self.seed)
        val = np.zeros_like(lat)
        for _ in range(10):
            fx, fy = rng.uniform(0.5, 4.0, 2) * self.texture_scale
            ph = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.3, 1.0)
            val = val + amp * np.sin(fx * lon + fy * lat + ph)
        val = val / np.max(np.abs(val))
        return (val * 0.5 + 0.5) * 220.0 + 20.0


@dataclasses.dataclass
class CardPrim:
    """A finite textured rectangle (plane bounded in its (u, v) basis):
    the occluder primitive for occlusion scenes."""

    p0: np.ndarray
    n: np.ndarray
    half_u: float
    half_v: float
    seed: int = 0
    texture_scale: float = 3.0

    def __post_init__(self):
        self.n = self.n / np.linalg.norm(self.n)
        self.u, self.v = _orthobasis(self.n)


@dataclasses.dataclass
class SynthCamera:
    K: np.ndarray  # [3,3]
    R: np.ndarray  # [3,3]
    t: np.ndarray  # [3]
    width: int
    height: int

    @property
    def c(self) -> np.ndarray:
        return -self.R.T @ self.t


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)) -> Tuple[np.ndarray, np.ndarray]:
    """World->cam extrinsics for a camera at ``eye`` looking at ``target``."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    up = np.asarray(up, np.float64)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)  # rows
    t = -R @ eye
    return R, t


def render_view(
    cam: SynthCamera, planes: Sequence[PlanePrim]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render (image [H,W] f32, depth [H,W] f32, world normal [H,W,3] f32)."""
    H, W = cam.height, cam.width
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    fx, fy = cam.K[0, 0], cam.K[1, 1]
    cx, cy = cam.K[0, 2], cam.K[1, 2]
    dirs_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)
    dirs_world = dirs_cam @ cam.R  # R^T d
    origin = cam.c

    best_t = np.full((H, W), np.inf)
    img = np.zeros((H, W))
    normal = np.zeros((H, W, 3))
    for plane in planes:
        if isinstance(plane, CardPrim):
            denom = dirs_world @ plane.n
            denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
            tt = ((plane.p0 - origin) @ plane.n) / denom
            X = origin + dirs_world * tt[..., None]
            uu = (X - plane.p0) @ plane.u
            vv = (X - plane.p0) @ plane.v
            inside = (np.abs(uu) <= plane.half_u) & (np.abs(vv) <= plane.half_v)
            hit = (tt > 1e-6) & (tt < best_t) & inside
            rng = np.random.RandomState(plane.seed)
            val = np.zeros_like(uu)
            for _ in range(10):
                fx_, fy_ = rng.uniform(0.5, 8.0, 2) * plane.texture_scale
                ph = rng.uniform(0, 2 * np.pi)
                amp = rng.uniform(0.3, 1.0)
                val = val + amp * np.sin(2 * np.pi * (fx_ * uu + fy_ * vv) + ph)
            val = val / np.max(np.abs(val))
            tex = (val * 0.5 + 0.5) * 220.0 + 20.0
            img = np.where(hit, tex, img)
            best_t = np.where(hit, tt, best_t)
            normal = np.where(hit[..., None], plane.n, normal)
            continue
        if isinstance(plane, SpherePrim):
            tt, n_hit = plane.intersect(origin, dirs_world)
            hit = np.isfinite(tt) & (tt < best_t)
            X = origin + dirs_world * np.where(np.isfinite(tt), tt, 1.0)[..., None]
            tex = plane.texture(X)
            img = np.where(hit, tex, img)
            best_t = np.where(hit, tt, best_t)
            normal = np.where(hit[..., None], n_hit, normal)
            continue
        denom = dirs_world @ plane.n
        denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        tt = ((plane.p0 - origin) @ plane.n) / denom
        hit = (tt > 1e-6) & (tt < best_t)
        X = origin + dirs_world * tt[..., None]
        uu = (X - plane.p0) @ plane.u
        vv = (X - plane.p0) @ plane.v
        tex = _texture(plane, uu, vv)
        img = np.where(hit, tex, img)
        best_t = np.where(hit, tt, best_t)
        normal = np.where(hit[..., None], plane.n, normal)
    # depth = z in camera frame = t * (R d)_z = t * dirs_cam_z-normalized...
    # X_cam = R X + t; z-component:
    depth = best_t * (dirs_world @ cam.R[2])
    depth = np.where(np.isfinite(best_t), depth, 0.0)
    # normals oriented towards the camera (reference planes face the viewer)
    to_cam = origin - (origin + dirs_world * np.where(np.isfinite(best_t), best_t, 1.0)[..., None])
    flip = np.sum(normal * to_cam, -1) < 0
    normal = np.where(flip[..., None], -normal, normal)
    return img.astype(np.float32), depth.astype(np.float32), normal.astype(np.float32)


def make_ring_scene(
    num_views: int = 5,
    width: int = 160,
    height: int = 120,
    focal: float = 200.0,
    include_flat_region: bool = False,
    seed: int = 0,
) -> Tuple[List[SynthCamera], List[PlanePrim]]:
    """Cameras on a small arc looking at a two-plane 'corner' scene ~4m away.

    include_flat_region=True punches a textureless window into the first
    plane's texture (in plane coordinates, so it is photometrically
    consistent across views) — a true weak-texture region for the APD path.
    """
    planes = [
        make_plane(
            [0.0, 0.0, 4.0], [0.3, 0.1, -1.0], seed=seed + 1, texture_scale=2.0,
            flat_box=(-0.55, -0.45, 0.35, 0.45) if include_flat_region else None,
        ),
        make_plane([1.5, 0.0, 5.0], [-0.8, 0.0, -1.0], seed=seed + 2, texture_scale=2.0),
    ]
    cams = []
    for i in range(num_views):
        angle = (i - (num_views - 1) / 2.0) * 0.06
        eye = np.array([np.sin(angle) * 2.0, 0.02 * i, -np.cos(angle) * 0.2])
        R, t = look_at(eye, np.array([0.3, 0.0, 4.2]))
        K = np.array(
            [[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]]
        )
        cams.append(SynthCamera(K=K, R=R, t=t, width=width, height=height))
    return cams, planes


def make_occlusion_scene(
    num_views: int = 4,
    width: int = 160,
    height: int = 120,
    focal: float = 200.0,
    seed: int = 0,
) -> Tuple[List[SynthCamera], List[PlanePrim]]:
    """A foreground card occluding a background wall: with the arc baseline
    each view sees a different sliver of background next to the card, so
    fusion's consistency thresholds (reproj < 2 px, rel depth < 1%,
    APD.cpp:918-948) must reject half-occluded matches."""
    # background wall + floor-ish side plane
    planes = [
        make_plane([0.0, 0.0, 6.0], [0.05, 0.0, -1.0], seed=seed + 1, texture_scale=2.0),
        make_plane([0.0, 1.2, 4.0], [0.0, -1.0, -0.2], seed=seed + 2, texture_scale=2.0),
    ]
    # foreground card: a small tilted plane ~3 m away. Planes are infinite
    # in render_view, so bound it by giving it a finite textured window and
    # treating it as a card via a dedicated prim below.
    card = CardPrim(
        p0=np.array([-0.2, -0.1, 3.0]),
        n=np.array([0.15, 0.05, -1.0]) / np.linalg.norm([0.15, 0.05, -1.0]),
        half_u=0.45,
        half_v=0.35,
        seed=seed + 3,
    )
    prims: List = [card] + planes
    cams = []
    for i in range(num_views):
        angle = (i - (num_views - 1) / 2.0) * 0.09
        eye = np.array([np.sin(angle) * 2.2, 0.03 * i, -np.cos(angle) * 0.25])
        R, t = look_at(eye, np.array([0.0, 0.0, 4.5]))
        K = np.array(
            [[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]]
        )
        cams.append(SynthCamera(K=K, R=R, t=t, width=width, height=height))
    return cams, prims


def make_curved_scene(
    num_views: int = 4,
    width: int = 160,
    height: int = 120,
    focal: float = 200.0,
    seed: int = 0,
) -> Tuple[List[SynthCamera], List]:
    """A textured sphere in front of a wall: curvature breaks the global
    plane model, so recovery relies on PatchMatch's per-pixel local
    planes (the reference's operating regime on real scenes)."""
    prims = [
        SpherePrim(center=np.array([0.1, 0.0, 4.2]), radius=0.9, seed=seed + 1),
        # wall at ~6.7 m: focal 200 maps 1 world unit to ~30 px, so
        # texture_scale must keep max freq (8*scale cycles/unit) under
        # ~0.5 cycles/px (Nyquist) -> scale <= ~1.5
        make_plane([0.0, 0.0, 6.5], [0.0, 0.05, -1.0], seed=seed + 2, texture_scale=1.0),
    ]
    cams = []
    for i in range(num_views):
        # 0.11 rad steps at ~2 m orbit: ~0.22 m adjacent baselines keep
        # wall-depth sensitivity (z^2/(f*B)) inside sub-pixel-refinable range
        angle = (i - (num_views - 1) / 2.0) * 0.11
        eye = np.array([np.sin(angle) * 2.0, 0.02 * i, -np.cos(angle) * 0.2])
        R, t = look_at(eye, np.array([0.1, 0.0, 4.2]))
        K = np.array(
            [[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]]
        )
        cams.append(SynthCamera(K=K, R=R, t=t, width=width, height=height))
    return cams, prims


def perturb_radiometric(
    images: np.ndarray,
    gain_sigma: float = 0.08,
    bias_sigma: float = 6.0,
    noise_sigma: float = 2.0,
    seed: int = 0,
) -> np.ndarray:
    """Per-view radiometric gain/bias + pixel noise (real capture
    conditions; NCC is affine-invariant so matching should survive —
    SURVEY.md §7 item 5's robustness axis)."""
    rng = np.random.RandomState(seed)
    V = images.shape[0]
    gains = 1.0 + rng.randn(V, 1, 1) * gain_sigma
    biases = rng.randn(V, 1, 1) * bias_sigma
    noisy = images * gains + biases + rng.randn(*images.shape) * noise_sigma
    return np.clip(noisy, 0.0, 255.0).astype(np.float32)


def gt_cloud(
    cams: Sequence[SynthCamera],
    depths: np.ndarray,
    stride: int = 1,
) -> np.ndarray:
    """Ground-truth world points from oracle depth maps (for
    eval.cloud_metrics)."""
    pts = []
    for i, cam in enumerate(cams):
        d = depths[i][::stride, ::stride]
        H, W = depths[i].shape
        ys, xs = np.mgrid[0:H:stride, 0:W:stride].astype(np.float64)
        valid = d > 0
        fx, fy = cam.K[0, 0], cam.K[1, 1]
        cx, cy = cam.K[0, 2], cam.K[1, 2]
        dirs = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)
        Xc = dirs * d[..., None]
        Xw = (Xc - cam.t) @ cam.R  # R^T (Xc - t)
        pts.append(Xw[valid])
    return np.concatenate(pts, axis=0)


def render_scene(
    cams: Sequence[SynthCamera], planes: Sequence[PlanePrim]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render all views: images [V,H,W], depths [V,H,W], normals [V,H,W,3]."""
    imgs, deps, nors = [], [], []
    for cam in cams:
        i, d, n = render_view(cam, planes)
        imgs.append(i)
        deps.append(d)
        nors.append(n)
    return np.stack(imgs), np.stack(deps), np.stack(nors)


def write_mvsnet_dataset(
    folder: str | os.PathLike,
    cams: Sequence[SynthCamera],
    planes: Sequence[PlanePrim],
    depth_ranges: Tuple[float, float] = (2.0, 8.0),
    images: Optional[np.ndarray] = None,
) -> None:
    """Materialize the on-disk dataset contract the pipeline consumes
    (images/%08d.jpg, cams/%08d_cam.txt, pair.txt), as produced by the
    reference's converter (colmap2mvsnet.py). ``images`` overrides the
    clean renders (e.g. perturb_radiometric output)."""
    from PIL import Image

    folder = str(folder)
    os.makedirs(os.path.join(folder, "images"), exist_ok=True)
    os.makedirs(os.path.join(folder, "cams"), exist_ok=True)
    if images is None:
        images, _, _ = render_scene(cams, planes)
    pairs = []
    n = len(cams)
    for i, cam in enumerate(cams):
        idx = formats.to_format_index(i)
        Image.fromarray(np.clip(images[i], 0, 255).astype(np.uint8)).save(
            os.path.join(folder, "images", f"{idx}.jpg"), quality=98
        )
        dmin, dmax = depth_ranges
        interval = (dmax - dmin) / 192.0
        formats.write_camera(
            os.path.join(folder, "cams", f"{idx}_cam.txt"),
            cam.K,
            cam.R,
            cam.t,
            dmin,
            interval,
            192.0,
            dmax,
        )
        srcs = [(j, float(n - abs(i - j))) for j in range(n) if j != i]
        srcs.sort(key=lambda x: -x[1])
        pairs.append((i, srcs))
    formats.write_pair_file(os.path.join(folder, "pair.txt"), pairs)
