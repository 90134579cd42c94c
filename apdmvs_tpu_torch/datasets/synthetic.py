"""Synthetic multi-view plane scenes with exact ground truth.

The reference has no test suite (SURVEY.md §4); we build oracle scenes
instead: textured world planes rendered through real pinhole cameras, so
every view is photometrically consistent and depth/normal ground truth is
closed-form. The port's copy keeps the plane scenes: ``chip_smoke.py``,
``trace_pass`` and the port's CLI test render the ring scene with it.

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
    clean renders."""
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
