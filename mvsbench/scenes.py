"""The scene generator: a configuration's rig and a workload's objects, made
from a seed, rendered in PyTorch on the device and written in the MVSNet
layout that ``apdmvs_tpu_torch.scene.run_scene`` reads (``images/``,
``cams/``, ``pair.txt``).

The geometry of a cell is fixed by its files; the seed draws the textures
(the phase of each wave, its frequency and direction within their own
steps of the band and of the half-turn, and which direction goes with
which frequency) and the sensor noise, so every seed gives the
same sizes, the same surfaces, the same spectrum and the same textureless
share, with other images. The renderer is the
benchmark's own (after ``datasets/synthetic.py``'s ``render_view``): it
also gives the ground truth the judge of ``correct`` holds the program to,
exact depth, normal and the textureless mask of every pixel.

Objects (``"type"``):

- ``plane``: ``p0``, ``n``; an infinite plane, optionally with a
  textureless ``flat_box`` [u0, v0, u1, v1] in its (u, v) coordinates;
- ``card``: ``p0``, ``n``, ``half_u``, ``half_v``; a bounded rectangle;
- ``sphere``: ``center``, ``radius``.

Each takes ``flat`` (true: one albedo, ``flat_value``, all over) or a
texture: ``waves`` sinusoids of ``freq`` [lo, hi] cycles a unit of
length, in the plane's (u, v) or the sphere's (longitude, latitude)
radians times ``radius``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Sequence

import numpy as np
import torch

SEED_MOD = 2 ** 63


@dataclasses.dataclass
class Camera:
    K: np.ndarray  # [3, 3]
    R: np.ndarray  # [3, 3] world to camera
    t: np.ndarray  # [3]

    @property
    def center(self) -> np.ndarray:
        return -self.R.T @ self.t


@dataclasses.dataclass
class Scene:
    """A scene as rendered: cameras, objects with their drawn textures,
    and per view the image (uint8) and ground truth (on the host)."""

    cameras: List[Camera]
    objects: List[dict]
    width: int
    height: int
    depth_min: float
    depth_max: float
    images: np.ndarray  # [V, H, W] uint8
    depth: np.ndarray  # [V, H, W] float32, 0 where no surface
    normal: np.ndarray  # [V, H, W, 3] float32, world frame, facing the camera
    flat: np.ndarray  # [V, H, W] bool, textureless surface
    sources: List[List[int]]  # per view, its source views as pair.txt lists them


def sub_seed(seed: int, *path: int) -> np.random.SeedSequence:
    """A seed sequence for one part of the scene; any whole ``seed``."""
    return np.random.SeedSequence([int(seed) % SEED_MOD] + [int(p) for p in path])


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def _basis(n: np.ndarray):
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = _unit(np.cross(n, a))
    return u, np.cross(n, u)


def look_at(eye, target, down=(0.0, 1.0, 0.0)):
    """World-to-camera (R, t) of a camera at ``eye`` looking at ``target``,
    the image's rows running along ``down`` (world +y is down)."""
    eye = np.asarray(eye, np.float64)
    z = _unit(np.asarray(target, np.float64) - eye)
    x = _unit(np.cross(np.asarray(down, np.float64), z))
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return R, -R @ eye


def rig(cfg: dict) -> List[Camera]:
    """The configuration's cameras: ``num_views`` on an arc of ``radius``
    about ``target``, ``step_rad`` apart, ``rise`` higher each."""
    r = cfg["rig"]
    n, W, H, f = cfg["num_views"], cfg["width"], cfg["height"], cfg["focal_px"]
    target = np.asarray(r["target"], np.float64)
    K = np.array([[f, 0.0, W / 2.0], [0.0, f, H / 2.0], [0.0, 0.0, 1.0]])
    cams = []
    for i in range(n):
        a = (i - (n - 1) / 2.0) * r["step_rad"]
        eye = target + np.array([r["radius"] * math.sin(a), r["rise"] * i,
                                 -r["radius"] * math.cos(a)])
        R, t = look_at(eye, target)
        cams.append(Camera(K=K.copy(), R=R, t=t))
    return cams


def draw_objects(objects: Sequence[dict], seed: int) -> List[dict]:
    """The workload's objects with their textures drawn from ``seed``:
    each textured object gets ``waves`` rows of (direction cos, sin,
    frequency, phase, amplitude)."""
    out = []
    for i, obj in enumerate(objects):
        o = dict(obj)
        if o["type"] in ("plane", "card"):
            o["n"] = _unit(o["n"])
            o["u"], o["v"] = _basis(o["n"])
            o["p0"] = np.asarray(o["p0"], np.float64)
        else:
            o["center"] = np.asarray(o["center"], np.float64)
        if not o.get("flat", False):
            rng = np.random.default_rng(sub_seed(seed, 1, i))
            k = int(o["waves"])
            lo, hi = o["freq"]
            # one wave in each of k equal steps of log frequency and one in
            # each of k equal steps of direction, paired at random, all of
            # one amplitude: every seed's texture has the same spectrum and
            # no seed's texture runs along one direction
            freq = lo * (hi / lo) ** ((np.arange(k) + rng.uniform(0.0, 1.0, k)) / k)
            ang = math.pi * (rng.permutation(k) + rng.uniform(0.0, 1.0, k)) / k
            o["wave_table"] = np.stack([np.cos(ang), np.sin(ang), freq,
                                        rng.uniform(0.0, 2 * math.pi, k), np.ones(k)], axis=1)
        out.append(o)
    return out


def _texture(o: dict, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Albedo at surface coordinates (a, b) (length units): 128 plus 45 times
    a sum of waves of unit deviation, within [10, 245]."""
    if o.get("flat", False):
        return torch.full_like(a, float(o.get("flat_value", 128.0)))
    table = torch.as_tensor(o["wave_table"], dtype=a.dtype, device=a.device)
    val = torch.zeros_like(a)
    for c, s, f, ph, amp in table:
        val += amp * torch.sin(2 * math.pi * f * (c * a + s * b) + ph)
    val = val / torch.sqrt(0.5 * (table[:, 4] ** 2).sum())  # unit standard deviation
    tex = torch.clamp(128.0 + 45.0 * val, 10.0, 245.0)
    box = o.get("flat_box")
    if box is not None:
        inside = (a >= box[0]) & (a <= box[2]) & (b >= box[1]) & (b <= box[3])
        tex = torch.where(inside, torch.full_like(tex, float(o.get("flat_value", 128.0))), tex)
    return tex


def _flat_at(o: dict, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if o.get("flat", False):
        return torch.ones_like(a, dtype=torch.bool)
    box = o.get("flat_box")
    if box is None:
        return torch.zeros_like(a, dtype=torch.bool)
    return (a >= box[0]) & (a <= box[2]) & (b >= box[1]) & (b <= box[3])


def _hit(o: dict, origin: torch.Tensor, dirs: torch.Tensor):
    """Ray parameter (inf on a miss), world normal and surface coordinates
    of object ``o`` along ``dirs`` [..., 3] from ``origin`` [3]."""
    dev, dt = dirs.device, dirs.dtype
    if o["type"] == "sphere":
        c = torch.as_tensor(o["center"], dtype=dt, device=dev)
        r = float(o["radius"])
        oc = origin - c
        qa = (dirs * dirs).sum(-1)
        qb = dirs @ oc
        qc = oc @ oc - r * r
        disc = qb * qb - qa * qc
        ok = disc > 0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0, t1 = (-qb - sq) / qa, (-qb + sq) / qa
        t = torch.where(t0 > 1e-9, t0, t1)
        t = torch.where(ok & (t > 1e-9), t, torch.full_like(t, math.inf))
        X = origin + dirs * torch.where(torch.isfinite(t), t, torch.zeros_like(t))[..., None]
        n = (X - c) / r
        lon = torch.atan2(n[..., 0], n[..., 2]) * r
        lat = torch.asin(torch.clamp(n[..., 1], -1.0, 1.0)) * r
        return t, n, lon, lat
    n0 = torch.as_tensor(o["n"], dtype=dt, device=dev)
    p0 = torch.as_tensor(o["p0"], dtype=dt, device=dev)
    denom = dirs @ n0
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    t = ((p0 - origin) @ n0) / denom
    X = origin + dirs * t[..., None]
    a = (X - p0) @ torch.as_tensor(o["u"], dtype=dt, device=dev)
    b = (X - p0) @ torch.as_tensor(o["v"], dtype=dt, device=dev)
    ok = t > 1e-9
    if o["type"] == "card":
        ok &= (a.abs() <= o["half_u"]) & (b.abs() <= o["half_v"])
    t = torch.where(ok, t, torch.full_like(t, math.inf))
    return t, n0.expand_as(dirs), a, b


def render_view(cam: Camera, objects: Sequence[dict], width: int, height: int, device,
                noise_sigma: float, gen: torch.Generator):
    """(image uint8 [H, W], depth f32, world normal f32 [H, W, 3], flat
    bool) of one view, in float64 on ``device``. Pixel (x, y) looks along
    K^-1 (x, y, 1), the program's convention, so the ray parameter is the
    depth."""
    dt = torch.float64
    ys, xs = torch.meshgrid(torch.arange(height, device=device, dtype=dt),
                            torch.arange(width, device=device, dtype=dt), indexing="ij")
    K = cam.K
    dirs_cam = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                            torch.ones_like(xs)], -1)
    R = torch.as_tensor(cam.R, dtype=dt, device=device)
    dirs = dirs_cam @ R  # R^T d, row vectors
    origin = torch.as_tensor(cam.center, dtype=dt, device=device)
    best = torch.full((height, width), math.inf, dtype=dt, device=device)
    img = torch.zeros_like(best)
    normal = torch.zeros((height, width, 3), dtype=dt, device=device)
    flat = torch.zeros((height, width), dtype=torch.bool, device=device)
    for o in objects:
        t, n, a, b = _hit(o, origin, dirs)
        hit = t < best
        best = torch.where(hit, t, best)
        img = torch.where(hit, _texture(o, a, b), img)
        normal = torch.where(hit[..., None], n, normal)
        flat = torch.where(hit, _flat_at(o, a, b), flat)
    found = torch.isfinite(best)
    depth = torch.where(found, best, torch.zeros_like(best))
    # normals face the camera
    flip = (normal * dirs).sum(-1) > 0
    normal = torch.where(flip[..., None], -normal, normal)
    noise = torch.randn((height, width), generator=gen, device=device, dtype=torch.float32)
    img = img.to(torch.float32) + float(noise_sigma) * noise
    img = torch.clamp(torch.round(img), 0, 255).to(torch.uint8)
    return img, depth.to(torch.float32), normal.to(torch.float32), flat & found


def sources(num_views: int, num_sources: int) -> List[List[int]]:
    """Each view's ``num_sources`` nearest views along the rig, the nearest
    first (the lower index of two as near)."""
    return [sorted((j for j in range(num_views) if j != i), key=lambda j: (abs(i - j), j))
            [:num_sources] for i in range(num_views)]


def make_scene(cfg: dict, traffic: dict, seed: int, device) -> Scene:
    """Render every view of the cell's scene for ``seed`` on ``device``;
    the ground truth goes back to the host."""
    cams = rig(cfg)
    objects = draw_objects(traffic["scene"]["objects"], seed)
    W, H = cfg["width"], cfg["height"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(sub_seed(seed, 2).generate_state(2, np.uint64)[0]) % SEED_MOD)
    views = [render_view(c, objects, W, H, device, traffic["scene"]["noise_sigma"], gen)
             for c in cams]
    imgs, depth, normal, flat = (torch.stack([v[i] for v in views]).cpu().numpy()
                                 for i in range(4))
    return Scene(cameras=cams, objects=objects, width=W, height=H,
                 depth_min=float(cfg["depth_min"]), depth_max=float(cfg["depth_max"]),
                 images=imgs, depth=depth, normal=normal, flat=flat,
                 sources=sources(len(cams), int(cfg["num_sources"])))


def write_mvsnet(folder: str, scene: Scene, cfg: dict) -> None:
    """``images/%08d.jpg`` (grey JPEG), ``cams/%08d_cam.txt`` (extrinsic,
    intrinsic, depth_min interval depth_num depth_max) and ``pair.txt``
    (each view's sources, :func:`sources`)."""
    from PIL import Image

    os.makedirs(os.path.join(folder, "images"), exist_ok=True)
    os.makedirs(os.path.join(folder, "cams"), exist_ok=True)
    n = len(scene.cameras)
    interval = (scene.depth_max - scene.depth_min) / float(cfg["depth_num"])
    for i, cam in enumerate(scene.cameras):
        Image.fromarray(scene.images[i], mode="L").save(
            os.path.join(folder, "images", f"{i:08d}.jpg"), quality=int(cfg["jpeg_quality"]))
        R, t, K = cam.R.tolist(), cam.t.tolist(), cam.K.tolist()
        lines = ["extrinsic"]
        lines += [f"{R[r][0]!r} {R[r][1]!r} {R[r][2]!r} {t[r]!r}" for r in range(3)]
        lines += ["0.0 0.0 0.0 1.0", "", "intrinsic"]
        lines += [f"{K[r][0]!r} {K[r][1]!r} {K[r][2]!r}" for r in range(3)]
        lines += ["", f"{scene.depth_min!r} {interval!r} {float(cfg['depth_num'])!r} "
                      f"{scene.depth_max!r}"]
        with open(os.path.join(folder, "cams", f"{i:08d}_cam.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(folder, "pair.txt"), "w") as f:
        f.write(f"{n}\n")
        for i, srcs in enumerate(scene.sources):
            f.write(f"{i}\n{len(srcs)} " + " ".join(f"{j} {float(n - abs(i - j))!r}"
                                                   for j in srcs) + "\n")
