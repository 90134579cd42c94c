"""The judge of ``correct``: the program's outputs held against the scene's
exact ground truth, in plain PyTorch and NumPy. It reads the files that
``run_scene`` leaves (``APD/<id>/depths.dmb``, ``normals.dmb``,
``weak.bin``; ``APD/APD.ply``) with readers of its own, and imports
nothing of the program.

Two layers are judged:

- the pass layer (``pipeline.patchmatch_pass`` and its kernels), through
  each view's final depth, normal and pixel-state maps against the
  rendered depth and normal, per view and over all views;
- the fusion layer (``scene.run_fusion``), through the fused cloud: each
  point's distance to the nearest surface of the scene, which parts of
  each view's visible surface some consistent point covers, and whether
  each point is what the fusion, worked out again in float64 from the
  program's own final maps, would emit.

Every number is an error or a share of things that went wrong, so a
higher number is worse, and ``correct`` holds where each compared number
is at most its limit (``check.limits`` of the workload file).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional

import numpy as np
import torch

_CV_DTYPES = {0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16, 4: np.int32,
              5: np.float32, 6: np.float64}
PIXEL_STATES = (0, 1, 2)  # WEAK, STRONG, UNKNOWN


def read_mat(path: str) -> np.ndarray:
    """A ``.dmb`` / ``.bin`` matrix: int32 version 1, rows, cols, an
    OpenCV type (depth in the low 3 bits, channels - 1 above), then the
    data, little-endian."""
    with open(path, "rb") as f:
        version, rows, cols, cv_type = struct.unpack("<iiii", f.read(16))
        if version != 1:
            raise ValueError(f"{path}: version {version}")
        ch = (cv_type >> 3) + 1
        dtype = np.dtype(_CV_DTYPES[cv_type & 7])
        data = np.frombuffer(f.read(rows * cols * ch * dtype.itemsize), dtype=dtype)
    if data.size != rows * cols * ch:
        raise ValueError(f"{path}: short file")
    return data.reshape((rows, cols) if ch == 1 else (rows, cols, ch)).copy()


def read_ply_points(path: str) -> np.ndarray:
    """The vertices [N, 3] float32 of a binary little-endian PLY whose
    vertex holds x, y, z floats and three colour bytes."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            header += line
        text = header.decode("ascii")
        if "binary_little_endian" not in text:
            raise ValueError(f"{path}: not binary little-endian")
        n = next(int(ln.split()[-1]) for ln in text.splitlines()
                 if ln.startswith("element vertex"))
        rec = np.frombuffer(f.read(n * 15), dtype=[("xyz", "<f4", 3), ("bgr", "u1", 3)])
    if rec.shape[0] != n:
        raise ValueError(f"{path}: {rec.shape[0]} of {n} vertices")
    return rec["xyz"].copy()


def snapshot(dense_folder: str, num_views: int) -> dict:
    """The outputs of a finished scene, read into memory: per view the
    final depth, normal and pixel-state maps (None where a file is missing
    or unreadable), and the fused cloud's points."""
    views = []
    for i in range(num_views):
        rf = os.path.join(dense_folder, "APD", f"{i:08d}")
        try:
            views.append({"depth": read_mat(os.path.join(rf, "depths.dmb")),
                          "normal": read_mat(os.path.join(rf, "normals.dmb")),
                          "state": read_mat(os.path.join(rf, "weak.bin"))})
        except (OSError, ValueError, KeyError):
            views.append(None)
    try:
        points = read_ply_points(os.path.join(dense_folder, "APD", "APD.ply"))
    except (OSError, ValueError, StopIteration):
        points = None
    return {"views": views, "points": points}


def _view_ok(v: Optional[dict], H: int, W: int) -> bool:
    if v is None:
        return False
    d, n, s = v["depth"], v["normal"], v["state"]
    return (d.shape == (H, W) and n.shape == (H, W, 3) and s.shape == (H, W)
            and bool(np.isfinite(d).all()) and bool(np.isfinite(n).all())
            and bool(np.isin(s, PIXEL_STATES).all()))


def surface_distance(points: torch.Tensor, objects: List[dict]) -> torch.Tensor:
    """Distance of each point [N, 3] (float64) to the nearest surface."""
    best = torch.full(points.shape[:1], float("inf"), dtype=points.dtype, device=points.device)
    for o in objects:
        if o["type"] == "sphere":
            c = torch.as_tensor(o["center"], dtype=points.dtype, device=points.device)
            d = ((points - c).norm(dim=1) - float(o["radius"])).abs()
        else:
            p0, n, u, v = (torch.as_tensor(o[k], dtype=points.dtype, device=points.device)
                           for k in ("p0", "n", "u", "v"))
            rel = points - p0
            d = (rel @ n).abs()
            if o["type"] == "card":
                a, b = rel @ u, rel @ v
                da = (a.abs() - float(o["half_u"])).clamp(min=0.0)
                db = (b.abs() - float(o["half_v"])).clamp(min=0.0)
                d = torch.sqrt(d * d + da * da + db * db)
        best = torch.minimum(best, d)
    return best


def _cams(scene, device) -> List[tuple]:
    """(K, R, t) of every view as float64 tensors on ``device``."""
    return [tuple(torch.as_tensor(m, device=device, dtype=torch.float64) for m in (c.K, c.R, c.t))
            for c in scene.cameras]


def _project(cam, P: torch.Tensor):
    """Pixel (u, v) and depth of world points P [..., 3] in camera ``cam``."""
    K, R, t = cam
    q = (P @ R.T + t) @ K.T
    return q[..., 0] / q[..., 2], q[..., 1] / q[..., 2], q[..., 2]


def _backproject(cam, xs: torch.Tensor, ys: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """World points of pixels (xs, ys) at depths ``d`` (the ray's z)."""
    K, R, t = cam
    p = torch.stack([d * (xs - K[0, 2]) / K[0, 0], d * (ys - K[1, 2]) / K[1, 1], d], -1)
    return (p - t) @ R


def judge(scene, out: dict, check: dict, device) -> Dict[str, Optional[float]]:
    """Every number of one finished scene (see the module docstring).

    The pass layer, against the truth, over the pixels whose true depth
    lies in the depth range:

    - ``views_bad``: views whose maps are missing, of another size, not
      finite, or hold a pixel state other than WEAK, STRONG, UNKNOWN;
    - ``depth_bad_pct``: the share whose final depth is off by more than
      ``depth_rel_tol`` of the truth (a depth of 0, none, counts as off);
      ``flat_depth_bad_pct`` the same over the textureless pixels (None in
      a scene without them);
    - ``depth_err_p50`` (``_p25``): the median (lower quartile) relative
      error over those pixels of every view, a depth of 0 or a bad view
      infinite; ``depth_err_p50_worst``: the largest of the views' own
      medians, so that a fault in one view shows;
    - ``normal_bad_pct``: the share whose normal is more than
      ``normal_tol_deg`` off the truth; ``normal_err_p50_deg`` the median
      angle;
    - ``weak_pct``: the share in state WEAK.

    The fusion layer, through the fused cloud:

    - ``cloud_far_pct``: the share of fused points farther than
      ``cloud_tol`` (length units) from every surface, ``cloud_dist_p50``
      (``_p25``) the median (lower quartile) of that distance;
    - ``cloud_missing_pct``: of the ``block`` x ``block`` pixel blocks of
      every view that see the depth range, the share that no fused point
      lands in at its true depth (within ``depth_rel_tol``);
    - ``cloud_unmatched_pct``: the share of fused points that are not, to
      ``match_px`` pixels and ``match_rel`` of the depth (float32's
      precision), a pixel of some view's final depth map carried into the
      world whose best source passes the fusion's test (:func:`_unmatched`):
      the fusion worked out again in float64 from the program's own maps;
    - ``cloud_points``: how many points there are.

    ``depth_good`` and ``depth_valid`` are the counts the end-to-end
    metric ``depth_good_pct`` sums over scenes."""
    H, W = scene.height, scene.width
    tol = float(check["depth_rel_tol"])
    cos_tol = np.cos(np.deg2rad(float(check["normal_tol_deg"])))
    views = out["views"]
    ok = [_view_ok(v, H, W) for v in views]
    n_valid = n_bad = n_flat = n_flat_bad = n_nbad = n_weak = 0
    rels, view_p50, angles = [], [], []
    for i, v in enumerate(views):
        gt = torch.as_tensor(scene.depth[i], device=device, dtype=torch.float64)
        valid = (gt >= scene.depth_min) & (gt <= scene.depth_max)
        flat = torch.as_tensor(scene.flat[i], device=device) & valid
        nv, nf = int(valid.sum()), int(flat.sum())
        n_valid += nv
        n_flat += nf
        if not ok[i]:
            n_bad += nv
            n_flat_bad += nf
            n_nbad += nv
            rels.append(torch.full((nv,), float("inf"), dtype=torch.float64, device=device))
            view_p50.append(float("inf"))
            continue
        d = torch.as_tensor(v["depth"], device=device, dtype=torch.float64)
        rel = (d - gt).abs() / torch.where(valid, gt, torch.ones_like(gt))
        bad = valid & ((rel > tol) | (d <= 0))
        n_bad += int(bad.sum())
        n_flat_bad += int((bad & flat).sum())
        r = torch.where(d > 0, rel, torch.full_like(rel, float("inf")))[valid]
        rels.append(r)
        view_p50.append(_quantile(r, 0.5))
        n = torch.as_tensor(v["normal"], device=device, dtype=torch.float64)
        ng = torch.as_tensor(scene.normal[i], device=device, dtype=torch.float64)
        cos = (n * ng).sum(-1) / torch.clamp(n.norm(dim=-1), min=1e-12)
        n_nbad += int((valid & (cos < cos_tol)).sum())
        angles.append(torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))[valid])
        n_weak += int((torch.as_tensor(v["state"], device=device)[valid] == PIXEL_STATES[0]).sum())
    all_rel = torch.cat(rels) if rels else None
    per_view = [p for p in view_p50 if p is not None]
    cams = _cams(scene, device)
    nums = {
        "views_bad": float(len(views) - sum(ok)),
        "depth_bad_pct": 100.0 * n_bad / max(n_valid, 1),
        "flat_depth_bad_pct": 100.0 * n_flat_bad / n_flat if n_flat else None,
        "depth_err_p25": _quantile(all_rel, 0.25),
        "depth_err_p50": _quantile(all_rel, 0.5),
        "depth_err_p50_worst": max(per_view) if per_view else None,
        "normal_bad_pct": 100.0 * n_nbad / max(n_valid, 1),
        "normal_err_p50_deg": _quantile(torch.cat(angles), 0.5) if angles else None,
        "weak_pct": 100.0 * n_weak / max(n_valid, 1),
        "depth_good": float(n_valid - n_bad),
        "depth_valid": float(n_valid),
    }
    nums.update(_judge_cloud(scene, out["points"], views, ok, cams, check, device))
    return nums


def _judge_cloud(scene, points: Optional[np.ndarray], views, ok, cams, check: dict,
                 device) -> dict:
    if points is None or points.shape[0] == 0 or not np.isfinite(points).all():
        return {"cloud_far_pct": 100.0, "cloud_missing_pct": 100.0, "cloud_unmatched_pct": 100.0,
                "cloud_points": 0.0 if points is None else float(points.shape[0])}
    tol = float(check["depth_rel_tol"])
    block = int(check["block"])
    P = torch.as_tensor(points, device=device, dtype=torch.float64)
    dist = surface_distance(P, scene.objects)
    H, W = scene.height, scene.width
    Hb, Wb = -(-H // block), -(-W // block)
    n_blocks = n_missing = 0
    for i, cam in enumerate(cams):
        gt = torch.as_tensor(scene.depth[i], device=device, dtype=torch.float64)
        valid = (gt >= scene.depth_min) & (gt <= scene.depth_max)
        u, v, z = _project(cam, P)
        front = z > 0
        px = torch.round(torch.where(front, u, torch.full_like(u, -1.0))).long()
        py = torch.round(torch.where(front, v, torch.full_like(v, -1.0))).long()
        inside = front & (px >= 0) & (px < W) & (py >= 0) & (py < H)
        px, py, z = px[inside], py[inside], z[inside]
        g = gt[py, px]
        hit = (g >= scene.depth_min) & (g <= scene.depth_max) & ((z - g).abs() <= tol * g)
        covered = torch.zeros(Hb * Wb, dtype=torch.bool, device=device)
        covered[(py[hit] // block) * Wb + px[hit] // block] = True
        vb = torch.zeros(Hb * block, Wb * block, dtype=torch.bool, device=device)
        vb[:H, :W] = valid
        seen = vb.reshape(Hb, block, Wb, block).any(dim=3).any(dim=1).reshape(-1)
        n_blocks += int(seen.sum())
        n_missing += int((seen & ~covered).sum())
    return {"cloud_far_pct": 100.0 * float((dist > float(check["cloud_tol"])).double().mean()),
            "cloud_dist_p25": _quantile(dist, 0.25),
            "cloud_dist_p50": _quantile(dist, 0.5),
            "cloud_missing_pct": 100.0 * n_missing / max(n_blocks, 1),
            "cloud_unmatched_pct": _unmatched(scene, P, views, ok, cams, check, device),
            "cloud_points": float(P.shape[0])}


#: the fusion's test of a pixel against one source (ETH fusion, APD.cpp:
#: 941-951): back within 2 px, 1 % in depth, 10 degrees between normals;
#: the score's factor for a WEAK pixel and for the others
FUSE_PX, FUSE_REL, FUSE_ANGLE = 2.0, 0.01, 0.174533
FUSE_FACTOR_WEAK, FUSE_FACTOR = 0.45, 0.3


def _unmatched(scene, P, views, ok, cams, check, device) -> float:
    """Percent of the fused points P [N, 3] that no pixel of a view's final
    maps explains. A pixel explains a point where the point carried into
    that view lands within ``match_px`` of the pixel's centre at its depth
    (within ``match_rel``), and where the best of the view's sources
    passes the fusion's test of the pixel with a score above the pixel
    state's factor: the fusion accepts where the mean score of the
    sources that pass lies above it, so the best one's does too, whichever
    source pixels earlier points took."""
    H, W = scene.height, scene.width
    px_tol, rel_tol = float(check["match_px"]), float(check["match_rel"])
    maps = [None if not ok[i] else
            tuple(torch.as_tensor(v[k], device=device) for k in ("depth", "normal", "state"))
            for i, v in enumerate(views)]
    explained = torch.zeros(P.shape[0], dtype=torch.bool, device=device)
    for i, srcs in enumerate(scene.sources):
        if maps[i] is None:
            continue
        depth, normal, state = maps[i]
        u, v, z = _project(cams[i], P)
        cu, cv = torch.round(u), torch.round(v)
        near = ((z > 0) & ((u - cu).abs() <= px_tol) & ((v - cv).abs() <= px_tol)
                & (cu >= 0) & (cu < W) & (cv >= 0) & (cv < H) & ~explained)
        idx = torch.nonzero(near).squeeze(1)
        c, r = cu[idx].long(), cv[idx].long()
        d = depth[r, c].double()
        same = (d > 0) & ((z[idx] - d).abs() <= rel_tol * d)
        idx, c, r, d = idx[same], c[same], r[same], d[same]
        X = _backproject(cams[i], c.double(), r.double(), d)
        best = torch.zeros_like(d)
        for j in srcs:
            if maps[j] is None:
                continue
            dj, nj, _ = maps[j]
            sx, sy, _ = _project(cams[j], X)
            sc, sr = torch.trunc(sx + 0.5), torch.trunc(sy + 0.5)  # C's (long long)(x + 0.5)
            inb = (sc >= 0) & (sc < W) & (sr >= 0) & (sr < H)
            sc, sr = sc.clamp(0, W - 1).long(), sr.clamp(0, H - 1).long()
            sd = dj[sr, sc].double()
            bx, by, bd = _project(cams[i], _backproject(cams[j], sc.double(), sr.double(), sd))
            err = torch.sqrt((c - bx) ** 2 + (r - by) ** 2)
            rel = (bd - d).abs() / d
            dot = (normal[r, c].double() * nj[sr, sc].double()).sum(-1).clamp(-1.0, 1.0)
            ang = torch.nan_to_num(torch.arccos(dot), nan=0.0)
            passes = inb & (sd > 0) & (err < FUSE_PX) & (rel < FUSE_REL) & (ang < FUSE_ANGLE)
            score = torch.exp(-(err + 200.0 * rel + 10.0 * ang))
            best = torch.maximum(best, torch.where(passes, score, torch.zeros_like(score)))
        factor = torch.where(state[r, c] == PIXEL_STATES[0], FUSE_FACTOR_WEAK, FUSE_FACTOR)
        explained[idx[best > factor]] = True
    return 100.0 * float((~explained).double().mean())


def _quantile(values: Optional[torch.Tensor], q: float) -> Optional[float]:
    """The ``q`` quantile of ``values`` by sorting, the value at index
    floor(q * n) (the upper median of an even count; None if there are
    none)."""
    if values is None or values.numel() == 0:
        return None
    v = torch.sort(values.reshape(-1))[0]
    return float(v[min(v.numel() - 1, int(q * v.numel()))])


def verdict(nums: Dict[str, Optional[float]], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit; a number that is missing
    (None) or above its limit fails."""
    out = {}
    for name, limit in limits.items():
        value = nums.get(name)
        out[name] = {"value": value, "limit": limit,
                     "ok": value is not None and value <= limit}
    return out
