"""COLMAP sparse model -> MVSNet-format dataset converter.

Capability equivalent of the reference's offline prep layer
(colmap2mvsnet.py, reference: colmap2mvsnet.py:20-494): reads a COLMAP
sparse reconstruction (.txt or .bin), computes per-image depth ranges from
the sparse points, scores view pairs by shared-point count (zeroed when the
75th-percentile triangulation angle is < 1 degree), and writes the dataset
contract the pipeline consumes: ``cams/%08d_cam.txt``, ``pair.txt``, and
``images/%08d.jpg`` padded to a common size and downscaled by
``scale_factor``.

The pair scoring is NumPy-vectorized (incidence-matrix intersection +
batched angle percentiles) instead of the reference's per-pair Python loops
under multiprocessing (colmap2mvsnet.py:280-302, 411-416).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# COLMAP camera models: model_id -> (name, param names)
# (format documented in COLMAP's colmap/src/base/camera_models.h)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", ["f", "cx", "cy"]),
    1: ("PINHOLE", ["fx", "fy", "cx", "cy"]),
    2: ("SIMPLE_RADIAL", ["f", "cx", "cy", "k"]),
    3: ("RADIAL", ["f", "cx", "cy", "k1", "k2"]),
    4: ("OPENCV", ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"]),
    5: ("OPENCV_FISHEYE", ["fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"]),
    6: (
        "FULL_OPENCV",
        ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "k4", "k5", "k6"],
    ),
    7: ("FOV", ["fx", "fy", "cx", "cy", "omega"]),
    8: ("SIMPLE_RADIAL_FISHEYE", ["f", "cx", "cy", "k"]),
    9: ("RADIAL_FISHEYE", ["f", "cx", "cy", "k1", "k2"]),
    10: (
        "THIN_PRISM_FISHEYE",
        ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "k4", "sx1", "sy1"],
    ),
}
_MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # [4] (w, x, y, z)
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str
    xys: np.ndarray  # [P, 2]
    point3D_ids: np.ndarray  # [P] int64, -1 = unmatched


@dataclasses.dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """Quaternion (w, x, y, z) -> rotation matrix (colmap2mvsnet.py:252-262)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), largest-eigenvector method
    (colmap2mvsnet.py:264-276)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


# ---------------------------------------------------------------------------
# .txt readers
# ---------------------------------------------------------------------------


def _txt_lines(path):
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_txt(path) -> Dict[int, ColmapCamera]:
    out = {}
    for line in _txt_lines(path):
        toks = line.split()
        cid = int(toks[0])
        out[cid] = ColmapCamera(
            id=cid,
            model=toks[1],
            width=int(toks[2]),
            height=int(toks[3]),
            params=np.array([float(t) for t in toks[4:]]),
        )
    return out


def read_images_txt(path) -> Dict[int, ColmapImage]:
    out = {}
    lines = list(_txt_lines(path))
    for i in range(0, len(lines), 2):
        toks = lines[i].split()
        iid = int(toks[0])
        qvec = np.array([float(t) for t in toks[1:5]])
        tvec = np.array([float(t) for t in toks[5:8]])
        camera_id = int(toks[8])
        name = toks[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(
            [[float(pts[j]), float(pts[j + 1])] for j in range(0, len(pts), 3)]
        ).reshape(-1, 2)
        ids = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)], np.int64)
        out[iid] = ColmapImage(iid, qvec, tvec, camera_id, name, xys, ids)
    return out


def read_points3d_txt(path) -> Dict[int, ColmapPoint3D]:
    out = {}
    for line in _txt_lines(path):
        toks = line.split()
        pid = int(toks[0])
        out[pid] = ColmapPoint3D(
            id=pid,
            xyz=np.array([float(t) for t in toks[1:4]]),
            rgb=np.array([int(t) for t in toks[4:7]], np.uint8),
            error=float(toks[7]),
        )
    return out


# ---------------------------------------------------------------------------
# .bin readers
# ---------------------------------------------------------------------------


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, width, height = _read(f, "<iiQQ")
            name, param_names = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{len(param_names)}d"))
            out[cid] = ColmapCamera(cid, name, int(width), int(height), params)
    return out


def read_images_bin(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (iid,) = _read(f, "<i")
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            (camera_id,) = _read(f, "<i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(f, "<Q")
            data = np.frombuffer(
                f.read(24 * num_pts), dtype=[("xy", "<f8", 2), ("id", "<i8")]
            )
            out[iid] = ColmapImage(
                iid, qvec, tvec, camera_id, name.decode("utf-8"),
                data["xy"].reshape(-1, 2).copy(), data["id"].copy(),
            )
    return out


def read_points3d_bin(path) -> Dict[int, ColmapPoint3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (pid,) = _read(f, "<Q")
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"), np.uint8)
            (error,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)  # (image_id, point2D_idx) pairs, unused
            out[pid] = ColmapPoint3D(int(pid), xyz, rgb, float(error))
    return out


def read_model(model_dir: str, ext: str = "auto"):
    """Read a COLMAP sparse model directory (cameras/images/points3D)."""
    if ext == "auto":
        ext = ".bin" if os.path.exists(os.path.join(model_dir, "cameras.bin")) else ".txt"
    if ext == ".bin":
        cameras = read_cameras_bin(os.path.join(model_dir, "cameras.bin"))
        images = read_images_bin(os.path.join(model_dir, "images.bin"))
        points3d = read_points3d_bin(os.path.join(model_dir, "points3D.bin"))
    else:
        cameras = read_cameras_txt(os.path.join(model_dir, "cameras.txt"))
        images = read_images_txt(os.path.join(model_dir, "images.txt"))
        points3d = read_points3d_txt(os.path.join(model_dir, "points3D.txt"))
    return cameras, images, points3d


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------


def pair_scores(
    images: Sequence[ColmapImage],
    points3d: Dict[int, ColmapPoint3D],
    extrinsics: Sequence[np.ndarray],
) -> np.ndarray:
    """Pair score = #shared 3D points, zeroed when the 75th-percentile
    triangulation angle < 1 degree (colmap2mvsnet.py:280-302), vectorized.
    """
    n = len(images)
    pid_index = {pid: k for k, pid in enumerate(points3d.keys())}
    P = len(pid_index)
    xyz = np.zeros((P, 3))
    for pid, pt in points3d.items():
        xyz[pid_index[pid]] = pt.xyz

    M = np.zeros((n, P), bool)
    for i, im in enumerate(images):
        ids = im.point3D_ids
        ids = ids[ids >= 0]
        rows = [pid_index[p] for p in set(ids.tolist()) if p in pid_index]
        M[i, rows] = True

    centers = np.stack(
        [-(e[:3, :3].T @ e[:3, 3]) for e in extrinsics]
    )  # [n, 3]

    score = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            shared = M[i] & M[j]
            cnt = int(shared.sum())
            if cnt == 0:
                continue
            p = xyz[shared]  # [S, 3]
            vi = centers[i] - p
            vj = centers[j] - p
            cosang = np.sum(vi * vj, axis=1) / (
                np.linalg.norm(vi, axis=1) * np.linalg.norm(vj, axis=1)
            )
            theta = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
            theta_sorted = np.sort(theta)
            tri = theta_sorted[int(len(theta_sorted) * 0.75)]
            s = 0.0 if tri < 1.0 else float(cnt)
            score[i, j] = score[j, i] = s
    return score


def convert(
    dense_folder: str,
    save_folder: str,
    model_dir: Optional[str] = None,
    image_dir: Optional[str] = None,
    model_ext: str = "auto",
    max_d: int = 0,
    interval_scale: float = 1.0,
    scale_factor: float = 1.0,
    num_src_views: int = 20,
) -> None:
    """Convert a COLMAP scene to the MVSNet dataset contract
    (behavioral parity with colmap2mvsnet.py:304-473)."""
    from PIL import Image

    image_dir = image_dir or os.path.join(dense_folder, "images")
    model_dir = model_dir or os.path.join(dense_folder, "dslr_calibration_undistorted")
    cam_dir = os.path.join(save_folder, "cams")
    image_out_dir = os.path.join(save_folder, "images")
    for d in (image_out_dir, cam_dir):
        if os.path.exists(d):
            shutil.rmtree(d)
        os.makedirs(d)

    cameras, images_map, points3d = read_model(model_dir, model_ext)
    # renumber images 0..n-1 by sorted original id (colmap2mvsnet.py:359-362)
    ordered = [images_map[k] for k in sorted(images_map.keys())]
    n = len(ordered)

    # intrinsics scaled by 1/scale_factor (colmap2mvsnet.py:340-354)
    intrinsics = {}
    for cid, cam in cameras.items():
        pd = dict(zip(CAMERA_MODELS[_MODEL_NAME_TO_ID[cam.model]][1], cam.params))
        fx = pd.get("fx", pd.get("f"))
        fy = pd.get("fy", pd.get("f"))
        intrinsics[cid] = np.array(
            [
                [fx / scale_factor, 0.0, pd["cx"] / scale_factor],
                [0.0, fy / scale_factor, pd["cy"] / scale_factor],
                [0.0, 0.0, 1.0],
            ]
        )

    extrinsics = []
    for im in ordered:
        e = np.eye(4)
        e[:3, :3] = qvec2rotmat(im.qvec)
        e[:3, 3] = im.tvec
        extrinsics.append(e)

    # depth ranges from sparse points: 1%/99% percentiles x 0.75/1.25
    # (colmap2mvsnet.py:375-383)
    depth_ranges = []
    for i, im in enumerate(ordered):
        ids = im.point3D_ids
        ids = ids[ids >= 0]
        zs = []
        for pid in ids.tolist():
            if pid in points3d:
                X = points3d[pid].xyz
                zs.append(extrinsics[i][2, :3] @ X + extrinsics[i][2, 3])
        depth_min = depth_max = 0.0
        if zs:
            zs_sorted = np.sort(np.asarray(zs))
            depth_min = float(zs_sorted[int(len(zs) * 0.01)]) * 0.75
            depth_max = float(zs_sorted[int(len(zs) * 0.99)]) * 1.25
        if max_d == 0 and depth_min > 0:
            # inverse-depth plane count: how many inverse-depth steps of one
            # pixel of disparity fit in [1/dmax, 1/dmin]
            # (colmap2mvsnet.py:385-397)
            K = intrinsics[im.camera_id]
            pixel_shift = depth_min / K[0, 0]  # |P2 - P1| in closed form
            depth_num = (1.0 / depth_min - 1.0 / depth_max) / (
                1.0 / depth_min - 1.0 / (depth_min + pixel_shift)
            )
        else:
            depth_num = float(max_d) if max_d else 1.0
        interval = (
            (depth_max - depth_min) / (depth_num - 1.0) / interval_scale
            if depth_num > 1
            else 0.0
        )
        depth_ranges.append((depth_min, interval, depth_num, depth_max))

    score = pair_scores(ordered, points3d, extrinsics)
    num_view = min(num_src_views, n - 1)

    # cams/%08d_cam.txt in the reference's exact layout
    for i, im in enumerate(ordered):
        with open(os.path.join(cam_dir, f"{i:08d}_cam.txt"), "w") as f:
            f.write("extrinsic\n")
            for r in range(4):
                f.write(" ".join(str(extrinsics[i][r, c]) for c in range(4)) + " \n")
            f.write("\nintrinsic\n")
            K = intrinsics[im.camera_id]
            for r in range(3):
                f.write(" ".join(str(K[r, c]) for c in range(3)) + " \n")
            f.write("\n%f %f %f %f\n" % depth_ranges[i])

    with open(os.path.join(save_folder, "pair.txt"), "w") as f:
        f.write(f"{n}\n")
        for i in range(n):
            top = np.argsort(score[i])[::-1][:num_view]
            f.write(f"{i}\n{len(top)} ")
            f.write(" ".join(f"{int(k)} {int(score[i, k])}" for k in top))
            f.write(" \n")

    # pad all images to the common max size, nearest-downscale by
    # scale_factor, save as %08d.jpg (colmap2mvsnet.py:451-473)
    sizes = []
    for im in ordered:
        with Image.open(os.path.join(image_dir, im.name)) as img:
            sizes.append(img.size)
    max_w = max(s[0] for s in sizes)
    max_h = max(s[1] for s in sizes)
    for i, im in enumerate(ordered):
        with Image.open(os.path.join(image_dir, im.name)) as img:
            arr = np.asarray(img.convert("RGB"))
        pad_h = max_h - arr.shape[0]
        pad_w = max_w - arr.shape[1]
        if pad_h or pad_w:
            arr = np.pad(arr, ((0, pad_h), (0, pad_w), (0, 0)))
        if scale_factor != 1.0:
            new_w = int(arr.shape[1] / scale_factor)
            new_h = int(arr.shape[0] / scale_factor)
            ys = np.minimum(
                (np.arange(new_h) * (arr.shape[0] / new_h)).astype(np.int64),
                arr.shape[0] - 1,
            )
            xs = np.minimum(
                (np.arange(new_w) * (arr.shape[1] / new_w)).astype(np.int64),
                arr.shape[1] - 1,
            )
            arr = arr[ys][:, xs]
        Image.fromarray(arr).save(
            os.path.join(image_out_dir, f"{i:08d}.jpg"), quality=95
        )


def main() -> None:
    ap = argparse.ArgumentParser(
        description="COLMAP sparse model -> MVSNet dataset (reference "
        "colmap2mvsnet.py equivalent)"
    )
    ap.add_argument("--dense_folder", required=True)
    ap.add_argument("--save_folder", required=True)
    ap.add_argument("--model_dir", default=None,
                    help="sparse model dir (default: <dense>/dslr_calibration_undistorted)")
    ap.add_argument("--image_dir", default=None)
    ap.add_argument("--model_ext", default="auto", choices=["auto", ".txt", ".bin"])
    ap.add_argument("--max_d", type=int, default=0)
    ap.add_argument("--interval_scale", type=float, default=1.0)
    ap.add_argument("--scale_factor", type=float, default=1.0)
    args = ap.parse_args()
    convert(
        args.dense_folder,
        args.save_folder,
        model_dir=args.model_dir,
        image_dir=args.image_dir,
        model_ext=args.model_ext,
        max_d=args.max_d,
        interval_scale=args.interval_scale,
        scale_factor=args.scale_factor,
    )


if __name__ == "__main__":
    main()
