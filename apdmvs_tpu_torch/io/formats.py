"""On-disk formats, byte-compatible with the reference toolchain.

Implements the reference's file contracts so outputs interoperate with its
ecosystem (evaluators, viewers):

- ``.dmb``/``.bin`` binary matrices (reference ReadBinMat/WriteBinMat:
  APD.cpp:3-49): int32 header (version=1, rows, cols, cv_type) + raw data.
- ``*_cam.txt`` MVSNet camera files (reference ReadCamera: APD.cpp:51-92).
- ``pair.txt`` view-selection lists (reference GenerateSampleList:
  main.cpp:6-49).
- binary little-endian PLY with BGR color bytes (reference ExportPointCloud:
  APD.cpp:214-254).

A native C accelerator (apdmvs_tpu_torch/native) is used for bulk PLY writes when
built; the pure-Python path is the always-available fallback.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

# OpenCV type code mapping (depth = code & 7, channels = (code >> 3) + 1).
_CV_DEPTH_TO_DTYPE = {
    0: np.uint8,
    1: np.int8,
    2: np.uint16,
    3: np.int16,
    4: np.int32,
    5: np.float32,
    6: np.float64,
}
_DTYPE_TO_CV_DEPTH = {np.dtype(v): k for k, v in _CV_DEPTH_TO_DTYPE.items()}


def to_format_index(index: int) -> str:
    """8-digit zero-padded image index (reference: APD.cpp:350-354)."""
    return f"{index:08d}"


def read_bin_mat(path: str | os.PathLike) -> np.ndarray:
    """Read a .dmb/.bin matrix (reference ReadBinMat: APD.cpp:3-28).

    Returns [rows, cols] for single-channel or [rows, cols, ch] otherwise.
    """
    with open(path, "rb") as f:
        version, rows, cols, cv_type = struct.unpack("<iiii", f.read(16))
        if version != 1:
            raise ValueError(f"dmb version error in {path}: {version}")
        depth = cv_type & 7
        channels = (cv_type >> 3) + 1
        dtype = _CV_DEPTH_TO_DTYPE[depth]
        count = rows * cols * channels
        data = np.frombuffer(f.read(count * np.dtype(dtype).itemsize), dtype=dtype)
    if channels == 1:
        return data.reshape(rows, cols).copy()
    return data.reshape(rows, cols, channels).copy()


def write_bin_mat(path: str | os.PathLike, mat: np.ndarray) -> None:
    """Write a .dmb/.bin matrix (reference WriteBinMat: APD.cpp:30-49)."""
    mat = np.ascontiguousarray(mat)
    rows, cols = mat.shape[:2]
    channels = 1 if mat.ndim == 2 else mat.shape[2]
    depth = _DTYPE_TO_CV_DEPTH[mat.dtype]
    cv_type = depth + ((channels - 1) << 3)
    with open(path, "wb") as f:
        f.write(struct.pack("<iiii", 1, rows, cols, cv_type))
        f.write(mat.tobytes())


def read_camera(path: str | os.PathLike) -> Dict[str, np.ndarray | float]:
    """Read an MVSNet-format camera file (reference ReadCamera: APD.cpp:51-92,
    ETH/TAT variant: four trailing floats ``depth_min interval depth_num
    depth_max``).

    Returns dict with K [3,3], R [3,3], t [3], c [3] (world center = -R^T t),
    depth_min, depth_max, interval, depth_num.
    """
    with open(path, "r") as f:
        tokens = f.read().split()
    it = iter(tokens)

    def expect(word: str):
        tok = next(it)
        if tok != word:
            raise ValueError(f"Expected '{word}' in {path}, got '{tok}'")

    expect("extrinsic")
    ext = np.array([float(next(it)) for _ in range(16)], np.float64).reshape(4, 4)
    expect("intrinsic")
    K = np.array([float(next(it)) for _ in range(9)], np.float64).reshape(3, 3)
    depth_min = float(next(it))
    interval = float(next(it))
    depth_num = float(next(it))
    depth_max = float(next(it))
    R = ext[:3, :3]
    t = ext[:3, 3]
    c = -R.T @ t  # reference: APD.cpp:73-77
    return {
        "K": K.astype(np.float32),
        "R": R.astype(np.float32),
        "t": t.astype(np.float32),
        "c": c.astype(np.float32),
        "depth_min": depth_min,
        "depth_max": depth_max,
        "interval": interval,
        "depth_num": depth_num,
    }


def read_camera_dtu(path: str | os.PathLike) -> Dict[str, np.ndarray | float]:
    """DTU variant: depth_max = interval * 192 + depth_min (reference
    commented-out branch: APD.cpp:84-89)."""
    cam = read_camera(path)
    cam["depth_max"] = cam["interval"] * 192.0 + cam["depth_min"]
    return cam


def write_camera(
    path: str | os.PathLike,
    K: np.ndarray,
    R: np.ndarray,
    t: np.ndarray,
    depth_min: float,
    interval: float,
    depth_num: float,
    depth_max: float,
) -> None:
    """Write an MVSNet camera file readable by read_camera and the reference."""
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for i in range(3):
            f.write(f"{R[i, 0]} {R[i, 1]} {R[i, 2]} {t[i]}\n")
        f.write("0.0 0.0 0.0 1.0\n\n")
        f.write("intrinsic\n")
        for i in range(3):
            f.write(f"{K[i, 0]} {K[i, 1]} {K[i, 2]}\n")
        f.write(f"\n{depth_min} {interval} {depth_num} {depth_max}\n")


def read_pair_file(path: str | os.PathLike) -> List[Tuple[int, List[Tuple[int, float]]]]:
    """Read pair.txt (reference GenerateSampleList: main.cpp:6-49).

    Returns [(ref_id, [(src_id, score), ...]), ...] with *all* sources
    (including score <= 0; filtering is the caller's policy, as in the
    reference which drops score <= 0 entries at main.cpp:42-44).
    """
    with open(path, "r") as f:
        lines = [ln for ln in f.read().splitlines()]
    out: List[Tuple[int, List[Tuple[int, float]]]] = []
    n = int(lines[0].split()[0])
    li = 1
    for _ in range(n):
        ref_id = int(lines[li].split()[0])
        li += 1
        toks = lines[li].split()
        li += 1
        m = int(toks[0])
        srcs = []
        for j in range(m):
            srcs.append((int(toks[1 + 2 * j]), float(toks[2 + 2 * j])))
        out.append((ref_id, srcs))
    return out


def write_pair_file(
    path: str | os.PathLike, pairs: Sequence[Tuple[int, Sequence[Tuple[int, float]]]]
) -> None:
    with open(path, "w") as f:
        f.write(f"{len(pairs)}\n")
        for ref_id, srcs in pairs:
            f.write(f"{ref_id}\n")
            f.write(f"{len(srcs)} ")
            f.write(" ".join(f"{sid} {score}" for sid, score in srcs))
            f.write("\n")


_PLY_HEADER = (
    "ply\n"
    "format binary_little_endian 1.0\n"
    "element vertex {n}\n"
    "property float x\n"
    "property float y\n"
    "property float z\n"
    "property uchar diffuse_blue\n"
    "property uchar diffuse_green\n"
    "property uchar diffuse_red\n"
    "end_header\n"
)


def export_point_cloud(
    path: str | os.PathLike, coords: np.ndarray, colors_bgr: np.ndarray
) -> None:
    """Binary little-endian PLY with BGR color bytes (reference
    ExportPointCloud: APD.cpp:214-254).

    coords: [N, 3] float; colors_bgr: [N, 3] uint8-compatible (B, G, R).
    """
    coords = np.asarray(coords, np.float32)
    colors = np.asarray(colors_bgr)
    n = coords.shape[0]
    # Interleave as a structured record array: 12B floats + 3B colors.
    rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("bgr", "u1", 3)])
    rec["xyz"] = coords
    rec["bgr"] = colors.astype(np.uint8)
    with open(path, "wb") as f:
        f.write(_PLY_HEADER.format(n=n).encode("ascii"))
        f.write(rec.tobytes())


def read_point_cloud(path: str | os.PathLike) -> Tuple[np.ndarray, np.ndarray]:
    """Read back a PLY written by export_point_cloud (or the reference)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        n = 0
        for line in header.decode("ascii").splitlines():
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
        rec = np.frombuffer(
            f.read(n * 15), dtype=[("xyz", "<f4", 3), ("bgr", "u1", 3)]
        )
    return rec["xyz"].copy(), rec["bgr"].copy()
