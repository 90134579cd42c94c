"""ctypes bindings for the native host runtime (apd_native.cpp).

Builds the shared library on first use with g++ into the package's build
directory (``apdmvs_tpu_torch/_build``, git-ignored); plain C ABI + ctypes.
Callers check the ``None`` return and fall back to the NumPy fusion.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "apd_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(_BUILD_DIR, "libapd_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-ffast-math", "-shared", "-fPIC",
        "-std=c++17", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, _SO)  # atomic: concurrent test workers never see a torn file
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None

        dp = ctypes.POINTER(ctypes.c_double)
        fp = ctypes.POINTER(ctypes.c_float)
        up = ctypes.POINTER(ctypes.c_ubyte)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.fuse_eth_native.restype = ctypes.c_longlong
        lib.fuse_eth_native.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, dp, dp, dp, fp, fp,
            up, up, up, ip, ip, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            fp, up, ctypes.c_longlong,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _pack_views(views) -> Tuple:
    n = len(views)
    H, W = views[0].depth.shape
    Ks = np.ascontiguousarray(np.stack([v.K for v in views]).astype(np.float64))
    Rs = np.ascontiguousarray(np.stack([v.R for v in views]).astype(np.float64))
    ts = np.ascontiguousarray(np.stack([v.t for v in views]).astype(np.float64))
    depths = np.ascontiguousarray(np.stack([v.depth for v in views]).astype(np.float32))
    normals = np.ascontiguousarray(np.stack([v.normal for v in views]).astype(np.float32))
    bgrs = np.ascontiguousarray(np.stack([v.image_bgr for v in views]).astype(np.uint8))
    if any(v.block is not None for v in views):
        blocks = np.ascontiguousarray(
            np.stack(
                [
                    v.block if v.block is not None else np.full((H, W), 255, np.uint8)
                    for v in views
                ]
            ).astype(np.uint8)
        )
    else:
        blocks = None
    return n, H, W, Ks, Rs, ts, depths, normals, bgrs, blocks


def _pack_srcs(src_ids: Sequence[Sequence[int]]):
    n = len(src_ids)
    max_src = max((len(s) for s in src_ids), default=1) or 1
    arr = np.zeros((n, max_src), np.int32)
    counts = np.zeros((n,), np.int32)
    for i, s in enumerate(src_ids):
        counts[i] = len(s)
        arr[i, : len(s)] = s
    return arr, counts, max_src


def _ptr(a, ctype):
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def fuse_eth(views, src_ids, weak_factor=0.45, strong_factor=0.3):
    """Native ETH fusion with the reference's exact sequential greedy
    semantics (APD.cpp:826-977). Returns (coords [N,3] f32, colors [N,3] u8)
    or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n, H, W, Ks, Rs, ts, depths, normals, bgrs, blocks = _pack_views(views)
    weaks = None
    if all(v.weak is not None for v in views):
        weaks = np.ascontiguousarray(np.stack([v.weak for v in views]).astype(np.uint8))
    src_arr, counts, max_src = _pack_srcs(src_ids)
    cap = int(n) * H * W
    out_xyz = np.empty((cap, 3), np.float32)
    out_bgr = np.empty((cap, 3), np.uint8)
    cnt = lib.fuse_eth_native(
        n, H, W,
        _ptr(Ks, ctypes.c_double), _ptr(Rs, ctypes.c_double), _ptr(ts, ctypes.c_double),
        _ptr(depths, ctypes.c_float), _ptr(normals, ctypes.c_float),
        _ptr(weaks, ctypes.c_ubyte), _ptr(bgrs, ctypes.c_ubyte),
        _ptr(blocks, ctypes.c_ubyte),
        _ptr(src_arr, ctypes.c_int), _ptr(counts, ctypes.c_int), max_src,
        float(weak_factor), float(strong_factor),
        _ptr(out_xyz, ctypes.c_float), _ptr(out_bgr, ctypes.c_ubyte), cap,
    )
    cnt = min(int(cnt), cap)
    return out_xyz[:cnt].copy(), out_bgr[:cnt].copy()
