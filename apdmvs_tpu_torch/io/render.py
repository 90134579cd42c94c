"""Debug visualization renderers (reference: APD.cpp:94-212).

Byte-faithful reimplementations of the reference's JPEG dumps:
- ShowDepthMap: inverted-range 5-segment blue->red colormap.
- ShowNormalMap: (n + 1) * 127.5 after per-pixel normalization.
- ShowWeakImage: WEAK=white, STRONG=green, UNKNOWN=red (BGR order).
"""

from __future__ import annotations

import numpy as np

from apdmvs_tpu_torch.params import PixelState


def render_depth(depth: np.ndarray, depth_min: float, depth_max: float) -> np.ndarray:
    """BGR uint8 visualization (ShowDepthMap: APD.cpp:94-158)."""
    H, W = depth.shape
    out = np.zeros((H, W, 3), np.uint8)
    delta = depth_max - depth_min
    valid = (depth >= depth_min) & (depth <= depth_max) & np.isfinite(depth)
    pv = np.clip((depth_max - depth) / max(delta, 1e-30), 0.0, 1.0) * 255.0
    pv = np.clip(pv, 0.0, 255.0)

    b = np.zeros((H, W)); g = np.zeros((H, W)); r = np.zeros((H, W))
    seg1 = pv <= 51
    b = np.where(seg1, 255, b); g = np.where(seg1, pv * 5, g)
    seg2 = (pv > 51) & (pv <= 102)
    t = pv - 51
    b = np.where(seg2, 255 - t * 5, b); g = np.where(seg2, 255, g)
    seg3 = (pv > 102) & (pv <= 153)
    t = pv - 102
    g = np.where(seg3, 255, g); r = np.where(seg3, t * 5, r)
    seg4 = (pv > 153) & (pv <= 204)
    t = pv - 153
    g = np.where(seg4, 255 - np.uint8(t * 128.0 / 51 + 0.5), g)
    r = np.where(seg4, 255, r)
    seg5 = pv > 204
    t = pv - 204
    g = np.where(seg5, 127 - np.uint8(t * 127.0 / 51 + 0.5), g)
    r = np.where(seg5, 255, r)

    out[..., 0] = np.where(valid, b, 0).astype(np.uint8)
    out[..., 1] = np.where(valid, g, 0).astype(np.uint8)
    out[..., 2] = np.where(valid, r, 0).astype(np.uint8)
    return out


def render_normal(normal: np.ndarray) -> np.ndarray:
    """BGR uint8 visualization (ShowNormalMap: APD.cpp:160-183)."""
    norm = np.linalg.norm(normal, axis=-1, keepdims=True)
    n = np.where(norm > 0, normal / np.maximum(norm, 1e-30), 0.0)
    img = n * 127.5 + 127.5
    return np.clip(img, 0, 255).astype(np.uint8)


def render_weak(weak: np.ndarray) -> np.ndarray:
    """BGR uint8 visualization (ShowWeakImage: APD.cpp:185-212)."""
    H, W = weak.shape
    out = np.zeros((H, W, 3), np.uint8)
    out[weak == PixelState.WEAK] = (255, 255, 255)
    out[weak == PixelState.STRONG] = (0, 255, 0)
    out[weak == PixelState.UNKNOWN] = (0, 0, 255)
    return out
