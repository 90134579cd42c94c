"""Image loading, color conversion, and resizing for the host pipeline.

The reference uses OpenCV (`cv::imread(IMREAD_GRAYSCALE)` + `cv::resize`,
reference: APD.cpp:410-427, 464-488); this environment has no OpenCV, so we
use PIL for decode (identical ITU-R 601-2 grayscale weights 0.299/0.587/0.114)
and NumPy bilinear/nearest resizers that reproduce OpenCV's pixel-center
conventions:

- bilinear (`cv::INTER_LINEAR`): source coordinate
  ``sx = (dx + 0.5) * (src/dst) - 0.5`` with edge clamping — used for images.
- nearest state-map rescale (reference RescaleMatToTargetSize,
  APD.cpp:752-774): ``src = floor(dst * src_size / dst_size)``. The reference
  swaps scale_x/scale_y in its index math (a quirk, SURVEY.md §7 item 6);
  we implement the intended (unswapped) behavior.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def load_gray_f32(path: str | os.PathLike) -> np.ndarray:
    """Grayscale float32 image in [0, 255] (reference: APD.cpp:410-413)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), np.float32)


def load_bgr_u8(path: str | os.PathLike) -> np.ndarray:
    """BGR uint8 color image (reference fusion reads color, APD.cpp:859)."""
    from PIL import Image

    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), np.uint8)
    return rgb[..., ::-1].copy()


def save_image_u8(path: str | os.PathLike, img: np.ndarray) -> None:
    """Save a uint8 image; 3-channel input is interpreted as BGR
    (OpenCV convention used throughout, reference: APD.cpp:94-212)."""
    from PIL import Image

    arr = np.asarray(img, np.uint8)
    if arr.ndim == 3:
        arr = arr[..., ::-1]  # BGR -> RGB
    Image.fromarray(arr).save(path)


def resize_bilinear(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """OpenCV INTER_LINEAR-convention bilinear resize (vectorized NumPy).

    Matches `cv::resize` pixel-center alignment (reference: APD.cpp:473-476).
    Works on [H, W] or [H, W, C] float arrays.
    """
    img = np.asarray(img)
    h, w = img.shape[:2]
    if (new_w, new_h) == (w, h):
        return img.copy()
    sx = (np.arange(new_w, dtype=np.float64) + 0.5) * (w / new_w) - 0.5
    sy = (np.arange(new_h, dtype=np.float64) + 0.5) * (h / new_h) - 0.5
    x0 = np.clip(np.floor(sx), 0, w - 1).astype(np.int64)
    y0 = np.clip(np.floor(sy), 0, h - 1).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = np.clip(sx - x0, 0.0, 1.0)
    fy = np.clip(sy - y0, 0.0, 1.0)
    if img.ndim == 3:
        fx_ = fx[None, :, None]
        fy_ = fy[:, None, None]
    else:
        fx_ = fx[None, :]
        fy_ = fy[:, None]
    row0 = img[y0][:, x0] * (1 - fx_) + img[y0][:, x1] * fx_
    row1 = img[y1][:, x0] * (1 - fx_) + img[y1][:, x1] * fx_
    out = row0 * (1 - fy_) + row1 * fy_
    return out.astype(img.dtype if np.issubdtype(img.dtype, np.floating) else np.float32)


def resize_nearest(mat: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Nearest-neighbor state-map rescale (reference RescaleMatToTargetSize
    APD.cpp:752-774, intended un-swapped indexing)."""
    mat = np.asarray(mat)
    h, w = mat.shape[:2]
    if (new_w, new_h) == (w, h):
        return mat.copy()
    xs = np.minimum((np.arange(new_w) * (w / new_w)).astype(np.int64), w - 1)
    ys = np.minimum((np.arange(new_h) * (h / new_h)).astype(np.int64), h - 1)
    return mat[ys][:, xs].copy()
