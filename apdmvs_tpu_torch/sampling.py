"""Image sampling utilities: bilinear gathers and static patch shifts.

PyTorch counterpart of ``apdmvs_tpu/sampling.py``. Sampling at float pixel
coordinate (x, y) with integer x, y returns image[y, x] (the reference's
texel-center convention, APD.cpp:596-602). Out-of-range reads clamp to the
border, with the clamp applied *before* the fractional split.
"""

from __future__ import annotations

import numpy as np
import torch


def bilinear_sample(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Border-clamped bilinear sample of a [H, W] image at float coords.

    Coordinates are clamped to [0, W-1] x [0, H-1] before the fractional
    split, so out-of-range reads return pure edge values.
    """
    H, W = image.shape
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = x - x0f
    wy = y - y0f
    x0 = torch.clamp(x0f.to(torch.int64), 0, W - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y0 = torch.clamp(y0f.to(torch.int64), 0, H - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    flat = image.reshape(-1)
    v00 = flat[y0 * W + x0]
    v01 = flat[y0 * W + x1]
    v10 = flat[y1 * W + x0]
    v11 = flat[y1 * W + x1]
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def nearest_sample_trunc(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """image[int(y), int(x)] with truncation toward zero, border-clamped
    (the reference's depth-texture read, APD.cu:772)."""
    H, W = image.shape
    xi = torch.clamp(x.to(torch.int64), 0, W - 1)
    yi = torch.clamp(y.to(torch.int64), 0, H - 1)
    return image.reshape(-1)[yi * W + xi]


def gather_grid(field: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Integer-coordinate gather from a [H, W, ...] field, coordinates
    clamped into the grid (so -1 padding reads row/column 0)."""
    H, W = field.shape[:2]
    xi = torch.clamp(x.to(torch.int64), 0, W - 1)
    yi = torch.clamp(y.to(torch.int64), 0, H - 1)
    return field.reshape((H * W,) + tuple(field.shape[2:]))[yi * W + xi]


def select_axis1(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[n, idx[n, ...]] along axis 1. values: [N, D, *rest]; idx:
    [N, *extra] with entries in [0, D). Returns [N, *extra, *rest]."""
    N = values.shape[0]
    rest = tuple(values.shape[2:])
    extra = tuple(idx.shape[1:])
    flat = idx.to(torch.int64).reshape(N, -1)  # [N, E]
    flat = flat.reshape(flat.shape + (1,) * len(rest)).expand((N, flat.shape[1]) + rest)
    return torch.gather(values, 1, flat).reshape((N,) + extra + rest)


def shift2d(arr: torch.Tensor, dx: int, dy: int, fill) -> torch.Tensor:
    """Static shift: out[y, x] = arr[y + dy, x + dx], out of bounds -> fill.
    Leading two dims are (H, W); trailing dims ride along."""
    H, W = arr.shape[:2]
    out = torch.full_like(arr, fill)
    ys_dst = slice(max(-dy, 0), H - max(dy, 0))
    xs_dst = slice(max(-dx, 0), W - max(dx, 0))
    ys_src = slice(max(dy, 0), H - max(-dy, 0))
    xs_src = slice(max(dx, 0), W - max(-dx, 0))
    if ys_dst.start < ys_dst.stop and xs_dst.start < xs_dst.stop:
        out[ys_dst, xs_dst] = arr[ys_src, xs_src]
    return out


def select_index(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[idx] along axis 0. values: [C, ...]; idx: [H, W] (or any
    shape that is a prefix of values.shape[1:])."""
    extra = values.ndim - 1 - idx.ndim
    idx_b = idx.to(torch.int64).reshape((1,) + tuple(idx.shape) + (1,) * extra)
    idx_b = idx_b.expand((1,) + tuple(values.shape[1:]))
    return torch.gather(values, 0, idx_b)[0]


def patch_offsets(radius: int, increment: int) -> np.ndarray:
    """NCC window offsets, i, j in [-radius, radius] step increment
    (APD.cu:461-468). Returns int [S, 2] (dx, dy) pairs; radius 5 step 2
    gives the 36-sample strong window."""
    vals = list(range(-radius, radius + 1, increment))
    return np.asarray([(i, j) for i in vals for j in vals], np.int32)
