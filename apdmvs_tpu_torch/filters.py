"""Checkerboard median depth filter.

PyTorch counterpart of ``apdmvs_tpu/filters.py`` (CheckerboardFilterStrong:
APD.cu:1604-1714, red/black scheduling APD.cu:1716-1748). Only the depth
channel is filtered; all 20 neighbour offsets have odd parity, so two
masked half-sweeps reproduce the reference's in-place sweeps. The median of
an even count is the mean of the two middle values, taken by sorting
(``torch.median`` would return the lower one).
"""

from __future__ import annotations

import torch

from apdmvs_tpu_torch import sampling
from apdmvs_tpu_torch.params import PixelState

# (dx, dy) neighbour offsets in the reference's push order (APD.cu:1642-1703)
_FILTER_OFFSETS = [
    (0, -1), (0, -3), (0, -5),
    (0, 1), (0, 3), (0, 5),
    (-1, 0), (-3, 0), (-5, 0),
    (1, 0), (3, 0), (5, 0),
    (2, -1), (2, 1), (-2, -1), (-2, 1),
    (-1, -2), (1, -2), (-1, 2), (1, 2),
]


def _median_filter_values(depth, pixel_state) -> torch.Tensor:
    """Median of self + STRONG in-bounds checkerboard neighbours per pixel."""
    vals = [depth]  # self first (APD.cu:1620)
    valid = [torch.ones_like(depth, dtype=torch.bool)]
    strong = (pixel_state == PixelState.STRONG).to(torch.float32)
    for dx, dy in _FILTER_OFFSETS:
        v = sampling.shift2d(depth, dx, dy, float("inf"))
        ok = sampling.shift2d(strong, dx, dy, 0.0) > 0.5
        vals.append(torch.where(ok, v, float("inf")))
        valid.append(ok)
    stack = torch.stack(vals)  # [21, H, W]; invalid -> +inf sorts last
    n = torch.sum(torch.stack(valid), dim=0)  # includes self
    s = torch.sort(stack, dim=0).values
    lo = torch.gather(s, 0, ((n - 1) // 2)[None])[0]
    hi = torch.gather(s, 0, (n // 2)[None])[0]
    return 0.5 * (lo + hi)


def checkerboard_median_filter(planes, costs, pixel_state) -> torch.Tensor:
    """Two red-black masked median sweeps over non-WEAK pixels; pixels with
    cost < 0.001 are left untouched (APD.cu:1638-1640). planes: [H, W, 4]
    with depth in channel 3."""
    H, W = costs.shape
    y, x = torch.meshgrid(
        torch.arange(H, device=costs.device), torch.arange(W, device=costs.device),
        indexing="ij",
    )
    parity = (x + y) % 2
    out = planes.clone()
    for color in (0, 1):  # black then red (APD.cu:2462-2465)
        depth = out[..., 3]
        med = _median_filter_values(depth, pixel_state)
        upd = (parity == color) & (pixel_state != PixelState.WEAK) & (costs >= 0.001)
        out[..., 3] = torch.where(upd, med, depth)
    return out
