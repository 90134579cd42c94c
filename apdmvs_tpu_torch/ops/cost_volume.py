"""Per-slice NCC cost volumes for the APD weak machinery.

PyTorch counterpart of ``apdmvs_tpu/ops/cost_volume.py`` (plain tensor code
there too: the reference package leaves it to XLA, not to a TPU kernel).

C[k, y, x] is the plain-NCC cost of the patch centred at padded reference
pixel (y, x) against the image volume E under the fronto-parallel plane of
slice k: the classic plane-sweep cost volume, from separable shifted sums
of E and the padded reference image (no gathers). The deformed NCC of the
weak machinery (ComputeBilateralNCCNew, APD.cu:400-528) then reads each
anchor patch's cost as one k-interpolated lookup (``ops/cols.py``), or,
without resident columns, :func:`fetch_cost`.
"""

from __future__ import annotations

import torch

from apdmvs_tpu_torch.ops.ncc_volume import ncc_moments

COST_MAX = 2.0
MIN_VAR = 1e-5


def build_cost_volume(E_pad: torch.Tensor, ref_pad: torch.Tensor, radius: int = 5,
                      increment: int = 2, chunk: int = 8) -> torch.Tensor:
    """[K, PH, PW] bf16 cost volume of the image volume E [K, PH, PW] against
    the padded reference image ref_pad [PH, PW] f32, for the window
    (``radius``, ``increment``): 6x6 samples for (5, 2), 3x3 for (5, 5).

    The sums are taken in the reference package's order (along x, then
    along y, offsets ascending), the moments as in the NCC kernel
    (``ncc_volume.ncc_moments``), the cost is rounded to bf16 (round to
    nearest even) at the end. Rows and columns within ``radius`` of the
    padded edge have zero sums and so cost COST_MAX; no lookup reads them.
    """
    K, PH, PW = E_pad.shape
    vals = list(range(-radius, radius + 1, increment))
    R = radius
    inv = torch.tensor(1.0 / float(len(vals) ** 2), dtype=torch.float32, device=E_pad.device)

    def sep_sum(a):
        ax = torch.zeros_like(a)
        for dx in vals:
            ax[..., R:PW - R] += a[..., R + dx:PW - R + dx]
        out = torch.zeros_like(a)
        for dy in vals:
            out[..., R:PH - R, :] += ax[..., R + dy:PH - R + dy, :]
        return out

    ref = ref_pad.to(torch.float32)
    mr = sep_sum(ref) * inv
    s_rr = sep_sum(ref * ref)[None]
    out = torch.empty((K, PH, PW), dtype=torch.bfloat16, device=E_pad.device)
    for k0 in range(0, K, chunk):
        e = E_pad[k0:k0 + chunk].to(torch.float32)
        ms = sep_sum(e) * inv
        var_r, var_s, cov = ncc_moments(s_rr, sep_sum(e * e), sep_sum(ref[None] * e), mr[None],
                                        ms, inv)
        cost = 1.0 - cov * torch.rsqrt(torch.clamp(var_r * var_s, min=1e-30))
        cost = torch.clamp(cost, 0.0, COST_MAX)
        cost = torch.where((var_r < MIN_VAR) | (var_s < MIN_VAR), COST_MAX, cost)
        out[k0:k0 + chunk] = cost.to(torch.bfloat16)
    return out


def fetch_cost(C: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, k: torch.Tensor,
               pad_y: int, pad_x: int) -> torch.Tensor:
    """Cost at integer reference pixels (``xs``, ``ys``, unpadded) and
    fractional slices ``k`` of a cost volume C [K, PH, PW] bf16: the two
    neighbouring slices interpolated linearly, k clamped to [0, K-1] and
    the pixel to the padded grid (2 gathers, f32; NaN k reads slice 0 and
    gives NaN)."""
    K, PH, PW = C.shape
    kc = torch.clamp(k, 0.0, K - 1.0)
    k0 = torch.floor(torch.nan_to_num(kc, nan=0.0)).to(torch.int64)
    k1 = torch.clamp(k0 + 1, max=K - 1)
    f = kc - k0.to(torch.float32)
    xi = torch.clamp(xs.to(torch.int64) + pad_x, 0, PW - 1)
    yi = torch.clamp(ys.to(torch.int64) + pad_y, 0, PH - 1)
    flat = C.reshape(-1)
    base = yi * PW + xi
    c0 = flat[k0 * (PH * PW) + base].to(torch.float32)
    c1 = flat[k1 * (PH * PW) + base].to(torch.float32)
    return c0 * (1.0 - f) + c1 * f
