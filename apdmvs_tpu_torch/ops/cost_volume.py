"""Per-slice NCC cost volumes for the APD weak machinery.

PyTorch counterpart of ``apdmvs_tpu/ops/cost_volume.py`` (plain tensor code
there too: the reference package leaves it to XLA, not to a TPU kernel).

C[k, y, x] is the plain-NCC cost of the patch centred at padded reference
pixel (y, x) against the image volume E under the fronto-parallel plane of
slice k: the classic plane-sweep cost volume, from separable shifted sums
of E and the padded reference image (no gathers). The deformed NCC of the
weak machinery (ComputeBilateralNCCNew, APD.cu:400-528) then reads each
anchor patch's cost as one k-interpolated lookup of its resident column
(``ops/cols.py``).

:func:`build_cost_volumes` builds C36 and C9 of every source view: on CPU
tensors through :func:`build_cost_volume` (the plain version), on CUDA
tensors as one launch of kernel H9 (``csrc/cost_volume.cu``), bit-equal to
it, counted in ``build_cost_volumes.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from apdmvs_tpu_torch import telemetry
from apdmvs_tpu_torch.ops import _build
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


_H9_SIG = {
    "cost_volumes_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
}


def cost_volumes_work_shape(E: torch.Tensor) -> dict:
    """The call shape that fixes an H9 launch's work: the source views,
    slices and padded H, W of E."""
    NV, K, PH, PW = E.shape
    return dict(views=NV, slices=K, height=PH, width=PW)


def build_cost_volumes(E: torch.Tensor, ref_pad: torch.Tensor, out36=None, out9=None):
    """Kernel H9 wrapper: the cost volumes (C36, C9) [NV, K, PH, PW] bf16
    of every source view of E [NV, K, PH, PW] bf16 against ref_pad [PH, PW]
    f32, written into ``out36`` and ``out9`` where given (every element;
    a lent slot need not be zeroed), else into new tensors. Its plain
    version is :func:`build_cost_volume` of each view, windows (5, 2) and
    (5, 5)."""
    if E.dim() != 4 or E.dtype != torch.bfloat16:
        raise ValueError("E must be an [NV, K, PH, PW] bf16 tensor")
    if ref_pad.dtype != torch.float32 or tuple(ref_pad.shape) != tuple(E.shape[2:]):
        raise ValueError(f"ref_pad must be [{E.shape[2]}, {E.shape[3]}] float32")
    outs = []
    for name, o in (("out36", out36), ("out9", out9)):
        if o is None:
            o = torch.empty(E.shape, dtype=torch.bfloat16, device=E.device)
        elif o.dtype != torch.bfloat16 or o.shape != E.shape or not o.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {list(E.shape)} bf16 tensor")
        outs.append(o)
    out36, out9 = outs
    if len({E.device, ref_pad.device, out36.device, out9.device}) != 1:
        raise ValueError("inputs on several devices")
    if E.device.type == "cpu":
        for v in range(E.shape[0]):
            out36[v] = build_cost_volume(E[v], ref_pad, 5, 2)
            out9[v] = build_cost_volume(E[v], ref_pad, 5, 5)
        return out36, out9
    if E.device.type != "cuda":
        raise ValueError(f"unsupported device {E.device}")
    if E.numel() == 0:
        return out36, out9
    NV, K, PH, PW = E.shape
    E = E.contiguous()
    ref_pad = ref_pad.contiguous()
    lib = _build.load("cost_volume", _H9_SIG)
    with _build.on_device(E):
        err = lib.cost_volumes_launch(
            E.data_ptr(), ref_pad.data_ptr(), NV, K, PH, PW, out36.data_ptr(), out9.data_ptr(),
            torch.cuda.current_stream(E.device).cuda_stream)
    _build.check(err, "cost_volumes")
    telemetry.count_launch(build_cost_volumes, **cost_volumes_work_shape(E))
    return out36, out9


build_cost_volumes.launches = 0
build_cost_volumes.work = {}
