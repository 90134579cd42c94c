"""Epipolar plane-sweep volumes: the inverse-depth slice grid, the volume
builder (kernel H1) and the K-interpolating sampler (kernel H8).

PyTorch counterpart of ``apdmvs_tpu/ops/volume.py``. E[k, y, x] is the
source image bilinearly sampled at the warp of reference pixel (x, y) under
the fronto-parallel plane at inverse depth u_k = u_min + k du: one global
homography per slice. Any plane hypothesis's warp of (x, y) equals E
sampled at k(depth(x, y)) exactly, which is what the cost kernels
interpolate, and what :func:`volume_sample` computes at a depth map's
slice coordinates (:func:`depth_to_slice`).

Two wrappers, each running its plain version on a CPU tensor and launching
its kernel on a CUDA tensor (or raising), with a launch counter:

- :func:`build_volume` (H1, ``csrc/build_volume.cu``; replaces
  ``apdmvs_tpu/ops/volume.py:123 _build_kernel``), plain version
  :func:`build_volume_padded`;
- :func:`volume_sample` (H8, ``csrc/volume_sample.cu``; replaces
  ``apdmvs_tpu/ops/volume.py:375 _select_kernel``), plain version
  :func:`volume_sample_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from apdmvs_tpu_torch import geometry, sampling
from apdmvs_tpu_torch.ops import _build


def inv_depth_grid(depth_min, depth_max, num_slices: int):
    """Slice grid uniform in inverse depth, in float32 like the reference
    package's traced scalars. Returns (u_min, du) as 0-d f32 tensors."""
    depth_min = torch.as_tensor(depth_min, dtype=torch.float32)
    depth_max = torch.as_tensor(depth_max, dtype=torch.float32)
    u_min = 1.0 / depth_max
    u_max = 1.0 / depth_min
    du = (u_max - u_min) / (num_slices - 1)
    return u_min, du


def depth_to_slice(depth, u_min, du):
    """Fractional slice coordinate of a depth value (clamps nothing)."""
    return (1.0 / depth - u_min) / du


def build_volume_padded(
    src_image, M, b, K0, height: int, width: int, u_min, du, num_slices: int,
    pad_y: int, pad_x: int, dtype=torch.bfloat16, trunc: bool = False, row0: float = 0.0,
) -> torch.Tensor:
    """Plain version of H1: [K, height+2*pad_y, width+2*pad_x] in ``dtype``
    over the padded pixel grid [row0-pad_y, row0+H+pad_y) x [-pad_x, W+pad_x).
    ``trunc`` floors the warped coordinates first (the depth-texture nearest
    read, APD.cu:770-772)."""
    dev = src_image.device
    PH, PW = height + 2 * pad_y, width + 2 * pad_x
    y, x = torch.meshgrid(
        torch.arange(PH, dtype=torch.float32, device=dev),
        torch.arange(PW, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    y = y - pad_y + row0
    x = x - pad_x
    dirs = geometry.pixel_dirs(K0, x, y)
    Md = geometry.mat3_vec(M, dirs)
    u_min = torch.as_tensor(u_min, dtype=torch.float32, device=dev)
    du = torch.as_tensor(du, dtype=torch.float32, device=dev)
    out = torch.empty((num_slices, PH, PW), dtype=dtype, device=dev)
    for k in range(num_slices):
        u = u_min + torch.tensor(float(k), dtype=torch.float32, device=dev) * du
        q = Md + b * u
        sx = q[..., 0] / q[..., 2]
        sy = q[..., 1] / q[..., 2]
        if trunc:
            sx = torch.floor(sx)
            sy = torch.floor(sy)
        out[k] = sampling.bilinear_sample(src_image, sx, sy).to(dtype)
    return out


_SIG = {
    "build_volume_launch": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
}


def build_volume(
    src_image, M, b, K0, height: int, width: int, u_min, du, num_slices: int,
    pad_y: int = 8, pad_x: int = 128, dtype=torch.bfloat16, trunc: bool = False,
    row0: int = 0,
) -> torch.Tensor:
    """Kernel H1 wrapper (for the TPU kernel ``_build_kernel``): the volume
    of :func:`build_volume_padded`. ``dtype`` must be bf16 for the
    bilinear mode and f32 for ``trunc``. ``row0`` is the global row of the
    volume's first interior row (a row slab of a spaced set,
    ``ncc.build_volume_set_spaced``); an integer below 2^24, so the
    kernel's ``(py - pad_y) + row0`` in float32 is exact."""
    if not 0 <= row0 < 2 ** 24 or int(row0) != row0:
        raise ValueError(f"row0 must be an integer in [0, 2^24), got {row0}")
    if src_image.dim() != 2 or src_image.dtype != torch.float32:
        raise ValueError("src_image must be a [H, W] float32 tensor")
    if dtype != (torch.float32 if trunc else torch.bfloat16):
        raise ValueError("build_volume writes bf16 (bilinear) or f32 (trunc)")
    if src_image.device.type == "cpu":
        return build_volume_padded(
            src_image, M, b, K0, height, width, u_min, du, num_slices,
            pad_y=pad_y, pad_x=pad_x, dtype=dtype, trunc=trunc, row0=float(row0),
        )
    if src_image.device.type != "cuda":
        raise ValueError(f"unsupported device {src_image.device}")
    src = src_image.contiguous()
    dev = src.device
    # fx, fy, cx, cy, M(9), b(3), u_min, du: stays on the card (no sync)
    params = torch.cat([
        torch.stack([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]).to(dev, torch.float32),
        M.reshape(-1).to(dev, torch.float32), b.reshape(-1).to(dev, torch.float32),
        torch.as_tensor(u_min, dtype=torch.float32).reshape(1).to(dev),
        torch.as_tensor(du, dtype=torch.float32).reshape(1).to(dev),
    ])
    PH, PW = height + 2 * pad_y, width + 2 * pad_x
    out = torch.empty((num_slices, PH, PW), dtype=dtype, device=dev)
    lib = _build.load("build_volume", _SIG)
    with _build.on_device(src):
        err = lib.build_volume_launch(
            src.data_ptr(), src.shape[0], src.shape[1], params.data_ptr(),
            num_slices, PH, PW, pad_y, pad_x, float(row0), int(trunc), out.data_ptr(),
            torch.cuda.current_stream(src.device).cuda_stream,
        )
    _build.check(err, "build_volume")
    build_volume.launches += 1
    return out


build_volume.launches = 0


def volume_sample_ref(E: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version of H8 (the reference package's ``volume_sample_ref``):
    linear interpolation along K with border clamping. E: [K, H, W]; k:
    [H, W] float; returns [H, W] f32. A NaN ``k`` reads slice 0 and gives
    NaN, as the mirror's float-to-integer conversion does."""
    K = E.shape[0]
    kc = torch.clamp(k, 0.0, K - 1.0)
    k0 = torch.nan_to_num(torch.floor(kc), nan=0.0).to(torch.int64)
    k1 = torch.clamp(k0 + 1, max=K - 1)
    f = (kc - k0.to(torch.float32)).to(torch.float32)
    e0 = torch.gather(E, 0, k0[None])[0].to(torch.float32)
    e1 = torch.gather(E, 0, k1[None])[0].to(torch.float32)
    return e0 * (1.0 - f) + e1 * f


_SAMPLE_SIG = {
    "volume_sample_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
}


def volume_sample(E: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Kernel H8 wrapper (for the TPU kernel ``_select_kernel``, entry
    ``volume_sample``): E [K, H, W] bf16 or f32, k [H, W] f32 -> [H, W] f32,
    as :func:`volume_sample_ref`, NaN included. Any H and W (the reference
    package's multiples of (8, 128) are its TPU tiling)."""
    if E.dim() != 3 or E.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("E must be a [K, H, W] bf16 or f32 tensor")
    if k.dtype != torch.float32 or tuple(k.shape) != tuple(E.shape[1:]):
        raise ValueError(f"k must be a {tuple(E.shape[1:])} float32 tensor")
    if E.device != k.device:
        raise ValueError("inputs on several devices")
    if E.device.type == "cpu":
        return volume_sample_ref(E, k)
    if E.device.type != "cuda":
        raise ValueError(f"unsupported device {E.device}")
    K, H, W = E.shape
    E, k = E.contiguous(), k.contiguous()
    out = torch.empty((H, W), dtype=torch.float32, device=E.device)
    if H * W == 0:
        return out
    lib = _build.load("volume_sample", _SAMPLE_SIG)
    with _build.on_device(E):
        err = lib.volume_sample_launch(
            E.data_ptr(), k.data_ptr(), K, H * W, int(E.dtype == torch.bfloat16), out.data_ptr(),
            torch.cuda.current_stream(E.device).cuda_stream,
        )
    _build.check(err, "volume_sample")
    volume_sample.launches += 1
    return out


volume_sample.launches = 0
