"""Multi-view geometry core on whole-image [H, W] tensors.

PyTorch counterpart of ``apdmvs_tpu/geometry.py`` (reference device math:
APD.cu:57-392, APD.cu:718-789). Conventions are identical:

  - Camera: ``x_cam = R @ X_world + t``; world center ``c = -R^T t``.
  - Plane hypothesis = ``(nx, ny, nz, w)``: unit normal in the
    reference-camera frame with ``n . X + w = 0``. At readout ``w`` becomes
    depth and the normal is rotated to the world frame.
  - Intrinsics: zero skew (closed-form K inverse).

The warp identity ``H(plane) = A - b (n~)^T / w`` lets every cost
evaluation work from three homogeneous vectors per (pixel, view); the
per-view constants are :class:`WarpConstants`. 3x3 products are written as
explicit multiply-adds so the arithmetic order matches the reference
package element for element.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class Cameras(NamedTuple):
    """A stack of V cameras; index 0 is the reference view (all float32)."""

    K: torch.Tensor  # [V, 3, 3]
    R: torch.Tensor  # [V, 3, 3] world -> cam
    t: torch.Tensor  # [V, 3]
    c: torch.Tensor  # [V, 3] world-frame centers (-R^T t)
    depth_min: torch.Tensor  # [V]
    depth_max: torch.Tensor  # [V]

    @property
    def num_views(self) -> int:
        return self.K.shape[0]

    @property
    def device(self) -> torch.device:
        return self.K.device


def mat3_vec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Explicit M @ v with broadcasting. M: [..., 3, 3], v: [..., 3]."""
    return torch.stack(
        [
            M[..., 0, 0] * v[..., 0] + M[..., 0, 1] * v[..., 1] + M[..., 0, 2] * v[..., 2],
            M[..., 1, 0] * v[..., 0] + M[..., 1, 1] * v[..., 1] + M[..., 1, 2] * v[..., 2],
            M[..., 2, 0] * v[..., 0] + M[..., 2, 1] * v[..., 1] + M[..., 2, 2] * v[..., 2],
        ],
        dim=-1,
    )


def mat3_t_vec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Explicit M^T @ v (see mat3_vec)."""
    return torch.stack(
        [
            M[..., 0, 0] * v[..., 0] + M[..., 1, 0] * v[..., 1] + M[..., 2, 0] * v[..., 2],
            M[..., 0, 1] * v[..., 0] + M[..., 1, 1] * v[..., 1] + M[..., 2, 1] * v[..., 2],
            M[..., 0, 2] * v[..., 0] + M[..., 1, 2] * v[..., 1] + M[..., 2, 2] * v[..., 2],
        ],
        dim=-1,
    )


def mat3_mat3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Explicit 3x3 @ 3x3 (see mat3_vec)."""
    return torch.stack([mat3_vec(A, B[..., :, k]) for k in range(3)], dim=-1)


def make_cameras(K, R, t, depth_min, depth_max, device="cpu") -> Cameras:
    def f32(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=torch.float32)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    K, R, t = f32(K), f32(R), f32(t)
    return Cameras(
        K=K, R=R, t=t, c=-mat3_t_vec(R, t),
        depth_min=f32(depth_min), depth_max=f32(depth_max),
    )


def scale_intrinsics(K, scale_x: float, scale_y: float):
    """Rescale fx, cx by scale_x and fy, cy by scale_y (APD.cpp:480-483).
    Works on numpy arrays or tensors of shape [..., 3, 3]; returns a copy."""
    out = K.clone() if isinstance(K, torch.Tensor) else K.copy()
    out[..., 0, 0] *= scale_x
    out[..., 0, 2] *= scale_x
    out[..., 1, 1] *= scale_y
    out[..., 1, 2] *= scale_y
    return out


def pixel_grid(height: int, width: int, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer pixel coordinate fields x[H,W], y[H,W] as float32."""
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return x, y


def pixel_dirs(K: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """((x-cx)/fx, (y-cy)/fy, 1) (APD.cu:159-171). Returns [..., 3]."""
    dx = (x - K[0, 2]) / K[0, 0]
    dy = (y - K[1, 2]) / K[1, 1]
    return torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)


def depth_from_plane(K, plane, x, y) -> torch.Tensor:
    """Depth ``-w / (n . dir(p))`` of the plane at pixel (x, y)
    (APD.cu:206-209). plane: [..., 4]."""
    d = pixel_dirs(K, x, y)
    denom = torch.sum(plane[..., :3] * d, dim=-1)
    return -plane[..., 3] / denom


def dist_to_origin(K, x, y, depth, normal) -> torch.Tensor:
    """w = -(n . X) with X = depth * dir(p) (APD.cu:187-192)."""
    d = pixel_dirs(K, x, y)
    return -depth * torch.sum(normal[..., :3] * d, dim=-1)


def relative_pose(cams: Cameras, src: int):
    """R_rel = R_src R_ref^T and t_rel = R_src (C_ref - C_src)."""
    r_rel = mat3_mat3(cams.R[src], cams.R[0].transpose(-1, -2))
    t_rel = mat3_vec(cams.R[src], cams.c[0] - cams.c[src])
    return r_rel, t_rel


def k_inverse_zero_skew(K: torch.Tensor) -> torch.Tensor:
    """Closed-form K^{-1} under zero skew (APD.cu:343-352)."""
    fx, cx, fy, cy = K[0, 0], K[0, 2], K[1, 1], K[1, 2]
    z = torch.zeros((), dtype=K.dtype, device=K.device)
    o = torch.ones((), dtype=K.dtype, device=K.device)
    return torch.stack(
        [
            torch.stack([1.0 / fx, z, -cx / fx]),
            torch.stack([z, 1.0 / fy, -cy / fy]),
            torch.stack([z, z, o]),
        ]
    )


class WarpConstants(NamedTuple):
    """Per-(ref, src) homography constants (index v = camera v; entry 0 is
    ref-vs-ref and unused)."""

    A: torch.Tensor  # [V, 3, 3]: K_src R_rel K_ref^{-1}
    M: torch.Tensor  # [V, 3, 3]: K_src R_rel
    b: torch.Tensor  # [V, 3]: K_src t_rel
    inv_fx: torch.Tensor  # []
    inv_fy: torch.Tensor  # []


def warp_constants(cams: Cameras) -> WarpConstants:
    K_ref_inv = k_inverse_zero_skew(cams.K[0])
    As, Ms, bs = [], [], []
    for v in range(cams.num_views):
        r_rel, t_rel = relative_pose(cams, v)
        M = mat3_mat3(cams.K[v], r_rel)
        As.append(mat3_mat3(M, K_ref_inv))
        Ms.append(M)
        bs.append(mat3_vec(cams.K[v], t_rel))
    return WarpConstants(
        A=torch.stack(As), M=torch.stack(Ms), b=torch.stack(bs),
        inv_fx=1.0 / cams.K[0, 0, 0], inv_fy=1.0 / cams.K[0, 1, 1],
    )


def backproject_world(x, y, depth, K, R, c) -> torch.Tensor:
    """Pixel + depth -> world point X = R^T (depth * dir) + c
    (Get3DPointonWorld_cu, APD.cu:718-738). K, R: [3, 3] or batched
    [..., 3, 3] broadcasting against the pixels."""
    dx = (x - K[..., 0, 2]) / K[..., 0, 0]
    dy = (y - K[..., 1, 2]) / K[..., 1, 1]
    X_cam = depth[..., None] * torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
    return mat3_t_vec(R, X_cam) + c


def project_camera(X, K, R, t):
    """World point -> (px, py, depth) through full K rows
    (ProjectonCamera_cu, APD.cu:740-750). Batched cameras broadcast as in
    :func:`backproject_world`."""
    x_cam = mat3_vec(R, X) + t
    x0, x1, x2 = x_cam[..., 0], x_cam[..., 1], x_cam[..., 2]
    depth = K[..., 2, 0] * x0 + K[..., 2, 1] * x1 + K[..., 2, 2] * x2
    px = (K[..., 0, 0] * x0 + K[..., 0, 1] * x1 + K[..., 0, 2] * x2) / depth
    py = (K[..., 1, 0] * x0 + K[..., 1, 1] * x1 + K[..., 1, 2] * x2) / depth
    return px, py, depth


def normal_cam_to_world(R, n):
    """R^T n (APD.cu:374-382)."""
    return mat3_t_vec(R, n)


def normal_world_to_cam(R, n):
    """R n (APD.cu:384-392)."""
    return mat3_vec(R, n)


def planes_to_depth_normal(cams: Cameras, planes, height: int, width: int):
    """Optimization-frame planes -> (depth [H,W], world normals [H,W,3])
    (APD.cu:1587-1602)."""
    x, y = pixel_grid(height, width, planes.device)
    depth = depth_from_plane(cams.K[0], planes, x, y)
    return depth, normal_cam_to_world(cams.R[0], planes[..., :3])


def depth_normal_to_planes(cams: Cameras, depth, normal_world, height: int, width: int):
    """(depth, world normal) -> optimization-frame planes (APD.cu:826-833)."""
    x, y = pixel_grid(height, width, depth.device)
    n_cam = normal_world_to_cam(cams.R[0], normal_world)
    w = dist_to_origin(cams.K[0], x, y, depth, n_cam)
    return torch.cat([n_cam, w[..., None]], dim=-1)
