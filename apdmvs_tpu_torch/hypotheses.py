"""Random plane-hypothesis generation and perturbation from injected draws.

PyTorch counterpart of ``apdmvs_tpu/hypotheses.py`` (reference:
APD.cu:211-301). The functions take their raw uniform / Gaussian draws as
tensors (see ``rng.py``) and apply the same transforms:

- random normal: an isotropic Gaussian normalized onto the sphere, flipped
  to face the camera (GenerateRandomNormal, APD.cu:211-237);
- perturbed normal: Euler-angle perturbation, keeping the original normal
  when the perturbed one faces away (APD.cu:239-274);
- perturbed depth: one uniform draw in [0.98, 1.02] * depth (APD.cu:857-862).
"""

from __future__ import annotations

from typing import Tuple

import math

import torch

from apdmvs_tpu_torch import geometry
from apdmvs_tpu_torch.geometry import mat3_vec


def random_normal_facing(g: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Unit normal on the hemisphere facing the camera from Gaussian draws
    ``g`` [..., 3]; ``dirs`` are the pixel viewing directions."""
    v = g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-12)
    dot = torch.sum(v * dirs, dim=-1, keepdim=True)
    return torch.where(dot > 0.0, -v, v)


def _euler_rotation(a1, a2, a3) -> torch.Tensor:
    """Rotation from the reference's Euler composition (APD.cu:247-263)."""
    s1, s2, s3 = torch.sin(a1), torch.sin(a2), torch.sin(a3)
    c1, c2, c3 = torch.cos(a1), torch.cos(a2), torch.cos(a3)
    row0 = torch.stack([c2 * c3, c3 * s1 * s2 - c1 * s3, s1 * s3 + c1 * c3 * s2], -1)
    row1 = torch.stack([c2 * s3, c1 * c3 + s1 * s2 * s3, c1 * s2 * s3 - c3 * s1], -1)
    row2 = torch.stack([-s2, c2 * s1, c1 * c2], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def perturbed_normal(u_angles, dirs, normal, perturbation: float) -> torch.Tensor:
    angles = (u_angles - 0.5) * perturbation
    R = _euler_rotation(angles[..., 0], angles[..., 1], angles[..., 2])
    n_pert = mat3_vec(R, normal)
    facing_away = torch.sum(n_pert * dirs, dim=-1, keepdim=True) >= 0.0
    n_out = torch.where(facing_away, normal, n_pert)
    return n_out / torch.clamp(torch.linalg.vector_norm(n_out, dim=-1, keepdim=True), min=1e-12)


def random_depth(u, depth_min, depth_max) -> torch.Tensor:
    return u * (depth_max - depth_min) + depth_min


def perturbed_depth(u, depth, perturbation: float = 0.02) -> torch.Tensor:
    lo = (1.0 - perturbation) * depth
    hi = (1.0 + perturbation) * depth
    return u * (hi - lo) + lo


def random_plane(u_depth, g_normal, K, x, y, dirs, depth_min, depth_max) -> torch.Tensor:
    """Random full plane hypothesis (APD.cu:276-282): uniform depth,
    uniform facing normal, w from depth."""
    depth = random_depth(u_depth, depth_min, depth_max)
    n = random_normal_facing(g_normal, dirs)
    w = geometry.dist_to_origin(K, x, y, depth, n)
    return torch.cat([n, w[..., None]], dim=-1)


def refinement_combos(
    u_depth, g_normal, u_pert, u_angles, K, x, y, dirs, cur_normal, cur_depth,
    depth_min, depth_max,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 5 refinement candidates (APD.cu:855-867):

      depths  = [rand, cur, rand, cur,  perturbed]
      normals = [cur,  rand, rand, pert, cur]

    Returns (depths [5, H, W], normals [5, H, W, 3]).
    """
    d_rand = random_depth(u_depth, depth_min, depth_max)
    n_rand = random_normal_facing(g_normal, dirs)
    d_pert = perturbed_depth(u_pert, cur_depth)
    n_pert = perturbed_normal(u_angles, dirs, cur_normal, 0.02 * math.pi)
    depths = torch.stack([d_rand, cur_depth, d_rand, cur_depth, d_pert], dim=0)
    normals = torch.stack([cur_normal, n_rand, n_rand, n_pert, cur_normal], dim=0)
    return depths, normals
