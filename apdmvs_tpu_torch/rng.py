"""Random draws for one PatchMatch pass.

The stochastic functions of the port (``hypotheses.random_plane``,
``hypotheses.refinement_combos``, ``propagation.joint_view_selection``)
take their raw draws as tensors, so a caller can feed any source: the
default :class:`TorchDraws` below, or a test-side source that replays
another implementation's draws bit for bit.

A draw source answers these requests, named after the pass stages that
consume them:

  - ``init_plane()`` -> (u_depth [H,W] uniform, g_normal [H,W,3] Gaussian)
  - ``view_selection(it, color)`` -> u [S,H,W] uniform (S Monte-Carlo draws)
  - ``refinement(it, color)`` -> (u_depth [H,W], g_normal [H,W,3],
    u_pert [H,W], u_angles [H,W,3])

and, on passes with the APD weak machinery (``weak.py``; N is the weak
worklist's capacity):

  - ``anchor_probes(steps, dirs, shift_range)`` -> int [steps, dirs, 2] ray
    jitters in [-shift_range+1, shift_range)
  - ``anchor_ransac(shape)`` -> int [5, N, 10, 3] in [0, 2^30): triangle
    draws of the anchor RANSAC, reduced modulo the hit count by the caller
  - ``fit_ransac(it, shape)`` -> the same for iteration ``it``'s plane fit
  - ``weak_view_selection(it, n)`` -> u [S, N] uniform
  - ``weak_refinement(it, n)`` -> (u_depth [N], g_normal [N,3], u_pert [N],
    u_angles [N,3])

Uniforms lie in [0, 1); Gaussians are standard normal.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def pass_seed(seed: int, pass_index: int, problem_index: int) -> int:
    """One 63-bit generator seed from (seed, pass, problem), the same triple
    the reference package folds into its per-problem key."""
    state = np.random.SeedSequence([seed, pass_index, problem_index]).generate_state(2)
    return int((int(state[0]) << 32 | int(state[1])) & ((1 << 63) - 1))


class TorchDraws:
    """Draws from one ``torch.Generator`` on the pass's device."""

    def __init__(self, seed: int, height: int, width: int, device, num_samples: int = 15):
        self.shape = (height, width)
        self.num_samples = num_samples
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def _u(self, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)

    def _g(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)

    def init_plane(self) -> Tuple[torch.Tensor, torch.Tensor]:
        H, W = self.shape
        return self._u(H, W), self._g(H, W, 3)

    def view_selection(self, it: int, color: int) -> torch.Tensor:
        H, W = self.shape
        return self._u(self.num_samples, H, W)

    def refinement(self, it: int, color: int):
        H, W = self.shape
        return self._u(H, W), self._g(H, W, 3), self._u(H, W), self._u(H, W, 3)

    def _i(self, low: int, high: int, shape) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape), generator=self.gen, device=self.device,
                             dtype=torch.int64)

    def anchor_probes(self, steps: int, dirs: int, shift_range: int) -> torch.Tensor:
        return self._i(-shift_range + 1, shift_range, (steps, dirs, 2))

    def anchor_ransac(self, shape) -> torch.Tensor:
        return self._i(0, 1 << 30, shape)

    def fit_ransac(self, it: int, shape) -> torch.Tensor:
        return self._i(0, 1 << 30, shape)

    def weak_view_selection(self, it: int, n: int) -> torch.Tensor:
        return self._u(self.num_samples, n)

    def weak_refinement(self, it: int, n: int):
        return self._u(n), self._g(n, 3), self._u(n), self._u(n, 3)
