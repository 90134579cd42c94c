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

A :class:`DrawPlan` lets a captured pass (``compiled.py``) take its draws
from any source: a warm-up pass records the requests, in order, and keeps
their answers on the device as slots; the captured pass reads the slots,
and before each replay :meth:`DrawPlan.fill` asks the replay's own source
the same requests in the same order and copies the answers in, so a
replay sees the bits the eager pass would have drawn.
"""

from __future__ import annotations

from typing import List, Tuple

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


#: the requests of a draw source, as the pass makes them
REQUESTS = ("init_plane", "view_selection", "refinement", "anchor_probes", "anchor_ransac",
            "fit_ransac", "weak_view_selection", "weak_refinement")


def _flat(answer) -> List[torch.Tensor]:
    return list(answer) if isinstance(answer, tuple) else [answer]


class _Recorder:
    """A draw source that forwards each request to ``source`` and records
    it in ``plan``, its answer moved to ``device`` as the request's slots."""

    def __init__(self, source, plan: "DrawPlan", device):
        self._source, self._plan, self._device = source, plan, torch.device(device)

    def _request(self, name: str, *args):
        answer = getattr(self._source, name)(*args)
        slots = tuple(torch.as_tensor(a, device=self._device).contiguous()
                      for a in _flat(answer))
        self._plan.requests.append((name, args))
        self._plan.slots.append(slots if isinstance(answer, tuple) else slots[0])
        return self._plan.slots[-1]


class _Reader:
    """A draw source that answers ``plan``'s requests from its slots, in
    order, and raises on a request the plan does not hold."""

    def __init__(self, plan: "DrawPlan"):
        self._plan, self._next = plan, 0

    def _request(self, name: str, *args):
        i = self._next
        held = self._plan.requests[i] if i < len(self._plan.requests) else None
        if held != (name, args):
            raise RuntimeError(f"draw request {i} is {name}{args}, the plan holds {held}")
        self._next += 1
        return self._plan.slots[i]


for _name in REQUESTS:
    def _method(self, *args, _name=_name):
        return self._request(_name, *args)

    setattr(_Recorder, _name, _method)
    setattr(_Reader, _name, _method)


class DrawPlan:
    """The draw requests of one pass, (name, arguments) in order, each
    with its answer's slots: tensors on the pass's device that keep their
    addresses, so a CUDA graph can read them."""

    def __init__(self):
        self.requests: List[tuple] = []
        self.slots: list = []  # a tensor, or a tuple of them, a request

    @classmethod
    def record(cls, source, device) -> Tuple["DrawPlan", _Recorder]:
        """A new plan and the source that fills it: hand the recorder to
        the warm-up pass; its answers are ``source``'s, and stay as the
        slots."""
        plan = cls()
        return plan, _Recorder(source, plan, device)

    def reader(self) -> _Reader:
        """A draw source answering this plan's requests from the slots."""
        return _Reader(self)

    def fill(self, source) -> None:
        """Ask ``source`` this plan's requests in order and copy each
        answer into its slots (on the slots' stream order, no host read)."""
        for (name, args), slots in zip(self.requests, self.slots):
            answer, slots = _flat(getattr(source, name)(*args)), _flat(slots)
            if len(answer) != len(slots):
                raise RuntimeError(f"draw request {name}{args} answered {len(answer)} tensors, "
                                   f"the plan holds {len(slots)}")
            for slot, a in zip(slots, answer):
                slot.copy_(a)
