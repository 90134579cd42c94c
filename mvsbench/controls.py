"""The controls a cell's limits are set against: the program with one thing
it should keep broken on purpose, read through the same judge. Only
``calibrate`` and the card's tests plant them; a benchmark run never does.

A control is a dict (``check.controls`` of a workload file names them):

- ``{"run": {...}}``: ``run_scene`` arguments in place of the
  configuration's, such as fewer inverse-depth slices than it states;
- ``{"round": "maps", "dtype": "bfloat16"}``: every pass's depth and
  normal maps rounded to ``dtype`` where the pass returns them, the later
  passes and the fusion reading the rounded maps;
- ``{"round": "cloud", "dtype": "bfloat16"}``: the fused points'
  coordinates rounded to ``dtype`` where the fusion returns them;
- ``{"round": "truth", "dtype": "bfloat16"}``: in place of each pass's
  maps, the scene's exact depth and normal rounded to ``dtype`` (a depth
  outside the range as none), as the pass's state files would hold them;
  for a one-round cell, whose passes all run at the images' size.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype).to(x.dtype)


@contextlib.contextmanager
def planted(spec: dict, truth=None):
    """While open, the program runs with ``spec``'s rounding planted (a
    ``run`` control plants nothing: its arguments go to ``run_scene``)."""
    kind = spec.get("round")
    if kind is None:
        yield
        return
    dtype = getattr(torch, spec["dtype"])
    if kind == "maps":
        from apdmvs_tpu_torch import pipeline as mod

        name, real = "patchmatch_pass", mod.patchmatch_pass

        def fake(*a, **kw):
            out = real(*a, **kw)
            return out._replace(depth=_rounded(out.depth, dtype),
                                normal_world=_rounded(out.normal_world, dtype))
    elif kind == "cloud":
        from apdmvs_tpu_torch import fusion as mod

        name, real = "fuse_eth", mod.fuse_eth

        def fake(*a, **kw):
            coords, colors = real(*a, **kw)
            return _rounded(torch.from_numpy(np.asarray(coords)), dtype).numpy(), colors
    elif kind == "truth":
        from apdmvs_tpu_torch import scene as mod

        name, real = "_persist", mod._persist

        def fake(problem, spec_, out, dmin, dmax, *a, **kw):
            i = int(problem.ref_image_id)
            d = torch.as_tensor(truth.depth[i], device=out.depth.device)
            d = torch.where((d >= dmin) & (d <= dmax), d, torch.zeros_like(d))
            n = torch.as_tensor(truth.normal[i], device=out.depth.device)
            out = out._replace(depth=_rounded(d, dtype), normal_world=_rounded(n, dtype))
            return real(problem, spec_, out, dmin, dmax, *a, **kw)
    else:
        raise ValueError(f"unknown control {spec!r}")
    setattr(mod, name, fake)
    try:
        yield
    finally:
        setattr(mod, name, real)
