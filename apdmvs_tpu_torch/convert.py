"""Carry state across from the reference package.

The system has no weights; what carries across is state. These functions
turn the reference package's ``Cameras``, ``PassState`` and ``VolumeSet``
(any object with the same field names whose leaves convert with
``numpy.asarray``) into the port's tensors, so both implementations can be
fed identical inputs. bf16 leaves (numpy's ``bfloat16`` extension dtype)
are carried bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from apdmvs_tpu_torch import geometry, ncc, pipeline


def tensor(a, device="cpu") -> torch.Tensor:
    """numpy-convertible array -> tensor of the same dtype (bf16 included)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def _opt(a, device):
    return None if a is None else tensor(a, device)


def to_cameras(src, device="cpu") -> geometry.Cameras:
    return geometry.Cameras(*(tensor(getattr(src, f), device).float()
                              for f in geometry.Cameras._fields))


def to_pass_state(src, device="cpu") -> pipeline.PassState:
    return pipeline.PassState(
        depth=tensor(src.depth, device).float(),
        normal_world=tensor(src.normal_world, device).float(),
        pixel_state=tensor(src.pixel_state, device).to(torch.uint8),
        selected=tensor(src.selected, device).to(torch.bool),
    )


def to_volume_set(src, device="cpu") -> ncc.VolumeSet:
    return ncc.VolumeSet(
        E=tensor(src.E, device),
        consts=tensor(src.consts, device),
        ref_pad=tensor(src.ref_pad, device),
        D=_opt(src.D, device),
        geom_consts=_opt(src.geom_consts, device),
        C36=_opt(getattr(src, "C36", None), device),
        C9=_opt(getattr(src, "C9", None), device),
        R=_opt(getattr(src, "R", None), device),
        base_k=_opt(getattr(src, "base_k", None), device),
    )
