"""Batched pass bodies over N reference-view problems on one card.

PyTorch counterpart of the one-card part of ``apdmvs_tpu/parallel/sharded.py``
(a mesh of one view shard and one space shard):

- :func:`_volume_batched_pass` (the volume path, ``sharded.py:185-306``): a
  Python loop over the problems, the counterpart of the reference's
  ``lax.scan``. Each problem's image-volume set comes from ``prebuilt``
  (the runner's once-per-scale stacked cache, which may cover only the
  first M problems) or is built in the loop, so at most one transient set
  is live beside the pinned ones; every kernel runs unbatched, exactly as
  in the sequential runner.
- :func:`_batched_pass` (the direct-warp path, ``sharded.py:94-123``): a
  loop over the problems, the counterpart of ``jax.vmap``.

On geometric passes problem i's source depths are ``all_depths[src_index[i]]``
(the reference's all-gather over the view axis is an index on one card).
Every problem draws from its own draw source (``rng.py``), so a problem's
pass equals the sequential runner's on the same inputs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from apdmvs_tpu_torch import ncc, pipeline
from apdmvs_tpu_torch.geometry import Cameras
from apdmvs_tpu_torch.params import PassConfig

_MULTI_GPU = ("more than one view or space shard is multi-GPU work (ROADMAP queue 1 "
              "item 5); the port runs one card")


def shard_problems(num_problems: int, n_shards: int) -> Tuple[int, np.ndarray]:
    """Pad the problem count to a multiple of the view-shard count and
    return (padded_n, owner shard per problem)."""
    padded = ((num_problems + n_shards - 1) // n_shards) * n_shards
    return padded, np.arange(padded) % n_shards


def pinned_count(set_bytes: int, n: int, budget_bytes: float) -> int:
    """How many of n problems' image-volume sets a byte budget pins: all
    that fit, less one held back for the set built in the loop when not all
    fit (the reference's per-problem policy, apdmvs_tpu/scene.py:741-805)."""
    m = int(budget_bytes // set_bytes)
    if m < n:
        m = max(0, m - 1)
    return min(m, n)


def problem_row(x, i: int):
    """Problem i of a batched NamedTuple (fields [N, ...])."""
    return type(x)(*(None if f is None else f[i] for f in x))


def _stack(rows):
    """Stack per-problem NamedTuples into one with [N, ...] fields."""
    return type(rows[0])(*(torch.stack(fs) for fs in zip(*rows)))


def build_batch_image_volumes(images: torch.Tensor, cams: Cameras, num_slices: int,
                              weak_cost_volumes: bool = True) -> ncc.VolumeSet:
    """Stacked image-volume sets [M, ...] of M problems (images [M, V, H,
    W], cameras with [M, V, ...] fields): built one problem at a time and
    copied into the stacked tensors, so the build holds M sets and one
    transient set at most (``sharded.py:131-178``)."""
    stacked = None
    for i in range(images.shape[0]):
        cams_i = problem_row(cams, i)
        vs = ncc.build_image_volume_set(images[i], cams_i, cams_i.depth_min[0],
                                        cams_i.depth_max[0], num_slices=num_slices,
                                        weak_cost_volumes=weak_cost_volumes)
        if stacked is None:
            stacked = type(vs)(*(None if f is None else
                                 f.new_empty((images.shape[0],) + tuple(f.shape))
                                 for f in vs))
        for dst, src in zip(stacked, vs):
            if src is not None:
                dst[i] = src
        del vs
    return stacked


def _depth_maps(all_depths, src_index, i: int) -> torch.Tensor:
    return all_depths[torch.as_tensor(src_index[i], dtype=torch.int64,
                                      device=all_depths.device)]


def _volume_batched_pass(images, cams: Cameras, src_valid, prior: pipeline.PassState,
                         draws: Sequence, ransac_threshold, all_depths, src_index,
                         cfg: PassConfig, weak_capacity: int, use_geom: bool, num_slices: int,
                         prebuilt: Optional[ncc.VolumeSet] = None) -> pipeline.PassOutputs:
    """The volume path over N problems: problem i < M takes the pinned set
    ``prebuilt[i]``, the others build theirs in the loop (with C36 and C9
    exactly when the pinned sets carry them, or when ``cfg.use_APD`` if
    nothing is pinned); geometric passes attach depth volumes of
    ``all_depths[src_index[i]]``."""
    m_pre = 0 if prebuilt is None else prebuilt.E.shape[0]
    build_cv = cfg.use_APD if prebuilt is None else prebuilt.C36 is not None
    outs = []
    for i in range(images.shape[0]):
        cams_i = problem_row(cams, i)
        dmin, dmax = cams_i.depth_min[0], cams_i.depth_max[0]
        if i < m_pre:
            vols = problem_row(prebuilt, i)
        else:
            vols = ncc.build_image_volume_set(images[i], cams_i, dmin, dmax,
                                              num_slices=num_slices,
                                              weak_cost_volumes=build_cv)
        if use_geom:
            vols = ncc.add_depth_volumes(vols, _depth_maps(all_depths, src_index, i), cams_i,
                                         dmin, dmax)
        outs.append(pipeline.patchmatch_pass(
            cams_i, src_valid[i], problem_row(prior, i), draws[i], cfg, vols,
            weak_capacity=weak_capacity, ransac_threshold=float(ransac_threshold[i])))
        del vols
    return _stack(outs)


def _batched_pass(images, cams: Cameras, src_valid, prior: pipeline.PassState,
                  draws: Sequence, ransac_threshold, all_depths, src_index, cfg: PassConfig,
                  weak_capacity: int, use_geom: bool) -> pipeline.PassOutputs:
    """The direct-warp path over N problems (no volume is built)."""
    outs = [pipeline.patchmatch_pass(
        problem_row(cams, i), src_valid[i], problem_row(prior, i), draws[i], cfg,
        weak_capacity=weak_capacity, ransac_threshold=float(ransac_threshold[i]),
        images=images[i],
        depth_maps=_depth_maps(all_depths, src_index, i) if use_geom else None)
        for i in range(images.shape[0])]
    return _stack(outs)


def sharded_batch_pass(images: torch.Tensor, cams: Cameras, src_valid: torch.Tensor,
                       prior: pipeline.PassState, draws: Sequence, ransac_threshold,
                       cfg: PassConfig, weak_capacity: int = 0,
                       all_depths: Optional[torch.Tensor] = None, src_index=None,
                       use_volumes: bool = False, num_slices: int = 160,
                       prebuilt: Optional[ncc.VolumeSet] = None, n_view_shards: int = 1,
                       n_space_shards: int = 1) -> pipeline.PassOutputs:
    """One pass for a batch of N reference views on one card (images
    [N, V, H, W], cameras, src_valid and prior with a leading [N]; one draw
    source and one ransac threshold per problem). Returns the stacked
    outputs [N, ...].

    For geometric passes give ``all_depths`` [P, H, W] and ``src_index``
    [N, V], mapping each problem's view slot to its row of ``all_depths``
    (slot 0 and padding views: any row, src_valid masks them). The batched
    runner passes the previous pass's depth stack, so its geometric passes
    are Jacobi sweeps (the sequential runner reads sources already updated
    in the same pass). ``use_volumes`` takes :func:`_volume_batched_pass`
    with ``prebuilt`` (:func:`build_batch_image_volumes`, possibly the first
    M problems only), else :func:`_batched_pass`."""
    if n_view_shards != 1 or n_space_shards != 1:
        raise NotImplementedError(_MULTI_GPU)
    use_geom = all_depths is not None
    if use_volumes:
        return _volume_batched_pass(images, cams, src_valid, prior, draws, ransac_threshold,
                                    all_depths, src_index, cfg, weak_capacity, use_geom,
                                    num_slices, prebuilt)
    return _batched_pass(images, cams, src_valid, prior, draws, ransac_threshold, all_depths,
                         src_index, cfg, weak_capacity, use_geom)
