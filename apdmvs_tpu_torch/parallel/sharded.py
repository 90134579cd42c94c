"""Batched pass bodies over N reference-view problems on a (view, space)
mesh of devices.

PyTorch counterpart of ``apdmvs_tpu/parallel/sharded.py:36-66,185-533``,
written in PyTorch's idiom rather than shard_map by shard_map:

- a :class:`Mesh` is a grid of ``torch.device`` s, [n_view][n_space]
  (:func:`make_mesh`); a device may repeat, which is how one card (or the
  CPU) holds a mesh of several shards. View rows may belong to several
  processes (``parallel/multihost.py``); the space axis stays inside a
  process.
- view axis: the padded problem list is cut into contiguous blocks, one
  per view row, as the JAX package's ``P("view")`` places it
  (:func:`problem_blocks`); a row runs its problems one after another on
  its first device, and padding problems are not run.
- space axis: each problem's volumes are built as row slabs, one on each
  device of its row (``ncc.build_volume_set_spaced``), every pass.

The bodies, each over the problems of one view row:

- :func:`_volume_batched_pass` (the volume path, ``sharded.py:185-306``): a
  Python loop over the problems, the counterpart of the reference's
  ``lax.scan``. Each problem's image-volume set comes from the row's
  ``prebuilt`` stack (the runner's once-per-scale cache, which may cover
  only the row's first M problems) or is built in the loop, so at most one
  transient set is live beside the pinned ones; every kernel runs
  unbatched, exactly as in the sequential runner. On a space mesh the same
  loop builds each problem's volumes as slabs over the row's devices
  (``sharded.py:313-358``); over several view rows that is the JAX
  package's composed body (``sharded.py:361-438``).
- :func:`_batched_pass` (the direct-warp path, ``sharded.py:94-123``): a
  loop over the problems, the counterpart of ``jax.vmap``. It builds no
  volume, so on a space mesh each problem runs whole on its row's first
  device (the JAX package's outputs do not depend on the sharding either).

On geometric passes problem i's source depths are ``all_depths[src_index[i]]``
from the full depth stack (the reference's all-gather over the view axis is
a ``.to(device)`` within a process and ``multihost.all_gather_rows``
across processes). Every problem draws from its own draw source
(``rng.py``), so a problem's pass equals the sequential runner's on the
same inputs, whatever the mesh.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from apdmvs_tpu_torch import ncc, pipeline
from apdmvs_tpu_torch.geometry import Cameras
from apdmvs_tpu_torch.params import PassConfig


class Mesh(NamedTuple):
    """A (view, space) grid of devices. ``devices[r]`` is view row r's
    devices (one per space shard), or None for a row of another process;
    ``owners[r]`` the rank of the process that runs row r; ``rank`` this
    process's."""

    devices: Tuple[Optional[Tuple[torch.device, ...]], ...]
    owners: Tuple[int, ...]
    n_space: int
    rank: int = 0

    @property
    def n_view(self) -> int:
        return len(self.devices)

    def local_rows(self) -> List[int]:
        return [r for r in range(self.n_view) if self.owners[r] == self.rank]

    def row_problems(self, r: int, num_problems: int) -> range:
        """The real problems of view row r (a contiguous block)."""
        _, per_row = problem_blocks(num_problems, self.n_view)
        return range(min(r * per_row, num_problems), min((r + 1) * per_row, num_problems))

    def local_problems(self, num_problems: int) -> List[int]:
        """The problems this process runs and persists, in order."""
        return [n for r in self.local_rows() for n in self.row_problems(r, num_problems)]

    def problem_counts(self, num_problems: int) -> List[int]:
        """The number of real problems of each process, in rank order."""
        ranks = max(self.owners) + 1
        return [sum(len(self.row_problems(r, num_problems)) for r in range(self.n_view)
                    if self.owners[r] == p) for p in range(ranks)]

    def problem_device(self, n: int, num_problems: int) -> torch.device:
        """The device problem n runs on: its row's first (space shard 0)."""
        _, per_row = problem_blocks(num_problems, self.n_view)
        return self.devices[n // per_row][0]

    def describe(self) -> str:
        return f"{self.n_view}x{self.n_space} mesh"


def default_devices(device, count: int) -> List[torch.device]:
    """``count`` devices for this process's shards, a device repeated only
    where no other card could take a shard:

    - the CPU, repeated;
    - a CUDA ``device`` with an index: that card, repeated;
    - in a run of several processes: this process's card (``device``, or
      the current card, which ``multihost.maybe_initialize`` sets),
      repeated. Each process takes one card, the rule of
      :func:`default_view_shards`;
    - in a run of one process: cuda:0 .. cuda:count-1 when the machine has
      at least ``count`` cards, cuda:0 repeated when it has one. With more
      than one card and fewer than ``count`` it raises ``ValueError``
      rather than pile the shards onto one card while the others sit
      idle: pass ``devices=`` to lay them out by hand."""
    from apdmvs_tpu_torch.parallel import multihost

    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev] * count
    if multihost.world_size() > 1:
        return [torch.device("cuda", torch.cuda.current_device())] * count
    cards = torch.cuda.device_count()
    if cards >= count:
        return [torch.device("cuda", i) for i in range(count)]
    if cards == 1:
        return [torch.device("cuda", 0)] * count
    raise ValueError(f"{count} shards but {cards} cards: the default mesh puts one shard on "
                     "each card; pass devices= (a list of count devices, which may repeat) "
                     "to place them yourself")


def make_mesh(n_view: int = 1, n_space: int = 1, devices=None, device="cuda") -> Mesh:
    """A (view, space) mesh over every process (``sharded.py:36-44``): view
    rows go to the processes in contiguous blocks of ``n_view /
    world_size`` rows, this process's laid out row-major over ``devices``
    (default :func:`default_devices` of ``device``; a device may repeat)."""
    from apdmvs_tpu_torch.parallel import multihost

    world, me = multihost.world_size(), multihost.rank()
    if n_view < 1 or n_space < 1:
        raise ValueError(f"mesh {n_view}x{n_space}: both axes need at least one shard")
    if n_view % world:
        raise ValueError(f"{n_view} view rows do not split over {world} processes")
    per_proc = n_view // world
    need = per_proc * n_space
    devs = default_devices(device, need) if devices is None else [torch.device(d)
                                                                   for d in devices]
    if len(devs) != need:
        raise ValueError(f"this process's {per_proc} view rows x {n_space} space shards "
                         f"need {need} devices, got {len(devs)}")
    owners = tuple(r // per_proc for r in range(n_view))
    grid = tuple(tuple(devs[(r - me * per_proc) * n_space:(r - me * per_proc + 1) * n_space])
                 if owners[r] == me else None for r in range(n_view))
    return Mesh(devices=grid, owners=owners, n_space=n_space, rank=me)


def default_view_shards(device, n_space: int, num_problems: int) -> int:
    """The view rows of a mesh when none are asked for
    (``apdmvs_tpu/scene.py:549-552``): the cards of all processes (one a
    process, or this process's cards when it runs alone; the CPU counts
    one) over ``n_space``, at most the problem count, a multiple of the
    process count."""
    from apdmvs_tpu_torch.parallel import multihost

    world = multihost.world_size()
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" and world == 1 else 1
    rows = min(num_problems, world * cards // n_space)
    return max(world, rows // world * world)


def problem_blocks(num_problems: int, n_view: int) -> Tuple[int, int]:
    """(padded count, problems per view row): the problem list padded to a
    multiple of ``n_view`` and cut into contiguous blocks, row r holding
    problems [r * per_row, (r + 1) * per_row), as ``P("view")`` places
    them."""
    padded, _ = shard_problems(num_problems, n_view)
    return padded, padded // n_view


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
                         prebuilt: Optional[ncc.VolumeSet] = None,
                         devices: Optional[Sequence[torch.device]] = None
                         ) -> pipeline.PassOutputs:
    """The volume path over one view row's N problems; geometric passes
    add depth volumes of ``all_depths[src_index[i]]``.

    With one device (``devices`` None or of one): problem i < M takes the
    pinned set ``prebuilt[i]``, the others build theirs in the loop (with
    C36 and C9 exactly when the pinned sets carry them, or when
    ``cfg.use_APD`` if nothing is pinned). With several ``devices``
    (``sharded.py:313-358``): each problem's volumes are row slabs over
    them, built every pass (``prebuilt`` is not read), with C36 and C9
    when ``cfg.use_APD``; the pass runs on ``devices[0]`` and evaluates
    slab by slab."""
    spaced = devices is not None and len(devices) > 1
    m_pre = 0 if prebuilt is None or spaced else prebuilt.E.shape[0]
    build_cv = cfg.use_APD if m_pre == 0 else prebuilt.C36 is not None
    outs = []
    for i in range(images.shape[0]):
        cams_i = problem_row(cams, i)
        dmin, dmax = cams_i.depth_min[0], cams_i.depth_max[0]
        depth_maps = _depth_maps(all_depths, src_index, i) if use_geom else None
        if spaced:
            vols = ncc.build_volume_set_spaced(images[i], cams_i, dmin, dmax, devices,
                                               num_slices=num_slices, depth_maps=depth_maps,
                                               weak_cost_volumes=build_cv)
        else:
            vols = (problem_row(prebuilt, i) if i < m_pre else
                    ncc.build_image_volume_set(images[i], cams_i, dmin, dmax,
                                               num_slices=num_slices,
                                               weak_cost_volumes=build_cv))
            if use_geom:
                vols = ncc.add_depth_volumes(vols, depth_maps, cams_i, dmin, dmax)
        outs.append(pipeline.patchmatch_pass(
            cams_i, src_valid[i], problem_row(prior, i), draws[i], cfg, vols,
            weak_capacity=weak_capacity, ransac_threshold=float(ransac_threshold[i])))
        del vols
    return _stack(outs)


def _batched_pass(images, cams: Cameras, src_valid, prior: pipeline.PassState,
                  draws: Sequence, ransac_threshold, all_depths, src_index, cfg: PassConfig,
                  weak_capacity: int, use_geom: bool) -> pipeline.PassOutputs:
    """The direct-warp path over one view row's problems (no volume)."""
    outs = [pipeline.patchmatch_pass(
        problem_row(cams, i), src_valid[i], problem_row(prior, i), draws[i], cfg,
        weak_capacity=weak_capacity, ransac_threshold=float(ransac_threshold[i]),
        images=images[i],
        depth_maps=_depth_maps(all_depths, src_index, i) if use_geom else None)
        for i in range(images.shape[0])]
    return _stack(outs)


def _rows_of(x, a: int, b: int, device):
    """Problems [a, b) of a tensor or a NamedTuple of [N, ...] fields, on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x[a:b].to(device)
    return type(x)(*(None if f is None else f[a:b].to(device) for f in x))


def sharded_batch_pass(images: torch.Tensor, cams: Cameras, src_valid: torch.Tensor,
                       prior: pipeline.PassState, draws: Sequence, ransac_threshold,
                       cfg: PassConfig, weak_capacity: int = 0,
                       all_depths: Optional[torch.Tensor] = None, src_index=None,
                       use_volumes: bool = False, num_slices: int = 160,
                       prebuilt: Optional[Sequence[Optional[ncc.VolumeSet]]] = None,
                       mesh: Optional[Mesh] = None,
                       num_problems: Optional[int] = None) -> pipeline.PassOutputs:
    """One pass for this process's problems of a batch of ``num_problems``
    reference views (default: all of them, ``images.shape[0]``) on
    ``mesh`` (default: one shard on the device of ``images``). The inputs
    (images [L, V, H, W]; cameras, src_valid and prior with a leading [L];
    one draw source, on its problem's device, and one ransac threshold per
    problem) hold ``mesh.local_problems(num_problems)`` in order; the
    stacked outputs [L, ...] come back on the device of ``images``.

    For geometric passes give ``all_depths`` [num_problems, H, W], the
    full stack, and ``src_index`` [L, V], mapping each problem's view slot
    to its row of ``all_depths`` (slot 0 and padding views: any row,
    src_valid masks them). The batched runner passes the previous pass's
    depth stack, so its geometric passes are Jacobi sweeps (the sequential
    runner reads sources already updated in the same pass).

    Routing (``sharded.py:441-533``), over every view row of this process:
    ``use_volumes`` takes :func:`_volume_batched_pass` over the row's
    devices, with one space shard with the row's entry of ``prebuilt`` (per
    view row, :func:`build_batch_image_volumes` on the row's device,
    possibly the row's first M problems only; None entries build every
    set), with several as row slabs (``prebuilt`` is not read); without
    volumes :func:`_batched_pass` on the row's first
    device, whatever ``n_space``."""
    home = images.device
    if mesh is None:
        mesh = make_mesh(1, 1, devices=[home])
    N = images.shape[0] if num_problems is None else num_problems
    if len(mesh.local_problems(N)) != images.shape[0]:
        raise ValueError(f"{images.shape[0]} problems given, this process runs "
                         f"{len(mesh.local_problems(N))} of {N} on {mesh.describe()}")
    use_geom = all_depths is not None
    outs, a = [], 0
    for r in mesh.local_rows():
        n = len(mesh.row_problems(r, N))
        if n == 0:
            continue
        devs = mesh.devices[r]
        dev = devs[0]
        b = a + n
        args = (_rows_of(images, a, b, dev), _rows_of(cams, a, b, dev),
                _rows_of(src_valid, a, b, dev), _rows_of(prior, a, b, dev), draws[a:b],
                ransac_threshold[a:b], all_depths.to(dev) if use_geom else None,
                src_index[a:b] if use_geom else None, cfg, weak_capacity, use_geom)
        if not use_volumes:
            out = _batched_pass(*args)
        else:
            out = _volume_batched_pass(*args, num_slices,
                                       None if prebuilt is None else prebuilt[r], devs)
        outs.append(_rows_of(out, 0, n, home))
        a = b
    return type(outs[0])(*(torch.cat(fs) for fs in zip(*outs)))
