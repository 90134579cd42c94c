"""Several processes over ``torch.distributed``.

PyTorch counterpart of ``apdmvs_tpu/parallel/multihost.py:1-137``. The JAX
package starts ``jax.distributed`` and lets XLA place its collectives on a
global mesh; here one process group carries the few exchanges the batched
runner makes between passes, each an explicit call below:

- :func:`maybe_initialize` starts the group from explicit arguments, else
  from ``APD_COORDINATOR`` / ``APD_NUM_PROCESSES`` / ``APD_PROCESS_ID``,
  else does nothing (one process);
- :func:`addressable_problems`: the problem rows this process persists;
- :func:`all_gather_rows`: every process's rows into the full stack (the
  depth exchange of geometric passes, and ``fetch_rows``' purpose);
- :func:`all_reduce_max`, :func:`any_positive`, :func:`all_reduce_min_`:
  small reductions whose values drive host decisions (the worklist
  capacity, which sizes the RANSAC draws, and the geometry gate) or the
  device fusion's first-raster-pixel rule, so every process takes the
  same branch;
- :func:`barrier` before fusion;
- :func:`host_threads`: the host threads a process takes for its own
  work (the ETH fusion core).

In one process every helper is the identity. The backend is ``nccl`` on
cards and ``gloo`` on the CPU; ``gloo`` on cards (several processes
sharing one card, which NCCL refuses) stages every tensor through the host
(``.cpu()`` -> collective -> ``.to(device)``). ``nccl`` with two ranks on
one card raises; no backend is switched for the caller.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch

_STATE = {"backend": None, "device": None}


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def host_threads() -> int:
    """This process's share of the host threads it may run on: its CPU
    affinity over the processes of the group, at least 1."""
    return max(1, len(os.sched_getaffinity(0)) // world_size())


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


def maybe_initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     device="cuda") -> bool:
    """Start the process group if several processes are asked for
    (``multihost.py:43-77``): explicit arguments first, then the
    ``APD_COORDINATOR`` (``host:port``), ``APD_NUM_PROCESSES`` and
    ``APD_PROCESS_ID`` variables. Returns True iff running several
    processes. ``backend`` None takes ``nccl`` for a CUDA ``device`` and
    ``gloo`` for the CPU; collectives run on ``device`` (nccl) or on the
    host (gloo)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    coord = coordinator or os.environ.get("APD_COORDINATOR")
    nproc = num_processes if num_processes is not None else _env_int("APD_NUM_PROCESSES")
    pid = process_id if process_id is not None else _env_int("APD_PROCESS_ID")
    if coord is None:
        if (nproc or 1) > 1:
            raise ValueError("several processes need a coordinator address (--coordinator "
                             "or APD_COORDINATOR)")
        return False
    if nproc is None or pid is None:
        raise ValueError("a coordinator needs the process count and this process's id "
                         "(--num-processes/--process-id or APD_NUM_PROCESSES/APD_PROCESS_ID)")
    if not 0 <= pid < nproc:
        raise ValueError(f"process id {pid} outside [0, {nproc})")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("nccl needs a CUDA device")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if "OMP_NUM_THREADS" not in os.environ:
        # as torchrun does: the processes share the host's cores, and more
        # CPU threads than cores can stall OpenMP's waiting threads
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nproc))
    host, port = coord.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), nproc, is_master=pid == 0)
    if backend == "nccl":
        _refuse_shared_cards(store, pid, nproc, device)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=pid, world_size=nproc)
    _STATE.update(backend=backend, device=device)
    return nproc > 1


def _refuse_shared_cards(store, pid: int, nproc: int, device: torch.device) -> None:
    """Raise if two ranks would run NCCL on one card (NCCL refuses it)."""
    props = torch.cuda.get_device_properties(device)
    card = str(getattr(props, "uuid", f"{socket.gethostname()}:{device.index}"))
    store.set(f"apd_card_{pid}", card)
    cards = [store.get(f"apd_card_{r}").decode() for r in range(nproc)]
    if len(set(cards)) < nproc:
        raise RuntimeError(
            f"nccl cannot run two ranks on one card (cards by rank: {cards}); give each "
            "process its own card, or ask for gloo (--dist-backend gloo)")


def _stage(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend's collectives read it: the host for gloo,
    the process's card for nccl."""
    if _STATE["backend"] == "nccl":
        return t.to(_STATE["device"]).contiguous()
    return t.cpu().contiguous()


def addressable_problems(mesh, n_padded: int) -> np.ndarray:
    """Indices of the padded problem rows whose view row this process owns
    (``multihost.py:80-95``): the rows it persists, so each state file is
    written by exactly one process. ``mesh.local_problems`` of the padded
    count (padding rows included)."""
    return np.array(mesh.local_problems(n_padded), np.int64)


def all_gather_rows(local_rows: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
    """The full stack [sum(counts), ...] on every process, from each
    process's rows [counts[rank], ...] (rank order; every process's rows are
    a contiguous block of problems). One process: ``local_rows`` itself."""
    import torch.distributed as dist

    if world_size() == 1:
        return local_rows
    if local_rows.shape[0] != counts[rank()]:
        raise ValueError(f"{local_rows.shape[0]} local rows, expected {counts[rank()]}")
    width = max(counts)
    pad = local_rows.new_zeros((width - local_rows.shape[0],) + tuple(local_rows.shape[1:]))
    mine = _stage(torch.cat([local_rows, pad]))
    parts = [torch.empty_like(mine) for _ in counts]
    dist.all_gather(parts, mine)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).to(local_rows.device)


def _reduce(t: torch.Tensor, op) -> torch.Tensor:
    import torch.distributed as dist

    staged = _stage(t)
    dist.all_reduce(staged, op=op)
    return staged.to(t.device)


def all_reduce_max(value: int) -> int:
    """The maximum of an integer over the processes (the batch's WEAK
    count, which sets the worklist capacity)."""
    if world_size() == 1:
        return int(value)
    import torch.distributed as dist

    return int(_reduce(torch.tensor([int(value)], dtype=torch.int64), dist.ReduceOp.MAX)[0])


def any_positive(t: Optional[torch.Tensor]) -> bool:
    """Whether any entry of ``t`` (None: none) on any process is > 0 (the
    geometry gate of a geometric pass)."""
    local = 0 if t is None or t.numel() == 0 else int(bool((t > 0).any()))
    return all_reduce_max(local) > 0


def all_reduce_min_(t: torch.Tensor) -> torch.Tensor:
    """The elementwise minimum of ``t`` over the processes, in place."""
    if world_size() == 1:
        return t
    import torch.distributed as dist

    t.copy_(_reduce(t, dist.ReduceOp.MIN))
    return t


def all_reduce_or_(t: torch.Tensor) -> torch.Tensor:
    """The elementwise OR of a bool tensor over the processes, in place."""
    if world_size() == 1:
        return t
    import torch.distributed as dist

    t.copy_(_reduce(t.to(torch.uint8), dist.ReduceOp.MAX).bool())
    return t


def all_gather_objects(obj) -> list:
    """Every process's ``obj`` in rank order (one process: ``[obj]``)."""
    if world_size() == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    """Wait for every process (before fusion reads the state files)."""
    if world_size() > 1:
        import torch.distributed as dist

        dist.barrier()


def shutdown() -> None:
    """End the process group, if one was started."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(backend=None, device=None)
