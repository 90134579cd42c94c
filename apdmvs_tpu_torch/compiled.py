"""The compiled pass: ``pipeline.patchmatch_pass`` on a card, the body
(``pipeline.patchmatch_pass_impl``) captured once per static key as a CUDA
graph and replayed.

The counterpart of the JAX package's ``patchmatch_pass = jax.jit(
patchmatch_pass_impl, static_argnames=("cfg", "weak_capacity", "debug"))``
(``apdmvs_tpu/pipeline.py:219-224``): XLA compiles the pass into one program
per static key; here the key's program is a CUDA graph, whose replay
launches every kernel and operator of the pass with no Python between
them.

- **Static key** (:func:`static_key`): the device, (H, W, V), the path
  (the volume set's shapes, K and the padded grid, and which of D, C36 and
  C9 it carries; a spaced set's slab count S, slab height Hs, padded grid
  (Hp, Wp) and each slab's shapes and volumes, the counterpart of the JAX
  package's jitted pass over row slabs, ``apdmvs_tpu/parallel/sharded.py:
  309-438``; or the direct-warp path and whether it reads depth maps),
  ``cfg``, ``weak_capacity`` and ``debug``: the JAX package's static
  arguments plus the shapes it traces. A spaced set is captured when
  every slab lies on the pass's device; slabs on several devices raise,
  since one graph holds the work of one device.
- **Slots.** A value that can differ between two calls of one key is
  never a captured constant: every input is a slot, a tensor at a fixed
  address that the graph reads, filled before each replay. The slots are
  the cameras, ``src_valid``, the prior, ``ransac_threshold`` (0-d), the
  volume set's tensors, or each slab's (a cached set or slabs built
  outside the graph are copied in, device to device), the
  direct-warp path's images and depth maps, and the draws
  (``rng.DrawPlan``). The keys of a device share slots by (role, shape,
  dtype): replays run one at a time on one stream, and each fills all of
  its slots before it launches. A slot is not copied again from the tensor
  it was last filled from while that tensor is unchanged (the same object
  at the same version).
- **Memory.** Every graph of a device captures into one pool
  (``torch.cuda.graph_pool_handle()``), so the keys' working sets share
  memory. When a call's (H, W) differs from the last call's on its device,
  the device's graphs and slots are dropped, as the scene's volume cache
  is at a new scale (``scene.SceneCache``).
- **A miss** runs the body once on the caller's inputs and draws
  (recording the draw plan, whose answers fill the draw slots), captures
  the body on the slots on the device's capture stream, instantiates the
  graph and replays it.
  The replay must equal that warm-up bit for bit in every output, or the
  capture raises with its key. **A hit** fills the slots, asks the caller's
  draw source the plan's requests in order, replays, and returns clones of
  the outputs.
- **Launch counters** (``ops.launch_counters``): the wrappers count in
  Python, so a replay would count nothing. The counts the body adds while
  it is captured are taken back (a capture launches nothing), kept as the
  key's launches, and added at every replay.
- **Processes.** Each process of a ``torch.distributed`` run captures and
  replays on its own device. The pass holds no collective (the batched
  runner's exchanges sit between passes), and the capture runs in
  ``"thread_local"`` mode, so another thread's CUDA call does not end it.
- **No fallback.** A failed capture or replay raises with its key, and
  nothing runs the body eagerly in its place. The spans of
  ``pipeline._span`` do not replay, so the profiler runs and the stage
  timing call ``pipeline.patchmatch_pass_impl`` by name.
"""

from __future__ import annotations

import ctypes
import time
import weakref
from typing import Dict, Optional

import torch

from apdmvs_tpu_torch import ncc, ops, pipeline, rng
from apdmvs_tpu_torch.geometry import Cameras
from apdmvs_tpu_torch.parallel.spaced import SpacedVolumeSet


def static_key(cams: Cameras, prior: pipeline.PassState, cfg, volumes, weak_capacity: int,
               debug: bool) -> tuple:
    """The pass's static key (see the module docstring). A spaced volume
    set whose slabs lie on another device than the pass's raises: one CUDA
    graph holds the work of one device (ROADMAP queue 1 item 4)."""
    H, W = prior.depth.shape
    if volumes is None:
        path = ("direct", bool(cfg.geom_consistency))
    elif volumes.spaced:
        devices = set(volumes.devices)
        if devices != {cams.device}:
            raise ValueError(
                f"a pass over slabs on {sorted(str(d) for d in devices)} from "
                f"{cams.device} is not captured: one CUDA graph holds the work of one "
                "device (ROADMAP queue 1 item 4); call pipeline.patchmatch_pass_impl for it")
        path = ("spaced", volumes.S, volumes.Hs, volumes.Hp, volumes.Wp,
                tuple(_set_path(slab) for slab in volumes.slabs))
    else:
        path = ("volumes",) + _set_path(volumes)
    return (cams.device, H, W, cams.K.shape[0], path, cfg, int(weak_capacity), bool(debug))


def _set_path(vs: ncc.VolumeSet) -> tuple:
    """A volume set's part of the key: the shapes of E and the padded
    reference, and which of D, C36 and C9 it carries."""
    return (tuple(vs.E.shape), tuple(vs.ref_pad.shape), vs.D is not None, vs.C36 is not None,
            vs.C9 is not None)


def _layout(key) -> Optional[tuple]:
    """(S, Hs, Hp, Wp) of a key's spaced set, else None."""
    path = key[4]
    return path[1:5] if path[0] == "spaced" else None


def _arguments(cams, src_valid, prior, volumes, ransac_threshold, images, depth_maps,
               cfg) -> Dict[str, object]:
    """The pass's per-call inputs by role, on the pass's device: what
    becomes a slot. The path's unread inputs are left out."""
    dev = cams.device
    args = {f"cams.{f}": getattr(cams, f) for f in Cameras._fields}
    args["src_valid"] = torch.as_tensor(src_valid, dtype=torch.bool, device=dev)
    args.update({f"prior.{f}": getattr(prior, f) for f in pipeline.PassState._fields})
    args["ransac_threshold"] = ransac_threshold
    if volumes is not None:
        sets = ([(f"volumes.slabs.{s}.", slab) for s, slab in enumerate(volumes.slabs)]
                if volumes.spaced else [("volumes.", volumes)])
        for prefix, vs in sets:
            args.update({prefix + f: getattr(vs, f) for f in ncc.VolumeSet._fields
                         if getattr(vs, f) is not None})
    else:
        if images is None:
            raise ValueError("a pass without volumes needs the images (the direct-warp path)")
        args["images"] = torch.as_tensor(images, dtype=torch.float32, device=dev)
        if cfg.geom_consistency:
            if depth_maps is None:
                raise ValueError("a geometric pass without volumes needs the source depth maps")
            args["depth_maps"] = torch.as_tensor(depth_maps, dtype=torch.float32, device=dev)
    return args


def _body(args, draws, cfg, weak_capacity: int, debug: bool, layout: Optional[tuple] = None):
    """``pipeline.patchmatch_pass_impl`` on ``args`` (:func:`_arguments`'
    roles, or their slots); ``layout`` is (S, Hs, Hp, Wp) of a spaced set
    (:func:`_layout` of the key)."""
    def volume_set(prefix):
        return ncc.VolumeSet(**{f: args.get(prefix + f) for f in ncc.VolumeSet._fields})

    volumes = None
    if layout is not None:
        S, Hs, Hp, Wp = layout
        volumes = SpacedVolumeSet(slabs=tuple(volume_set(f"volumes.slabs.{s}.")
                                              for s in range(S)), Hs=Hs, Hp=Hp, Wp=Wp)
    elif "volumes.E" in args:
        volumes = volume_set("volumes.")
    return pipeline.patchmatch_pass_impl(
        Cameras(*(args[f"cams.{f}"] for f in Cameras._fields)), args["src_valid"],
        pipeline.PassState(*(args[f"prior.{f}"] for f in pipeline.PassState._fields)), draws,
        cfg, volumes, weak_capacity, args["ransac_threshold"], args.get("images"),
        args.get("depth_maps"), debug)


def _outputs(out) -> list:
    """The output tensors of a pass, in order (``None`` probes left out)."""
    outs, probes = (out if isinstance(out, tuple) and len(out) == 2
                    and isinstance(out[1], pipeline.DebugProbes) else (out, None))
    return list(outs) + ([] if probes is None else [t for t in probes if t is not None])


def _clone(out):
    """The pass's outputs as fresh tensors (the graph's are overwritten by
    its next replay)."""
    if isinstance(out, pipeline.PassOutputs):
        return pipeline.PassOutputs(*(t.clone() for t in out))
    outs, probes = out
    return _clone(outs), pipeline.DebugProbes(*(None if t is None else t.clone()
                                                for t in probes))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(bits), b.view(bits)
    return bool(torch.equal(a, b))


def _graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a kept graph (the CUDA driver's cuGraphGetNodes)."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return int(n.value)


class Entry:
    """One key's graph: its input slots by role, its draw plan, its static
    outputs and the launches one replay makes, with its capture figures
    (warm-up, capture and instantiate ms on the host clock, graph nodes)
    and CUDA events around the last slot fill."""

    def __init__(self, graph, slots, plan, outputs, launches, nodes, warmup_ms, capture_ms,
                 instantiate_ms):
        self.graph, self.slots, self.plan, self.outputs = graph, slots, plan, outputs
        self.launches, self.nodes = launches, nodes
        self.warmup_ms, self.capture_ms, self.instantiate_ms = (warmup_ms, capture_ms,
                                                                instantiate_ms)
        self.fill_events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def fill_ms(self) -> float:
        """Device ms of the last call's slot fill (the input copies and the
        draws); synchronises on it."""
        self.fill_events[1].synchronize()
        return self.fill_events[0].elapsed_time(self.fill_events[1])


class _DeviceGraphs:
    """A device's graphs by key, their shared pool and slots, and the
    scale (H, W) they were captured at."""

    def __init__(self):
        self.pool = self.stream = None  # the pool and capture stream, at the first capture
        self.scale = None
        self.entries: Dict[tuple, Entry] = {}
        self.slots: Dict[tuple, torch.Tensor] = {}
        self.sources: Dict[int, tuple] = {}  # id(slot) -> (weakref to its source, version)

    def slot(self, role, like: torch.Tensor, device) -> torch.Tensor:
        k = (role, tuple(like.shape), like.dtype)
        if k not in self.slots:
            self.slots[k] = torch.empty(like.shape, dtype=like.dtype, device=device)
        return self.slots[k]

    def input_slots(self, args, device) -> Dict[str, torch.Tensor]:
        """A slot for each of the pass's inputs (:func:`_arguments`), filled
        from them; ``ransac_threshold`` takes a 0-d float32 slot."""
        slots = {role: self.slot(role, torch.as_tensor(v, dtype=torch.float32)
                                 if role == "ransac_threshold" else v, device)
                 for role, v in args.items()}
        for role, slot in slots.items():
            self.fill(slot, args[role])
        return slots

    def fill(self, slot: torch.Tensor, src) -> None:
        if not isinstance(src, torch.Tensor):
            slot.fill_(float(src))
            self.sources.pop(id(slot), None)
            return
        last = self.sources.get(id(slot))
        if last is not None and last[0]() is src and last[1] == src._version:
            return
        slot.copy_(src)
        self.sources[id(slot)] = (weakref.ref(src), src._version)


_DEVICES: Dict[torch.device, _DeviceGraphs] = {}
#: every capture of this process, in order: (key, warm-up ms, capture ms,
#: instantiate ms, graph nodes)
captures: list = []
#: the replays of a hit on each device over this process
replays: Dict[torch.device, int] = {}


def _device_graphs(device: torch.device, scale) -> _DeviceGraphs:
    st = _DEVICES.get(device)
    if st is None:
        st = _DEVICES[device] = _DeviceGraphs()
    if st.scale != scale:
        if st.entries or st.slots:
            drop(device)
            st = _DEVICES[device] = _DeviceGraphs()
        st.scale = scale
    return st


def drop(device=None) -> None:
    """Drop the graphs and slots of ``device`` (all devices: None) and
    return their memory to the card."""
    for dev in [torch.device(device)] if device is not None else list(_DEVICES):
        if _DEVICES.pop(dev, None) is not None:
            torch.cuda.empty_cache()


def entries(device) -> Dict[tuple, Entry]:
    """The keys of ``device`` and their graphs."""
    st = _DEVICES.get(torch.device(device))
    return {} if st is None else dict(st.entries)


def slot_bytes(device) -> int:
    """Device bytes of ``device``'s slots (inputs and draws)."""
    st = _DEVICES.get(torch.device(device))
    return 0 if st is None else sum(t.numel() * t.element_size() for t in st.slots.values())


def _launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in ops.launch_counters().items()}


def _add_launches(launches: Dict[str, int]) -> None:
    for name, fn in ops.launch_counters().items():
        fn.launches += launches[name]


def _fill(st: _DeviceGraphs, entry: Entry, args, draws) -> None:
    entry.fill_events[0].record()
    for role, slot in entry.slots.items():
        st.fill(slot, args[role])
    entry.plan.fill(draws)
    entry.fill_events[1].record()


def _capture(st: _DeviceGraphs, key, args, draws, cfg, weak_capacity: int, debug: bool):
    """The miss of the module docstring; returns the new entry and the
    replay's outputs."""
    dev = key[0]
    t0 = time.perf_counter()
    plan, recorder = rng.DrawPlan.record(draws, dev)
    layout = _layout(key)
    eager = _body(args, recorder, cfg, weak_capacity, debug, layout)
    torch.cuda.synchronize(dev)
    warmup_ms = 1e3 * (time.perf_counter() - t0)
    try:
        # the draw slots of the plan, shared by (request, occurrence, part)
        seen: Dict[str, int] = {}
        for i, ((name, _), answer) in enumerate(zip(plan.requests, plan.slots)):
            n = seen[name] = seen.get(name, -1) + 1
            parts = answer if isinstance(answer, tuple) else (answer,)
            shared = tuple(st.slot(("draw", name, n, j), a, dev) for j, a in enumerate(parts))
            for s, a in zip(shared, parts):
                s.copy_(a)
            plan.slots[i] = shared if isinstance(answer, tuple) else shared[0]
        slots = st.input_slots(args, dev)
        if st.pool is None:
            st.pool = torch.cuda.graph_pool_handle()
            st.stream = torch.cuda.Stream(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = _launch_counts()
        t1 = time.perf_counter()
        # captured on the device's one capture stream, as torch.cuda.graph
        # captures (the pool's blocks belong to the stream they were made
        # on, so one stream lets every key reuse them), without its
        # gc.collect() and empty_cache(), which cost more than they free.
        # "thread_local": a CUDA call of another thread (NCCL's watchdog
        # queries its events) does not invalidate this thread's capture
        side = st.stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            graph.capture_begin(pool=st.pool, capture_error_mode="thread_local")
            try:
                outputs = _body(slots, plan.reader(), cfg, weak_capacity, debug, layout)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        t2 = time.perf_counter()
        after = _launch_counts()
        for name, fn in ops.launch_counters().items():
            fn.launches = before[name]  # a capture launches nothing
        graph.instantiate()
        t3 = time.perf_counter()
        entry = Entry(graph, slots, plan, outputs,
                      {name: after[name] - before[name] for name in after},
                      _graph_nodes(graph), warmup_ms, 1e3 * (t2 - t1), 1e3 * (t3 - t2))
        graph.replay()
    except Exception as e:
        raise RuntimeError(f"capture of the pass failed for key {key}: {e}") from e
    _add_launches(entry.launches)
    differ = [i for i, (a, b) in enumerate(zip(_outputs(eager), _outputs(outputs)))
              if not _same_bits(a, b)]
    if differ:
        raise RuntimeError(f"the captured pass for key {key} differs from its warm-up in "
                           f"outputs {differ} (of {len(_outputs(eager))})")
    st.entries[key] = entry
    captures.append((key, warmup_ms, entry.capture_ms, entry.instantiate_ms, entry.nodes))
    return entry, _clone(outputs)


def run(cams: Cameras, src_valid, prior: pipeline.PassState, draws, cfg, volumes=None,
        weak_capacity: int = 0, ransac_threshold=0.005, images: Optional[torch.Tensor] = None,
        depth_maps: Optional[torch.Tensor] = None, debug: bool = False):
    """``pipeline.patchmatch_pass`` on a card: the key's graph replayed on
    this call's inputs and draws, captured first on a miss."""
    key = static_key(cams, prior, cfg, volumes, weak_capacity, debug)
    dev = key[0]
    args = _arguments(cams, src_valid, prior, volumes, ransac_threshold, images, depth_maps,
                      cfg)
    with torch.cuda.device(dev):
        st = _device_graphs(dev, key[1:3])
        entry = st.entries.get(key)
        if entry is None:
            return _capture(st, key, args, draws, cfg, weak_capacity, debug)[1]
        _fill(st, entry, args, draws)
        try:
            entry.graph.replay()
        except Exception as e:
            raise RuntimeError(f"replay of the pass failed for key {key}: {e}") from e
        _add_launches(entry.launches)
        replays[dev] = replays.get(dev, 0) + 1
        return _clone(entry.outputs)
