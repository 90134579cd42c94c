"""Scene orchestrator: problem list, round scheduler, per-pass state, fusion.

PyTorch counterpart of the sequential runner of ``apdmvs_tpu/scene.py``
(reference main.cpp:140-233 ``main``, main.cpp:91-138 ``ProcessProblem``,
APD.cpp:399-583 ``InuputInitialization``): host Python that loads the
dataset contract, runs one PatchMatch pass per (view, pass) on the device,
and persists the inter-pass state files byte-compatibly with the reference
(``APD/<id>/depths.dmb|normals.dmb|weak.bin|selected_views.bin``), which
doubles as the checkpoint/resume contract. Freshly written state is also
kept in memory so geometric passes need no file round trip.

Entry point: :func:`run_scene` (``device="cuda"`` by default; with no card
it raises rather than falling back to the CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from apdmvs_tpu_torch import fusion as fusion_mod
from apdmvs_tpu_torch import debug, geometry, ncc, pipeline, rng
from apdmvs_tpu_torch.io import formats, images as imio, render
from apdmvs_tpu_torch.params import (
    MAX_IMAGES, PassConfig, PassSpec, PixelState, Problem, RunState, build_schedule,
    compute_round_num, scaled_size,
)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev


def generate_sample_list(dense_folder) -> List[Problem]:
    """Parse pair.txt into problems, dropping sources with score <= 0 and
    creating per-view result dirs (main.cpp:6-49)."""
    dense_folder = str(dense_folder)
    pairs = formats.read_pair_file(os.path.join(dense_folder, "pair.txt"))
    result_root = os.path.join(dense_folder, "APD")
    os.makedirs(result_root, exist_ok=True)
    problems: List[Problem] = []
    for index, (ref_id, srcs) in enumerate(pairs):
        src_ids = [sid for sid, score in srcs if score > 0.0][: MAX_IMAGES - 1]
        result_folder = os.path.join(result_root, formats.to_format_index(ref_id))
        os.makedirs(result_folder, exist_ok=True)
        problems.append(Problem(index=index, ref_image_id=ref_id, src_image_ids=src_ids,
                                dense_folder=dense_folder, result_folder=result_folder))
    return problems


def check_images(dense_folder, problems: Sequence[Problem]) -> Tuple[int, int]:
    """All reference images share one resolution; return (w, h)
    (main.cpp:51-70)."""
    from PIL import Image

    size: Optional[Tuple[int, int]] = None
    for p in problems:
        path = os.path.join(str(dense_folder), "images",
                            formats.to_format_index(p.ref_image_id) + ".jpg")
        with Image.open(path) as im:
            if size is None:
                size = im.size
            elif im.size != size:
                raise ValueError(f"image {p.ref_image_id} size {im.size} != {size}; "
                                 "all images must share one resolution")
    if size is None:
        raise ValueError(f"no problems in {dense_folder}")
    return size


def _bucket_capacity(count: int, total: int) -> int:
    """The weak worklist's capacity: the WEAK count rounded up to a {1, 1.5}
    x power-of-two bucket of at least 1024, at most ``total``, as the
    reference package sizes it (its RANSAC draws take the capacity's shape)."""
    if count <= 0:
        return 0
    cap = 1024
    while cap < count:
        if count <= cap + cap // 2:
            return min(cap + cap // 2, total)
        cap *= 2
    return min(cap, total)


#: device bytes a pass holds for its own work, per pixel of each view: an
#: upper bound of the eager working set (the two-round 1280x960x5 scene's
#: peak less its set and depth volumes, PERF.md); a compiled pass holds
#: as much again in its graph pool
PASS_BYTES_PER_PIXEL_VIEW = 1024
#: draw slot bytes of a compiled pass per pixel: the strong sweeps' ~576
#: and the weak draws of a worklist over about a quarter of the pixels
DRAW_BYTES_PER_PIXEL = 2048


def volume_cache_budget(device, num_views: int, height: int, width: int,
                        num_slices: int = 160, weak_cost_volumes: bool = True) -> float:
    """The default byte budget of the pinned image-volume sets at one scale
    on ``device``: its memory less what a pass there holds beside them.

    On a card the memory is ``torch.cuda.get_device_properties(device)
    .total_memory``, and a pass holds, beside the pinned sets: one more set
    (built in the loop when not every set is pinned), the depth volumes D
    twice (built view by view, then stacked), its working set
    (:data:`PASS_BYTES_PER_PIXEL_VIEW`); and for the compiled pass
    (``compiled.py``) its volume slots (a set and D), its graph pool (a
    working set again) and its draw slots (:data:`DRAW_BYTES_PER_PIXEL`).
    The processes of a run share the host's cards evenly (each takes one,
    ``parallel.default_devices``), so ceil(processes / cards) of them share
    this card: each takes that share of its memory and holds its own pass,
    graphs and slots beside its sets. On the CPU the memory is the host's
    physical memory, and the compiled pass's share is not held back (the
    CPU runs the body). Never below 0."""
    dev = torch.device(device)
    set_bytes = ncc.image_volume_set_nbytes(num_views, height, width, num_slices,
                                            weak_cost_volumes)
    Hp, Wp = ncc.padded_grid(height, width)
    d_bytes = (num_views - 1) * num_slices * Hp * Wp * 4
    work = PASS_BYTES_PER_PIXEL_VIEW * num_views * height * width
    reserve = set_bytes + 2 * d_bytes + work
    if dev.type == "cuda":
        from apdmvs_tpu_torch.parallel import multihost

        world = multihost.world_size()
        sharing = 1 if world == 1 else -(-world // torch.cuda.device_count())
        total = torch.cuda.get_device_properties(dev).total_memory / sharing
        reserve += set_bytes + d_bytes + work + DRAW_BYTES_PER_PIXEL * height * width
    else:
        total = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return float(max(0, total - reserve))


@dataclasses.dataclass(frozen=True)
class ProblemStats:
    """Per-(view, pass) wall-clock seconds (ending in a device sync), the
    WEAK share of this pass's classification (APD.cpp:538) and the number
    of WEAK pixels that entered the pass's weak machinery (0 without it)."""

    seconds: float
    weak_pct: float
    weak_in: int = 0


class SceneCache:
    """Host caches (grey images, cameras, resized stacks), the in-memory
    mirror of the per-pass state files, and the device-resident image
    volume sets, reused across a round's passes within a byte budget
    (first come, pinned; cleared when the scale changes).

    ``volume_cache_bytes`` None takes each scale's budget from
    :func:`volume_cache_budget` on the pass's device. ``expected_sets`` is
    the number of problems sharing a scale: caching is all-or-nothing per
    scale, so pinned sets never sit beside every uncached build."""

    def __init__(self, dense_folder: str, camera_model: str = "eth",
                 volume_cache_bytes: Optional[float] = None,
                 expected_sets: Optional[int] = None):
        self.dense_folder = dense_folder
        self.camera_model = camera_model
        self._gray: Dict[int, np.ndarray] = {}
        self._cam: Dict[int, dict] = {}
        self._scaled: Dict[Tuple[int, int], np.ndarray] = {}
        self.outputs: Dict[int, Dict[str, np.ndarray]] = {}
        self.volume_cache_bytes = (None if volume_cache_bytes is None
                                   else float(volume_cache_bytes))
        self._volumes: Dict[Tuple[int, int], ncc.VolumeSet] = {}
        self._volumes_width: Optional[int] = None
        self._volumes_bytes = 0
        self.expected_sets = expected_sets

    def image_volumes(self, image_id: int, width: int, builder,
                      budget: Optional[float] = None) -> ncc.VolumeSet:
        """The cached set of (image_id, width), or ``builder()``'s, pinned
        if it fits: within ``volume_cache_bytes`` when given, else within
        ``budget`` (the scale's default, :func:`volume_cache_budget`)."""
        if self._volumes_width != width:
            self._volumes.clear()
            self._volumes_bytes = 0
            self._volumes_width = width
        key = (image_id, width)
        vs = self._volumes.get(key)
        if vs is not None:
            return vs
        vs = builder()
        cap = self.volume_cache_bytes if self.volume_cache_bytes is not None else budget
        if cap is None:
            raise ValueError("no volume cache budget: give volume_cache_bytes or budget")
        nbytes = sum(t.numel() * t.element_size() for t in vs if isinstance(t, torch.Tensor))
        fits_scale = self.expected_sets is None or self.expected_sets * nbytes <= cap
        if fits_scale and self._volumes_bytes + nbytes <= cap:
            self._volumes[key] = vs
            self._volumes_bytes += nbytes
        return vs

    def gray(self, image_id: int) -> np.ndarray:
        if image_id not in self._gray:
            path = os.path.join(self.dense_folder, "images",
                                formats.to_format_index(image_id) + ".jpg")
            self._gray[image_id] = imio.load_gray_f32(path)
        return self._gray[image_id]

    def camera(self, image_id: int) -> dict:
        if image_id not in self._cam:
            path = os.path.join(self.dense_folder, "cams",
                                formats.to_format_index(image_id) + "_cam.txt")
            reader = formats.read_camera_dtu if self.camera_model == "dtu" else formats.read_camera
            self._cam[image_id] = reader(path)
        return self._cam[image_id]

    def gray_scaled(self, image_id: int, new_w: int, new_h: int) -> np.ndarray:
        key = (image_id, new_w)
        if key not in self._scaled:
            self._scaled[key] = imio.resize_bilinear(
                self.gray(image_id), new_w, new_h).astype(np.float32)
        return self._scaled[key]


def _load_prior(cache: SceneCache, problem: Problem, num_views: int, W: int, H: int,
                device, missing_ok: bool = False) -> Optional[pipeline.PassState]:
    """The previous pass's outputs for this view (memory first, then disk),
    rescaled to this pass's size (APD.cpp:552-581). Missing state under a
    non-FIRST pass raises unless ``missing_ok`` (APD.cpp:514-518)."""
    out = cache.outputs.get(problem.ref_image_id)
    if out is None:
        depth_path = os.path.join(problem.result_folder, "depths.dmb")
        if not os.path.exists(depth_path):
            if missing_ok:
                return None
            raise FileNotFoundError(
                f"prior state missing for view {problem.ref_image_id:08d} ({depth_path}): "
                "a non-FIRST_INIT pass requires the previous pass's outputs "
                "(pass allow_missing_prior=True to re-initialise instead)"
            )
        rf = problem.result_folder
        out = {
            "depth": formats.read_bin_mat(depth_path),
            "normal": formats.read_bin_mat(os.path.join(rf, "normals.dmb")),
            "weak": formats.read_bin_mat(os.path.join(rf, "weak.bin")),
            "selected": formats.read_bin_mat(os.path.join(rf, "selected_views.bin")),
        }
        cache.outputs[problem.ref_image_id] = out
    sel = pipeline.bitmask_to_selected(imio.resize_nearest(out["selected"], W, H), num_views)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return pipeline.PassState(
        depth=dev(imio.resize_nearest(out["depth"], W, H), torch.float32),
        normal_world=dev(imio.resize_nearest(out["normal"], W, H), torch.float32),
        pixel_state=dev(imio.resize_nearest(out["weak"], W, H), torch.uint8),
        selected=dev(sel, torch.bool),
    )


def _load_src_depths(cache: SceneCache, problem: Problem, view_ids: Sequence[int],
                     W: int, H: int) -> np.ndarray:
    """Current depth estimates of the source views at this pass's size
    (APD.cpp:492-510); entry 0 (the ref view) stays zero."""
    depths = np.zeros((len(view_ids), H, W), np.float32)
    for v, vid in enumerate(view_ids):
        if v == 0:
            continue
        out = cache.outputs.get(vid)
        if out is None:
            path = os.path.join(cache.dense_folder, "APD", formats.to_format_index(vid),
                                "depths.dmb")
            if not os.path.exists(path):
                continue
            d = formats.read_bin_mat(path)
        else:
            d = out["depth"]
        depths[v] = imio.resize_nearest(d, W, H)
    return depths


class ProblemInputs(NamedTuple):
    """One problem's pass inputs at a scale, on the host: images [V, H, W]
    (zero for padding views), K (scaled), R, t [V, ...] (padding views take
    the reference camera), src_valid [V] and the depth range."""

    images: np.ndarray
    K: np.ndarray
    R: np.ndarray
    t: np.ndarray
    src_valid: np.ndarray
    dmin: float
    dmax: float


def _problem_inputs(cache: SceneCache, problem: Problem, W: int, H: int,
                    full_size: Tuple[int, int], V: int) -> ProblemInputs:
    full_w, full_h = full_size
    view_ids = [problem.ref_image_id] + list(problem.src_image_ids)
    V_real = len(view_ids)
    imgs = np.zeros((V, H, W), np.float32)
    for v, vid in enumerate(view_ids):
        imgs[v] = cache.gray_scaled(vid, W, H)
    src_valid = np.zeros(V, bool)
    src_valid[1:V_real] = True
    cams_np = [cache.camera(vid) for vid in view_ids]
    cams_np += [cams_np[0]] * (V - V_real)  # padding views: ref camera, invalid
    K = geometry.scale_intrinsics(
        np.stack([c["K"] for c in cams_np]).astype(np.float32), W / float(full_w), H / float(full_h)
    )
    ref_cam = cache.camera(problem.ref_image_id)
    # depth range: ref view's range x 0.6 / 1.2 (APD.cpp:454-455)
    return ProblemInputs(
        images=imgs, K=K, R=np.stack([c["R"] for c in cams_np]),
        t=np.stack([c["t"] for c in cams_np]), src_valid=src_valid,
        dmin=float(ref_cam["depth_min"]) * 0.6, dmax=float(ref_cam["depth_max"]) * 1.2,
    )


def _cameras(inp: ProblemInputs, device) -> geometry.Cameras:
    V = inp.K.shape[0]
    return geometry.make_cameras(inp.K, inp.R, inp.t, np.full(V, inp.dmin, np.float32),
                                 np.full(V, inp.dmax, np.float32), device=device)


def _empty_prior(V: int, H: int, W: int, device, lead: Tuple[int, ...] = ()):
    """The FIRST_INIT prior: zero depth and normals, all STRONG, no view."""
    return pipeline.PassState(
        depth=torch.zeros(lead + (H, W), device=device),
        normal_world=torch.zeros(lead + (H, W, 3), device=device),
        pixel_state=torch.full(lead + (H, W), int(PixelState.STRONG), dtype=torch.uint8,
                               device=device),
        selected=torch.zeros(lead + (V, H, W), dtype=torch.bool, device=device),
    )


def _persist(problem: Problem, spec: PassSpec, out, dmin: float, dmax: float,
             show_medium_result: bool) -> Dict[str, np.ndarray]:
    """Write one problem's four state files (main.cpp:117-124) and, with
    ``show_medium_result``, its JPEGs (main.cpp:127-134); returns the host
    arrays as the in-memory mirror keeps them."""
    depth = out.depth.cpu().numpy().astype(np.float32)
    normal = out.normal_world.cpu().numpy().astype(np.float32)
    weak = out.pixel_state.cpu().numpy().astype(np.uint8)
    selected = pipeline.selected_to_bitmask(out.selected.cpu().numpy())
    rf = problem.result_folder
    formats.write_bin_mat(os.path.join(rf, "depths.dmb"), depth)
    formats.write_bin_mat(os.path.join(rf, "normals.dmb"), normal)
    formats.write_bin_mat(os.path.join(rf, "weak.bin"), weak)
    formats.write_bin_mat(os.path.join(rf, "selected_views.bin"), selected)
    if show_medium_result:
        tag = f"{spec.pass_index}"
        imio.save_image_u8(os.path.join(rf, f"depth_{tag}.jpg"),
                           render.render_depth(depth, dmin, dmax))
        imio.save_image_u8(os.path.join(rf, f"normal_{tag}.jpg"), render.render_normal(normal))
        imio.save_image_u8(os.path.join(rf, f"weak_{tag}.jpg"), render.render_weak(weak))
    return {"depth": depth, "normal": normal, "weak": weak, "selected": selected}


def process_problem(
    cache: SceneCache,
    problem: Problem,
    spec: PassSpec,
    full_size: Tuple[int, int],
    seed: int,
    device,
    num_views_pad: Optional[int] = None,
    show_medium_result: bool = False,
    num_slices: int = 160,
    allow_missing_prior: bool = False,
    use_volumes: bool = True,
    debug_dumps: bool = False,
    eager: bool = False,
) -> ProblemStats:
    """One (view, pass): the reference's ProcessProblem (main.cpp:91-138).
    Loads inputs, runs the pass on ``device``, clamps out-of-range depths
    and persists the four state files. ``use_volumes`` False runs the
    direct-warp path: no volume is built, and geometric passes read the
    source views' depth maps. ``debug_dumps`` also writes the pass's debug
    probes (``debug.dump_probes``: the DEBUG_NEIGHBOUR and DEBUG_COST_LINE
    files) into the view's result folder, from the outputs before
    clamping (``apdmvs_tpu/scene.py:440-446``). The pass is the compiled
    ``pipeline.patchmatch_pass``; ``eager`` runs its body,
    ``pipeline.patchmatch_pass_impl``, whose stage spans a profiler
    records (a replay records none)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    # the cached image volumes serve all of this (problem, scale)'s passes, so
    # they follow the round's APD mode, not this pass's after a downgrade below
    round_use_apd = spec.use_APD
    W, H = scaled_size(*full_size, spec.scale_size)
    view_ids = [problem.ref_image_id] + list(problem.src_image_ids)
    V_real = len(view_ids)
    V = num_views_pad or V_real
    inp = _problem_inputs(cache, problem, W, H, full_size, V)
    dmin, dmax = inp.dmin, inp.dmax
    cams = _cameras(inp, device)

    prior = None
    if spec.state != RunState.FIRST_INIT:
        prior = _load_prior(cache, problem, V, W, H, device, missing_ok=allow_missing_prior)
    if prior is None:
        prior = _empty_prior(V, H, W, device)
        spec = dataclasses.replace(spec, state=RunState.FIRST_INIT, use_APD=False,
                                   geom_consistency=False)
    weak_in = weak_capacity = 0
    if spec.use_APD:
        weak_in = int(torch.sum(prior.pixel_state == PixelState.WEAK))
        weak_capacity = _bucket_capacity(weak_in, H * W)
        if weak_capacity == 0:
            spec = dataclasses.replace(spec, use_APD=False)

    images = torch.as_tensor(inp.images, device=device)
    volumes = depth_maps = None
    if use_volumes:
        volumes = cache.image_volumes(
            problem.ref_image_id, W,
            builder=lambda: ncc.build_image_volume_set(
                images, cams, dmin, dmax, num_slices=num_slices,
                weak_cost_volumes=round_use_apd),
            budget=volume_cache_budget(device, V, H, W, num_slices, round_use_apd),
        )
    if spec.geom_consistency:
        dm = _load_src_depths(cache, problem, view_ids, W, H)
        if dm[1:V_real].any():
            dm = np.concatenate([dm, np.zeros((V - V_real, H, W), np.float32)])
            depth_maps = torch.as_tensor(dm, device=device)
            if use_volumes:
                volumes = ncc.add_depth_volumes(volumes, depth_maps, cams, dmin, dmax)
        else:
            spec = dataclasses.replace(spec, geom_consistency=False)

    draws = rng.TorchDraws(rng.pass_seed(seed, spec.pass_index, problem.index), H, W, device)
    run_pass = pipeline.patchmatch_pass_impl if eager else pipeline.patchmatch_pass
    out = run_pass(
        cams, torch.as_tensor(inp.src_valid, device=device), prior, draws,
        PassConfig.from_spec(spec), volumes, weak_capacity=weak_capacity,
        ransac_threshold=spec.ransac_threshold, images=images, depth_maps=depth_maps,
        debug=debug_dumps,
    )
    if debug_dumps:
        out, probes = out
        debug.dump_probes(problem.result_folder, probes, H, W)
    out = pipeline.clamp_outputs(out, dmin, dmax)
    saved = _persist(problem, spec, out, dmin, dmax, show_medium_result)
    cache.outputs[problem.ref_image_id] = saved
    weak_pct = 100.0 * float(np.mean(saved["weak"] == PixelState.WEAK))
    return ProblemStats(seconds=time.perf_counter() - t0, weak_pct=weak_pct, weak_in=weak_in)


def _load_fusion_views(dense_folder: str, problems: Sequence[Problem]):
    """Per-view fusion inputs from the persisted pass outputs
    (APD.cpp:826-900)."""
    id_to_pos = {p.ref_image_id: i for i, p in enumerate(problems)}
    views: List[fusion_mod.FusionView] = []
    for p in problems:
        cam = formats.read_camera(os.path.join(
            dense_folder, "cams", formats.to_format_index(p.ref_image_id) + "_cam.txt"))
        depth = formats.read_bin_mat(os.path.join(p.result_folder, "depths.dmb"))
        normal = formats.read_bin_mat(os.path.join(p.result_folder, "normals.dmb"))
        weak = formats.read_bin_mat(os.path.join(p.result_folder, "weak.bin"))
        H, W = depth.shape
        bgr = imio.load_bgr_u8(os.path.join(
            dense_folder, "images", formats.to_format_index(p.ref_image_id) + ".jpg"))
        K = cam["K"]
        if bgr.shape[:2] != (H, W):  # rescale colour + K to depth size (APD.cpp:729-750)
            K = geometry.scale_intrinsics(K, W / bgr.shape[1], H / bgr.shape[0])
            bgr = imio.resize_bilinear(bgr.astype(np.float32), W, H).astype(np.uint8)
        block = None
        block_path = os.path.join(dense_folder, "blocks", f"mask_{p.ref_image_id}.jpg")
        if os.path.exists(block_path):  # optional ROI masks (APD.cpp:848-852)
            block = imio.resize_nearest(imio.load_gray_f32(block_path).astype(np.uint8), W, H)
        views.append(fusion_mod.FusionView(
            K=np.asarray(K, np.float64), R=np.asarray(cam["R"], np.float64),
            t=np.asarray(cam["t"], np.float64), image_bgr=bgr, depth=depth,
            normal=normal, weak=weak, block=block,
        ))
    src_ids = [[id_to_pos[s] for s in p.src_image_ids if s in id_to_pos] for p in problems]
    return views, src_ids


FUSION_VARIANTS = ("eth", "eth-device", "tat_intermediate", "tat_advanced")


def run_fusion(dense_folder, problems: Sequence[Problem], variant: str = "eth",
               out_name: str = "APD.ply", device="cuda") -> str:
    """Fuse all per-view outputs into ``APD/<out_name>`` (reference
    RunFusion: APD.cpp:826-977, called at main.cpp:219; the Tanks&Temples
    variants APD.cpp:979-1296). ``eth`` and the ``tat_*`` variants run on
    the host; ``eth-device`` runs the ETH algorithm on ``device``
    (``fusion_device.py``) and never falls back to the host."""
    dense_folder = str(dense_folder)
    if variant not in FUSION_VARIANTS:
        raise ValueError(f"unknown fusion variant {variant!r}")
    views, src_ids = _load_fusion_views(dense_folder, problems)
    if variant == "eth":
        coords, colors = fusion_mod.fuse_eth(views, src_ids)
    elif variant == "eth-device":
        from apdmvs_tpu_torch import fusion_device

        coords, colors = fusion_device.fuse_eth_device(views, src_ids, device=device)
    else:
        coords, colors = fusion_mod.fuse_tat(views, src_ids,
                                             advanced=variant == "tat_advanced")
    out_path = os.path.join(dense_folder, "APD", out_name)
    formats.export_point_cloud(out_path, coords, colors)
    return out_path


class SceneRun(NamedTuple):
    """What :func:`run_scene` did: the fused cloud's path and, per
    (pass, view) in schedule order, its stats."""

    ply: str
    passes: List[Tuple[PassSpec, Problem, ProblemStats]]


def run_scene(
    dense_folder,
    seed: int = 0,
    device="cuda",
    fusion_variant: str = "eth",
    show_medium_result: bool = False,
    keep_intermediates: bool = True,
    max_rounds: Optional[int] = None,
    min_rounds: Optional[int] = None,
    camera_model: str = "eth",
    allow_missing_prior: bool = False,
    volume_cache_gb: Optional[float] = None,
    verbose: bool = True,
    num_slices: int = 160,
    use_volumes: bool = True,
    debug_dumps: bool = False,
    profile_dir: Optional[str] = None,
) -> SceneRun:
    """Full reconstruction (main.cpp:140-233): round scheduler -> one pass
    per (view, pass) on ``device`` -> fusion (``fusion_variant``, one of
    :data:`FUSION_VARIANTS`; ``eth-device`` fuses on ``device``) ->
    APD/APD.ply.

    Images over 1000 px run more than one round; every round after the
    first runs the APD weak machinery. ``min_rounds`` forces extra rounds
    below that trigger (main.cpp:72-88), ``max_rounds`` caps them.

    Views run one after another, and a geometric pass reads the source
    views' depths as they stand, some already updated in the same pass
    (Gauss-Seidel, as the reference package's sequential runner; the
    batched runner, :func:`run_scene_batched`, reads the previous pass's).
    ``use_volumes`` False takes the direct-warp path (``--no-volumes``);
    volumes stay on by default on every device, the CPU included, where
    the reference package turns them off.

    Each pass is the compiled ``pipeline.patchmatch_pass`` (a CUDA graph
    per static key on a card). The image-volume sets of a scale are pinned
    within ``volume_cache_gb`` when given, else within the scale's
    :func:`volume_cache_budget` on ``device``; the cache changes when sets
    are built, never the results.

    ``debug_dumps`` writes every pass's debug probes into its view's result
    folder (:func:`process_problem`). ``profile_dir`` records the passes
    (not the fusion) under ``torch.profiler``, the CPU's activity and, on a
    card, the card's, and writes one Chrome trace to
    ``profile_dir/trace.json``, which ``python -m apdmvs_tpu_torch.timeline``
    reads; the passes then run ``pipeline.patchmatch_pass_impl``, the
    body, so that the trace holds its stage spans. A large run makes a
    large file: 1.94 GB for a two-round
    640x480x5 run (40 view-passes, 105 s traced, the export included) on
    an NVIDIA H100. If the profiler cannot start, the run fails."""
    device = resolve_device(device)
    if fusion_variant not in FUSION_VARIANTS:
        raise ValueError(f"unknown fusion variant {fusion_variant!r}")
    dense_folder = str(dense_folder)
    problems = generate_sample_list(dense_folder)
    if verbose:
        print(f"There are {len(problems)} problems needed to be processed!")
    full_size = check_images(dense_folder, problems)
    round_num = compute_round_num(*full_size)
    if min_rounds is not None:
        round_num = max(round_num, min_rounds)
    if max_rounds is not None:
        round_num = min(round_num, max_rounds)
    if verbose:
        print(f"Round num: {round_num}")
    cache = SceneCache(dense_folder, camera_model=camera_model,
                       volume_cache_bytes=None if volume_cache_gb is None
                       else volume_cache_gb * 1e9, expected_sets=len(problems))
    V_pad = max(1 + len(p.src_image_ids) for p in problems)
    passes = []
    profiler = _profiler(device) if profile_dir else contextlib.nullcontext()
    with profiler:
        for spec in build_schedule(round_num):
            for problem in problems:
                stats = process_problem(
                    cache, problem, spec, full_size, seed, device, num_views_pad=V_pad,
                    show_medium_result=show_medium_result, num_slices=num_slices,
                    allow_missing_prior=allow_missing_prior, use_volumes=use_volumes,
                    debug_dumps=debug_dumps, eager=profile_dir is not None,
                )
                passes.append((spec, problem, stats))
                if verbose:
                    print(f"round {spec.round_index} pass {spec.pass_index} "
                          f"view {problem.ref_image_id:08d} ({spec.state.name}, "
                          f"scale 1/{spec.scale_size}): {stats.seconds * 1000:.0f} ms, "
                          f"weak {stats.weak_pct:.1f}%, weak in {stats.weak_in}")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        trace = os.path.join(str(profile_dir), "trace.json")
        profiler.export_chrome_trace(trace)
        if verbose:
            print(f"Profiler trace: {trace}")
    ply = run_fusion(dense_folder, problems, variant=fusion_variant, device=device)
    if verbose:
        print(f"Fused point cloud: {ply}")
    if not keep_intermediates:  # the reference deletes per-view dirs (main.cpp:220-230)
        for p in problems:
            shutil.rmtree(p.result_folder, ignore_errors=True)
    return SceneRun(ply=ply, passes=passes)


def _profiler(device: torch.device) -> torch.profiler.profile:
    """A profiler of the CPU's activity and, for a CUDA ``device``, the
    card's (kernels, copies), without shapes."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False)


def _resample_nearest(state: pipeline.PassState, H: int, W: int) -> pipeline.PassState:
    """Nearest-neighbour resample of a batched state [N, ...] to (H, W) on
    its device, by the static index maps of ``imio.resize_nearest``
    (APD.cpp:552-581)."""
    ph, pw = state.depth.shape[1:3]
    if (ph, pw) == (H, W):
        return state
    dev = state.depth.device
    ys = torch.as_tensor(np.minimum((np.arange(H) * (ph / H)).astype(np.int64), ph - 1),
                         device=dev)
    xs = torch.as_tensor(np.minimum((np.arange(W) * (pw / W)).astype(np.int64), pw - 1),
                         device=dev)

    def rz(a, axis):  # the (y, x) axes are (axis, axis + 1)
        return a.index_select(axis, ys).index_select(axis + 1, xs)

    return pipeline.PassState(depth=rz(state.depth, 1), normal_world=rz(state.normal_world, 1),
                              pixel_state=rz(state.pixel_state, 1), selected=rz(state.selected, 2))


def run_scene_batched(
    dense_folder,
    seed: int = 0,
    device="cuda",
    fusion_variant: str = "eth",
    keep_intermediates: bool = True,
    max_rounds: Optional[int] = None,
    min_rounds: Optional[int] = None,
    n_view_shards: Optional[int] = None,
    n_space_shards: int = 1,
    camera_model: str = "eth",
    show_medium_result: bool = False,
    verbose: bool = True,
    use_volumes: bool = True,
    num_slices: int = 160,
    volume_cache_gb: Optional[float] = None,
    devices=None,
) -> SceneRun:
    """Batched reconstruction (``apdmvs_tpu/scene.py:485-890``): every
    reference view of a pass runs as one batch on a (view, space) mesh
    (``parallel.make_mesh(n_view_shards, n_space_shards, devices, device)``;
    ``n_view_shards`` None: the cards of all processes over
    ``n_space_shards``, at most the problem count), through
    ``parallel.sharded_batch_pass``; the state stays on the device between
    passes and is persisted per pass (the checkpoint contract of
    :func:`run_scene`, with the same JPEGs). Returns a :class:`SceneRun`
    whose per-view stats, of this process's problems, carry the batch's
    wall divided over its views.

    Per pass: stacked inputs [L, V, H, W] of this process's L problems
    (padding views take the reference camera and are invalid); the prior
    resampled on the device between scales; the batch's largest WEAK count
    sizes one worklist capacity for all problems of every process (a
    problem without weak pixels runs the weak branch on an all-padding
    worklist) and "any depth > 0" over every process gates geometry, both
    agreed through ``parallel.multihost``, since the capacity sizes the
    RANSAC draws; problem i draws from ``rng.pass_seed(seed, pass, i)`` on
    its row's device, as the sequential runner does, so a FIRST_INIT pass
    equals its on any mesh. A geometric pass reads the previous pass's
    depth stack of every process (Jacobi; the sequential runner is
    Gauss-Seidel, both the reference package's own semantics). Image
    volumes (``use_volumes``, on by default on every device) are pinned
    once per scale within ``volume_cache_gb`` a device (None: the scale's
    :func:`volume_cache_budget` on each device), per problem: each
    view row's first M sets that fit, one set held back for the loop's own
    build when not all do; the rest are rebuilt every pass. A space mesh
    pins nothing: its slabs are built every pass. Each process persists
    its own problems' files; after a barrier, process 0 alone fuses.

    A schedule whose first pass is not FIRST_INIT raises (the reference
    package re-initialises there silently)."""
    from apdmvs_tpu_torch import compiled, parallel
    from apdmvs_tpu_torch.parallel import multihost

    device = resolve_device(device)
    if fusion_variant not in FUSION_VARIANTS:
        raise ValueError(f"unknown fusion variant {fusion_variant!r}")
    dense_folder = str(dense_folder)
    problems = generate_sample_list(dense_folder)
    lead = multihost.rank() == 0
    report, verbose = verbose, verbose and lead
    if verbose:
        print(f"There are {len(problems)} problems needed to be processed!")
    full_size = check_images(dense_folder, problems)
    round_num = compute_round_num(*full_size)
    if min_rounds is not None:
        round_num = max(round_num, min_rounds)
    if max_rounds is not None:
        round_num = min(round_num, max_rounds)
    if verbose:
        print(f"Round num: {round_num}")
    cache = SceneCache(dense_folder, camera_model=camera_model)
    N = len(problems)
    if n_view_shards is None:
        n_view_shards = parallel.default_view_shards(device, n_space_shards, N)
    mesh = parallel.make_mesh(n_view_shards, n_space_shards, devices=devices, device=device)
    for r in mesh.local_rows():
        for d in mesh.devices[r]:
            resolve_device(d)
    local = mesh.local_problems(N)
    counts = mesh.problem_counts(N)
    if 0 in counts:
        raise ValueError(f"{N} problems on a {mesh.describe()} leave process "
                         f"{counts.index(0)} without a problem; ask for fewer view shards")
    home = mesh.devices[mesh.local_rows()[0]][0]
    mesh_note = (f"{mesh.describe()} on " + ", ".join(
        str(d) for r in mesh.local_rows() for d in mesh.devices[r])
        + (f", {multihost.world_size()} processes" if multihost.world_size() > 1 else ""))
    V = max(1 + len(p.src_image_ids) for p in problems)
    id_to_pos = {p.ref_image_id: i for i, p in enumerate(problems)}
    src_index = np.array([[id_to_pos.get(vid, n) for vid in [problems[n].ref_image_id]
                           + problems[n].src_image_ids]
                          + [n] * (V - 1 - len(problems[n].src_image_ids))
                          for n in local], np.int64)
    state: Optional[pipeline.PassState] = None
    vol_cache: Dict[Tuple[int, int], Optional[list]] = {}
    captures0, replays0 = len(compiled.captures), sum(compiled.replays.values())
    passes = []
    for spec in build_schedule(round_num):
        t0 = time.perf_counter()
        W, H = scaled_size(*full_size, spec.scale_size)
        inps = [_problem_inputs(cache, problems[n], W, H, full_size, V) for n in local]
        L = len(inps)
        images = torch.as_tensor(np.stack([i.images for i in inps]), device=home)
        dmins = np.array([i.dmin for i in inps], np.float32)
        dmaxs = np.array([i.dmax for i in inps], np.float32)
        cams = geometry.make_cameras(
            np.stack([i.K for i in inps]), np.stack([i.R for i in inps]),
            np.stack([i.t for i in inps]), np.repeat(dmins[:, None], V, 1),
            np.repeat(dmaxs[:, None], V, 1), device=home)
        src_valid = torch.as_tensor(np.stack([i.src_valid for i in inps]), device=home)

        if state is None:
            if spec.state != RunState.FIRST_INIT:
                raise ValueError(f"the batched runner's first pass must be FIRST_INIT, not "
                                 f"{spec.state.name}: there is no prior state to refine")
            prior = _empty_prior(V, H, W, home, lead=(L,))
        else:
            prior = _resample_nearest(state, H, W)

        eff = spec
        weak_capacity = 0
        weak_counts = np.zeros(L, np.int64)
        if eff.use_APD:
            weak_counts = torch.sum(prior.pixel_state == PixelState.WEAK, dim=(1, 2)).cpu().numpy()
            weak_capacity = _bucket_capacity(multihost.all_reduce_max(int(weak_counts.max())),
                                             H * W)
            if weak_capacity == 0:
                eff = dataclasses.replace(eff, use_APD=False)
        all_depths = None
        if eff.geom_consistency:
            if multihost.any_positive(prior.depth):
                all_depths = multihost.all_gather_rows(prior.depth, counts)
            else:
                eff = dataclasses.replace(eff, geom_consistency=False)
        draws = [rng.TorchDraws(rng.pass_seed(seed, spec.pass_index, problems[n].index), H, W,
                                mesh.problem_device(n, N)) for n in local]

        prebuilt = None
        if use_volumes and mesh.n_space == 1:
            if (W, H) not in vol_cache:
                vol_cache.clear()  # the schedule never revisits a finished scale
                vol_cache[(W, H)] = _pin_row_sets(mesh, N, images, cams, V, H, W, num_slices,
                                                  spec.use_APD, volume_cache_gb, verbose)
            prebuilt = vol_cache[(W, H)]

        out = parallel.sharded_batch_pass(
            images, cams, src_valid, prior, draws, np.full(L, eff.ransac_threshold),
            PassConfig.from_spec(eff), weak_capacity=weak_capacity, all_depths=all_depths,
            src_index=src_index if all_depths is not None else None, use_volumes=use_volumes,
            num_slices=num_slices, prebuilt=prebuilt, mesh=mesh, num_problems=N)
        dmin_t = torch.as_tensor(dmins, device=home)[:, None, None]
        dmax_t = torch.as_tensor(dmaxs, device=home)[:, None, None]
        bad = (out.depth < dmin_t) | (out.depth > dmax_t)
        state = pipeline.PassState(
            depth=torch.where(bad, 0.0, out.depth), normal_world=out.normal_world,
            pixel_state=torch.where(bad, torch.full_like(out.pixel_state,
                                                         int(PixelState.UNKNOWN)),
                                    out.pixel_state),
            selected=out.selected)
        weak_pcts = []
        for k, n in enumerate(local):
            saved = _persist(problems[n], spec, parallel.problem_row(state, k), float(dmins[k]),
                             float(dmaxs[k]), show_medium_result)
            weak_pcts.append(100.0 * float(np.mean(saved["weak"] == PixelState.WEAK)))
        seconds = time.perf_counter() - t0
        for k, n in enumerate(local):
            passes.append((spec, problems[n], ProblemStats(
                seconds=seconds / L, weak_pct=weak_pcts[k], weak_in=int(weak_counts[k]))))
        if verbose:
            print(f"round {spec.round_index} pass {spec.pass_index} ({eff.state.name}, scale "
                  f"1/{spec.scale_size}, {N} views batched over {mesh_note}): "
                  f"{seconds * 1000:.0f} ms, weak {float(np.mean(weak_pcts)):.1f}%")
    who = (f"process {multihost.rank()} of {multihost.world_size()}: "
           if multihost.world_size() > 1 else "")
    if report and who:
        print(who + "persisted views " + " ".join(str(problems[n].ref_image_id) for n in local),
              flush=True)
    if report and home.type == "cuda":
        print(f"{who}compiled pass: {len(compiled.captures) - captures0} keys captured, "
              f"{sum(compiled.replays.values()) - replays0} replays", flush=True)
    # every process's state files are on disk before fusion reads them
    multihost.barrier()
    ply = os.path.join(dense_folder, "APD", "APD.ply")
    if lead:
        ply = run_fusion(dense_folder, problems, variant=fusion_variant, device=home)
        if verbose:
            print(f"Fused point cloud: {ply}")
        if not keep_intermediates:
            for p in problems:
                shutil.rmtree(p.result_folder, ignore_errors=True)
    return SceneRun(ply=ply, passes=passes)


def _pin_row_sets(mesh, N: int, images, cams, V: int, H: int, W: int, num_slices: int,
                  weak_cost_volumes: bool, volume_cache_gb: Optional[float], verbose: bool):
    """The once-per-scale pinned image-volume sets of each of this
    process's view rows (``parallel.build_batch_image_volumes`` on the
    row's device), each row's first M problems that fit the row's share of
    ``volume_cache_gb`` (None: :func:`volume_cache_budget` of the row's
    device; rows sharing a device split its budget). Returns the per-row
    list ``sharded_batch_pass`` takes (None: nothing pinned)."""
    from apdmvs_tpu_torch import parallel

    per_set = ncc.image_volume_set_nbytes(V, H, W, num_slices,
                                          weak_cost_volumes=weak_cost_volumes)
    rows = mesh.local_rows()
    sharing = {}
    for r in rows:
        sharing[mesh.devices[r][0]] = sharing.get(mesh.devices[r][0], 0) + 1
    pinned: list = [None] * mesh.n_view
    total_m, a = 0, 0
    for r in rows:
        n = len(mesh.row_problems(r, N))
        dev = mesh.devices[r][0]
        budget = (volume_cache_budget(dev, V, H, W, num_slices, weak_cost_volumes)
                  if volume_cache_gb is None else volume_cache_gb * 1e9)
        M = parallel.pinned_count(per_set, n, budget / sharing[dev])
        if M:
            pinned[r] = parallel.build_batch_image_volumes(
                images[a:a + M].to(dev), geometry.Cameras(*(f[a:a + M].to(dev) for f in cams)),
                num_slices, weak_cost_volumes=weak_cost_volumes)
        total_m += M
        a += n
    if verbose:
        print(f"volume cache: pinning {total_m}/{a} problems' image-volume sets "
              f"({per_set / 1e9:.2f} GB each, budget {budget / 1e9:.2f} GB a device"
              + (")" if volume_cache_gb is not None else ", derived from its memory)")
              + ("" if total_m == a else "; the rest rebuild every pass"))
    return pinned


def run_fusion_device_sharded(dense_folder, problems: Sequence[Problem], mesh=None,
                              device="cuda", out_name: str = "APD_device.ply") -> str:
    """The ETH fusion on the card with each view's pixel work and the
    consumed masks row-sharded over the mesh's devices
    (``fusion_device.fuse_eth_device``'s mesh mode; ``apdmvs_tpu/scene.py:
    971-1000``). Collective: with several processes every process calls it;
    process 0 writes ``APD/<out_name>``, every process returns its path.
    ``mesh`` None takes one view row over this process's cards
    (``parallel.make_mesh(world_size, cards)``)."""
    from apdmvs_tpu_torch import fusion_device, parallel
    from apdmvs_tpu_torch.parallel import multihost

    dense_folder = str(dense_folder)
    if mesh is None:
        dev = resolve_device(device)
        cards = (torch.cuda.device_count() if dev.type == "cuda" and multihost.world_size() == 1
                 else 1)
        mesh = parallel.make_mesh(multihost.world_size(), cards, device=dev)
    views, src_ids = _load_fusion_views(dense_folder, problems)
    coords, colors = fusion_device.fuse_eth_device(views, src_ids, mesh=mesh)
    out_path = os.path.join(dense_folder, "APD", out_name)
    if multihost.rank() == 0:
        formats.export_point_cloud(out_path, coords, colors)
    return out_path
