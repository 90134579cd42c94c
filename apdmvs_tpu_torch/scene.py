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

import dataclasses
import os
import shutil
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from apdmvs_tpu_torch import fusion as fusion_mod
from apdmvs_tpu_torch import geometry, ncc, pipeline, rng
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

    ``expected_sets`` is the number of problems sharing a scale: caching is
    all-or-nothing per scale, so pinned sets never sit beside every
    uncached build."""

    def __init__(self, dense_folder: str, camera_model: str = "eth",
                 volume_cache_bytes: float = 6e9, expected_sets: Optional[int] = None):
        self.dense_folder = dense_folder
        self.camera_model = camera_model
        self._gray: Dict[int, np.ndarray] = {}
        self._cam: Dict[int, dict] = {}
        self._scaled: Dict[Tuple[int, int], np.ndarray] = {}
        self.outputs: Dict[int, Dict[str, np.ndarray]] = {}
        self.volume_cache_bytes = float(volume_cache_bytes)
        self._volumes: Dict[Tuple[int, int], ncc.VolumeSet] = {}
        self._volumes_width: Optional[int] = None
        self._volumes_bytes = 0
        self.expected_sets = expected_sets

    def image_volumes(self, image_id: int, width: int, builder) -> ncc.VolumeSet:
        if self._volumes_width != width:
            self._volumes.clear()
            self._volumes_bytes = 0
            self._volumes_width = width
        key = (image_id, width)
        vs = self._volumes.get(key)
        if vs is not None:
            return vs
        vs = builder()
        nbytes = sum(t.numel() * t.element_size() for t in vs if isinstance(t, torch.Tensor))
        fits_scale = (self.expected_sets is None
                      or self.expected_sets * nbytes <= self.volume_cache_bytes)
        if fits_scale and self._volumes_bytes + nbytes <= self.volume_cache_bytes:
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
) -> ProblemStats:
    """One (view, pass): the reference's ProcessProblem (main.cpp:91-138).
    Loads inputs, runs the pass on ``device``, clamps out-of-range depths
    and persists the four state files."""
    t0 = time.perf_counter()
    device = torch.device(device)
    # the cached image volumes serve all of this (problem, scale)'s passes, so
    # they follow the round's APD mode, not this pass's after a downgrade below
    round_use_apd = spec.use_APD
    full_w, full_h = full_size
    W, H = scaled_size(full_w, full_h, spec.scale_size)
    view_ids = [problem.ref_image_id] + list(problem.src_image_ids)
    V_real = len(view_ids)
    V = num_views_pad or V_real

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
    dmin = float(ref_cam["depth_min"]) * 0.6
    dmax = float(ref_cam["depth_max"]) * 1.2
    cams = geometry.make_cameras(
        K, np.stack([c["R"] for c in cams_np]), np.stack([c["t"] for c in cams_np]),
        np.full(V, dmin, np.float32), np.full(V, dmax, np.float32), device=device,
    )

    prior = None
    if spec.state != RunState.FIRST_INIT:
        prior = _load_prior(cache, problem, V, W, H, device, missing_ok=allow_missing_prior)
    if prior is None:
        prior = pipeline.PassState(
            depth=torch.zeros((H, W), device=device),
            normal_world=torch.zeros((H, W, 3), device=device),
            pixel_state=torch.full((H, W), int(PixelState.STRONG), dtype=torch.uint8,
                                   device=device),
            selected=torch.zeros((V, H, W), dtype=torch.bool, device=device),
        )
        spec = dataclasses.replace(spec, state=RunState.FIRST_INIT, use_APD=False,
                                   geom_consistency=False)
    weak_in = weak_capacity = 0
    if spec.use_APD:
        weak_in = int(torch.sum(prior.pixel_state == PixelState.WEAK))
        weak_capacity = _bucket_capacity(weak_in, H * W)
        if weak_capacity == 0:
            spec = dataclasses.replace(spec, use_APD=False)

    volumes = cache.image_volumes(
        problem.ref_image_id, W,
        builder=lambda: ncc.build_image_volume_set(
            torch.as_tensor(imgs, device=device), cams, dmin, dmax, num_slices=num_slices,
            weak_cost_volumes=round_use_apd),
    )
    if spec.geom_consistency:
        dm = _load_src_depths(cache, problem, view_ids, W, H)
        if dm[1:V_real].any():
            dm = np.concatenate([dm, np.zeros((V - V_real, H, W), np.float32)])
            volumes = ncc.add_depth_volumes(
                volumes, torch.as_tensor(dm, device=device), cams, dmin, dmax)
        else:
            spec = dataclasses.replace(spec, geom_consistency=False)

    draws = rng.TorchDraws(rng.pass_seed(seed, spec.pass_index, problem.index), H, W, device)
    out = pipeline.patchmatch_pass(
        cams, torch.as_tensor(src_valid, device=device), prior, draws,
        PassConfig.from_spec(spec), volumes, weak_capacity=weak_capacity,
        ransac_threshold=spec.ransac_threshold,
    )
    out = pipeline.clamp_outputs(out, dmin, dmax)

    depth = out.depth.cpu().numpy().astype(np.float32)
    normal = out.normal_world.cpu().numpy().astype(np.float32)
    weak = out.pixel_state.cpu().numpy().astype(np.uint8)
    selected = pipeline.selected_to_bitmask(out.selected.cpu().numpy())
    rf = problem.result_folder
    formats.write_bin_mat(os.path.join(rf, "depths.dmb"), depth)
    formats.write_bin_mat(os.path.join(rf, "normals.dmb"), normal)
    formats.write_bin_mat(os.path.join(rf, "weak.bin"), weak)
    formats.write_bin_mat(os.path.join(rf, "selected_views.bin"), selected)
    cache.outputs[problem.ref_image_id] = {
        "depth": depth, "normal": normal, "weak": weak, "selected": selected,
    }
    if show_medium_result:
        tag = f"{spec.pass_index}"
        imio.save_image_u8(os.path.join(rf, f"depth_{tag}.jpg"),
                           render.render_depth(depth, dmin, dmax))
        imio.save_image_u8(os.path.join(rf, f"normal_{tag}.jpg"), render.render_normal(normal))
        imio.save_image_u8(os.path.join(rf, f"weak_{tag}.jpg"), render.render_weak(weak))
    weak_pct = 100.0 * float(np.mean(weak == PixelState.WEAK))
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


def run_fusion(dense_folder, problems: Sequence[Problem], out_name: str = "APD.ply") -> str:
    """ETH-fuse all per-view outputs into ``APD/<out_name>``
    (APD.cpp:826-977); the Tanks&Temples variants are not ported."""
    dense_folder = str(dense_folder)
    views, src_ids = _load_fusion_views(dense_folder, problems)
    coords, colors = fusion_mod.fuse_eth(views, src_ids)
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
    show_medium_result: bool = False,
    keep_intermediates: bool = True,
    max_rounds: Optional[int] = None,
    min_rounds: Optional[int] = None,
    camera_model: str = "eth",
    allow_missing_prior: bool = False,
    volume_cache_gb: float = 6.0,
    verbose: bool = True,
    num_slices: int = 160,
) -> SceneRun:
    """Full reconstruction (main.cpp:140-233): round scheduler -> one pass
    per (view, pass) on ``device`` -> ETH fusion -> APD/APD.ply.

    Images over 1000 px run more than one round; every round after the
    first runs the APD weak machinery. ``min_rounds`` forces extra rounds
    below that trigger (main.cpp:72-88), ``max_rounds`` caps them."""
    device = resolve_device(device)
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
                       volume_cache_bytes=volume_cache_gb * 1e9, expected_sets=len(problems))
    V_pad = max(1 + len(p.src_image_ids) for p in problems)
    passes = []
    for spec in build_schedule(round_num):
        for problem in problems:
            stats = process_problem(
                cache, problem, spec, full_size, seed, device, num_views_pad=V_pad,
                show_medium_result=show_medium_result, num_slices=num_slices,
                allow_missing_prior=allow_missing_prior,
            )
            passes.append((spec, problem, stats))
            if verbose:
                print(f"round {spec.round_index} pass {spec.pass_index} "
                      f"view {problem.ref_image_id:08d} ({spec.state.name}, "
                      f"scale 1/{spec.scale_size}): {stats.seconds * 1000:.0f} ms, "
                      f"weak {stats.weak_pct:.1f}%, weak in {stats.weak_in}")
    ply = run_fusion(dense_folder, problems)
    if verbose:
        print(f"Fused point cloud: {ply}")
    if not keep_intermediates:  # the reference deletes per-view dirs (main.cpp:220-230)
        for p in problems:
            shutil.rmtree(p.result_folder, ignore_errors=True)
    return SceneRun(ply=ply, passes=passes)
