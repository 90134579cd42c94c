#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``apdmvs_tpu_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises (exit code != 0)
and no ``ok`` line is printed:

1. build: compiles every kernel source under ``apdmvs_tpu_torch/csrc`` (one
   nvcc per source, all at once) and prints the build seconds and each
   kernel's ``-Xptxas -v`` register / spill summary.
2. kernels: holds each kernel of the one-round path (H1 build_volume, H2
   ncc_cost, H4 geom_cost) and H3 rebase_view against its plain PyTorch
   version on the card at the shapes of the main path (640x480, 5 views,
   K=160), with the stated tolerance: H1 on E (bf16) and D (trunc f32); H2
   from E per view at C=9 (propagation), C=3 (random depths, full-K), C=8
   (a sweep chunk) and C=1 (the K2 entry point), then over all four source
   views at C=9 through ``ncc_cost_views`` (what the main path launches),
   with planes the folded slice coordinate cannot take (w = 0, NaN, an
   infinite normal); H3 at j2=25 and 49, with the share of 8-position
   groups whose bases span 0 and 1 slices, then H3 and H8 bit-exact on
   edge cases (``h3_h8_edges``: sizes not a multiple of 8 or 4, pointers
   one element off alignment, j2 = 1 and K - 1, bases of exact halves and
   +-inf, k lanes NaN, +-inf, 0, K-1); H4 at C=8 over the depth volumes
   of all four source views through ``geom_cost_views`` (what the main
   path launches), bit-exact, with the same kinds of degenerate planes
   (NaN in the plain version's lanes) and with views that do not share one
   slice grid (the kernel's per-view branch), and its one-view entry equal
   to its slice. Times kernel, plain version and, where one PyTorch call
   computes the same function, that call (``F.grid_sample`` for H1): H1,
   H2, H3 and H4 in device time (20 calls replayed from a CUDA graph,
   warmed up) and per call (CUDA events); H4 also as four one-view calls
   and a ``torch.stack``, as the main path evaluated it before. Then H4
   over four views of K=160 at 3200x2400, C=8 (19.7 GB of depth volume
   from a seeded generator, more than 2^32 elements), bit-exact view by
   view.
3. main path: renders the 5-view 640x480 ring scene, writes it as a
   dataset, and runs ``scene.run_scene(device="cuda")``: one round of 4
   passes x 5 views (FIRST_INIT + 3 geometric REFINE_ITER) and ETH fusion.
   The launch counters are zeroed just before and read just after; every
   kernel of that path (H1, H2 through ``ncc_cost_views``, H4 through
   ``geom_cost_views``) must have launched, and H3 and the one-view H2 and
   H4 wrappers must not. Checks: median
   relative depth error on interior pixels < 0.01 against ground truth,
   > 1000 fused points, median point-to-plane distance < 0.05.
4. cols: holds H5 gather_cols (bit-exact) against its plain version at
   the flagship shapes below and times kernel, plain version and library
   yardstick in device time; H5's lines give the distinct (slice, 32-byte
   sector) pairs its reads touch beside the bytes bound, and the distinct
   128-byte lines a warp load touches. H6 contract_lookup (tent within
   1.2e-7 with NaN where the plain version has NaN, nearest bit-exact) is
   held against its plain version and timed on the lookups of a real
   flagship pass (the first call of each kind, captured by
   ``trace_pass.flagship_h6_calls``), with the quartiles of the slice
   range the lookups of 32 and of 256 neighbouring positions weigh and the
   bytes staging those ranges would move; the costliest call is its row in
   the kernels line. Then edge cases, each against the plain version: H5
   at M = 1, 12, 14, 1001, every coordinate -1, and 196608 slots over 100
   positions; H6 on the weak sweep's synthetic candidates (B=10 and 5,
   lanes with k NaN, +-inf, < 0, > K-1), with k in a 4-slice band, over
   all of K and in the last slices, R = 1001, B = 1 and 17, columns 2
   bytes past 16-byte alignment, and K * R >= 2^32 against gathers.
5. ops: the entry points that no default path calls, at full width, run
   once with the launch counters zeroed just before and read just after
   (their launches in the kernels line are these): H8 volume_sample on the
   volumes E of view 1 ([160, 496, 896] bf16) and D ([160, 480, 640] f32)
   at k = depth_to_slice of view 0's ground truth, with lanes of k NaN,
   +-inf, < 0, > K-1, K-1 and integers; H7 gather_rows on the
   position-major tables of C9 at the anchors and of D at the weak pixels,
   gather_rows_sorted on C36's at the weak pixels sorted; H2 on K10's
   case (the ground-truth plane and a random-depth plane in one candidate
   group); and H3 rebase_view (j2=25 and 49, around view 0's ground truth)
   with H2's two rebased entries, which compute from E. H3, H7 and H8 must
   be bit-exact with their plain versions (NaN where the plain version has
   NaN), H7 equal to H5's columns, H2 within 1e-4 and its rebased entries
   equal to it; E sampled at k must stay within the thresholds of
   tests/test_volume.py:87-90 of the direct warp. Then H7 bit-exact on edge
   cases: one row, a row count that leaves a block part-full, indices out
   of range at both ends, 72-byte rows, a table 2 bytes past alignment and
   int32 indices, and on D's rows (which take its warp-a-row path) one
   row, indices out of range and int32 indices. Times kernel, plain
   version and library yardstick (index_select, 5-D grid_sample) in device
   time (20 calls replayed from a CUDA graph), and the kernel's wrapper
   per call.
6. flagship pass: bench.py's program through the port
   (``apdmvs_tpu_torch.bench``'s flagship state and pass, the one
   definition of it), a REFINE_ITER pass
   with geometric consistency and the APD weak machinery at 640x480x5
   (prior from the ground truth, a 19200-pixel weak box, worklist 24576,
   ransac threshold 0.00875): wall ms of 5 passes after a warm-up, the
   launches of the kernels in one pass (H4 through ``geom_cost_views``; H3
   and the one-view H2 and H4 wrappers must not launch); median relative
   depth error < 0.01 over interior pixels and over the weak box.
7. two rounds: a 1280x960 five-view scene with a textureless window
   through ``scene.run_scene``: two rounds (40 view-passes), the second
   with the weak machinery, then ETH fusion. H1, H2, H4, H5, H6 must have
   launched and > 1000 weak pixels must enter round 1's REFINE_INIT pass of
   view 0. Checks: per-view median relative depth error < 0.01 on interior
   pixels, < 0.02 on view 0's textureless core, > 1000 fused points and
   median point-to-plane distance < 0.05. H3 and the one-view H2 and H4
   wrappers must not have launched. The outputs stay for phases 8 and 14.
8. fusion: the four variants of ``scene.run_fusion`` (eth, eth-device,
   tat_intermediate, tat_advanced) on phase 7's outputs, each timed twice
   with the host clock (views loaded, fused, PLY written); every cloud's
   median point-to-plane distance < 0.01, and eth-device's point count
   within 1 % of eth's (the JAX package's bounds,
   tests/test_fusion_device.py). A variant that raises fails the run.
9. quality: the four scene families of ``apdmvs_tpu_torch.quality_table``
   (multiround, occlusion, curved, ring) through ``scene.run_scene`` on the
   card, each row (points, accuracy, completeness, F1 at 0.05) printed
   beside the JAX package's round-4 F1 on a TPU (BASELINE.md) and held to
   the JAX package's floors (tests/test_quality.py); H1, H2 and H4 must
   launch on every family, H5 and H6 on multiround.
10. bench: ``apdmvs_tpu_torch.bench``'s measurement (depth-maps/s of the
   flagship pass with amortized volume builds, median of 5, and
   ``batched_maps_per_sec``: 4 copies of the flagship problem through the
   batched runner's volume path, their image-volume sets pinned within the
   default budget, ``scene.volume_cache_budget``), its JSON line printed.
11. batched: the one-round scene of phase 3 through
   ``scene.run_scene_batched`` on the card (H1, H2 through
   ``ncc_cost_views`` and H4 through ``geom_cost_views`` must launch, H3
   and the one-view wrappers must not; phase 3's checks), then the
   two-round scene of phase 7 through it (H5 and H6 must launch too;
   phase 7's checks). Each run with the launch counters zeroed just
   before and read just after; its wall per view-pass printed beside the
   sequential runner's (phases 3 and 7).
12. direct: the one-round scene through
   ``scene.run_scene_batched(use_volumes=False)``, the direct-warp path,
   and the flagship APD pass with ``volumes=None`` once, its stages timed
   with a device synchronise around each; every launch counter of H1-H8
   must stay at 0 over each run; phase 3's checks, and the flagship's
   median relative depth error < 0.01 over interior pixels and the weak
   box. The walls per view-pass of phases 3, 7, 11 and 12 in one line.
13. sharded: the two-round scene of phase 7 through
   ``scene.run_scene_batched`` on a view 2 x space 2 mesh, all four shards
   on cuda:0, every pass compiled (keys captured and replays printed, both
   > 0), with the launch counters zeroed (H1, H2, H4, H5, H6 must
   launch, H3, H7, H8 and the one-view wrappers must not; phase 7's
   checks), its wall per view-pass beside the body's and its peak, its
   state files byte-equal to phase 11's batched run of the same scene
   (the share of equal entries per field printed and held to the JAX
   package's decision-level bounds: pixel_state 0.999, depth within 2e-3
   0.995, selected 0.995); the one-round scene in two processes on
   cuda:0 (``python -m apdmvs_tpu_torch --batched --view-shards 2
   --num-processes 2 ... --dist-backend gloo --fusion eth-device``), each
   process reporting the keys it captured and its replays (both > 0), its
   state files equal to phase 11's one-process batched run byte for byte,
   each process persisting only its own views and process 0 alone fusing
   on the card; and
   ``fusion_device.fuse_eth_device`` in mesh mode (space 2 on cuda:0) on
   the 2 x 2 run's outputs, equal to the one-device call, both timed.
14. debug and profile: (a) the flagship pass of phase 6 with ``debug=True``
   against the same pass without it, the same draws: every output field
   equal, the launches of every kernel equal, the probes consistent (live
   worklist = the prior's 19200 WEAK pixels, under the 24576 capacity;
   anchors in the image or -1; the sweep [61, 480, 640], finite or
   COST_MAX), dumped with ``debug.dump_probes`` and read back with
   ``debug.read_neighbours``; (c) ``timeline``'s gap ledger (wall, device
   busy, idle share, busy and idle per ``apd.*`` stage, the five longest
   gaps with their stage and host operator) of one traced flagship pass,
   the same pass on 4 row slabs, on the direct-warp path, and of
   ``fuse_eth_device`` on phase 7's outputs (kept until here), then
   ``profile_stages``' per-stage times of the flagship pass (its JSON line
   printed); (b) ``scene.run_scene(debug_dumps=True, profile_dir=...)`` on
   a 640x480 five-view ring scene with a textureless window, two rounds:
   focal 800 (phase 7's field of view): > 1000 WEAK pixels enter round
   1's REFINE_INIT pass of every view, every view's probe files read back
   (as many neighbour rows as mapped pixels as WEAK pixels entered its last
   round-1 pass with a worklist), the trace holds every ``apd.*`` span and
   the kernels of H1, H2, H4, H5 and H6 by name, and phase 3's checks. The
   phase prints its seconds; the walls of traced runs are not compared with
   untraced ones. Its traced passes run ``pipeline.patchmatch_pass_impl``,
   the body, whose stage spans a replay would not record.
15. compiled: ``pipeline.patchmatch_pass``, the body captured once per
   static key as a CUDA graph and replayed (``compiled.py``), the only pass
   of every phase above but the traced and stage-timed ones. The
   default volume cache at 1280x960x5 (its budget and the sets it pins).
   For each key (the one-round scene's FIRST_INIT and geometric
   REFINE_ITER, the flagship APD pass, the same with ``debug=True``, the
   flagship on the direct-warp path, the flagship on S = 2 and S = 4 row
   slabs of cuda:0, all at 640x480 from views 0 and 1 of the ring scene;
   and the two-round scene's last round-1 pass of views 0 and 1 at
   1280x960 from phase 7's state files, in the larger of their worklist
   buckets, unsharded and on S = 2 slabs): its capture (warm-up, capture
   and instantiate ms, graph nodes), a replay held against
   ``patchmatch_pass_impl`` on the same inputs and draws (every output
   field and probe bit for bit, the same launches per kernel) and, over
   slabs, against the unsharded key's replay, the second problem through
   the same graph against its own eager run (bit for bit, no new key), the
   slot fill's device ms, the median of 10 eager passes against 10 replays
   and the peak memory of each. Then ``timeline``'s gap ledger of one traced
   flagship replay (device events only: no span replays), the keys and
   slot bytes at each scale, and the one-round scene run compiled and
   eagerly (walls per view-pass, peaks, captures; state files byte-equal)
   and the two-round scene run eagerly with ``volume_cache_gb=6``, its
   state files byte-equal to phase 7's compiled run with the default
   cache. One JSON line ``{"compiled": [...]}`` holds the keys' rows.

Then it prints the ``kernels`` JSON line (launches: H1, H2 and H4 from
phase 3, H5-H6 from phase 7, H3, H7 and H8 from phase 5, and each
kernel's ``sharded`` launches from phase 13's 2 x 2 run, compiled; a
replay counts the launches its key's capture recorded, and a capture's
warm-up pass counts its own; times in device time where the script takes
it; phases 11, 12, 14 and 15 launch no other kernel),
the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the rest
of the repository beside it, it fails before printing any result.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and f32 rate
# outside the tensor cores; the kernels do f32 arithmetic on CUDA cores.
MEM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations of each kernel's function, counted off its plain version
# (the work the function needs, not the kernel's instructions):
# H1 22 per output (3 adds of the warp, 2 divisions, clamp 4, floor 2,
# weights 2, bilinear 9; M dirs is per pixel, b u per slice);
# H2 17 per window sample of an output (slice coordinate from the plane 4,
# clamp 2, floor and fraction 2, lerp 4, the three sums s, ss, rs 5), 46 per
# output (folding the plane 6, moments, epilogue and centre warp 40) and 3
# per window sample of a pixel (the reference sums r, rr, shared by every
# view and field); H4 ~60 per output (depth, slice, warp, reprojection, error).
OPS_H1, OPS_H2_SAMPLE, OPS_H2_OUT, OPS_H2_REF, OPS_H4 = 22, 17, 46, 3, 60

W, H, V, K = 640, 480, 5, 160
W2, H2 = 1280, 960  # the two-round scene


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed between two events. Back-to-back calls (``time_ms``)
    time the host instead wherever a call's Python and ctypes work (~30 us)
    outlasts its kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bf16_ulps(a, b):
    """Distance between two bf16 tensors in units in the last place."""
    import torch

    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    # map sign-magnitude onto a monotone integer line
    ia = torch.where(ia < 0, -32768 - ia, ia)
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return (ia - ib).abs()


def ncc_touched(planes_cf, consts, num_slices, PH, PW, radius=5, increment=2):
    """Distinct elements (slice, padded pixel) of E that H2 must read for
    these fields: the two K-neighbours of each window sample, with the
    plain version's slice arithmetic. The data decides how many."""
    import torch

    from apdmvs_tpu_torch.ops import ncc_volume as nv

    C, _, Hq, Wq = planes_cf.shape
    dev = planes_cf.device
    c = consts[0]
    fx, fy, cx, cy, u_min, du = (c[m] for m in range(6))
    yi, xi = torch.meshgrid(torch.arange(Hq, device=dev), torch.arange(Wq, device=dev),
                            indexing="ij")
    ys, xs = yi.float() + c[20], xi.float()
    n, w = planes_cf[:, :3], planes_cf[:, 3]
    seen = torch.zeros(num_slices * PH * PW, dtype=torch.bool, device=dev)
    for dx, dy in nv._offsets(radius, increment):
        dirx = (xs + float(dx) - cx) / fx
        diry = (ys + float(dy) - cy) / fy
        u = -(n[:, 0] * dirx + n[:, 1] * diry + n[:, 2]) / w
        k = torch.clamp((u - u_min) / du, 0.0, num_slices - 1.0)
        k0 = nv._slice_index(torch.floor(k), num_slices)
        pix = (yi + nv.PAD_Y + dy) * PW + (xi + nv.PAD_X + dx)
        seen[k0 * (PH * PW) + pix] = True
        seen[torch.clamp(k0 + 1, max=num_slices - 1) * (PH * PW) + pix] = True
    return int(seen.sum())


def h2_bound_views(planes_cf, views, touched, samples=36):
    """H2's bound for these fields over ``views`` source views: the NCC
    function's own traffic (the ``touched`` elements of E that the fields'
    windows read, the reference image under the windows, planes in, costs
    out) or its f32 operations, the larger."""
    C, _, Hp, Wp = planes_cf.shape
    nbytes = (touched * 2 + (Hp + 10) * (Wp + 10) * 4 + C * 4 * Hp * Wp * 4
              + views * C * Hp * Wp * 4)
    ops = (views * C * Hp * Wp * (samples * OPS_H2_SAMPLE + OPS_H2_OUT)
           + Hp * Wp * samples * OPS_H2_REF)
    return bound(nbytes, ops)


def h2_bound(planes_cf, consts):
    """H2's bound for these fields against one source view, and the
    elements of E touched."""
    from apdmvs_tpu_torch.ops import ncc_volume as nv

    _, _, Hp, Wp = planes_cf.shape
    touched = ncc_touched(planes_cf, consts, K, Hp + 2 * nv.PAD_Y, Wp + 2 * nv.PAD_X)
    return h2_bound_views(planes_cf, 1, touched), touched


def geom_touched(planes_cf, gconsts, num_slices):
    """Distinct elements of the depth volume D that H4 must read: the
    nearest slice of each field at each pixel."""
    import torch

    from apdmvs_tpu_torch.ops import ncc_volume as nv

    C, _, Hq, Wq = planes_cf.shape
    dev = planes_cf.device
    c = gconsts[0]
    fx, fy, cx, cy, u_min, du = (c[m] for m in range(6))
    ys, xs = torch.meshgrid(torch.arange(Hq, device=dev, dtype=torch.float32),
                            torch.arange(Wq, device=dev, dtype=torch.float32), indexing="ij")
    dirx = (xs - cx) / fx
    diry = (ys + c[32] - cy) / fy
    n = planes_cf
    u = -(n[:, 0] * dirx + n[:, 1] * diry + n[:, 2]) / n[:, 3]
    k = nv._slice_index(torch.round(torch.clamp((u - u_min) / du, 0.0, num_slices - 1.0)),
                        num_slices)
    seen = torch.zeros(num_slices * Hq * Wq, dtype=torch.bool, device=dev)
    seen[k * (Hq * Wq) + torch.arange(Hq * Wq, device=dev).reshape(Hq, Wq)] = True
    return int(seen.sum())


def phase_build():
    from apdmvs_tpu_torch.ops import _build

    t0 = time.perf_counter()
    results = _build.build_all()
    log(f"build: {len(results)} kernel libraries compiled in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, (secs, out) in results.items():
        regs = []
        for ln in out.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", ln)
            if entry:
                regs.append(entry.group(1))
            elif re.search(r"registers|spill", ln):
                regs.append(ln.split("ptxas info    :")[-1].strip())
        log(f"build: {name} {secs:.2f} s; ptxas: " + " | ".join(regs))


def make_inputs(dev):
    """The main path's inputs at 640x480x5 views: images, cameras, volumes
    and plane fields built from the ground truth with perturbations."""
    import numpy as np
    import torch

    from apdmvs_tpu_torch import geometry, ncc
    from apdmvs_tpu_torch.datasets import synthetic

    cams_s, planes_s = synthetic.make_ring_scene(num_views=V, width=W, height=H)
    images, depths, normals = synthetic.render_scene(cams_s, planes_s)
    cams = geometry.make_cameras(
        np.stack([c.K for c in cams_s]), np.stack([c.R for c in cams_s]),
        np.stack([c.t for c in cams_s]), np.full(V, 1.2), np.full(V, 9.6), device=dev,
    )
    return cams_s, planes_s, images, depths, normals, cams


def check_h2(out, ref, name):
    """Max abs difference of H2 from its plain version on the lanes where
    the plain version is not NaN; raises unless it is < 1e-4 and the NaN
    lanes agree."""
    import torch

    nan = torch.isnan(ref)
    same_nan = torch.equal(torch.isnan(out), nan)
    err = float((out[~nan] - ref[~nan]).abs().max())
    if not (same_nan and err < 1e-4):
        raise AssertionError(f"H2 disagrees with its plain version ({name}: {err:.3e}, "
                             f"NaN lanes agree {same_nan})")
    return err, int(nan.sum())


def phase_kernels(dev, inputs):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from apdmvs_tpu_torch import geometry, ncc
    from apdmvs_tpu_torch.ops import ncc_volume as nv, volume as vol

    _, _, images, depths, normals, cams = inputs
    rs = np.random.RandomState(0)
    imgs = torch.as_tensor(images, device=dev)
    dm = torch.as_tensor(depths, device=dev)
    wc = geometry.warp_constants(cams)
    # on the card, so that a CUDA graph can capture the wrappers' packing
    u_min, du = (v.to(dev) for v in vol.inv_depth_grid(1.2, 9.6, K))
    Hp, Wp = ncc._ceil_to(H, nv.NCC_TILE_H), ncc._ceil_to(W, nv.TILE_W)
    PH, PW = Hp + 2 * nv.PAD_Y, Wp + 2 * nv.PAD_X
    rows = []

    # ---- H1 build_volume: bilinear bf16 (image volume) + trunc f32 (depth volume)
    args = (wc.M[1], wc.b[1], cams.K[0], Hp, Wp, u_min, du, K)
    E = vol.build_volume(imgs[1], *args, pad_y=nv.PAD_Y, pad_x=nv.PAD_X)
    E_ref = vol.build_volume_padded(imgs[1], *args, pad_y=nv.PAD_Y, pad_x=nv.PAD_X)
    ulps = int(bf16_ulps(E, E_ref).max())
    exact_e = torch.equal(E.view(torch.int16), E_ref.view(torch.int16))
    D = vol.build_volume(dm[1], *args, pad_y=0, pad_x=0, dtype=torch.float32, trunc=True)
    D_ref = vol.build_volume_padded(dm[1], *args, pad_y=0, pad_x=0,
                                    dtype=torch.float32, trunc=True)
    eq_trunc = float((D == D_ref).float().mean())
    err_h1 = float((E.float() - E_ref.float()).abs().max())
    ok = ulps <= 1 and eq_trunc >= 0.999
    log(f"kernel H1 build_volume: bilinear max {ulps} bf16 ulp (tol 1), bit-exact {exact_e}, "
        f"max abs {err_h1:.3e}; trunc {100 * eq_trunc:.4f}% equal (tol >= 99.9%) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("H1 disagrees with its plain version")
    del E_ref, D_ref

    def h1_e():
        return vol.build_volume(imgs[1], *args, pad_y=nv.PAD_Y, pad_x=nv.PAD_X)

    def h1_d():
        return vol.build_volume(dm[1], *args, pad_y=0, pad_x=0, dtype=torch.float32, trunc=True)

    call = time_ms(h1_e, 10)
    dev_e, dev_d = graph_ms(h1_e, 10), graph_ms(h1_d, 10)
    plain = time_ms(lambda: vol.build_volume_padded(imgs[1], *args, pad_y=nv.PAD_Y,
                                                    pad_x=nv.PAD_X), 2, 1)
    # library yardstick: grid_sample (bilinear, border) on the precomputed
    # sampling grid of all K slices
    ys, xs = torch.meshgrid(torch.arange(PH, device=dev, dtype=torch.float32) - nv.PAD_Y,
                            torch.arange(PW, device=dev, dtype=torch.float32) - nv.PAD_X,
                            indexing="ij")
    Md = geometry.mat3_vec(wc.M[1], geometry.pixel_dirs(cams.K[0], xs, ys))
    u = u_min.to(dev) + torch.arange(K, device=dev, dtype=torch.float32)[:, None, None] * du.to(dev)
    q = Md[None] + wc.b[1] * u[..., None]
    gx = (q[..., 0] / q[..., 2]) / (W - 1) * 2 - 1
    gy = (q[..., 1] / q[..., 2]) / (H - 1) * 2 - 1
    grid = torch.stack([gx, gy], -1).reshape(1, K * PH, PW, 2)
    del q, gx, gy

    def library():
        return F.grid_sample(imgs[1][None, None], grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    lib_call = time_ms(library, 10)
    lib = graph_ms(library, 10)
    del grid
    b_ms, b_by = bound(H * W * 4 + K * PH * PW * 2, K * PH * PW * OPS_H1)
    b_d, b_d_by = bound(H * W * 4 + K * Hp * Wp * 4, K * Hp * Wp * OPS_H1)
    rows.append(dict(name="build_volume", route="cuda",
                     source="apdmvs_tpu_torch/csrc/build_volume.cu",
                     replaces="apdmvs_tpu/ops/volume.py:123", max_abs_err=err_h1, ms=dev_e,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    log(f"kernel H1 build_volume E bf16 [{K}, {PH}, {PW}]: device {dev_e:.4f} ms, {call:.4f} ms "
        f"a call (plain {plain:.3f}; grid_sample device {lib:.4f}, {lib_call:.4f} a call; "
        f"bound {b_ms:.4f} by {b_by})")
    log(f"kernel H1 build_volume D trunc f32 [{K}, {Hp}, {Wp}]: device {dev_d:.4f} ms "
        f"(bound {b_d:.4f} by {b_d_by})")

    # ---- H3 rebase_view around the ground-truth depth of view 0, j2=25 and
    # 49 (K4's counterpart; no default path calls it, the ops phase does)
    vs = ncc.VolumeSet(E=E[None], consts=nv.pack_consts(cams.K[0], wc.M[1], wc.b[1], u_min,
                                                         du, W, H)[None],
                       ref_pad=ncc._edge_pad(imgs[0], nv.PAD_Y, nv.PAD_Y + Hp - H,
                                             nv.PAD_X, nv.PAD_X + Wp - W))
    base_k = ncc._base_slice_map(vs, dm[0])
    err_h3 = 0.0
    for j2 in (nv.J2_REBASE, nv.SWEEP_J2):
        R, bf = nv.build_rebased_view(E, base_k, K, j2=j2)
        R_ref, bf_ref = nv.build_rebased_view_ref(E, base_k, K, j2=j2)
        exact = torch.equal(R.view(torch.int16), R_ref.view(torch.int16)) and torch.equal(bf, bf_ref)
        err = max(float((R.float() - R_ref.float()).abs().max()),
                  float((bf - bf_ref).abs().max()))
        err_h3 = max(err_h3, err)
        log(f"kernel H3 rebase_view j2={j2}: bit-exact {exact}, max abs {err:.3e} "
            "(tol: bit-exact)")
        if not exact:
            raise AssertionError("H3 disagrees with its plain version")
    del R, bf, R_ref, bf_ref
    ms = graph_ms(lambda: nv.build_rebased_view(E, base_k, K))
    call = time_ms(lambda: nv.build_rebased_view(E, base_k, K), 20)
    plain = time_ms(lambda: nv.build_rebased_view_ref(E, base_k, K), 3, 1)
    J = (nv.J2_REBASE - 1) // 2
    idx = (torch.clamp(torch.round(base_k), J, K - 1 - J).long()[None]
           + torch.arange(nv.J2_REBASE, device=dev)[:, None, None] - J)
    lib = graph_ms(lambda: torch.gather(E, 0, idx))
    b_ms, b_by = bound(2 * nv.J2_REBASE * PH * PW * 2 + 2 * PH * PW * 4, 0.0)
    rows.append(dict(name="rebase_view", route="cuda", source="apdmvs_tpu_torch/csrc/rebase_view.cu",
                     replaces="apdmvs_tpu/ops/ncc_volume.py:1029", max_abs_err=err_h3, ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    b = torch.clamp(torch.round(base_k), J, K - 1 - J).reshape(-1, 8)
    span = b.amax(1) - b.amin(1)
    span0, span1 = (100 * float((span == s).float().mean()) for s in (0, 1))
    log(f"kernel H3 rebase_view j2=25 {PH}x{PW}: device {ms:.4f} ms, {call:.4f} ms a call "
        f"(plain {plain:.3f}, torch.gather device {lib:.4f}, bound {b_ms:.4f} by {b_by}); "
        f"bases of 8-position groups span 0 slices in {span0:.2f}%, 1 in {span1:.2f}%")
    del idx, b, span
    h3_h8_edges(dev, E, D, base_k)

    # ---- H2 ncc_cost at the main path's batch shapes, all from E
    x, y = geometry.pixel_grid(H, W, dev)
    n_cam = geometry.normal_world_to_cam(cams.R[0], torch.as_tensor(normals[0], device=dev))
    gt = torch.where(dm[0] > 0, dm[0], torch.full_like(dm[0], 4.0))

    def plane_field(depth, normal):
        w = geometry.dist_to_origin(cams.K[0], x, y, depth, normal)
        return torch.cat([normal, w[..., None]], -1)

    def noisy(scale, seed):
        r = np.random.RandomState(seed)
        d = gt * torch.as_tensor(1 + scale * r.randn(H, W), device=dev, dtype=torch.float32)
        n = n_cam + torch.as_tensor(0.05 * r.randn(H, W, 3), device=dev, dtype=torch.float32)
        return plane_field(d, n / torch.linalg.vector_norm(n, dim=-1, keepdim=True))

    rand_depth = torch.as_tensor(rs.uniform(1.2, 9.6, (3, H, W)), device=dev, dtype=torch.float32)
    # per view, as the parent's cases: C=9 propagation (formerly through R,
    # j2=25), C=3 random depths (full-K), a C=8 sweep chunk (formerly through
    # R, j2=49), C=1 (FIRST_INIT seeding, LocalRefine, the K2 entry point)
    cases = {
        "C9_propagation": torch.stack([noisy(0.01, s) for s in range(9)]),
        "C3_fullk_random": torch.stack([plane_field(rand_depth[i], n_cam) for i in range(3)]),
        "C8_sweep": torch.stack([plane_field(gt * (1 + 0.004 * (s - 4)), n_cam)
                                 for s in range(8)]),
        "C1_E": noisy(0.01, 9)[None],
    }
    err_h2 = 0.0
    consts = vs.consts[0]
    for name, pl in cases.items():
        planes_cf = ncc._pad_planes_cf(pl, Hp, Wp)
        cases[name] = planes_cf
        out = nv.ncc_cost(E, vs.ref_pad, planes_cf, consts, K)
        ref = nv.ncc_volume_cost_ref(E, vs.ref_pad, planes_cf, consts, K)
        err, _ = check_h2(out, ref, name)
        err_h2 = max(err_h2, err)

        def h2():
            return nv.ncc_cost(E, vs.ref_pad, planes_cf, consts, K)

        ms, call = graph_ms(h2), time_ms(h2, 10)
        plain = time_ms(lambda: nv.ncc_volume_cost_ref(E, vs.ref_pad, planes_cf, consts, K), 2, 1)
        (b_ms, b_by), touched = h2_bound(planes_cf, consts)
        log(f"kernel H2 ncc_cost {name}: max abs {err:.3e} (tol 1e-4), plain finite "
            f"{bool(torch.isfinite(ref).all())}; device {ms:.4f} ms, {call:.4f} ms a call (plain "
            f"{plain:.3f}; bound {b_ms:.4f} by {b_by}; E elements touched {touched}, "
            f"{touched / (PH * PW):.2f} slices a pixel)")

    # all four source views in one launch, C=9: what the main path launches
    Es = torch.stack([E] + [vol.build_volume(imgs[v], wc.M[v], wc.b[v], cams.K[0], Hp, Wp,
                                             u_min, du, K, pad_y=nv.PAD_Y, pad_x=nv.PAD_X)
                            for v in range(2, V)])
    consts_v = torch.stack([nv.pack_consts(cams.K[0], wc.M[v], wc.b[v], u_min, du, W, H)
                            for v in range(1, V)])
    pl9 = cases["C9_propagation"]

    def h2_views(planes_cf):
        return nv.ncc_cost_views(Es, vs.ref_pad, planes_cf, consts_v, K)

    def plain_views(planes_cf):
        return torch.stack([nv.ncc_volume_cost_ref(Es[v], vs.ref_pad, planes_cf, consts_v[v], K)
                            for v in range(V - 1)])

    err, _ = check_h2(h2_views(pl9), plain_views(pl9), "C9 over four views")
    err_h2 = max(err_h2, err)
    # planes the folded slice coordinate cannot take: w = 0 (once with n0 =
    # 0 too), a NaN plane, an infinite normal; their lanes take the divisions
    deg = pl9.clone()
    deg[0, 3, 10, 20:24] = 0.0
    deg[0, 0, 10, 20] = 0.0
    deg[1, :, 11, 30] = float("nan")
    deg[2, 0, 12, 40] = float("inf")
    err_d, nan_d = check_h2(h2_views(deg), plain_views(deg), "degenerate planes")
    err_h2 = max(err_h2, err_d)
    ms = graph_ms(lambda: h2_views(pl9))
    call = time_ms(lambda: h2_views(pl9), 10)
    plain = time_ms(lambda: plain_views(pl9), 2, 1)
    touched = sum(ncc_touched(pl9, consts_v[v], K, PH, PW) for v in range(V - 1))
    b_ms, b_by = h2_bound_views(pl9, V - 1, touched)
    rows.append(dict(name="ncc_cost", route="cuda", source="apdmvs_tpu_torch/csrc/ncc_cost.cu",
                     replaces="apdmvs_tpu/ops/ncc_volume.py:353", max_abs_err=err_h2, ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None))
    log(f"kernel H2 ncc_cost_views C9 over {V - 1} views: max abs {err:.3e} (tol 1e-4); "
        f"degenerate planes max abs {err_d:.3e}, NaN in {nan_d} lanes as the plain version; "
        f"device {ms:.4f} ms, {call:.4f} ms a call (plain {plain:.3f}; bound {b_ms:.4f} by "
        f"{b_by}; E elements touched {touched}); no single PyTorch call computes it")
    del Es

    # ---- H4 geom_cost: the trunc depth volumes of all four source views
    # (what the main path's geometric passes read, 786 MB), C=8 sweep planes
    vs_d = ncc.add_depth_volumes(vs, dm, cams, 1.2, 9.6)
    Ds, gconsts = vs_d.D, vs_d.geom_consts
    del vs_d
    pl8 = cases["C8_sweep"]
    C = pl8.shape[0]
    # planes the divisions make degenerate: w = 0 (once with n0 = 0 too), a
    # NaN plane, an infinite normal
    deg8 = pl8.clone()
    deg8[0, 3, 10, 20:24] = 0.0
    deg8[0, 0, 10, 20] = 0.0
    deg8[1, :, 11, 30] = float("nan")
    deg8[2, 0, 12, 40] = float("inf")
    # views that do not share one slice grid: the kernel's per-view branch
    g_mixed = gconsts.clone()
    g_mixed[2, 0, 5] *= 1.01

    def plain_geom(planes_cf, g):
        return torch.stack([nv.geom_volume_cost_view_ref(Ds[v], planes_cf, g[v], K)
                            for v in range(V - 1)])

    for name, pcf, g in (("C8", pl8, gconsts), ("degenerate planes", deg8, gconsts),
                         ("views without a shared slice grid", pl8, g_mixed)):
        out, ref = nv.geom_cost_views(Ds, pcf, g, K), plain_geom(pcf, g)
        nan = torch.isnan(ref)
        exact = (torch.equal(torch.isnan(out), nan)
                 and torch.equal(out[~nan].view(torch.int32), ref[~nan].view(torch.int32)))
        log(f"kernel H4 geom_cost_views {name} over {V - 1} views: bit-exact {exact}, NaN in "
            f"{int(nan.sum())} lanes as the plain version (tol: bit-exact, NaN where the plain "
            "version has NaN)")
        if not exact or (name == "degenerate planes") != bool(nan.any()):
            raise AssertionError(f"H4 disagrees with its plain version ({name})")
    one = nv.geom_volume_cost_view(Ds[1], pl8, gconsts[1], K)
    out = nv.geom_cost_views(Ds, pl8, gconsts, K)
    if not torch.equal(one.view(torch.int32), out[1].view(torch.int32)):
        raise AssertionError("H4's one-view entry differs from its views entry")
    del out, ref, one

    def h4_views():
        return nv.geom_cost_views(Ds, pl8, gconsts, K)

    def h4_one_view_calls():  # the parent's evaluation: one call a view, then a stack
        return torch.stack([nv.geom_volume_cost_view(Ds[v], pl8, gconsts[v], K)
                            for v in range(V - 1)])

    ms, call = graph_ms(h4_views), time_ms(h4_views, 20)
    ms1 = graph_ms(lambda: nv.geom_volume_cost_view(Ds[0], pl8, gconsts[0], K))
    ms_calls, call_calls = graph_ms(h4_one_view_calls), time_ms(h4_one_view_calls, 10)
    plain = time_ms(lambda: plain_geom(pl8, gconsts), 3, 1)
    touched = [geom_touched(pl8, gconsts[v], K) for v in range(V - 1)]
    b_ms, b_by = bound(sum(touched) * 4 + C * 4 * Hp * Wp * 4 + (V - 1) * C * Hp * Wp * 4,
                       (V - 1) * C * Hp * Wp * OPS_H4)
    b1, b1_by = bound(touched[0] * 4 + C * Hp * Wp * (16 + 4), C * Hp * Wp * OPS_H4)
    rows.append(dict(name="geom_cost", route="cuda", source="apdmvs_tpu_torch/csrc/geom_cost.cu",
                     replaces="apdmvs_tpu/ops/ncc_volume.py:1370", max_abs_err=0.0, ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None))
    log(f"kernel H4 geom_cost_views C=8 over {V - 1} views: device {ms:.4f} ms, {call:.4f} ms a "
        f"call (plain {plain:.3f}; bound {b_ms:.4f} by {b_by}, {b_ms / ms:.2f} of it; D elements "
        f"touched {sum(touched)}); four one-view calls + torch.stack device {ms_calls:.4f} ms, "
        f"{call_calls:.4f} ms a call; no single PyTorch call computes it")
    log(f"kernel H4 geom_volume_cost_view C=8 one view: device {ms1:.4f} ms (bound {b1:.4f} by "
        f"{b1_by})")
    del Ds
    h4_large(dev)
    torch.cuda.synchronize()
    return rows


def h4_large(dev, NV=4, C=8, H4=2400, W4=3200):
    """H4 over NV views of K=160 at 3200x2400, C=8: 4 x 4.9 GB of depth
    volume, more than 2^32 elements over the views, held bit for bit
    against the plain version view by view. The kernel addresses each view
    from a 64-bit base; a guard over the whole of D refused this."""
    import numpy as np
    import torch

    from apdmvs_tpu_torch import geometry
    from apdmvs_tpu_torch.datasets import synthetic
    from apdmvs_tpu_torch.ops import ncc_volume as nv, volume as vol

    if not nv.geom_offsets_fit(K, C, H4, W4):
        raise AssertionError("the large H4 case does not fit the kernel's offsets")
    old_rule = max(4 * K, 4 * C, NV * C) * H4 * W4
    cams_s, _ = synthetic.make_ring_scene(num_views=NV + 1, width=W4, height=H4)
    cams = geometry.make_cameras(
        np.stack([c.K for c in cams_s]), np.stack([c.R for c in cams_s]),
        np.stack([c.t for c in cams_s]), np.full(NV + 1, 1.2), np.full(NV + 1, 9.6), device=dev)
    wc = geometry.warp_constants(cams)
    u_min, du = vol.inv_depth_grid(1.2, 9.6, K)
    KR = geometry.mat3_mat3(cams.K[0], cams.R[0])
    gconsts = torch.stack([nv.pack_geom_consts(
        cams.K[0], wc.M[v], wc.b[v],
        geometry.mat3_mat3(geometry.mat3_mat3(KR, cams.R[v].transpose(-1, -2)),
                           geometry.k_inverse_zero_skew(cams.K[v])),
        geometry.mat3_vec(KR, cams.c[v] - cams.c[0]), u_min, du, W4, H4)
        for v in range(1, NV + 1)])
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    # depths 0 .. 8.5, about 6 % of them 0 (no depth: cost 3)
    D = torch.rand((NV, K, H4, W4), generator=gen, device=dev)
    D.mul_(9.0).sub_(0.5).clamp_(min=0.0)
    x, y = geometry.pixel_grid(H4, W4, dev)
    n = torch.tensor([0.0, 0.0, -1.0], device=dev) + 0.2 * torch.randn(
        (C, H4, W4, 3), generator=gen, device=dev)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    depth = 1.2 + 8.4 * torch.rand((C, H4, W4), generator=gen, device=dev)
    w = geometry.dist_to_origin(cams.K[0], x, y, depth, n)
    planes = torch.cat([n, w[..., None]], -1).permute(0, 3, 1, 2).contiguous()
    del n, depth, w
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = nv.geom_cost_views(D, planes, gconsts, K)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    nan_lanes, exact = 0, True
    for v in range(NV):
        ref = nv.geom_volume_cost_view_ref(D[v], planes, gconsts[v], K)
        nan = torch.isnan(ref)
        nan_lanes += int(nan.sum())
        exact &= (torch.equal(torch.isnan(out[v]), nan)
                  and torch.equal(out[v][~nan].view(torch.int32), ref[~nan].view(torch.int32)))
        del ref, nan
    log(f"kernel H4 geom_cost_views {NV} views K={K} C={C} at {W4}x{H4}: D "
        f"{D.numel() * 4 / 1e9:.1f} GB ({D.numel()} elements, 2^32 = {2 ** 32}); bit-exact "
        f"{exact}, NaN in {nan_lanes} lanes as the plain version (tol: bit-exact); one launch "
        f"{ms:.2f} ms with its first-call work; max(4K, 4C, NV*C)*H*W = {old_rule} >= 2^32 "
        f"{old_rule >= 2 ** 32} (the old whole-D guard refused it), max(K, 4C)*H*W = "
        f"{max(K, 4 * C) * H4 * W4}")
    if not exact:
        raise AssertionError("H4 disagrees with its plain version at 3200x2400")
    del D, planes, out
    torch.cuda.empty_cache()


# the launch counters of the one-round path (the weak machinery's H5, H6
# run only in rounds after the first; H2 and H4 run as ncc_cost_views and
# geom_cost_views, every source view in one launch); of the two-round
# scene; and of the ops entry
# points that no default path calls (H7, H8, H3 with H2's two rebased
# entries) with H2 on K10's case
ONE_ROUND_KERNELS = ("build_volume", "ncc_cost_views", "geom_cost_views")
TWO_ROUND_KERNELS = ONE_ROUND_KERNELS + ("gather_cols", "contract_lookup")
OPS_KERNELS = ("volume_sample", "gather_rows", "gather_rows_sorted", "ncc_cost", "rebase_view")
# counters that no default path may advance: H2 and H4 one view at a time,
# and H3
NOT_ON_MAIN_PATH = ("ncc_cost", "rebase_view", "geom_cost")
# counters the sharded runs must leave at 0 as well: H7 and H8
NOT_ON_SHARDED_PATH = NOT_ON_MAIN_PATH + ("gather_rows", "gather_rows_sorted",
                                          "volume_sample")
STATE_FILES = ("depths.dmb", "normals.dmb", "weak.bin", "selected_views.bin")
# the JAX package's decision-level bounds for a sharded run against an
# unsharded one (tests/test_spaced_volumes.py:92-100): share of equal
# pixel states, of depths within 2e-3 (relative and absolute), of equal
# selected-view masks
SHARDED_FLOORS = {"pixel_state": 0.999, "depth": 0.995, "selected": 0.995}
# K10's two windows are BAND2 = 32 slices each (apdmvs_tpu/ops/ncc_volume.py:81)
BAND2 = 32
# grid_sample counts as computing volume_sample's function if it agrees with
# the plain version to coordinate rounding: normalised pixel centres come
# back within ~1e-4 px, worth < 0.05 grey levels next to a 255-level step
LIB_TOL = 0.05


def _counters():
    from apdmvs_tpu_torch import ops

    return ops.launch_counters()


def _off_by_one(x):
    """``x`` copied one element past the start of a buffer: contiguous, its
    data not 16-byte aligned."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.reshape(-1)
    return buf[1:].view(x.shape)


def h3_h8_edges(dev, E, D, base_k):
    """H3 and H8 on inputs the main path's shapes never reach, each
    bit-exact against its plain version (H8 with NaN where the plain
    version has NaN): H3 on 495x641 positions (not a multiple of 8) and on
    E and base_k one element past alignment (both take its
    element-by-element path), at j2 = 1 and K - 1, and with base_k lanes of
    exact halves and +-inf; H8 on E (bf16) at 495x895 and D (f32) at
    479x639 pixels (not multiples of 4) and with E and k one element past
    alignment, k holding NaN, +-inf, 0, K-1, out-of-range, integer and
    fractional lanes. One line a case."""
    import torch

    from apdmvs_tpu_torch.ops import ncc_volume as nv, volume as vol

    nan, inf = float("nan"), float("inf")
    halves = base_k.clone()
    J = (nv.SWEEP_J2 - 1) // 2
    halves[0, :16] = torch.tensor([J - 0.5, J + 0.5, 40.5, 41.5, K - 1 - J - 0.5,
                                   K - 1 - J + 0.5, -0.5, K + 0.5] * 2)
    halves[1, :8] = inf  # a group of 8 equal bases, clamped
    halves[2, ::3] = inf
    halves[3, ::5] = -inf
    odd = (slice(None), slice(0, 495), slice(0, 641))
    h3 = {"495x641 positions": (E[odd].contiguous(), base_k[odd[1:]].contiguous(), nv.J2_REBASE),
          "E and base_k 1 element off": (_off_by_one(E), _off_by_one(base_k), nv.J2_REBASE),
          "j2 = 1": (E, base_k, 1), f"j2 = K - 1 = {K - 1}": (E, base_k, K - 1),
          "halves and +-inf bases": (E, halves, nv.SWEEP_J2)}
    for name, (Ev, bk, j2) in h3.items():
        R, bf = nv.build_rebased_view(Ev, bk, K, j2=j2)
        R_ref, bf_ref = nv.build_rebased_view_ref(Ev, bk, K, j2=j2)
        exact = (torch.equal(R.view(torch.int16), R_ref.view(torch.int16))
                 and torch.equal(bf, bf_ref))
        vec = nv.rebase_vector_path(bk.numel(), Ev.data_ptr(), bk.data_ptr(), R.data_ptr(),
                                    bf.data_ptr())
        log(f"kernel H3 edge case {name}: E {tuple(Ev.shape)} at byte offset "
            f"{Ev.data_ptr() % 16} mod 16, j2={j2}, 16-byte path {vec}: bit-exact {exact} "
            "(tol: bit-exact)")
        if not exact:
            raise AssertionError(f"H3 disagrees with its plain version ({name})")
        del R, bf, R_ref, bf_ref
    del h3, halves

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    lanes = torch.tensor([nan, inf, -inf, 0.0, K - 1.0, -5.0, K + 10.0, 7.0, 31.0, K - 2.0],
                         device=dev)

    def slices(shape):
        k = (K + 4) * torch.rand(shape, generator=gen, device=dev) - 2
        k.view(-1)[:lanes.numel()] = lanes
        k[1, ::7] = nan
        return k

    h8 = {}
    for dname, V in (("E bf16", E), ("D f32", D)):
        Hv, Wv = V.shape[1:]
        small = (slice(None), slice(0, Hv - 1), slice(0, Wv - 1))
        h8[f"{dname} {Hv - 1}x{Wv - 1} pixels"] = (V[small].contiguous(), slices((Hv - 1, Wv - 1)))
        h8[f"{dname}, E and k 1 element off"] = (_off_by_one(V), _off_by_one(slices((Hv, Wv))))
    for name, (Ev, kk) in h8.items():
        out, ref = vol.volume_sample(Ev, kk), vol.volume_sample_ref(Ev, kk)
        isn = torch.isnan(ref)
        exact = (torch.equal(torch.isnan(out), isn)
                 and torch.equal(out[~isn].view(torch.int32), ref[~isn].view(torch.int32)))
        log(f"kernel H8 edge case {name}: E {tuple(Ev.shape)} at byte offset "
            f"{Ev.data_ptr() % 16}, k at {kk.data_ptr() % 16} mod 16: bit-exact {exact}, NaN "
            f"outputs {int(isn.sum())} (tol: bit-exact, NaN where the plain version has NaN)")
        if not exact:
            raise AssertionError(f"H8 disagrees with its plain version ({name})")
    del h8
    torch.cuda.empty_cache()


def _median_plane_distance(coords, planes):
    """Median distance of the points to the nearest of the scene's planes
    (inf for no points)."""
    import numpy as np

    dist = np.full(coords.shape[0], np.inf)
    for pl in planes:
        dist = np.minimum(dist, np.abs((coords.astype(np.float64) - pl.p0) @ pl.n))
    return float(np.median(dist)) if len(coords) else float("inf")


def _run_counted(runner, *args, **kwargs):
    """``runner(*args, **kwargs)`` with every launch counter set to 0 just
    before and read just after; returns (result, wall seconds, launches)."""
    import torch

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = runner(*args, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {name: fn.launches for name, fn in counters.items()}


def _one_round_checks(tag, folder, depths, planes_s, ply):
    """The one-round scene's checks: every view's depth map finite at
    640x480 with a median relative error < 0.01 on interior pixels; > 1000
    fused points at a median point-to-plane distance < 0.05."""
    import numpy as np

    from apdmvs_tpu_torch.io import formats

    errs = []
    for v in range(V):
        d = formats.read_bin_mat(os.path.join(folder, "APD", formats.to_format_index(v),
                                              "depths.dmb"))
        if d.shape != (H, W) or not np.isfinite(d).all():
            raise AssertionError(f"{tag}: view {v} depth map {d.shape} not finite/expected shape")
        gt = depths[v]
        m = np.zeros_like(gt, bool)
        m[10:-10, 10:-10] = gt[10:-10, 10:-10] > 0
        errs.append(float(np.median(np.abs(d - gt)[m] / gt[m])))
    log(f"{tag}: median relative depth error per view "
        + ", ".join(f"{e:.5f}" for e in errs) + " (tol < 0.01 each)")
    if not max(errs) < 0.01:
        raise AssertionError(f"{tag}: depth error above 0.01")
    coords, _ = formats.read_point_cloud(ply)
    med = _median_plane_distance(coords, planes_s)
    log(f"{tag}: fused {len(coords)} points (tol > 1000), median plane distance "
        f"{med:.5f} (tol < 0.05)")
    if not (len(coords) > 1000 and med < 0.05 and np.isfinite(coords).all()):
        raise AssertionError(f"{tag}: fused cloud fails the thresholds")


def _check_launches(tag, launches, need):
    missing = [n for n in need if launches[n] == 0]
    if missing:
        raise AssertionError(f"{tag}: kernels not launched: {missing}")
    stray = [n for n in NOT_ON_MAIN_PATH if launches[n] != 0]
    if stray:
        raise AssertionError(f"{tag}: launched {stray}")


def phase_main_path(dev, inputs):
    """Phase 3; returns the launches, the per-pass view walls and the wall
    per view-pass."""
    import numpy as np

    from apdmvs_tpu_torch import scene
    from apdmvs_tpu_torch.datasets import synthetic

    cams_s, planes_s, images, depths, _, _ = inputs
    folder = os.path.join(ROOT, "_smoke_scene")
    shutil.rmtree(folder, ignore_errors=True)
    try:
        synthetic.write_mvsnet_dataset(folder, cams_s, planes_s, depth_ranges=(2.0, 8.0),
                                       images=images)
        run, wall, launches = _run_counted(scene.run_scene, folder, device="cuda",
                                           verbose=False)
        per_pass = {}
        for spec, problem, stats in run.passes:
            per_pass.setdefault(spec.pass_index, []).append(stats.seconds * 1e3)
        for p, ts in per_pass.items():
            log(f"main path pass {p}: " + ", ".join(f"{t:.1f}" for t in ts)
                + f" ms per view (mean {np.mean(ts):.1f} ms)")
        log(f"main path: {len(run.passes)} view-passes + fusion in {wall:.2f} s; launches "
            + json.dumps(launches))
        _check_launches("main path", launches, ONE_ROUND_KERNELS)
        _one_round_checks("main path", folder, depths, planes_s, run.ply)
        return launches, per_pass, 1e3 * wall / len(run.passes)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def flagship_state(dev, inputs):
    """Volumes, prior and worklist capacity of bench.py's flagship pass
    (``apdmvs_tpu_torch.bench.flagship_state``), with their build times."""
    from apdmvs_tpu_torch import bench

    _, _, images, depths, normals, cams = inputs
    vs, prior, cap, build_ms = bench.flagship_state(images, depths, normals, cams, K)
    log(f"flagship: image volumes (E, C36, C9) built in {build_ms[0]:.1f} ms, depth volumes "
        f"in {build_ms[1]:.1f} ms")
    return vs, prior, cap


def h5_read_figures(vol, pix):
    """The read side of H5 for slots at pixel offsets ``pix`` (int64, into
    each plane of ``vol``): distinct positions; distinct (slice, 32-byte
    sector) pairs the reads touch; and the mean number of distinct 128-byte
    lines one warp load touches: with a thread an element (lane l, slot
    l), in the kernel's layout (lane l owns slots G l .. G l + G-1, load g
    reads slot g of every lane, G = 16 bytes over the element size), and
    in that layout with each lane's slots sorted by position (what the
    kernel loads for bf16); and the (slice, sector) pairs summed over the
    kernel's blocks of 256 G slots (what L1 misses bring from L2 where no
    two blocks on one SM share a line)."""
    import torch

    Vs, Kv, PH, PW = vol.shape
    P, elem, plane = Vs * Kv, vol.element_size(), PH * PW
    positions = int(torch.unique(pix).numel())
    if plane * elem % 32 == 0:  # every plane starts on a sector: the same sectors each
        sectors = P * int(torch.unique(pix * elem // 32).numel())
    else:
        sectors = sum(int(torch.unique((p * plane + pix) * elem // 32).numel()) for p in range(P))
    G = 16 // elem
    tiles = pix.split(256 * G)
    block_sectors = P * sum(int(torch.unique(t * elem // 32).numel()) for t in tiles)
    pad = (-pix.numel()) % (32 * G)
    pix = torch.cat([pix, pix[-1:].expand(pad)])
    lines = pix * elem // 128
    by_lane = torch.sort(pix.reshape(-1, G), dim=1).values.reshape(-1) * elem // 128

    def mean_distinct(rows):
        srt = torch.sort(rows, dim=1).values
        return float((1 + (srt[:, 1:] != srt[:, :-1]).sum(1)).float().mean())

    def lanes(x):  # one row a warp load of the kernel's layout
        return x.reshape(-1, 32, G).transpose(1, 2).reshape(-1, 32)

    return (positions, sectors, mean_distinct(lines.reshape(-1, 32)),
            mean_distinct(lanes(lines)), mean_distinct(lanes(by_lane)), block_sectors)


def h6_ranges(k, num_slices: int, nearest: bool, width: int):
    """For each group of ``width`` neighbouring positions: the number of
    slices the lookups of all its candidates weigh, lowest to highest (NaN
    k excluded; <= 0 when every k is NaN): what staging the group's slice
    range in shared memory would read (a warp's 32 positions, a block's
    256)."""
    import torch

    R = k.shape[1]
    kc = torch.clamp(k, 0.0, num_slices - 1.0)
    i0 = torch.round(kc) if nearest else torch.floor(kc)
    top = i0 if nearest else torch.clamp(i0 + 1, max=num_slices - 1)
    nan = torch.isnan(kc)
    lo = torch.where(nan, float(num_slices), i0).amin(dim=0)
    hi = torch.where(nan, -1.0, top).amax(dim=0)
    pad = (-R) % width
    lo = torch.nn.functional.pad(lo, (0, pad), value=float(num_slices))
    hi = torch.nn.functional.pad(hi, (0, pad), value=-1.0)
    return (hi.reshape(-1, width).amax(1) - lo.reshape(-1, width).amin(1) + 1).long()


def quartiles(x):
    import torch

    return torch.quantile(x.float(), torch.tensor([0.25, 0.5, 0.75], device=x.device)).tolist()


def h6_large(dev, gen, R=2 ** 32 // K + 64):
    """H6 at K * R >= 2^32 (its 64-bit offsets): one view of 8.6 GB of bf16
    columns (values 0.5 .. 128 from the generator), B=2, against the lookups
    computed by gathers (the plain version's one-hot sums would need
    ~50 GB here)."""
    import torch

    from apdmvs_tpu_torch.ops import cols

    big = torch.randint(0x3F00, 0x4300, (1, K, R), dtype=torch.int16, generator=gen,
                        device=dev).view(torch.bfloat16)  # 0.5 .. 128
    big_k = (K - 1.0) * torch.rand((2, R), generator=gen, device=dev)
    big_k[0, :3] = torch.tensor([float("nan"), float("inf"), -1.0])
    for nearest in (False, True):
        out = cols.contract_lookup(big, big_k, nearest=nearest)
        ok, err, tol = check_h6(out, h6_gather_ref(big, big_k, nearest), nearest)
        log(f"kernel H6 edge case K * R = {K * R} ({'>=' if K * R >= 2 ** 32 else '<'} 2^32), "
            f"{'nearest' if nearest else 'tent'}: max abs {err:.3e} ({tol}) against gathers -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("H6 disagrees with the gathers at K * R >= 2^32")
    del big, big_k, out
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def h6_gather_ref(cols_t, k, nearest: bool):
    """H6's function by gathers of the one or two weighing slices, in the
    mirrors' arithmetic (for columns too large for the one-hot plain
    version)."""
    import torch

    Vs, Kt = cols_t.shape[:2]
    kc = torch.clamp(k, 0.0, Kt - 1.0)
    nan = torch.isnan(kc)
    kz = torch.where(nan, 0.0, kc)

    def at(i):
        return torch.gather(cols_t, 1, i[None].expand(Vs, -1, -1).contiguous()).float()

    if nearest:
        return torch.where(nan[:, None], 0.0, at(torch.round(kz).long()).transpose(0, 1))
    i0 = torch.floor(kz)
    w0 = torch.clamp(1.0 - torch.abs(kz - i0), min=0.0)
    two = i0 + 1 < Kt
    w1 = torch.where(two, torch.clamp(1.0 - torch.abs(kz - (i0 + 1)), min=0.0), 0.0)
    c0 = at(i0.long()).transpose(0, 1)
    c1 = at(torch.clamp(i0 + 1, max=Kt - 1).long()).transpose(0, 1)
    s = c0 * w0[:, None]
    s = torch.where(two[:, None], s + c1 * w1[:, None], s)
    return torch.where(nan[:, None], float("nan"), s)


def check_h6(out, ref, nearest):
    """H6 against its plain version: nearest bit-exact; tent within 1.2e-7
    with NaN where the plain version has NaN. Returns (ok, max abs, tol)."""
    import torch

    if nearest:
        return torch.equal(out, ref), float((out - ref).abs().max()), "bit-exact"
    same_nan = torch.equal(torch.isnan(out), torch.isnan(ref))
    fin = ~torch.isnan(ref)
    err = float((out[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
    return same_nan and err <= 1.2e-7, err, "<= 1.2e-7, NaN where the plain version has NaN"


def phase_cols(dev, inputs, flag):
    """H5 gather_cols and H6 contract_lookup against their plain versions at
    the flagship pass's shapes, with its anchors, and on edge cases."""
    import torch

    from apdmvs_tpu_torch import trace_pass
    from apdmvs_tpu_torch.ops import cols, ncc_volume as nv

    cams = inputs[-1]
    vs, prior, cap = flag
    weak_xy, a, wcols, k_c, k_a = trace_pass.weak_lookups(cams, vs, prior, cap, K)
    log(f"cols: worklist {cap} ({int((weak_xy[:, 0] >= 0).sum())} weak pixels), "
        f"{int((a[..., 0] >= 0).sum())} anchors found")
    rows = []

    # ---- H5 gather_cols: C36 and D at the weak pixels, C9 at the anchors
    cases = {
        "c36": (vs.C36, weak_xy[:, 0], weak_xy[:, 1], nv.PAD_Y, nv.PAD_X),
        "c9": (vs.C9, a[..., 0].reshape(-1), a[..., 1].reshape(-1), nv.PAD_Y, nv.PAD_X),
        "d": (vs.D, weak_xy[:, 0], weak_xy[:, 1], 0, 0),
    }

    def h5_exact(args):
        out, ref = cols.gather_cols(*args), cols.gather_cols_ref(*args)
        ibits = torch.int16 if args[0].dtype == torch.bfloat16 else torch.int32
        return out, torch.equal(out.view(ibits), ref.view(ibits))

    h5 = {}
    for name, args in cases.items():
        vol, xs, ys, py, px = args
        out, exact = h5_exact(args)
        log(f"kernel H5 gather_cols {name}: {tuple(out.shape)} {vol.dtype}, bit-exact {exact} "
            "(tol: bit-exact)")
        if not exact:
            raise AssertionError(f"H5 disagrees with its plain version ({name})")
        Vs, Kv, PH, PW = vol.shape
        yi = torch.clamp(ys + py, 0, PH - 1)
        xi = torch.clamp(xs + px, 0, PW - 1)
        ms = graph_ms(lambda: cols.gather_cols(*args))
        call = time_ms(lambda: cols.gather_cols(*args), 20)
        plain = time_ms(lambda: cols.gather_cols_ref(*args), 3, 1)
        lib = graph_ms(lambda: vol[:, :, yi, xi])
        M, elem = xs.shape[0], vol.element_size()
        positions, sectors, lines_e, lines_k, lines_s, blk = h5_read_figures(vol, yi * PW + xi)
        b_ms, b_by = bound((positions + M) * Vs * Kv * elem + 8 * M, 0.0)
        b_sec, _ = bound(sectors * 32 + M * Vs * Kv * elem + 8 * M, 0.0)
        log(f"kernel H5 gather_cols {name}: device {ms:.4f} ms, {call:.4f} ms a call (plain "
            f"{plain:.3f}, vol[:, :, ys, xs] device {lib:.4f}; bound {b_ms:.4f} by {b_by}, "
            f"{b_ms / ms:.2f} of it; M {M}, distinct positions {positions})")
        log(f"kernel H5 gather_cols {name}: reads touch {sectors} distinct (slice, 32-byte "
            f"sector) pairs, {sectors * 32 / 1e6:.1f} MB against the bound's "
            f"{positions * Vs * Kv * elem / 1e6:.1f} MB of elements (bound with whole sectors "
            f"{b_sec:.4f} ms); a warp load touches {lines_e:.2f} distinct 128-byte lines with a "
            f"thread an element, {lines_k:.2f} with a thread {16 // elem} slots, {lines_s:.2f} "
            f"with those sorted by position; blocks of {256 * 16 // elem} slots touch {blk} "
            f"(slice, sector) pairs, {blk * 32 / 1e6:.1f} MB from L2")
        h5[name] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    rows.append(dict(name="gather_cols", route="cuda", source="apdmvs_tpu_torch/csrc/gather_cols.cu",
                     replaces="apdmvs_tpu/ops/cols.py:50", max_abs_err=0.0, **h5["c9"]))
    # edge cases, each bit-exact: one slot; slot counts that leave a thread
    # ragged or rule out 16-byte stores; every coordinate -1; the anchor
    # pattern at its worst, 196608 slots over 100 positions
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    wx, wy = weak_xy[:, 0], weak_xy[:, 1]
    rep = torch.randint(0, 100, (196608,), generator=gen, device=dev)
    neg = torch.full((4099,), -1, dtype=torch.int64, device=dev)
    edge = {"C36, M = 1": (vs.C36, wx[:1], wy[:1], nv.PAD_Y, nv.PAD_X),
            "C36, M = 1001": (vs.C36, wx[:1001], wy[:1001], nv.PAD_Y, nv.PAD_X),
            "D, M = 1001": (vs.D, wx[:1001], wy[:1001], 0, 0),
            "C36, M = 12": (vs.C36, wx[:12], wy[:12], nv.PAD_Y, nv.PAD_X),
            "D, M = 14": (vs.D, wx[:14], wy[:14], 0, 0),
            "C9, every coordinate -1": (vs.C9, neg, neg, nv.PAD_Y, nv.PAD_X),
            "D, every coordinate -1": (vs.D, neg, neg, 0, 0),
            "C9, 196608 slots at 100 positions": (vs.C9, wx[rep], wy[rep], nv.PAD_Y, nv.PAD_X)}
    for name, args in edge.items():
        _, exact = h5_exact(args)
        log(f"kernel H5 edge case {name}: bit-exact {exact} (tol: bit-exact)")
        if not exact:
            raise AssertionError(f"H5 disagrees with its plain version ({name})")

    # ---- H6 contract_lookup on the lookups of a real flagship pass: the
    # first call of each kind (table, B) with its inputs, against the plain
    # version, timed; its costliest call is the kernels line's row
    h6, err_h6 = {}, 0.0
    for kind, (table, kb, nearest) in sorted(
            trace_pass.flagship_h6_calls(cams, vs, prior, cap, 7).items()):
        out = cols.contract_lookup(table, kb, nearest=nearest)
        ok, err, tol = check_h6(out, cols.contract_lookup_ref(table, kb, nearest=nearest), nearest)
        err_h6 = max(err_h6, err)
        log(f"kernel H6 contract_lookup, a pass's {kind}: {tuple(out.shape)}, max abs {err:.3e} "
            f"({tol}) -> {'ok' if ok else 'FAIL'}; NaN outputs {int(torch.isnan(out).sum())}")
        if not ok:
            raise AssertionError(f"H6 disagrees with its plain version (a pass's {kind})")
        ms = graph_ms(lambda: cols.contract_lookup(table, kb, nearest=nearest))
        call = time_ms(lambda: cols.contract_lookup(table, kb, nearest=nearest), 20)
        plain = time_ms(lambda: cols.contract_lookup_ref(table, kb, nearest=nearest), 2, 1)
        lib = None
        Vs, Kt, R = table.shape
        B = kb.shape[0]
        if nearest:  # one torch.gather along K computes the nearest lookup
            idx = torch.round(torch.nan_to_num(kb, nan=0.0).clamp(0, Kt - 1)).long()
            idx = idx[None].expand(Vs, -1, -1)
            lib = graph_ms(lambda: torch.gather(table, 1, idx))
        # bytes: the column elements these k touch (1 or 2 slices a lane),
        # k in, out written
        kc = torch.nan_to_num(kb, nan=0.0).clamp(0, Kt - 1)
        seen = torch.zeros((Kt, R), dtype=torch.bool, device=dev)
        lanes = torch.arange(R, device=dev)[None].expand(B, -1)
        if nearest:
            seen[torch.round(kc).long(), lanes] = True
        else:
            k0 = torch.floor(kc).long()
            seen[k0, lanes] = True
            seen[torch.clamp(k0 + 1, max=Kt - 1), lanes] = True
        touched = int(seen.sum()) * Vs
        b_ms, b_by = bound(touched * table.element_size() + B * R * 4 + B * Vs * R * 4,
                           B * Vs * R * 4.0)
        spans = []
        for width in (32, 256):
            span = h6_ranges(kb, Kt, nearest, width)
            q = quartiles(span[span > 0])
            staged = int(span[span > 0].sum()) * width * Vs * table.element_size()
            spans.append(f"{width} neighbouring positions weigh {q[0]:.0f} / {q[1]:.0f} / "
                         f"{q[2]:.0f} slices (quartiles, max {int(span.max())}), "
                         f"{staged / 1e6:.2f} MB if staged")
        lib_s = "none" if lib is None else f"{lib:.4f}"
        log(f"kernel H6 contract_lookup, a pass's {kind}: device {ms:.4f} ms, {call:.4f} ms a "
            f"call (plain {plain:.3f}, torch.gather device {lib_s}; bound {b_ms:.4f} by {b_by}, "
            f"{b_ms / ms:.2f} of it; column elements touched {touched}, "
            f"{touched * table.element_size() / 1e6:.2f} MB); the lookups of "
            + "; of ".join(spans))
        h6[kind] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    # edge cases, each against the plain version: the weak sweep's
    # candidates at the flagship worklist (B=10: 8 anchor planes, current,
    # fit; B=5: refinement combos; tent on C36/C9, nearest on D; lanes with
    # k NaN, +-inf, < 0 and > K-1); k in a 4-slice band and over all of K;
    # k in the last slices (up to K-1 and past it); R odd; B = 1 and B = 17;
    # columns 2 bytes past 16-byte alignment
    R9 = wcols.c9.shape[2]
    band = 40.0 + 4.0 * torch.rand((17, R9), generator=gen, device=dev)
    spread = (K - 1.0) * torch.rand((10, R9), generator=gen, device=dev)
    top = (K - 4.0) + 5.0 * torch.rand((10, R9), generator=gen, device=dev)
    c9_odd = wcols.c9[:, :, :1001].contiguous()
    flat = torch.empty(wcols.c9.numel() + 1, dtype=wcols.c9.dtype, device=dev)
    flat[1:] = wcols.c9.reshape(-1)
    c9_shifted = flat[1:].view(wcols.c9.shape)
    d_cols = wcols.d
    Rd = d_cols.shape[2]
    edge6 = {f"{name} B={B}": (table, kk[:B].contiguous(), nearest)
             for name, table, kk, nearest in (("c36 tent", wcols.c36, k_c, False),
                                              ("c9 tent", wcols.c9, k_a, False),
                                              ("d nearest", wcols.d, k_c, True))
             for B in (10, 5)}
    edge6.update({
        "c9 tent, k in a 4-slice band": (wcols.c9, band[:10], False),
        "c9 tent, k over all of K": (wcols.c9, spread, False),
        "c9 nearest, k over all of K": (wcols.c9, spread, True),
        "d nearest, k in a 4-slice band": (d_cols, band[:10, :Rd].contiguous(), True),
        "d nearest, k over all of K": (d_cols, spread[:, :Rd].contiguous(), True),
        "c9 tent, k in the last slices": (wcols.c9, top, False),
        "c9 nearest, k in the last slices": (wcols.c9, top, True),
        "c9 tent, R = 1001": (c9_odd, spread[:, :1001].contiguous(), False),
        "c9 tent, B = 1": (wcols.c9, band[:1], False),
        "c9 tent, B = 17": (wcols.c9, band, False),
        "c9 tent, columns 2 bytes past alignment": (c9_shifted, band[:10], False)})
    for name, (table, kb, nearest) in edge6.items():
        out = cols.contract_lookup(table, kb, nearest=nearest)
        ok, err, tol = check_h6(out, cols.contract_lookup_ref(table, kb, nearest=nearest), nearest)
        err_h6 = max(err_h6, err)
        log(f"kernel H6 edge case {name}: max abs {err:.3e} ({tol}) -> {'ok' if ok else 'FAIL'}; "
            f"NaN outputs {int(torch.isnan(out).sum())}")
        if not ok:
            raise AssertionError(f"H6 disagrees with its plain version ({name})")
    del flat, c9_shifted, c9_odd
    h6_large(dev, gen)
    worst = max(h6, key=lambda kind: h6[kind]["ms"])
    log(f"kernel H6 contract_lookup: the kernels line holds a pass's {worst}")
    rows.append(dict(name="contract_lookup", route="cuda",
                     source="apdmvs_tpu_torch/csrc/contract_lookup.cu",
                     replaces="apdmvs_tpu/ops/cols.py:335", max_abs_err=err_h6, **h6[worst]))
    torch.cuda.synchronize()
    return rows, (weak_xy, a)


def phase_ops(dev, inputs, flag, worklist):
    """The ops entry points that no default path calls, at full width: H8
    ``volume_sample`` on E and D at view 0's ground truth, H7
    ``gather_rows`` / ``gather_rows_sorted`` on the flagship's position-major
    tables at its worklist, and H2 on K10's case (a depth-edge candidate
    group). One counted run of every entry point, then each output against
    its plain version (and H7 against H5's columns), times and bounds."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from apdmvs_tpu_torch import geometry, ncc, sampling
    from apdmvs_tpu_torch.ops import cols, ncc_volume as nv, volume as vol

    t_phase = time.perf_counter()
    _, _, images, depths, normals, cams = inputs
    vs = flag[0]
    weak_xy, a = worklist
    u_min, du = vs.u_grid
    PY, PX = nv.PAD_Y, nv.PAD_X
    Hp, Wp = ncc._ceil_to(H, nv.NCC_TILE_H), ncc._ceil_to(W, nv.TILE_W)
    PH, PW = Hp + 2 * PY, Wp + 2 * PX
    dm0 = torch.as_tensor(depths[0], device=dev)
    gt = torch.where(dm0 > 0, dm0, torch.full_like(dm0, 4.0))
    nan, inf = float("nan"), float("inf")

    def slice_map(depth):
        """k of ``depth`` with lanes of k NaN, +-inf, < 0, > K-1, exactly
        K-1, integers (rows 0-2: padding rows of E's grid)."""
        k = vol.depth_to_slice(depth, u_min, du)
        k[0, :10] = torch.tensor([nan, inf, -inf, -5.0, K + 10.0, K - 1.0, 0.0, 7.0, 31.0,
                                  K - 2.0])
        k[1, ::7] = nan
        k[2] = torch.floor(k[2])
        return k.contiguous()

    k_E = slice_map(ncc._edge_pad(gt, PY, PY + Hp - H, PX, PX + Wp - W))
    k_D = slice_map(gt)
    wx, wy = weak_xy[:, 0], weak_xy[:, 1]
    ax, ay = a[..., 0].reshape(-1), a[..., 1].reshape(-1)
    idx_s, order = torch.sort(cols.flat_index(wx, wy, PY, PX, PH, PW), stable=True)
    # name: (entry, volume, index, worklist xs, ys, pad_y, pad_x)
    gcases = {
        "c9 anchors": (cols.gather_rows, vs.C9, cols.flat_index(ax, ay, PY, PX, PH, PW), ax, ay,
                       PY, PX),
        "c36 sorted": (cols.gather_rows_sorted, vs.C36, idx_s, wx[order], wy[order], PY, PX),
        "d": (cols.gather_rows, vs.D, cols.flat_index(wx, wy, 0, 0, H, W), wx, wy, 0, 0),
    }
    # materialised once, as the reference package's tables are (the port's
    # pack_volume_rows is a transposed view, which the wrapper would copy)
    tables = {name: cols.pack_volume_rows(c[1]).contiguous() for name, c in gcases.items()}
    x, y = geometry.pixel_grid(H, W, dev)
    n_cam = geometry.normal_world_to_cam(cams.R[0], torch.as_tensor(normals[0], device=dev))
    rand = torch.as_tensor(np.random.RandomState(3).uniform(1.2, 9.6, (H, W)), device=dev,
                           dtype=torch.float32)
    pcf = ncc._pad_planes_cf(torch.stack([
        torch.cat([n_cam, geometry.dist_to_origin(cams.K[0], x, y, d, n_cam)[..., None]], -1)
        for d in (gt, rand)]), Hp, Wp)
    E0, ref_pad, consts = vs.E[0], vs.ref_pad, vs.consts[0]
    base_k = ncc._base_slice_map(vs, gt)
    torch.cuda.synchronize()

    # ---- the counted run: every entry point once
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    out_E = vol.volume_sample(E0, k_E)
    out_D = vol.volume_sample(vs.D[0], k_D)
    got_rows = {name: c[0](tables[name], c[2]) for name, c in gcases.items()}
    cost = nv.ncc_volume_cost_view(E0, ref_pad, pcf, consts, K)
    # K4's counterpart and H2's two rebased entries (which read E alone)
    rebased = {}
    for j2, entry in ((nv.J2_REBASE, nv.ncc_rebased_cost_view),
                      (nv.SWEEP_J2, nv.ncc_rebased_sweep_cost_view)):
        R, bf = nv.build_rebased_view(E0, base_k, K, j2=j2)
        rebased[entry.__name__] = (R, bf, entry(R, bf, E0, ref_pad, pcf, consts, K))
    torch.cuda.synchronize()
    launches = {n: counters[n].launches for n in OPS_KERNELS}
    log("ops: launches of one run of the entry points (these kernels run on no default path; "
        "their launches in the kernels line are these) " + json.dumps(launches))
    missing = [n for n in OPS_KERNELS if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the ops entry points: {missing}")
    rows = []

    # ---- H8 volume_sample: bit-exact, NaN where the plain version has NaN
    h8, err_h8 = {}, 0.0
    for name, Ev, kk, out in (("E", E0, k_E, out_E), ("D", vs.D[0], k_D, out_D)):
        ref = vol.volume_sample_ref(Ev, kk)
        isn = torch.isnan(ref)
        exact = (torch.equal(torch.isnan(out), isn)
                 and torch.equal(out[~isn].view(torch.int32), ref[~isn].view(torch.int32)))
        err = float((out[~isn] - ref[~isn]).abs().max())
        err_h8 = max(err_h8, err)
        log(f"kernel H8 volume_sample {name}: {tuple(Ev.shape)} {Ev.dtype} -> {tuple(out.shape)}, "
            f"bit-exact {exact}, NaN outputs {int(isn.sum())} (tol: bit-exact, NaN where the "
            "plain version has NaN)")
        if not exact:
            raise AssertionError(f"H8 disagrees with its plain version ({name})")
        ms = graph_ms(lambda: vol.volume_sample(Ev, kk))
        call = time_ms(lambda: vol.volume_sample(Ev, kk), 20)
        plain = graph_ms(lambda: vol.volume_sample_ref(Ev, kk), 5)
        # library yardstick: one trilinear grid_sample over E as a 5-D volume
        # (f32: grid and input share a dtype) at pixel centres and z = k
        Kv, Hv, Wv = Ev.shape
        Ef = Ev.float()[None, None]
        gy, gx = torch.meshgrid(torch.arange(Hv, device=dev, dtype=torch.float32),
                                torch.arange(Wv, device=dev, dtype=torch.float32), indexing="ij")
        grid = torch.stack([gx / (Wv - 1) * 2 - 1, gy / (Hv - 1) * 2 - 1,
                            kk / (Kv - 1) * 2 - 1], -1)[None, None]
        lib_out = F.grid_sample(Ef, grid, mode="bilinear", padding_mode="border",
                                align_corners=True)[0, 0, 0]
        fin = torch.isfinite(kk)
        lib_err = float((lib_out[fin] - ref[fin]).abs().max())
        lib = None
        if lib_err <= LIB_TOL:
            lib = graph_ms(lambda: F.grid_sample(Ef, grid, mode="bilinear", padding_mode="border",
                                                 align_corners=True))
        # bytes: the distinct elements of the two slices each pixel reads, k
        # in, out written; 5 f32 operations a pixel
        k0 = torch.floor(torch.nan_to_num(kk, nan=0.0).clamp(0, Kv - 1))
        distinct = kk.numel() + int((torch.clamp(k0 + 1, max=Kv - 1) != k0).sum())
        b_ms, b_by = bound(distinct * Ev.element_size() + 2 * kk.numel() * 4, 5.0 * kk.numel())
        lib_s = "none" if lib is None else f"{lib:.4f}"
        log(f"kernel H8 volume_sample {name}: {ms:.4f} ms device, {call:.4f} ms a call (plain "
            f"{plain:.4f}, grid_sample {lib_s} (max abs {lib_err:.3e} from the plain version on "
            f"finite k, tol {LIB_TOL}), bound {b_ms:.4f} by {b_by}; elements read {distinct})")
        h8[name] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        del Ef, grid, lib_out
    # the property of tests/test_volume.py:54-90: E sampled at k(depth)
    # against the direct bilinear warp of the source image
    wc = geometry.warp_constants(cams)
    q = (geometry.mat3_vec(wc.M[1], geometry.pixel_dirs(cams.K[0], x, y))
         + wc.b[1] * (1.0 / gt)[..., None])
    sx, sy = q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]
    direct = sampling.bilinear_sample(torch.as_tensor(images[1], device=dev), sx, sy)
    inb = (dm0 > 0) & (sx > 1) & (sx < W - 2) & (sy > 1) & (sy < H - 2)
    diff = (out_E[PY:PY + H, PX:PX + W] - direct).abs()[inb]
    med, under = float(diff.median()), float((diff < 8.0).float().mean())
    log(f"ops: E sampled at k(depth) vs the direct warp over {int(inb.sum())} pixels: median "
        f"{med:.4f} grey levels (tol < 2.0), {100 * under:.3f}% under 8.0 (tol > 95%)")
    if not (med < 2.0 and under > 0.95):
        raise AssertionError("volume_sample through E strays from the direct warp")
    rows.append(dict(name="volume_sample", route="cuda",
                     source="apdmvs_tpu_torch/csrc/volume_sample.cu",
                     replaces="apdmvs_tpu/ops/volume.py:375", launches=launches["volume_sample"],
                     max_abs_err=err_h8, **h8["E"]))

    # ---- H7 gather_rows / gather_rows_sorted: bit-exact, and H5's columns
    h7, err_h7 = {}, 0.0
    for name, (entry, volm, idx, xs, ys, py, px) in gcases.items():
        table, out = tables[name], got_rows[name]
        ref = cols.gather_rows_ref(table, idx)
        bits = torch.int16 if table.dtype == torch.bfloat16 else torch.int32
        exact = torch.equal(out.view(bits), ref.view(bits))
        Vs, Kv = volm.shape[:2]
        same = torch.equal(out.reshape(-1, Vs, Kv).permute(1, 2, 0).contiguous().view(bits),
                           cols.gather_cols(volm, xs, ys, py, px).view(bits))
        err = float((out.float() - ref.float()).abs().max())
        err_h7 = max(err_h7, err)
        log(f"kernel H7 {entry.__name__} {name}: table {tuple(table.shape)} {table.dtype} -> "
            f"{tuple(out.shape)}, bit-exact {exact}, equals gather_cols's columns {same} "
            "(tol: bit-exact)")
        if not (exact and same):
            raise AssertionError(f"H7 disagrees with its plain version or H5 ({name})")
        ms = graph_ms(lambda: entry(table, idx))
        call = time_ms(lambda: entry(table, idx), 20)
        plain = graph_ms(lambda: cols.gather_rows_ref(table, idx), 5)
        idx_cl = torch.clamp(idx, 0, table.shape[0] - 1)
        lib = graph_ms(lambda: torch.index_select(table, 0, idx_cl))
        M, row_bytes = idx.numel(), table.shape[1] * table.element_size()
        distinct = int(torch.unique(idx_cl).numel())
        b_ms, b_by = bound((distinct + M) * row_bytes + M * idx.element_size(), 0.0)
        log(f"kernel H7 {entry.__name__} {name}: {ms:.4f} ms device, {call:.4f} ms a call "
            f"(plain {plain:.4f}, index_select {lib:.4f}, {lib / ms:.3f}x the kernel's time; "
            f"bound {b_ms:.4f} by {b_by}, {b_ms / ms:.2f} of it; M {M}, distinct rows "
            f"{distinct})")
        h7[name] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    rows.append(dict(name="gather_rows", route="cuda", source="apdmvs_tpu_torch/csrc/gather_rows.cu",
                     replaces="apdmvs_tpu/ops/cols.py:151",
                     launches=launches["gather_rows"] + launches["gather_rows_sorted"],
                     max_abs_err=err_h7, **h7["c36 sorted"]))
    # edge cases of the kernel's paths and unit widths, each bit-exact:
    # one row; a row count that leaves the last block part-full; indices
    # out of range at both ends; 72-byte rows (8-byte units); a contiguous
    # view that starts 2 bytes past an aligned base (2-byte units); int32
    # indices; and the same on D's rows, which take the warp-a-row path
    c36, idx36 = tables["c36 sorted"], gcases["c36 sorted"][2]
    R36 = c36.shape[0]
    flat = c36.reshape(-1)
    shifted = flat[1:1 + (R36 - 1) * c36.shape[1]].view(R36 - 1, c36.shape[1])
    ends = torch.cat([torch.tensor([-5, -1, R36, R36 + 100], device=dev), idx36[:1001]])
    dtab, idxd = tables["d"], gcases["d"][2]
    ends_d = torch.cat([torch.tensor([-5, -1, dtab.shape[0], dtab.shape[0] + 100], device=dev),
                        idxd[:1001]])
    edge = {"M = 1": (c36, idx36[:1]), "M = 1001": (c36, idx36[:1001]),
            "indices out of range": (c36, ends),
            "72-byte rows": (c36[:, :36].contiguous(), idx36),
            "table 2 bytes past alignment": (shifted, idx36.clamp(max=R36 - 2)),
            "int32 indices": (c36, idx36.to(torch.int32)),
            "D rows, M = 1": (dtab, idxd[:1]),
            "D rows, indices out of range": (dtab, ends_d),
            "D rows, int32 indices": (dtab, ends_d.to(torch.int32))}
    for name, (table, idx) in edge.items():
        out, ref = cols.gather_rows_sorted(table, idx), cols.gather_rows_ref(table, idx)
        exact = torch.equal(out.view(torch.int16), ref.view(torch.int16))
        log(f"kernel H7 edge case {name}: table {tuple(table.shape)} at byte offset "
            f"{table.data_ptr() % 16} mod 16, idx {tuple(idx.shape)} {idx.dtype}: bit-exact "
            f"{exact} (tol: bit-exact)")
        if not exact:
            raise AssertionError(f"H7 disagrees with its plain version ({name})")
    del tables, got_rows, shifted

    # ---- H2 on K10's case: the ground-truth plane and a random-depth plane
    # in one candidate group, so a tile's slices span nearly all of K
    ref = nv.ncc_volume_cost_ref(E0, ref_pad, pcf, consts, K)
    err = float((cost - ref).abs().max())
    kc = vol.depth_to_slice(torch.stack([gt, rand]), u_min, du).clamp(0, K - 1)
    tiles = kc.reshape(2, H // nv.NCC_TILE_H, nv.NCC_TILE_H, W // nv.TILE_W, nv.TILE_W)
    span = tiles.amax(dim=(0, 2, 4)) - tiles.amin(dim=(0, 2, 4))
    wide = int((span > 2 * BAND2).sum())
    log(f"kernel H2 ncc_cost K10 case (C=2, ground truth + random depth): max abs {err:.3e} "
        f"(tol 1e-4); {wide} of {span.numel()} tiles span more than two {BAND2}-slice bands")
    if not (err < 1e-4 and wide > 0):
        raise AssertionError("H2 fails K10's case, or the case has no tile the bands miss")
    ms = graph_ms(lambda: nv.ncc_volume_cost_view(E0, ref_pad, pcf, consts, K))
    call = time_ms(lambda: nv.ncc_volume_cost_view(E0, ref_pad, pcf, consts, K), 20)
    plain = time_ms(lambda: nv.ncc_volume_cost_ref(E0, ref_pad, pcf, consts, K), 3, 1)
    (b_ms, b_by), touched = h2_bound(pcf, consts)
    log(f"kernel H2 ncc_cost K10 case: device {ms:.4f} ms, {call:.4f} ms a call (plain "
        f"{plain:.3f}, bound {b_ms:.4f} by {b_by}; E elements touched {touched}, "
        f"{touched / (PH * PW):.2f} slices a pixel); no single PyTorch call computes it")

    # ---- H3 and H2's rebased entries: H3 bit-exact, the entries as H2 from E
    for name, (R, bf, got) in rebased.items():
        j2 = R.shape[0]
        R_ref, bf_ref = nv.build_rebased_view_ref(E0, base_k, K, j2=j2)
        exact = torch.equal(R.view(torch.int16), R_ref.view(torch.int16)) and torch.equal(bf, bf_ref)
        err_e = float((got - cost).abs().max())
        log(f"ops: H3 rebase_view j2={j2} bit-exact {exact} (tol: bit-exact); {name} through it "
            f"max abs {err_e:.3e} from H2 on E (tol: 0)")
        if not (exact and err_e == 0.0):
            raise AssertionError(f"H3 or {name} disagrees")
    del rebased
    torch.cuda.synchronize()
    log(f"ops: phase took {time.perf_counter() - t_phase:.2f} s")
    return rows, launches


def _depth_errors(depth, gt, mask):
    import numpy as np

    m = mask & (gt > 0)
    return float(np.median(np.abs(depth - gt)[m] / gt[m]))


def phase_flagship(dev, inputs, flag):
    """bench.py's program through the port (``apdmvs_tpu_torch.bench``'s
    flagship pass): one warm-up, then 5 timed passes."""
    import numpy as np
    import torch

    from apdmvs_tpu_torch import bench

    depths = inputs[3]
    vs, prior, cap = flag

    def run(seed):
        return bench.flagship_pass(inputs[-1], vs, prior, cap, seed)

    run(0)
    torch.cuda.synchronize()
    counters = _counters()
    walls, launches = [], None
    for rep in range(5):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = run(rep + 1)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        if launches is None:
            launches = {name: fn.launches for name, fn in counters.items()}
    log(f"flagship pass (REFINE_ITER + geom + APD, {W}x{H}x{V}, worklist "
        f"{cap}): " + ", ".join(f"{w:.1f}" for w in walls)
        + f" ms; median {float(np.median(walls)):.1f} ms; launches in one pass "
        + json.dumps(launches))
    stray = [n for n in NOT_ON_MAIN_PATH if launches[n] != 0]
    if stray or launches["geom_cost_views"] == 0:
        raise AssertionError(f"the flagship pass launched {stray} or no geom_cost_views")
    d = out.depth.cpu().numpy()
    gt = depths[0]
    interior = np.zeros((H, W), bool)
    interior[10:-10, 10:-10] = True
    box = np.zeros((H, W), bool)
    box[H // 2 - H // 8:H // 2 + H // 8, W // 2 - W // 8:W // 2 + W // 8] = True
    e_int, e_box = _depth_errors(d, gt, interior), _depth_errors(d, gt, box)
    log(f"flagship pass: median relative depth error interior {e_int:.5f}, weak box "
        f"{e_box:.5f} (tol < 0.01 each)")
    if not (np.isfinite(d).all() and e_int < 0.01 and e_box < 0.01):
        raise AssertionError("flagship pass fails its depth checks")
    return walls, launches


def _erode(mask, r):
    import numpy as np

    out = mask.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out &= np.roll(np.roll(mask, dy, 0), dx, 1)
    return out


def _two_round_scene(folder):
    """The 1280x960 five-view scene with a textureless window (focal 1600:
    the field of view of the reference package's weak-path test scene),
    written to ``folder``; returns its images, depths and planes."""
    from apdmvs_tpu_torch.datasets import synthetic
    from apdmvs_tpu_torch.params import compute_round_num

    cams_s, planes_s = synthetic.make_ring_scene(num_views=V, width=W2, height=H2, focal=1600.0,
                                                 include_flat_region=True)
    images, depths, _ = synthetic.render_scene(cams_s, planes_s)
    rounds = compute_round_num(W2, H2)
    if rounds != 2:
        raise AssertionError(f"compute_round_num gives {rounds} rounds, not 2")
    shutil.rmtree(folder, ignore_errors=True)
    synthetic.write_mvsnet_dataset(folder, cams_s, planes_s, depth_ranges=(2.0, 8.0),
                                   images=images)
    return cams_s, images, depths, planes_s


def _two_round_checks(tag, folder, images, depths, planes_s, run, launches):
    """Phase 7's checks: H1, H2, H4, H5, H6 launched and no stray entry;
    > 1000 weak pixels enter round 1's REFINE_INIT pass of view 0; per-view
    median relative depth error < 0.01 on interior pixels, < 0.02 on view
    0's textureless core; > 1000 fused points at a median point-to-plane
    distance < 0.05."""
    import numpy as np

    from apdmvs_tpu_torch.io import formats

    _check_launches(tag, launches, TWO_ROUND_KERNELS)
    weak_in = next(st for spec, problem, st in run.passes
                   if spec.round_index == 1 and spec.state.name == "REFINE_INIT"
                   and problem.ref_image_id == 0).weak_in
    log(f"{tag}: {weak_in} weak pixels enter round 1's REFINE_INIT pass of view 0 "
        "(tol > 1000)")
    if not weak_in > 1000:
        raise AssertionError(f"{tag}: too few weak pixels enter round 1")
    errs, d0 = [], None
    interior = np.zeros((H2, W2), bool)
    interior[10:-10, 10:-10] = True
    for v in range(V):
        d = formats.read_bin_mat(os.path.join(folder, "APD", formats.to_format_index(v),
                                              "depths.dmb"))
        if d.shape != (H2, W2) or not np.isfinite(d).all():
            raise AssertionError(f"{tag}: view {v} depth map {d.shape} not finite/expected shape")
        errs.append(_depth_errors(d, depths[v], interior))
        d0 = d if v == 0 else d0
    flat_core = _erode(np.abs(images[0] - 128.0) < 1e-3, 8)
    e_flat = _depth_errors(d0, depths[0], flat_core)
    log(f"{tag}: median relative depth error per view "
        + ", ".join(f"{e:.5f}" for e in errs) + f" (tol < 0.01 each); view 0 flat core "
        f"({int(flat_core.sum())} px) {e_flat:.5f} (tol < 0.02)")
    if not (max(errs) < 0.01 and e_flat < 0.02):
        raise AssertionError(f"{tag}: depth checks fail")
    coords, _ = formats.read_point_cloud(run.ply)
    med = _median_plane_distance(coords, planes_s)
    log(f"{tag}: fused {len(coords)} points (tol > 1000), median plane distance "
        f"{med:.5f} (tol < 0.05)")
    if not (len(coords) > 1000 and med < 0.05 and np.isfinite(coords).all()):
        raise AssertionError(f"{tag}: fused cloud fails the thresholds")


def phase_two_rounds(dev, folder):
    """The two-round scene through ``scene.run_scene``: two rounds, the
    second with the APD weak machinery. Leaves its outputs in ``folder``
    for the fusion phase; returns the launches, the scene's planes and the
    wall per view-pass."""
    import numpy as np
    import torch

    from apdmvs_tpu_torch import geometry, ncc, scene

    cams_s, images, depths, planes_s = _two_round_scene(folder)
    cams = geometry.make_cameras(
        np.stack([c.K for c in cams_s]), np.stack([c.R for c in cams_s]),
        np.stack([c.t for c in cams_s]), np.full(V, 1.2), np.full(V, 9.6), device=dev)
    imgs = torch.as_tensor(images, device=dev)
    ncc.build_image_volume_set(imgs, cams, 1.2, 9.6, num_slices=K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vs = ncc.build_image_volume_set(imgs, cams, 1.2, 9.6, num_slices=K)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in vs if isinstance(t, torch.Tensor))
    log(f"two rounds: one image-volume set at {W2}x{H2} (E, C36, C9) builds in "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms, {nbytes / 1e9:.2f} GB; the default cache "
        f"holds all {V}: {V * nbytes <= scene.volume_cache_budget(dev, V, H2, W2, K)}")
    del vs, imgs
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    run, wall, launches = _run_counted(scene.run_scene, folder, device="cuda", verbose=False)
    per_pass = {}
    for spec, problem, stats in run.passes:
        per_pass.setdefault((spec.round_index, spec.pass_index, spec.state.name),
                            []).append(stats)
    for (r, p, state), st in per_pass.items():
        log(f"two rounds: round {r} pass {p} {state}: "
            + ", ".join(f"{s.seconds * 1e3:.1f}" for s in st) + " ms per view; weak in "
            + ", ".join(str(s.weak_in) for s in st))
    log(f"two rounds: {len(run.passes)} view-passes + fusion in {wall:.2f} s, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        + json.dumps(launches))
    _two_round_checks("two rounds", folder, images, depths, planes_s, run, launches)
    return launches, planes_s, 1e3 * wall / len(run.passes)


def phase_quality(dev):
    """The four scene families of ``apdmvs_tpu_torch.quality_table`` on the
    card: each row beside the JAX package's round-4 F1 on a TPU, held to the
    JAX package's floors (tests/test_quality.py); H1, H2 and H4 must launch
    on every family, H5 and H6 on multiround (two rounds)."""
    from apdmvs_tpu_torch import quality_table as qt
    from apdmvs_tpu_torch.bench import device_name

    root = os.path.join(ROOT, "_smoke_quality")
    counters = _counters()
    rows, failed = [], []
    try:
        for fam in qt.FAMILIES:
            for fn in counters.values():
                fn.launches = 0
            row = qt.run_family(fam, root, dev)
            launches = {name: fn.launches for name, fn in counters.items()}
            rows.append(row)
            floors = qt.FLOORS[fam]
            log(f"quality {fam}: {row['points']} points, accuracy {row['accuracy']:.4f}, "
                f"completeness {row['completeness']:.4f}, F1 {row['f1']:.4f} (round 4, JAX "
                f"package on a TPU: {row['round4_f1']}; F1 - round 4 "
                f"{row['f1'] - row['round4_f1']:+.4f}) in {row['seconds']:.2f} s; floors: "
                f"points > {floors[0]}, accuracy > {floors[1]}, F1 > {floors[2]}; launches "
                + json.dumps({n: launches[n] for n in TWO_ROUND_KERNELS}))
            need = TWO_ROUND_KERNELS if fam == "multiround" else ONE_ROUND_KERNELS
            missing = [n for n in need if launches[n] == 0]
            if missing:
                failed.append(f"{fam}: kernels not launched {missing}")
            below = qt.below_floors(row)
            if below:
                failed.append(f"{fam}: below the floors {below}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for ln in qt.markdown(rows, device_name(dev)).splitlines():
        log(f"quality: {ln}")
    if failed:
        raise AssertionError("quality phase: " + "; ".join(failed))
    return rows


def phase_fusion(dev, folder, planes):
    """The four fusion variants through ``scene.run_fusion`` on the outputs
    the two-round phase left in ``folder``: each timed twice with the host
    clock (after a device synchronise, ending in one), loading the views
    included (the load alone is timed too); ``eth-device`` is held to
    ``eth``'s point count within 1 % and, as every variant, to a median
    distance to the scene's planes below 0.01 (the JAX package's bounds,
    tests/test_fusion_device.py)."""
    import numpy as np
    import torch

    from apdmvs_tpu_torch import scene
    from apdmvs_tpu_torch.io import formats

    problems = scene.generate_sample_list(folder)
    t0 = time.perf_counter()
    scene._load_fusion_views(folder, problems)
    log(f"fusion: loading the {len(problems)} views' outputs takes "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms")
    points = {}
    for variant in scene.FUSION_VARIANTS:
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ply = scene.run_fusion(folder, problems, variant, out_name=f"fused_{variant}.ply",
                                   device=dev)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        coords, colors = formats.read_point_cloud(ply)
        med = _median_plane_distance(coords, planes)
        points[variant] = len(coords)
        log(f"fusion {variant}: {len(coords)} points, median plane distance {med:.5f} "
            f"(tol < 0.01), " + ", ".join(f"{w:.1f}" for w in walls) + " ms (views loaded "
            "and fused, PLY written)")
        if not (len(coords) > 1000 and med < 0.01 and np.isfinite(coords).all()
                and colors.shape == coords.shape):
            raise AssertionError(f"fusion {variant} fails its checks")
    rel = abs(points["eth-device"] - points["eth"]) / points["eth"]
    log(f"fusion: eth-device {points['eth-device']} points against eth {points['eth']}, "
        f"relative difference {rel:.5f} (tol < 0.01)")
    if not rel < 0.01:
        raise AssertionError("eth-device disagrees with eth on the point count")
    return points


def phase_bench(dev):
    """``python -m apdmvs_tpu_torch.bench``'s measurement (its defaults:
    640x480x5, 5 repeats, 4 batched problems); its JSON line is printed."""
    import torch

    from apdmvs_tpu_torch import bench

    row, out = bench.measure(device=dev)
    if not (row["value"] > 0 and row["batched_maps_per_sec"] > 0
            and bool(torch.isfinite(out.depth).all())):
        raise AssertionError(f"bench gives {row['value']} depth-maps/s or non-finite depths")
    log(f"bench: {row['value']:.4f} depth-maps/s (flagship pass {row['pass_ms']:.2f} ms); "
        f"batched_maps_per_sec {row['batched_maps_per_sec']:.4f} ({row['batched_problems']} "
        f"problems, {row['batched_pinned']} sets pinned, batch pass {row['batched_ms']:.2f} ms, "
        f"pinned sets built in {row['batched_prebuild_ms']:.2f} ms)")
    print(json.dumps(row), flush=True)
    return row


def _log_batched_passes(tag, run):
    """One line a pass of a batched run: the batch's wall (the per-view
    stats carry it divided over the views) and the WEAK pixels in."""
    seen = {}
    for spec, problem, st in run.passes:
        seen.setdefault((spec.round_index, spec.pass_index, spec.state.name), []).append(st)
    for (r, p, state), sts in seen.items():
        log(f"{tag}: round {r} pass {p} {state}: batch of {len(sts)} views "
            f"{sum(st.seconds for st in sts) * 1e3:.1f} ms; weak in "
            + ", ".join(str(st.weak_in) for st in sts))


def _batched_run(folder, **kwargs):
    """``scene.run_scene_batched`` on the card with its report captured; its
    volume-cache lines (the sets pinned per scale) are logged."""
    import contextlib
    import io

    from apdmvs_tpu_torch import scene

    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        run = scene.run_scene_batched(folder, device="cuda", **kwargs)
    for ln in report.getvalue().splitlines():
        if ln.startswith(("volume cache", "compiled pass:")):
            log(f"batched runner: {ln}")
    return run


def _state_files(folder):
    """The bytes of every view's four state files, by (view, file name)."""
    states = {}
    root = os.path.join(folder, "APD")
    for view in sorted(os.listdir(root)):
        for name in STATE_FILES:
            path = os.path.join(root, view, name)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    states[(view, name)] = f.read()
    return states


def phase_batched(dev, inputs, walls):
    """Phase 11: the one-round 640x480x5 scene and the 1280x960 two-round
    scene through ``scene.run_scene_batched`` on the card, each with the
    launch counters zeroed just before and read just after, held to the
    checks of phases 3 and 7; the walls per view-pass beside theirs
    (``walls``). Returns both walls and both runs' state files (phase 13
    compares with them)."""
    from apdmvs_tpu_torch.datasets import synthetic

    cams_s, planes_s, images, depths, _, _ = inputs
    folder = os.path.join(ROOT, "_smoke_batched")
    shutil.rmtree(folder, ignore_errors=True)
    try:
        synthetic.write_mvsnet_dataset(folder, cams_s, planes_s, depth_ranges=(2.0, 8.0),
                                       images=images)
        run, wall, launches = _run_counted(_batched_run, folder)
        _log_batched_passes("batched", run)
        ms = 1e3 * wall / len(run.passes)
        log(f"batched: {len(run.passes)} view-passes + fusion in {wall:.2f} s, {ms:.1f} ms a "
            f"view-pass (sequential, phase 3: {walls['one round']:.1f}); launches "
            + json.dumps(launches))
        _check_launches("batched", launches, ONE_ROUND_KERNELS)
        _one_round_checks("batched", folder, depths, planes_s, run.ply)
        states = {"one round": _state_files(folder)}
    finally:
        shutil.rmtree(folder, ignore_errors=True)

    folder = os.path.join(ROOT, "_smoke_batched_2r")
    try:
        _, images2, depths2, planes2 = _two_round_scene(folder)
        run, wall, launches = _run_counted(_batched_run, folder)
        _log_batched_passes("batched two rounds", run)
        ms2 = 1e3 * wall / len(run.passes)
        log(f"batched two rounds: {len(run.passes)} view-passes + fusion in {wall:.2f} s, "
            f"{ms2:.1f} ms a view-pass (sequential, phase 7: {walls['two rounds']:.1f}); "
            "launches " + json.dumps(launches))
        _two_round_checks("batched two rounds", folder, images2, depths2, planes2, run,
                          launches)
        states["two rounds"] = _state_files(folder)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return ms, ms2, states


def phase_direct(dev, inputs, walls):
    """Phase 12: the one-round 640x480x5 scene through
    ``scene.run_scene_batched(use_volumes=False)``, then the flagship APD
    pass with ``volumes=None`` once (its stages timed), each with the launch
    counters zeroed just before and read just after: every counter must stay
    at 0; phase 3's checks, and the flagship's median relative depth error <
    0.01 over interior pixels and over the weak box."""
    import numpy as np
    import torch

    from apdmvs_tpu_torch import bench, pipeline, rng
    from apdmvs_tpu_torch.datasets import synthetic
    from apdmvs_tpu_torch.profile_stages import _stage_timed

    cams_s, planes_s, images, depths, normals, cams = inputs
    folder = os.path.join(ROOT, "_smoke_direct")
    shutil.rmtree(folder, ignore_errors=True)
    try:
        synthetic.write_mvsnet_dataset(folder, cams_s, planes_s, depth_ranges=(2.0, 8.0),
                                       images=images)
        run, wall, launches = _run_counted(_batched_run, folder, use_volumes=False)
        _log_batched_passes("direct", run)
        ms = 1e3 * wall / len(run.passes)
        log(f"direct: {len(run.passes)} view-passes + fusion in {wall:.2f} s, {ms:.1f} ms a "
            f"view-pass (volume path batched, phase 11: {walls['batched']:.1f}); launches "
            + json.dumps(launches))
        if any(launches.values()):
            raise AssertionError(f"the direct-warp path launched a kernel: {launches}")
        _one_round_checks("direct", folder, depths, planes_s, run.ply)
    finally:
        shutil.rmtree(folder, ignore_errors=True)

    prior, cap = bench.flagship_prior(depths, normals, V, dev)
    sv = torch.arange(V, device=dev) > 0

    def flagship():  # the body: its stages synchronise, which no replay can
        return pipeline.patchmatch_pass_impl(
            cams, sv, prior, rng.TorchDraws(1, H, W, dev), bench.FLAGSHIP_CFG,
            weak_capacity=cap, ransac_threshold=bench.FLAGSHIP_RTH,
            images=torch.as_tensor(images, device=dev),
            depth_maps=torch.as_tensor(depths, device=dev))

    (out, stages), wall, launches = _run_counted(_stage_timed, flagship)
    log(f"direct flagship pass (REFINE_ITER + geom + APD, {W}x{H}x{V}, worklist {cap}, no "
        f"volumes): {1e3 * wall:.1f} ms with a device synchronise around each stage; stages "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items()) + "; launches "
        + json.dumps(launches))
    if any(launches.values()):
        raise AssertionError(f"the direct flagship pass launched a kernel: {launches}")
    d = out.depth.cpu().numpy()
    interior = np.zeros((H, W), bool)
    interior[10:-10, 10:-10] = True
    box = np.zeros((H, W), bool)
    box[H // 2 - H // 8:H // 2 + H // 8, W // 2 - W // 8:W // 2 + W // 8] = True
    e_int, e_box = _depth_errors(d, depths[0], interior), _depth_errors(d, depths[0], box)
    log(f"direct flagship pass: median relative depth error interior {e_int:.5f}, weak box "
        f"{e_box:.5f} (tol < 0.01 each)")
    if not (np.isfinite(d).all() and e_int < 0.01 and e_box < 0.01):
        raise AssertionError("the direct flagship pass fails its depth checks")
    return ms


def _bin_mat(data: bytes):
    """A state file's array from its bytes (``formats.read_bin_mat``)."""
    import struct

    import numpy as np

    from apdmvs_tpu_torch.io import formats

    _, rows, cols, cv_type = struct.unpack("<iiii", data[:16])
    channels = (cv_type >> 3) + 1
    arr = np.frombuffer(data[16:], dtype=formats._CV_DEPTH_TO_DTYPE[cv_type & 7])
    return arr.reshape((rows, cols) if channels == 1 else (rows, cols, channels))


def _agreement(tag, got, want):
    """The share of equal entries per field of two runs' state files
    (``_state_files``), held to SHARDED_FLOORS; returns whether every
    file was byte-equal."""
    import numpy as np

    from apdmvs_tpu_torch import pipeline

    if set(got) != set(want):
        raise AssertionError(f"{tag}: state files differ: {sorted(set(got) ^ set(want))}")
    byte_equal = all(got[k] == want[k] for k in want)
    views = sorted({v for v, _ in want})
    share = {"pixel_state": [], "depth": [], "selected": [], "normal": []}
    for v in views:
        a, b = (_bin_mat(x[(v, "weak.bin")]) for x in (got, want))
        share["pixel_state"].append(float(np.mean(a == b)))
        a, b = (_bin_mat(x[(v, "depths.dmb")]) for x in (got, want))
        share["depth"].append(float(np.mean(np.isclose(a, b, rtol=2e-3, atol=2e-3))))
        a, b = (_bin_mat(x[(v, "normals.dmb")]) for x in (got, want))
        share["normal"].append(float(np.mean(a == b)))
        a, b = (pipeline.bitmask_to_selected(_bin_mat(x[(v, "selected_views.bin")]), V)[1:]
                for x in (got, want))
        share["selected"].append(float(np.mean(a == b)))
    low = {k: min(vals) for k, vals in share.items()}
    log(f"{tag}: share of equal entries per field, lowest view: pixel_state "
        f"{low['pixel_state']:.6f} (tol >= {SHARDED_FLOORS['pixel_state']}), depth within 2e-3 "
        f"{low['depth']:.6f} (tol >= {SHARDED_FLOORS['depth']}), selected "
        f"{low['selected']:.6f} (tol >= {SHARDED_FLOORS['selected']}), normals equal "
        f"{low['normal']:.6f}; every state file byte-equal: {byte_equal}")
    below = [k for k, floor in SHARDED_FLOORS.items() if low[k] < floor]
    if below:
        raise AssertionError(f"{tag}: below the decision-level bounds: {below}")
    return byte_equal


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _two_processes(folder, dev, timeout=300):
    """The one-round scene in ``folder`` through the CLI in two processes
    sharing ``dev`` over gloo, process 0 fusing on the card after process 1
    has left the group (``--fusion eth-device``); returns each process's output (standard
    output and error, kept in ``folder``). A worker that fails or outlives
    ``timeout`` seconds fails the phase, and both are stopped."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    logs = [os.path.join(folder, f"process{i}.log") for i in range(2)]
    procs = []
    for i, path in enumerate(logs):
        with open(path, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "apdmvs_tpu_torch", folder, "--device", str(dev),
                 "--num-slices", str(K), "--batched", "--view-shards", "2",
                 "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                 "--process-id", str(i), "--dist-backend", "gloo", "--fusion", "eth-device"],
                cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outs = []
    for path in logs:
        with open(path) as f:
            outs.append(f.read())
    for i, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise AssertionError(f"two processes: process {i} exited {proc.returncode} "
                                 f"(killed at the {timeout} s limit if negative):\n"
                                 + out[-3000:])
    return outs


def phase_sharded(dev, inputs, states):
    """Phase 13 (see the module docstring); ``states`` are phase 11's state
    files. Returns the 2 x 2 run's launches and its wall per view-pass."""
    import numpy as np
    import torch

    from apdmvs_tpu_torch import compiled, fusion_device, parallel, scene
    from apdmvs_tpu_torch.datasets import synthetic

    # 1. the two-round scene on a view 2 x space 2 mesh of cuda:0, compiled
    folder = os.path.join(ROOT, "_smoke_sharded")
    try:
        _, images2, depths2, planes2 = _two_round_scene(folder)
        compiled.drop()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        caps, reps = len(compiled.captures), compiled.replays.get(dev, 0)
        run, wall, launches = _run_counted(_batched_run, folder, n_view_shards=2,
                                           n_space_shards=2, devices=[dev] * 4)
        _log_batched_passes("sharded 2x2", run)
        ms = 1e3 * wall / len(run.passes)
        caps, reps = len(compiled.captures) - caps, compiled.replays.get(dev, 0) - reps
        log(f"sharded 2x2 (compiled: {caps} keys captured, {reps} replays): "
            f"{len(run.passes)} view-passes + fusion in {wall:.2f} s, {ms:.1f} ms a view-pass "
            f"(the eager body's, PERF.md: 602.0-659.9), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
            + json.dumps(launches))
        stray = [n for n in NOT_ON_SHARDED_PATH if launches[n] != 0]
        if stray:
            raise AssertionError(f"sharded 2x2: launched {stray}")
        if caps == 0 or reps == 0:
            raise AssertionError("sharded 2x2: the passes did not replay graphs")
        _two_round_checks("sharded 2x2", folder, images2, depths2, planes2, run, launches)
        if not _agreement("sharded 2x2 against phase 11", _state_files(folder),
                          states["two rounds"]):
            raise AssertionError("sharded 2x2: state files differ from phase 11's one shard")
        compiled.drop()

        problems = scene.generate_sample_list(folder)
        views, src_ids = scene._load_fusion_views(folder, problems)
        walls = {}
        for name, kwargs in (("one device", {"device": dev}),
                             ("mesh 1x2", {"mesh": parallel.make_mesh(1, 2, devices=[dev] * 2)})):
            fusion_device.fuse_eth_device(views, src_ids, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            walls[name] = fusion_device.fuse_eth_device(views, src_ids, **kwargs)
            torch.cuda.synchronize()
            walls[name] += (1e3 * (time.perf_counter() - t0),)
        (c1, k1, ms1), (c2, k2, ms2) = walls["one device"], walls["mesh 1x2"]
        same = (np.array_equal(c1, c2) and np.array_equal(k1, k2))
        log(f"sharded fusion: eth-device {len(c1)} points in {ms1:.1f} ms on one device, "
            f"{len(c2)} in {ms2:.1f} ms in mesh mode (space 2 on {dev}); points and colours "
            f"equal: {same} (tol: equal)")
        if not same or len(c1) < 1000:
            raise AssertionError("the fusion's mesh mode disagrees with one device")
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    torch.cuda.empty_cache()

    # 2. the one-round scene in two processes sharing cuda:0, each compiled
    cams_s, planes_s, images, depths, _, _ = inputs
    folder = os.path.join(ROOT, "_smoke_two_processes")
    shutil.rmtree(folder, ignore_errors=True)
    try:
        synthetic.write_mvsnet_dataset(folder, cams_s, planes_s, depth_ranges=(2.0, 8.0),
                                       images=images)
        t0 = time.perf_counter()
        outs = _two_processes(folder, dev)
        wall = time.perf_counter() - t0
        persisted = []
        for i, out in enumerate(outs):
            line = next((ln for ln in out.splitlines()
                         if ln.startswith(f"process {i} of 2: persisted views")), None)
            if line is None:
                raise AssertionError(f"two processes: process {i} reported nothing:\n"
                                     + out[-3000:])
            persisted.append([int(v) for v in line.split("views")[1].split()])
            line = next((ln for ln in out.splitlines()
                         if ln.startswith(f"process {i} of 2: compiled pass:")), "")
            got = re.search(r"(\d+) keys captured, (\d+) replays", line)
            log(f"two processes: process {i}: {line}")
            if got is None or min(int(got.group(1)), int(got.group(2))) == 0:
                raise AssertionError(f"two processes: process {i} replayed no graph:\n"
                                     + out[-3000:])
            fused = "Fused point cloud" in out
            if fused != (i == 0):
                raise AssertionError(f"two processes: process {i} fused: {fused}")
        log(f"two processes on {dev} (gloo): {wall:.2f} s with start-up; persisted views "
            f"{persisted[0]} and {persisted[1]}; process 0 alone fused (eth-device)")
        if persisted != [[0, 1, 2], [3, 4]]:
            raise AssertionError(f"two processes: persisted {persisted}")
        got = _state_files(folder)
        equal = got == states["one round"]
        log(f"two processes: state files byte-equal to phase 11's one-process run: {equal} "
            "(tol: byte-equal)")
        if not equal:
            _agreement("two processes against phase 11", got, states["one round"])
            raise AssertionError("two processes: state files differ from one process's")
        _one_round_checks("two processes", folder, depths, planes_s,
                          os.path.join(folder, "APD", "APD.ply"))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return launches, ms


#: the kernels' function names, as a trace names them (H1, H2, H4, H5, H6)
TRACE_KERNELS = ("build_volume_kernel", "ncc_cost_kernel", "geom_cost_kernel",
                 "gather_cols_kernel", "contract_lookup_kernel")


def _launch_calls(path):
    """The host calls that launched each kernel of TRACE_KERNELS in the
    trace at ``path`` (matched through ``args.correlation``, as
    ``timeline`` matches them)."""
    from apdmvs_tpu_torch import timeline

    events = timeline.load_events(path)
    calls = {e["args"]["correlation"]: e["name"] for e in events
             if timeline._cat(e) in timeline.LAUNCH_CATS and "correlation" in e.get("args", {})}
    out = {}
    for e in events:
        if timeline._cat(e) == "kernel":
            for k in TRACE_KERNELS:
                if k in e["name"]:
                    out.setdefault(k, set()).add(calls.get(e["args"].get("correlation"), "none"))
    return {k: sorted(v) for k, v in out.items()}


def _log_ledger(tag, wall, led, t_phase):
    """One line of a gap ledger: wall, busy, idle share, busy and idle ms per
    stage, the five longest gaps with their stage and host operator (none
    between operators: the host in Python); and the seconds since
    ``t_phase``."""
    if not led["device_events"]:
        raise AssertionError(f"idle {tag}: the trace holds no device event")
    stages = ", ".join(f"{k} {v['busy_ms']:.2f}/{v['idle_ms']:.2f}"
                       for k, v in led["stages"].items())
    gaps = "; ".join(f"{g['ms']:.3f} ms in {g['stage']} (host in {g['host_op'] or 'Python'}, "
                     f"then {g['next'][:48]})" for g in led["gaps"]["top"][:5])
    log(f"idle {tag}: wall {wall:.1f} ms, device window {led['window_ms']:.1f} ms, busy "
        f"{led['busy_ms']:.1f} ms, idle share {led['idle_share']:.4f}; {led['device_events']} "
        f"device events ({led['unmatched']} not matched to a launch); busy/idle ms per stage "
        f"(- outside every stage): {stages}; gaps >= {led['gaps']['threshold_ms']} ms: "
        f"{led['gaps']['count']}, {led['gaps']['sum_ms']:.1f} ms; longest: {gaps} "
        f"[{time.perf_counter() - t_phase:.1f} s into the phase]")


def phase_debug_profile(dev, inputs, folder_2r):
    """Phase 14 (see the module docstring); ``folder_2r`` holds phase 7's
    outputs. Returns the phase's seconds."""
    import numpy as np
    import torch

    from apdmvs_tpu_torch import (bench, debug, fusion_device, ncc, pipeline, profile_stages,
                                  rng, scene)
    from apdmvs_tpu_torch.trace_pass import profiled
    from apdmvs_tpu_torch.datasets import synthetic
    from apdmvs_tpu_torch.io import formats
    from apdmvs_tpu_torch.params import PixelState

    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "_smoke_profile")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    cams_s, planes_s, images, depths, normals, cams = inputs
    try:
        # (a) the flagship pass with and without debug, the same draws
        vs, prior, cap, _ = bench.flagship_state(images, depths, normals, cams, K)
        for with_probes in (False, True):  # each key captured (a warm-up pass and a replay)
            bench.flagship_pass(cams, vs, prior, cap, 0, debug=with_probes)
        ref, launches_ref = _run_counted(bench.flagship_pass, cams, vs, prior, cap, 1)[::2]
        (out, probes), launches = _run_counted(bench.flagship_pass, cams, vs, prior, cap, 1,
                                               debug=True)[::2]
        equal = {f: bool(torch.equal(a, b)) for f, a, b in zip(ref._fields, ref, out)}
        weak_in = int((prior.pixel_state == PixelState.WEAK).sum())
        live = probes.weak_xy[:, 0] >= 0
        a = probes.anchor_coords[live]
        inside = ((a[..., 0] >= 0) & (a[..., 0] < W) & (a[..., 1] >= 0) & (a[..., 1] < H)) | (
            (a[..., 0] == -1) & (a[..., 1] == -1))
        sweep_ok = bool((torch.isfinite(probes.sweep) | (probes.sweep == ncc.COST_MAX)).all())
        debug.dump_probes(out_dir, probes, H, W)
        nb = debug.read_neighbours(os.path.join(out_dir, "neighbour.bin"))
        nb_map = formats.read_bin_mat(os.path.join(out_dir, "neighbour_map.bin"))
        log(f"debug flagship: every field equal to the pass without debug "
            f"{json.dumps(equal)} (tol: equal); launches with debug {json.dumps(launches)}, "
            f"without {json.dumps(launches_ref)} (tol: equal); worklist {int(live.sum())} live "
            f"of {cap} (prior WEAK {weak_in}), anchors in the image or -1: "
            f"{bool(inside.all())}, sweep {tuple(probes.sweep.shape)} finite or COST_MAX: "
            f"{sweep_ok}; dumped and read back: {nb.shape[0]} rows, {int((nb_map >= 0).sum())} "
            "mapped pixels")
        if not (all(equal.values()) and launches == launches_ref
                and all(launches[k] > 0 for k in ("ncc_cost_views", "geom_cost_views",
                                                  "gather_cols", "contract_lookup"))
                and int(live.sum()) == weak_in < cap and bool(inside.all()) and sweep_ok
                and tuple(probes.sweep.shape) == (61, H, W)
                and nb.shape == (weak_in, 9, 2) and nb.shape[0] == int((nb_map >= 0).sum())):
            raise AssertionError("debug flagship: debug changed the pass or its probes are wrong")
        del ref, out, probes

        # (c) idle shares: the bench's flagship pass, then on 4 row slabs
        _, wall, led = profiled(lambda: bench.flagship_pass(cams, vs, prior, cap, 2,
                                                            eager=True),
                                os.path.join(out_dir, "flagship.json"), 5)
        _log_ledger("flagship pass", wall, led, t_phase)
        log("flagship pass: the host calls that launched each kernel "
            + json.dumps(_launch_calls(os.path.join(out_dir, "flagship.json"))))
        del vs
        torch.cuda.empty_cache()
        sp = ncc.build_volume_set_spaced(torch.as_tensor(images, device=dev), cams, bench.DMIN,
                                         bench.DMAX, [dev] * 4, num_slices=K,
                                         depth_maps=torch.as_tensor(depths, device=dev))
        bench.flagship_pass(cams, sp, prior, cap, 1, eager=True)
        _, wall, led = profiled(lambda: bench.flagship_pass(cams, sp, prior, cap, 2,
                                                            eager=True),
                                os.path.join(out_dir, "flagship_4_slabs.json"), 5)
        _log_ledger("flagship pass on 4 row slabs", wall, led, t_phase)
        del sp
        torch.cuda.empty_cache()
        sv = torch.arange(V, device=dev) > 0
        imgs_t, dms_t = (torch.as_tensor(x, device=dev) for x in (images, depths))
        _, wall, led = profiled(
            lambda: pipeline.patchmatch_pass_impl(
                cams, sv, prior, rng.TorchDraws(2, H, W, dev), bench.FLAGSHIP_CFG,
                weak_capacity=cap, ransac_threshold=bench.FLAGSHIP_RTH, images=imgs_t,
                depth_maps=dms_t),
            os.path.join(out_dir, "flagship_direct.json"), 5)
        _log_ledger("flagship pass, direct-warp path", wall, led, t_phase)
        problems = scene.generate_sample_list(folder_2r)
        views, src_ids = scene._load_fusion_views(folder_2r, problems)
        fusion_device.fuse_eth_device(views, src_ids, device=dev)
        _, wall, led = profiled(lambda: fusion_device.fuse_eth_device(views, src_ids,
                                                                      device=dev),
                                os.path.join(out_dir, "eth_device.json"), 5)
        _log_ledger(f"eth-device fusion ({W2}x{H2}, two rounds' outputs)", wall, led, t_phase)
        del views
        torch.cuda.empty_cache()
        row = profile_stages.measure(W, H, V, dev)
        log(f"flagship stages (ms, least of {row['repeats']}, a device synchronise around "
            f"each): {json.dumps(row['stages_ms'])}; pass without them {row['pass_ms']:.1f} ms "
            f"[{time.perf_counter() - t_phase:.1f} s into the phase]")
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()

        # (b) a two-round 640x480 run with the dumps and a trace
        folder = os.path.join(ROOT, "_smoke_debug_2r")
        shutil.rmtree(folder, ignore_errors=True)
        # focal 800: phase 7's field of view, so the textureless window
        # covers a quarter of phase 7's pixels (the default focal leaves it
        # under a thousand)
        cams_f, planes_f = synthetic.make_ring_scene(num_views=V, width=W, height=H,
                                                     focal=800.0, include_flat_region=True)
        _, depths_f, _ = synthetic.render_scene(cams_f, planes_f)
        synthetic.write_mvsnet_dataset(folder, cams_f, planes_f, depth_ranges=(2.0, 8.0))
        prof_dir = os.path.join(out_dir, "two_rounds")
        try:
            run, wall, launches = _run_counted(scene.run_scene, folder, device="cuda",
                                               verbose=False, min_rounds=2, debug_dumps=True,
                                               profile_dir=prof_dir)
            last = {}
            for spec, problem, st in run.passes:
                if spec.round_index == 1 and st.weak_in:
                    last[problem.ref_image_id] = st.weak_in
            into = {problem.ref_image_id: st.weak_in for spec, problem, st in run.passes
                    if spec.round_index == 1 and spec.state.name == "REFINE_INIT"}
            read = []
            for v in range(V):
                rf = os.path.join(folder, "APD", formats.to_format_index(v))
                nb = debug.read_neighbours(os.path.join(rf, "neighbour.bin"))
                nb_map = formats.read_bin_mat(os.path.join(rf, "neighbour_map.bin"))
                line = formats.read_bin_mat(os.path.join(rf, "weak_cost_line.dmb"))
                read.append(nb.shape[0] == int((nb_map >= 0).sum()) == last.get(v)
                            and line.shape == (61, W) and nb_map.shape == (H, W))
            trace = os.path.join(prof_dir, "trace.json")
            t0 = time.perf_counter()
            with open(trace) as f:  # a scan, not a parse: the trace holds ~40 passes
                text = f.read()
            seen = {k: k in text for k in TRACE_KERNELS}
            spans = {s: f'"apd.{s}"' in text for s in pipeline.STAGES}
            del text
            log(f"debug two rounds ({W}x{H}, {len(run.passes)} view-passes, traced): "
                f"{wall:.2f} s, trace {os.path.getsize(trace) / 1e6:.1f} MB scanned in "
                f"{time.perf_counter() - t0:.1f} s; WEAK pixels entering round 1's REFINE_INIT "
                f"pass per view {json.dumps(into)} (tol > 1000 each); probe files read back "
                f"per view {read}; spans "
                f"{json.dumps(spans)}; kernels by name {json.dumps(seen)}; launches "
                f"{json.dumps(launches)} [{time.perf_counter() - t_phase:.1f} s into the phase]")
            if not (min(into.values()) > 1000 and all(read) and all(seen.values())
                    and all(spans.values())):
                raise AssertionError("debug two rounds: probes, spans or kernels missing")
            _one_round_checks("debug two rounds", folder, depths_f, planes_f, run.ply)
        finally:
            shutil.rmtree(folder, ignore_errors=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"debug and profile: phase took {seconds:.1f} s")
    return seconds


# ---------------------------------------------------------------------------
# Phase 15: the compiled pass
# ---------------------------------------------------------------------------


def _bits_equal(a, b) -> bool:
    """Equal bit for bit (NaN where the other has NaN, -0.0 apart from +0.0)."""
    import torch

    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(bits), b.view(bits)
    return bool(torch.equal(a, b))


def _fields_equal(x, y):
    """Per output field (and probe under ``debug``), whether two passes'
    results are bit-equal."""
    from apdmvs_tpu_torch import pipeline

    if isinstance(x, tuple) and isinstance(x[-1], pipeline.DebugProbes):
        out = _fields_equal(x[0], y[0])
        out.update({f"probe.{f}": _bits_equal(a, b)
                    for f, a, b in zip(x[1]._fields, x[1], y[1])})
        return out
    return {f: _bits_equal(a, b) for f, a, b in zip(x._fields, x, y)}


def _reordered(inputs, ref: int):
    """The 640x480 ring scene with view ``ref`` as the reference: images,
    depths, normals (numpy) and cameras in the new view order."""
    from apdmvs_tpu_torch import geometry

    _, _, images, depths, normals, cams = inputs
    order = [ref] + [v for v in range(V) if v != ref]
    return (images[order], depths[order], normals[order],
            geometry.Cameras(*(f[order] for f in cams)))


def _key_problems(name, dev, inputs, slabs: int = 0):
    """Two problems (keyword arguments of ``pipeline.patchmatch_pass``
    without draws) that share the static key ``name``: views 0 and 1 of the
    640x480 ring scene as the reference, the second with its own ransac
    threshold where the pass reads one; the flagship's volumes as ``slabs``
    row slabs of ``dev`` when ``slabs`` > 0."""
    import torch

    from apdmvs_tpu_torch import bench, ncc, scene
    from apdmvs_tpu_torch.params import PassConfig, PixelState, RunState

    sv = torch.arange(V, device=dev) > 0
    out = []
    for ref, rth in ((0, bench.FLAGSHIP_RTH), (1, 0.0125)):
        images, depths, normals, cams = _reordered(inputs, ref)
        imgs = torch.as_tensor(images, device=dev)
        dms = torch.as_tensor(depths, device=dev)
        kw = dict(cams=cams, src_valid=sv, ransac_threshold=rth)
        if name == "one-round FIRST_INIT":
            kw.update(prior=scene._empty_prior(V, H, W, dev),
                      cfg=PassConfig(state=RunState.FIRST_INIT, geom_consistency=False,
                                     use_APD=False),
                      volumes=ncc.build_image_volume_set(imgs, cams, bench.DMIN, bench.DMAX, K,
                                                         weak_cost_volumes=False))
        elif name == "one-round REFINE_ITER geometric":
            prior, _ = bench.flagship_prior(depths, normals, V, dev)
            vs = ncc.build_image_volume_set(imgs, cams, bench.DMIN, bench.DMAX, K,
                                            weak_cost_volumes=False)
            kw.update(prior=prior._replace(pixel_state=torch.full_like(
                prior.pixel_state, int(PixelState.STRONG))),
                cfg=PassConfig(state=RunState.REFINE_ITER, geom_consistency=True,
                               use_APD=False),
                volumes=ncc.add_depth_volumes(vs, dms, cams, bench.DMIN, bench.DMAX))
        else:  # the flagship pass, on volumes, with debug, or on the direct-warp path
            prior, cap = bench.flagship_prior(depths, normals, V, dev)
            kw.update(prior=prior, cfg=bench.FLAGSHIP_CFG, weak_capacity=cap,
                      debug=name == "flagship APD, debug")
            if name == "flagship APD, direct-warp path":
                kw.update(images=imgs, depth_maps=dms)
            elif slabs:
                kw["volumes"] = ncc.build_volume_set_spaced(
                    imgs, cams, bench.DMIN, bench.DMAX, [dev] * slabs, num_slices=K,
                    depth_maps=dms)
            else:
                vs = ncc.build_image_volume_set(imgs, cams, bench.DMIN, bench.DMAX, K)
                kw["volumes"] = ncc.add_depth_volumes(vs, dms, cams, bench.DMIN, bench.DMAX)
        out.append(kw)
    return out


def _scene_problems(folder, dev, slabs: int = 0):
    """Views 0 and 1 of the two-round scene's last round-1 pass (REFINE_ITER,
    geometric, APD at 1280x960), as ``scene.process_problem`` would pass
    them from the state files in ``folder``, both with the larger of their
    worklist buckets (one key); their volumes as ``slabs`` row slabs of
    ``dev`` when ``slabs`` > 0 (built from the images and depth maps the
    pass reads, over the problem's depth range)."""
    import inspect

    from apdmvs_tpu_torch import ncc, pipeline, scene
    from apdmvs_tpu_torch.params import build_schedule

    class _Stop(Exception):
        pass

    problems = scene.generate_sample_list(folder)
    cache = scene.SceneCache(folder, expected_sets=len(problems))
    spec = build_schedule(2)[-1]
    sig = inspect.signature(pipeline.patchmatch_pass_impl)
    real, out = pipeline.patchmatch_pass, []

    def spy(*args, **kwargs):
        out.append(dict(sig.bind(*args, **kwargs).arguments))
        raise _Stop

    pipeline.patchmatch_pass = spy
    try:
        for i in (0, 1):
            try:
                scene.process_problem(cache, problems[i], spec, (W2, H2), 0, dev,
                                      num_views_pad=V, num_slices=K, use_volumes=not slabs)
            except _Stop:
                pass
    finally:
        pipeline.patchmatch_pass = real
    cap = max(kw["weak_capacity"] for kw in out)
    for i, kw in enumerate(out):
        del kw["draws"]
        kw["weak_capacity"] = cap
        if slabs:
            inp = scene._problem_inputs(cache, problems[i], W2, H2, (W2, H2), V)
            kw["volumes"] = ncc.build_volume_set_spaced(
                kw["images"], kw["cams"], inp.dmin, inp.dmax, [dev] * slabs, num_slices=K,
                depth_maps=kw["depth_maps"])
    return out, spec


def _timed(fn, reps: int):
    """Host ms of ``reps`` calls, each ending in a device synchronise."""
    import torch

    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def _hold_key(name, problems, dev, reps: int = 10, unsharded=None):
    """One key of phase 15: captured on problem A (a miss), then a replay
    held against ``patchmatch_pass_impl`` on the same inputs and draws (every
    field and probe bit for bit, the same launches per kernel) and, for a
    key over row slabs, against ``unsharded`` (the unsharded key's replay of
    A with the same draws), problem B through the same graph against its
    own eager run, the slot fill's device ms, ``reps`` eager passes against
    ``reps`` replays, and the peak memory of each. Returns the key's row
    and that replay of A."""
    import numpy as np
    import torch

    from apdmvs_tpu_torch import compiled, pipeline, rng

    pa, pb = problems
    Hk, Wk = pa["prior"].depth.shape

    def compiled_pass(kw, seed):
        return pipeline.patchmatch_pass(draws=rng.TorchDraws(seed, Hk, Wk, dev), **kw)

    def eager_pass(kw, seed):
        return pipeline.patchmatch_pass_impl(draws=rng.TorchDraws(seed, Hk, Wk, dev), **kw)

    key = compiled.static_key(pa["cams"], pa["prior"], pa["cfg"], pa.get("volumes"),
                              pa.get("weak_capacity", 0), pa.get("debug", False))
    t0 = time.perf_counter()
    compiled_pass(pa, 1)
    torch.cuda.synchronize()
    miss_ms = 1e3 * (time.perf_counter() - t0)
    entry = compiled.entries(dev)[key]
    keys = len(compiled.entries(dev))
    out_c, _, l_c = _run_counted(compiled_pass, pa, 2)
    fill_ms = entry.fill_ms()
    out_e, _, l_e = _run_counted(eager_pass, pa, 2)
    eq_a = _fields_equal(out_c, out_e)
    eq_u = None if unsharded is None else _fields_equal(out_c, unsharded)
    del out_e
    out_cb = compiled_pass(pb, 3)
    fill_b_ms = entry.fill_ms()  # B's inputs, its volume set among them, copied in
    same_graph = len(compiled.entries(dev)) == keys
    eq_b = _fields_equal(out_cb, eager_pass(pb, 3))
    del out_cb
    row = {"key": name, "nodes": entry.nodes, "warmup_ms": entry.warmup_ms,
           "capture_ms": entry.capture_ms, "instantiate_ms": entry.instantiate_ms,
           "miss_ms": miss_ms, "fill_ms": fill_ms, "fill_new_problem_ms": fill_b_ms,
           "launches": {k: v for k, v in l_c.items() if v}}
    if reps:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eager_ms = _timed(lambda: eager_pass(pa, 4), reps)
        row["eager_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        torch.cuda.reset_peak_memory_stats()
        replay_ms = _timed(lambda: compiled_pass(pa, 4), reps)
        row["replay_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        row.update(eager_ms=float(np.median(eager_ms)), replay_ms=float(np.median(replay_ms)))
    log(f"compiled {name} ({Wk}x{Hk}): key captured in {miss_ms:.1f} ms (warm-up "
        f"{entry.warmup_ms:.1f}, capture {entry.capture_ms:.1f}, instantiate "
        f"{entry.instantiate_ms:.1f} ms, {entry.nodes} graph nodes); replay against "
        f"patchmatch_pass_impl, same inputs and draws: {json.dumps(eq_a)} (tol: every field "
        f"bit-equal); launches replay {json.dumps(row['launches'])}, eager "
        f"{json.dumps({k: v for k, v in l_e.items() if v})} (tol: equal); "
        + ("" if eq_u is None else f"against the unsharded key's replay {json.dumps(eq_u)} "
           "(tol: every field bit-equal); ")
        + "a second problem through the same graph "
        f"({'no new key' if same_graph else 'A NEW KEY'}): "
        f"{json.dumps(eq_b)} (tol: every field bit-equal to its eager run); slot fill "
        f"{fill_ms:.3f} ms device, {fill_b_ms:.3f} ms with the second problem's inputs "
        "copied in"
        + (f"; median of {reps} eager {row['eager_ms']:.1f} ms, of {reps} replays "
           f"{row['replay_ms']:.1f} ms; peak above the baseline eager "
           f"{row['eager_peak_gb']:.2f} GB, replay {row['replay_peak_gb']:.2f} GB"
           if reps else ""))
    if not (all(eq_a.values()) and all(eq_b.values()) and same_graph and l_c == l_e
            and (eq_u is None or all(eq_u.values()))):
        raise AssertionError(f"compiled {name}: the replay differs from the body")
    return row, out_c


def _eager_run(runner, *args, **kwargs):
    """``runner`` with every pass on the body (``pipeline.patchmatch_pass``
    pointed at ``patchmatch_pass_impl`` for the run: the caller names the
    eager body)."""
    from apdmvs_tpu_torch import pipeline

    real = pipeline.patchmatch_pass
    pipeline.patchmatch_pass = pipeline.patchmatch_pass_impl
    try:
        return runner(*args, **kwargs)
    finally:
        pipeline.patchmatch_pass = real


def _scene_walls(tag, folder, want_states, runs):
    """Each of ``runs`` (label -> runner of the scene in ``folder``) from
    fresh state, its wall per view-pass, peak memory and captures; every
    run's state files must equal ``want_states`` (or the first run's) byte
    for byte."""
    import torch

    from apdmvs_tpu_torch import compiled

    states, parts = want_states, []
    for label, runner in runs.items():
        shutil.rmtree(os.path.join(folder, "APD"), ignore_errors=True)
        caps = len(compiled.captures)
        torch.cuda.reset_peak_memory_stats()
        run, wall, _ = _run_counted(runner, folder)
        got = _state_files(folder)
        states = got if states is None else states
        equal = got == states
        parts.append(f"{label} {1e3 * wall / len(run.passes):.1f} ms a view-pass "
                     f"({len(run.passes)} + fusion in {wall:.2f} s, peak "
                     f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
                     f"{len(compiled.captures) - caps} captures), state files byte-equal "
                     f"{equal}")
        if not equal:
            raise AssertionError(f"{tag}: {label}'s state files differ")
    log(f"compiled {tag}: " + "; ".join(parts) + " (tol: byte-equal)")


def phase_compiled(dev, inputs, folder_2r, walls):
    """Phase 15 (see the module docstring)."""
    import torch

    from apdmvs_tpu_torch import bench, compiled, ncc, parallel, scene
    from apdmvs_tpu_torch.datasets import synthetic
    from apdmvs_tpu_torch.trace_pass import profiled

    t_phase = time.perf_counter()
    states_2r = _state_files(folder_2r)  # phase 7's run: compiled, the default cache
    per_set = ncc.image_volume_set_nbytes(V, H2, W2, K)
    budget = scene.volume_cache_budget(dev, V, H2, W2, K)
    log(f"compiled: default volume cache at {W2}x{H2}x{V}: budget {budget / 1e9:.2f} GB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.2f} GB, pins "
        f"{parallel.pinned_count(per_set, V, budget)} of {V} sets ({per_set / 1e9:.2f} GB "
        f"each; the scene caches all or none: {V * per_set <= budget})")
    rows = []
    compiled.drop()
    for name in ("one-round FIRST_INIT", "one-round REFINE_ITER geometric", "flagship APD",
                 "flagship APD, debug", "flagship APD, direct-warp path"):
        row, replay = _hold_key(name, _key_problems(name, dev, inputs), dev,
                                reps=0 if name.endswith("debug") else 10)
        rows.append(row)
        if name == "flagship APD":
            flagship_replay = replay
        del replay
        torch.cuda.empty_cache()
    # the flagship pass over row slabs of cuda:0, each replay also held
    # against the unsharded key's
    for S in (2, 4):
        rows.append(_hold_key(f"flagship APD, {S} slabs",
                              _key_problems("flagship APD", dev, inputs, slabs=S), dev,
                              unsharded=flagship_replay)[0])
        torch.cuda.empty_cache()
    vs, prior, cap, _ = bench.flagship_state(*inputs[2:5], inputs[-1], K)
    bench.flagship_pass(inputs[-1], vs, prior, cap, 5)
    out_dir = os.path.join(ROOT, "_smoke_profile")
    os.makedirs(out_dir, exist_ok=True)
    try:
        _, wall, led = profiled(lambda: bench.flagship_pass(inputs[-1], vs, prior, cap, 6),
                                os.path.join(out_dir, "flagship_replay.json"), 5)
        _log_ledger("flagship replay", wall, led, t_phase)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    del vs, prior
    log(f"compiled: {len(compiled.entries(dev))} keys at {W}x{H}, slots "
        f"{compiled.slot_bytes(dev) / 1e9:.2f} GB")
    compiled.drop()
    del flagship_replay
    scene_problems, spec = _scene_problems(folder_2r, dev)
    name = f"two-round round-1 APD bucket {scene_problems[0]['weak_capacity']}"
    row, replay = _hold_key(f"{name} ({spec.state.name})", scene_problems, dev)
    rows.append(row)
    log(f"compiled: {len(compiled.entries(dev))} keys at {W2}x{H2}, slots "
        f"{compiled.slot_bytes(dev) / 1e9:.2f} GB")
    del scene_problems
    compiled.drop()
    scene_problems, spec = _scene_problems(folder_2r, dev, slabs=2)
    rows.append(_hold_key(f"{name}, 2 slabs ({spec.state.name})", scene_problems, dev,
                          unsharded=replay)[0])
    log(f"compiled: {len(compiled.entries(dev))} keys at {W2}x{H2} on 2 slabs, slots "
        f"{compiled.slot_bytes(dev) / 1e9:.2f} GB")
    del scene_problems, replay
    compiled.drop()

    folder = os.path.join(ROOT, "_smoke_compiled")
    shutil.rmtree(folder, ignore_errors=True)
    try:
        cams_s, planes_s, images, _, _, _ = inputs
        synthetic.write_mvsnet_dataset(folder, cams_s, planes_s, depth_ranges=(2.0, 8.0),
                                       images=images)
        run = dict(device="cuda", verbose=False)
        _scene_walls("one-round scene", folder, None, {
            "compiled": lambda f: scene.run_scene(f, **run),
            "eager": lambda f: _eager_run(scene.run_scene, f, **run)})
        shutil.rmtree(folder, ignore_errors=True)
        _two_round_scene(folder)
        log(f"compiled two-round scene: compiled with the default cache (phase 7) "
            f"{walls['two rounds']:.1f} ms a view-pass")
        _scene_walls("two-round scene against phase 7's files", folder, states_2r, {
            "eager, --volume-cache-gb 6": lambda f: _eager_run(
                scene.run_scene, f, volume_cache_gb=6.0, **run)})
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    compiled.drop()
    log(f"compiled: phase took {time.perf_counter() - t_phase:.1f} s")
    print(json.dumps({"compiled": rows}), flush=True)
    return rows

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    import apdmvs_tpu_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase_build()
    inputs = make_inputs(dev)
    rows = phase_kernels(dev, inputs)
    walls = {}
    launches, _, walls["one round"] = phase_main_path(dev, inputs)
    flag = flagship_state(dev, inputs)
    cols_rows, worklist = phase_cols(dev, inputs, flag)
    rows += cols_rows
    ops_rows, ops_launches = phase_ops(dev, inputs, flag, worklist)
    rows += ops_rows
    torch.cuda.empty_cache()
    phase_flagship(dev, inputs, flag)
    del flag, worklist
    torch.cuda.empty_cache()
    # phase 7's outputs stay for phase 8, and for phase 14's trace of the device fusion
    folder_2r = os.path.join(ROOT, "_smoke_scene_2r")
    try:
        launches_2r, planes_2r, walls["two rounds"] = phase_two_rounds(dev, folder_2r)
        phase_fusion(dev, folder_2r, planes_2r)
        torch.cuda.empty_cache()
        phase_quality(dev)
        phase_bench(dev)
        torch.cuda.empty_cache()
        walls["batched"], walls["batched two rounds"], states = phase_batched(dev, inputs,
                                                                              walls)
        torch.cuda.empty_cache()
        walls["direct"] = phase_direct(dev, inputs, walls)
        torch.cuda.empty_cache()
        launches_sh, walls["sharded 2x2"] = phase_sharded(dev, inputs, states)
        log("walls per view-pass (ms, host clock ending in a device synchronise): "
            + json.dumps({k: round(v, 1) for k, v in walls.items()}))
        torch.cuda.empty_cache()
        phase_debug_profile(dev, inputs, folder_2r)
        torch.cuda.empty_cache()
        phase_compiled(dev, inputs, folder_2r, walls)
    finally:
        shutil.rmtree(folder_2r, ignore_errors=True)
    # each kernel's launches on its slice's main path: H1, H2 and H4 (both
    # wrappers of each) on the one-round 640x480 scene, H5-H6 on the two-round
    # 1280x960 scene, H3, H7, H8 in the ops phase
    launches["ncc_cost"] += launches["ncc_cost_views"]
    launches["geom_cost"] += launches["geom_cost_views"]
    for r in rows:
        if r["name"] == "rebase_view":
            r["launches"] = ops_launches["rebase_view"]
        elif "launches" not in r:
            r["launches"] = (launches_2r if r["name"] in ("gather_cols", "contract_lookup")
                             else launches)[r["name"]]
    # and each kernel's launches in phase 13's 2 x 2 run (both wrappers of
    # H2 and H4, both entries of H7)
    launches_sh["ncc_cost"] += launches_sh["ncc_cost_views"]
    launches_sh["geom_cost"] += launches_sh["geom_cost_views"]
    launches_sh["gather_rows"] += launches_sh["gather_rows_sorted"]
    for r in rows:
        r["sharded"] = launches_sh[r["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "sharded", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
