"""The port's fusion variants against the JAX package's.

- ``fusion.fuse_tat`` (intermediate, advanced): the numpy path equals the
  JAX numpy path exactly; the native path (``native.fuse_tat``, the same
  C++ source) equals the JAX native path and matches the port's numpy path
  under tests/test_native.py's criterion.
- ``fusion_device.fuse_eth_device`` on the CPU against the JAX
  ``fuse_eth_device``: float32 on both sides, so >= 99.9 % of the accept
  decisions agree and point counts within 0.5 %; against the host numpy
  backend the JAX package's own bounds (tests/test_fusion_device.py), and
  its greedy-dedup property.
- ``native.fuse_eth`` (evaluated on several threads, committed in raster
  order) at 1, 2, 3 and 8 threads against the JAX package's sequential
  native core, byte for byte: a collision-heavy scene, ROI blocks with WEAK
  pixels, a view among its own sources, fewer rows than threads.
- ``scene.run_fusion`` with each of the four variants on one folder of
  persisted ground-truth outputs, against the JAX ``scene.run_fusion``:
  ``eth`` and both ``tat`` variants write equal clouds, ``eth-device``
  within the bounds above, ``eth`` counting its threads and candidates;
  the CLI's ``--fusion`` reaches ``run_scene``.
"""

import dataclasses

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from apdmvs_tpu import fusion as jfus, fusion_device as jfd, native as jnative, scene as jscene
from apdmvs_tpu_torch import __main__ as cli
from apdmvs_tpu_torch import fusion as tfus, fusion_device as tfd, native, scene as tscene
from apdmvs_tpu_torch import telemetry
from apdmvs_tpu_torch.datasets import synthetic as tsyn
from apdmvs_tpu_torch.io import formats
from apdmvs_tpu_torch.params import PixelState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ["eth", "eth-device", "tat_intermediate", "tat_advanced"]


def _views(mod, num_views=4, width=160, height=120):
    cams, planes = tsyn.make_ring_scene(num_views=num_views, width=width, height=height)
    images, depths, normals = tsyn.render_scene(cams, planes)
    views = []
    for i, cam in enumerate(cams):
        bgr = np.repeat(np.clip(images[i], 0, 255).astype(np.uint8)[..., None], 3, axis=-1)
        weak = np.full(depths[i].shape, PixelState.STRONG, np.uint8)
        weak[height // 3:height // 2, width // 3:width // 2] = PixelState.WEAK
        views.append(mod.FusionView(K=cam.K.astype(np.float64), R=cam.R.astype(np.float64),
                                    t=cam.t.astype(np.float64), image_bgr=bgr, depth=depths[i],
                                    normal=normals[i], weak=weak))
    src_ids = [[j for j in range(num_views) if j != i] for i in range(num_views)]
    return views, src_ids, planes


def _plane_dist(points, planes):
    d = np.full(points.shape[0], np.inf)
    for pl in planes:
        d = np.minimum(d, np.abs((points.astype(np.float64) - pl.p0) @ pl.n))
    return d


@pytest.fixture(scope="module")
def oracle():
    jv, src, planes = _views(jfus)
    tv, _, _ = _views(tfus)
    return jv, tv, src, planes


@pytest.mark.parametrize("advanced", [False, True], ids=["intermediate", "advanced"])
def test_fuse_tat_numpy_equals_jax(oracle, advanced):
    jv, tv, src, _ = oracle
    jc, jcol = jfus.fuse_tat(jv, src, advanced=advanced, backend="numpy")
    tc, tcol = tfus.fuse_tat(tv, src, advanced=advanced, backend="numpy")
    assert tc.shape[0] > 10000
    np.testing.assert_array_equal(jc, tc)
    np.testing.assert_array_equal(jcol, tcol)


@pytest.mark.parametrize("advanced", [False, True], ids=["intermediate", "advanced"])
def test_fuse_tat_native_matches_numpy(oracle, advanced):
    jv, tv, src, planes = oracle
    assert native.fuse_tat(tv, src, advanced=advanced) is not None, "native library unavailable"
    cn, coln = tfus.fuse_tat(tv, src, advanced=advanced, backend="native")
    cp, _ = tfus.fuse_tat(tv, src, advanced=advanced, backend="numpy")
    # tests/test_native.py:64's criterion
    assert cn.shape[0] > 10000
    assert abs(cn.shape[0] - cp.shape[0]) / cp.shape[0] < 0.05
    assert np.median(_plane_dist(cn, planes)) < 0.01
    assert coln.dtype == np.uint8 and coln.shape == cn.shape
    jn, jcoln = jfus.fuse_tat(jv, src, advanced=advanced, backend="native")
    np.testing.assert_array_equal(jn, cn)
    np.testing.assert_array_equal(jcoln, coln)


def _eth_scene(name):
    """(views as arrays, src_ids) of one threaded-core case: ``collision``
    is tests/test_native.py::test_collision_heavy_backend_parity's scene
    (two views pushed back, many pixels claim one far source pixel);
    ``blocked_weak`` ROI blocks and WEAK boxes over normals tilted by ~6
    degrees, so terms fall near both factors; ``self_source`` the same maps
    with view 0 among its own sources; ``few_rows`` an image of 6 rows."""
    width, height = (64, 6) if name == "few_rows" else (160, 120)
    cams, planes = tsyn.make_ring_scene(num_views=4, width=width, height=height)
    if name == "collision":
        pushed = []
        for i, c in enumerate(cams):
            if i >= 2:  # push back along the view direction
                center = -c.R.T @ c.t + c.R.T @ np.array([0.0, 0.0, -6.0])
                c = dataclasses.replace(c, t=(-c.R @ center).astype(c.t.dtype))
            pushed.append(c)
        cams = pushed
    images, depths, normals = tsyn.render_scene(cams, planes)
    rng = np.random.default_rng(7)
    views = []
    for i, cam in enumerate(cams):
        normal, block = normals[i], None
        weak = np.full(depths[i].shape, PixelState.STRONG, np.uint8)
        if name in ("blocked_weak", "self_source"):
            tilted = normal + rng.normal(0.0, 0.07, normal.shape).astype(np.float32)
            normal = (tilted / np.linalg.norm(tilted, axis=-1, keepdims=True)).astype(np.float32)
            weak[20:70, 30:110] = PixelState.WEAK
        if name == "blocked_weak":
            block = np.full(depths[i].shape, 255, np.uint8)
            block[:, (i * 37) % width:(i * 37) % width + 50] = 0
        bgr = np.repeat(np.clip(images[i], 0, 255).astype(np.uint8)[..., None], 3, -1)
        views.append(dict(K=cam.K.astype(np.float64), R=cam.R.astype(np.float64),
                          t=cam.t.astype(np.float64), image_bgr=bgr, depth=depths[i],
                          normal=normal, weak=weak, block=block))
    n = len(views)
    src_ids = [[j for j in range(n) if j != i] for i in range(n)]
    if name == "self_source":
        src_ids[0] = [1, 0, 2, 3]
    return views, src_ids


@pytest.fixture(scope="module")
def eth_scenes():
    """Each case's views and the JAX package's sequential native cloud."""
    cases = {}
    for name in ("collision", "blocked_weak", "self_source", "few_rows"):
        views, src_ids = _eth_scene(name)
        expect = jnative.fuse_eth([jfus.FusionView(**v) for v in views], src_ids)
        assert expect is not None, "the JAX package's native core did not build"
        cases[name] = (views, src_ids, expect)
    return cases


@pytest.mark.parametrize("threads", [1, 2, 3, 8])
@pytest.mark.parametrize("scene", ["collision", "blocked_weak", "self_source", "few_rows"])
def test_native_eth_threads_byte_equal_to_sequential_core(eth_scenes, scene, threads):
    views, src_ids, (jc, jcol) = eth_scenes[scene]
    before = dict(telemetry._counters)
    got = native.fuse_eth([tfus.FusionView(**v) for v in views], src_ids, threads=threads)
    assert got is not None, "native library unavailable"
    tc, tcol = got
    assert len(jc) > 100 and tc.shape == jc.shape and tcol.shape == jcol.shape
    assert np.array_equal(tc, jc) and np.array_equal(tcol, jcol)
    counted = {k: telemetry._counters.get(k, 0) - before.get(k, 0)
               for k in ("fusion.threads", "fusion.candidates", "fusion.candidates_consumed")}
    rows_blocks = -(-views[0]["depth"].shape[0] // 4)
    assert counted["fusion.threads"] == min(threads, rows_blocks)
    assert counted["fusion.candidates"] >= counted["fusion.candidates_consumed"] >= 0
    if scene == "collision":  # the commit's consumed-mask path decides pixels
        assert counted["fusion.candidates_consumed"] > 0


def test_fuse_eth_device_matches_jax_decisions(oracle):
    import jax.numpy as jnp

    jv, tv, src, _ = oracle
    fa = jfd.pack_views(jv, src)
    j_acc, j_X, _ = jfd._fuse_eth_program(fa, jnp.zeros(fa.depth.shape, bool))
    t_acc, t_X, _ = tfd.fuse_eth_fields(tfd.pack_views(tv, src, "cpu"))
    j_acc, t_acc = np.asarray(j_acc), t_acc.numpy()
    assert t_acc.sum() > 10000
    assert (j_acc == t_acc).mean() >= 0.999, (j_acc != t_acc).sum()
    both = j_acc & t_acc
    np.testing.assert_allclose(t_X.numpy()[both], np.asarray(j_X)[both], rtol=0, atol=1e-5)
    jc, jcol = jfd.fuse_eth_device(jv, src)
    tc, tcol = tfd.fuse_eth_device(tv, src, device="cpu")
    assert abs(tc.shape[0] - jc.shape[0]) / jc.shape[0] < 0.005, (tc.shape[0], jc.shape[0])
    assert tc.dtype == np.float32 and tcol.dtype == np.uint8 and tcol.shape == tc.shape


def test_fuse_eth_device_matches_numpy(oracle):
    _, tv, src, planes = oracle
    cd, _ = tfd.fuse_eth_device(tv, src, device="cpu")
    cp, _ = tfus.fuse_eth(tv, src, backend="numpy")
    # tests/test_fusion_device.py's decision-level bounds
    assert cd.shape[0] > 10000, cd.shape
    assert abs(cd.shape[0] - cp.shape[0]) / cp.shape[0] < 0.01, (cd.shape[0], cp.shape[0])
    assert np.median(_plane_dist(cd, planes)) < 0.01


def test_fuse_eth_device_greedy_dedup():
    """A view processed later must not re-emit points another view
    already consumed (tests/test_fusion_device.py:57)."""
    views, src_ids, _ = _views(tfus, num_views=3, width=96, height=80)
    cd, _ = tfd.fuse_eth_device(views, src_ids, device="cpu")
    total_valid = sum(int((v.depth > 0).sum()) for v in views)
    assert 0 < cd.shape[0] < total_valid


def test_fuse_eth_device_honours_the_factors(oracle):
    """The acceptance factors reach the program (the JAX package's
    ``pack_views`` fixes them at 0.45 / 0.3): a WEAK factor no score sum can
    pass rejects exactly the pixels of the WEAK boxes."""
    _, tv, src, _ = oracle
    fa = tfd.pack_views(tv, src, "cpu", weak_factor=2.0)
    weak = torch.as_tensor(np.stack([v.weak == PixelState.WEAK for v in tv]))
    assert torch.equal(fa.factor == 2.0, weak)
    acc, _, _ = tfd.fuse_eth_fields(fa)
    base, _, _ = tfd.fuse_eth_fields(tfd.pack_views(tv, src, "cpu"))
    assert not (acc & weak).any() and (base & weak).any()
    assert torch.equal(acc[0] & ~weak[0], base[0] & ~weak[0])


def test_fuse_eth_device_refuses_mixed_shapes_and_a_missing_card(oracle, monkeypatch):
    _, tv, src, _ = oracle
    small, _, _ = _views(tfus, num_views=2, width=64, height=48)
    with pytest.raises(ValueError, match="uniform"):
        tfd.fuse_eth_device([tv[0], small[1]], [[1], [0]], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tfd.fuse_eth_device(tv, src)


@pytest.fixture(scope="module")
def gt_outputs(tmp_path_factory):
    """A 4-view 128x96 dataset with the ground truth persisted as every
    view's pass outputs (a WEAK box in each view's state map)."""
    folder = str(tmp_path_factory.mktemp("torch_fusion") / "scene")
    cams, planes = tsyn.make_ring_scene(num_views=4, width=128, height=96)
    images, depths, normals = tsyn.render_scene(cams, planes)
    tsyn.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0), images=images)
    for v in range(len(cams)):
        rf = os.path.join(folder, "APD", formats.to_format_index(v))
        os.makedirs(rf, exist_ok=True)
        weak = np.full((96, 128), PixelState.STRONG, np.uint8)
        weak[30:50, 40:70] = PixelState.WEAK
        formats.write_bin_mat(os.path.join(rf, "depths.dmb"), depths[v])
        formats.write_bin_mat(os.path.join(rf, "normals.dmb"), normals[v])
        formats.write_bin_mat(os.path.join(rf, "weak.bin"), weak)
    return folder, planes


@pytest.mark.parametrize("variant", VARIANTS)
def test_run_fusion_variant_matches_jax(gt_outputs, variant):
    folder, planes = gt_outputs
    out = f"fused_{variant}.ply"
    jply = jscene.run_fusion(folder, jscene.generate_sample_list(folder), variant=variant,
                             out_name="jax_" + out)
    tply = tscene.run_fusion(folder, tscene.generate_sample_list(folder), variant=variant,
                             out_name=out, device="cpu")
    assert tply == os.path.join(folder, "APD", out)
    jc, jcol = formats.read_point_cloud(jply)
    tc, tcol = formats.read_point_cloud(tply)
    assert tc.shape[0] > 5000 and tcol.shape == tc.shape
    if variant == "eth-device":
        assert abs(tc.shape[0] - jc.shape[0]) / jc.shape[0] < 0.005, (tc.shape[0], jc.shape[0])
        assert np.median(_plane_dist(tc, planes)) < 0.01
    else:
        np.testing.assert_array_equal(jc, tc)
        np.testing.assert_array_equal(jcol, tcol)


def test_run_fusion_eth_counts_threads_and_candidates(gt_outputs):
    folder, _ = gt_outputs
    start = telemetry.scene_start("cpu")
    tscene.run_fusion(folder, tscene.generate_sample_list(folder), variant="eth",
                      out_name="counted.ply", device="cpu")
    counters = telemetry.scene_end(start)["counters"]
    # this process's CPU affinity, at most one thread a block of 4 rows
    assert counters["fusion.threads"] == min(len(os.sched_getaffinity(0)), 96 // 4) >= 1
    assert counters["fusion.candidates"] >= counters.get("fusion.candidates_consumed", 0) >= 0
    assert counters["fusion.candidates"] > 0


def test_run_fusion_refuses_an_unknown_variant(gt_outputs):
    folder, _ = gt_outputs
    with pytest.raises(ValueError, match="unknown fusion variant"):
        tscene.run_fusion(folder, tscene.generate_sample_list(folder), variant="eth_device",
                          device="cpu")
    with pytest.raises(ValueError, match="unknown fusion variant"):
        tscene.run_scene(folder, device="cpu", fusion_variant="tat")


@pytest.mark.parametrize("variant", VARIANTS)
def test_cli_fusion_flag_reaches_run_scene(monkeypatch, variant):
    seen = {}
    monkeypatch.setattr(tscene, "run_scene", lambda folder, **kw: seen.update(kw))
    cli.main(["scene", "--device", "cpu", "--fusion", variant])
    assert seen["fusion_variant"] == variant and seen["device"] == "cpu"


def test_cli_fusion_default_and_choices(monkeypatch, capsys):
    seen = {}
    monkeypatch.setattr(tscene, "run_scene", lambda folder, **kw: seen.update(kw))
    cli.main(["scene"])
    assert seen["fusion_variant"] == "eth" and seen["device"] == "cuda"
    with pytest.raises(SystemExit):
        cli.main(["scene", "--fusion", "eth_device"])
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("variant", VARIANTS)
def test_cli_fusion_writes_the_cloud(gt_outputs, variant):
    """``python -m apdmvs_tpu_torch <scene> --device cpu --fusion V`` writes
    APD/APD.ply, equal to ``run_fusion``'s cloud (``--max-rounds 0``: no
    pass runs, the persisted outputs are fused)."""
    folder, _ = gt_outputs
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "apdmvs_tpu_torch", folder, "--device", "cpu", "--fusion",
         variant, "--max-rounds", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "Round num: 0" in proc.stdout
    coords, colors = formats.read_point_cloud(os.path.join(folder, "APD", "APD.ply"))
    ref, ref_colors = formats.read_point_cloud(tscene.run_fusion(
        folder, tscene.generate_sample_list(folder), variant=variant, out_name="ref.ply",
        device="cpu"))
    assert len(coords) > 5000
    np.testing.assert_array_equal(coords, ref)
    np.testing.assert_array_equal(colors, ref_colors)
