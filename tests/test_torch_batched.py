"""The batched runner (``scene.run_scene_batched``, ``parallel/sharded.py``)
on the CPU.

- A batched FIRST_INIT pass on the volume path is bit-equal, problem by
  problem, to the sequential runner's (both draw from
  ``rng.pass_seed(seed, pass, problem)``).
- Pinning M = 0, 1 and N of the N image-volume sets (``volume_cache_gb``)
  gives bit-equal outputs over a FIRST_INIT and a geometric pass, as in
  tests/test_scene_batched.py:167-274.
- A geometric batched pass reads the previous pass's depth stack (Jacobi),
  each problem its sources' rows.
- On the direct-warp path, a batch of two problems of which one has no
  WEAK pixel (its weak branch runs on an all-padding worklist of the
  batch's capacity) matches the reference package's
  ``sharded_batch_pass`` on a one-device mesh (``use_volumes=False``) with
  the reference's draws replayed: depth within 1e-3 on >= 99 % of pixels,
  pixel state and selected views on >= 99 % (tests/test_torch_pass.py),
  pixel (H-1, W-1) left out (the reference writes it through its wrapped
  -1 scatter indices, tests/test_torch_weak.py).
- A schedule whose first pass is not FIRST_INIT raises; ``use_volumes``
  False builds no volume in either runner; ``shard_problems`` as the
  reference's (meshes of several shards: tests/test_torch_spaced.py); the pinning policy counts the
  bytes the volume builder allocates.
- The CLI with ``--batched`` and ``--batched --no-volumes`` on
  ``--device cpu`` writes the four state files per view and a cloud on
  the scene's planes (tests/test_torch_cli.py::_cloud_ok).

Scene-level runs against the reference package's ``run_scene_batched`` are
under ``slow``, as tests/test_scene_batched.py is.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DMAX, DMIN, JaxDraws, flat_ring_scene, t
from apdmvs_tpu import geometry as jgeom, parallel as jparallel, pipeline as jpipe
from apdmvs_tpu.params import PassConfig, PixelState, RunState
from apdmvs_tpu_torch import ncc as tncc, parallel as tparallel, scene
from apdmvs_tpu_torch.datasets import synthetic
from apdmvs_tpu_torch.io import formats
from test_torch_cli import _cloud_ok

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE_FILES = ("depths.dmb", "normals.dmb", "weak.bin", "selected_views.bin")
SLICES = 32


def _dataset(folder, width=40, height=30, views=2):
    cams, planes = synthetic.make_ring_scene(num_views=views, width=width, height=height)
    synthetic.write_mvsnet_dataset(str(folder), cams, planes, depth_ranges=(2.0, 8.0))
    return str(folder), planes


def _state(folder, views=2):
    return {(v, name): formats.read_bin_mat(os.path.join(folder, "APD",
                                                         formats.to_format_index(v), name))
            for v in range(views) for name in STATE_FILES}


def _first_passes(monkeypatch, n):
    """Run the first ``n`` passes of the one-round schedule."""
    full = scene.build_schedule
    monkeypatch.setattr(scene, "build_schedule", lambda rounds: full(rounds)[:n])


def test_batched_first_init_equals_sequential(tmp_path, monkeypatch):
    _first_passes(monkeypatch, 1)
    seq, _ = _dataset(tmp_path / "seq")
    bat, _ = _dataset(tmp_path / "bat")
    scene.run_scene(seq, device="cpu", verbose=False, num_slices=SLICES)
    run = scene.run_scene_batched(bat, device="cpu", verbose=False, num_slices=SLICES)
    a, b = _state(seq), _state(bat)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    assert len(run.passes) == 2 and all(st.seconds > 0 for _, _, st in run.passes)


def test_pinned_sets_give_equal_outputs(tmp_path, monkeypatch, capsys):
    """M = 0, 1 and 3 of 3 sets pinned: bit-equal state after a FIRST_INIT
    and a geometric REFINE_ITER pass."""
    _first_passes(monkeypatch, 2)
    per_set = tncc.image_volume_set_nbytes(3, 30, 40, SLICES, weak_cost_volumes=False)
    outs = {}
    for pinned, sets in ((0, 1), (1, 2), (3, 3)):
        folder, _ = _dataset(tmp_path / f"m{pinned}", views=3)
        scene.run_scene_batched(folder, device="cpu", num_slices=SLICES,
                                volume_cache_gb=sets * per_set / 1e9)
        assert f"pinning {pinned}/3 problems" in capsys.readouterr().out
        outs[pinned] = _state(folder, views=3)
    for pinned in (0, 1):
        for k in outs[3]:
            np.testing.assert_array_equal(outs[pinned][k], outs[3][k], err_msg=f"{pinned} {k}")


def test_geometric_pass_reads_previous_stack(tmp_path, monkeypatch):
    """The depth stack a geometric batched pass gets is the previous pass's
    (clamped) output, as persisted, and each problem's source rows."""
    _first_passes(monkeypatch, 2)
    folder, _ = _dataset(tmp_path / "geo")
    seen = []
    inner = tparallel.sharded_batch_pass

    def spy(*args, **kwargs):
        if kwargs.get("all_depths") is not None:
            on_disk = np.stack([formats.read_bin_mat(os.path.join(
                folder, "APD", formats.to_format_index(v), "depths.dmb")) for v in range(2)])
            seen.append((kwargs["all_depths"].numpy().copy(), on_disk, kwargs["src_index"]))
        return inner(*args, **kwargs)

    monkeypatch.setattr(tparallel, "sharded_batch_pass", spy)
    scene.run_scene_batched(folder, device="cpu", verbose=False, num_slices=SLICES)
    assert len(seen) == 1
    stack, on_disk, src_index = seen[0]
    np.testing.assert_array_equal(stack, on_disk)
    problems = scene.generate_sample_list(folder)
    for n, p in enumerate(problems):
        assert list(src_index[n]) == [p.ref_image_id] + list(p.src_image_ids)


def _two_problems():
    """Problems 0 and 1 of the 3-view flat ring scene (64x48), priors from
    the ground truth: problem 0 with its textureless window WEAK and 20 %
    depth noise there, problem 1 all STRONG with 0.5 % noise (a STRONG
    pixel of a textureless window refines on rounding noise)."""
    sc = flat_ring_scene(3, 64, 48)
    V, H, W = sc["V"], sc["H"], sc["W"]
    K = np.stack([c.K for c in sc["cams"]]).astype(np.float32)
    R = np.stack([c.R for c in sc["cams"]]).astype(np.float32)
    tt = np.stack([c.t for c in sc["cams"]]).astype(np.float32)
    orders = [[0, 1, 2], [1, 0, 2]]
    rs = np.random.RandomState(2)
    imgs, Ks, Rs, ts, depth, normal, ps = [], [], [], [], [], [], []
    for i, order in enumerate(orders):
        imgs.append(sc["images"][order])
        Ks.append(K[order]), Rs.append(R[order]), ts.append(tt[order])
        gt = np.where(sc["depths"][i] > 0, sc["depths"][i], 4.0)
        flat = (np.abs(sc["images"][i] - 128.0) < 1e-3) & (i == 0)
        depth.append((gt * (1 + np.where(flat, 0.2, 0.005) * rs.randn(H, W))).astype(np.float32))
        normal.append(sc["normals"][i])
        ps.append(np.where(flat, PixelState.WEAK, PixelState.STRONG).astype(np.uint8))
    N = len(orders)
    sv = np.broadcast_to(np.arange(V) > 0, (N, V)).copy()
    prior = jpipe.PassState(
        depth=np.stack(depth), normal_world=np.stack(normal), pixel_state=np.stack(ps),
        selected=np.broadcast_to(sv[:, :, None, None], (N, V, H, W)).copy())
    dmin, dmax = np.full((N, V), DMIN, np.float32), np.full((N, V), DMAX, np.float32)
    return sc, np.stack(imgs), np.stack(Ks), np.stack(Rs), np.stack(ts), dmin, dmax, sv, prior


def test_direct_batch_with_a_problem_without_weak_pixels_matches_reference():
    sc, imgs, K, R, tt, dmin, dmax, sv, prior = _two_problems()
    N, V, H, W = imgs.shape
    counts = (prior.pixel_state == PixelState.WEAK).sum(axis=(1, 2))
    assert counts[0] > 0 and counts[1] == 0
    cap = scene._bucket_capacity(int(counts.max()), H * W)
    cfg = PassConfig(state=RunState.REFINE_INIT, geom_consistency=False, use_APD=True,
                     max_iterations=1, weak_peak_radius=6, rotate_time=2)
    rth = np.full(N, 0.00875, np.float32)
    keys = jnp.stack([jax.random.PRNGKey(20 + i) for i in range(N)])
    jcams = jax.vmap(jgeom.make_cameras)(jnp.asarray(K), jnp.asarray(R), jnp.asarray(tt),
                                         jnp.asarray(dmin), jnp.asarray(dmax))
    mesh = jparallel.make_mesh(n_view=1, n_space=1)
    jout = jparallel.sharded_batch_pass(
        mesh, jnp.asarray(imgs), jcams, jnp.asarray(sv),
        jax.tree.map(jnp.asarray, prior), keys, jnp.asarray(rth), cfg, weak_capacity=cap,
        use_volumes=False)
    from apdmvs_tpu_torch import geometry as tgeom, pipeline as tpipe

    tcams = tgeom.make_cameras(K, R, tt, dmin, dmax)
    tprior = tpipe.PassState(depth=t(prior.depth), normal_world=t(prior.normal_world),
                             pixel_state=t(prior.pixel_state), selected=t(prior.selected))
    tout = tparallel.sharded_batch_pass(
        t(imgs), tcams, t(sv), tprior, [JaxDraws(keys[i], H, W) for i in range(N)], rth, cfg,
        weak_capacity=cap, use_volumes=False)
    keep = np.ones((H, W), bool)
    keep[H - 1, W - 1] = False
    for i in range(N):
        jd, td = np.asarray(jout.depth[i]), tout.depth[i].numpy()
        rel = (np.abs(td - jd) / np.maximum(np.abs(jd), 1e-6))[keep]
        state_ok = (np.asarray(jout.pixel_state[i]) == tout.pixel_state[i].numpy())[keep].mean()
        sel_ok = np.all(np.asarray(jout.selected[i]) == tout.selected[i].numpy(),
                        axis=0)[keep].mean()
        print(f"problem {i}: depth within 1e-3 {np.mean(rel < 1e-3):.6f}, state "
              f"{state_ok:.6f}, selected {sel_ok:.6f}")
        assert np.mean(rel < 1e-3) >= 0.99 and state_ok >= 0.99 and sel_ok >= 0.99


@pytest.mark.parametrize("count,shards", [(5, 1), (5, 2), (8, 4), (3, 8)])
def test_shard_problems_matches(count, shards):
    want = jparallel.shard_problems(count, shards)
    got = tparallel.shard_problems(count, shards)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("weak_cost_volumes", [False, True])
def test_image_volume_set_nbytes_counts_the_set(weak_cost_volumes):
    """The pinning policy's set size is the bytes the builder allocates."""
    from apdmvs_tpu_torch import geometry as tgeom

    cams, planes = synthetic.make_ring_scene(num_views=3, width=40, height=30)
    images, _, _ = synthetic.render_scene(cams, planes)
    tc = tgeom.make_cameras(np.stack([c.K for c in cams]), np.stack([c.R for c in cams]),
                            np.stack([c.t for c in cams]), np.full(3, DMIN), np.full(3, DMAX))
    vs = tncc.build_image_volume_set(t(images), tc, DMIN, DMAX, num_slices=8,
                                     weak_cost_volumes=weak_cost_volumes)
    built = sum(f.numel() * f.element_size() for f in vs if f is not None)
    assert tncc.image_volume_set_nbytes(3, 30, 40, 8, weak_cost_volumes) == built
    assert tparallel.pinned_count(built, 4, 2.5 * built) == 1  # 2 fit, one held back
    assert tparallel.pinned_count(built, 4, 4 * built) == 4


def test_first_pass_must_be_first_init(tmp_path, monkeypatch):
    folder, _ = _dataset(tmp_path / "scene")
    full = scene.build_schedule
    monkeypatch.setattr(scene, "build_schedule", lambda rounds: full(rounds)[1:])
    with pytest.raises(ValueError, match="FIRST_INIT"):
        scene.run_scene_batched(folder, device="cpu", verbose=False)


@pytest.mark.parametrize("runner", ["run_scene", "run_scene_batched"])
def test_no_volumes_builds_no_volume(tmp_path, monkeypatch, runner):
    """A FIRST_INIT and a geometric pass without volumes; the volume
    builders raise if called."""
    _first_passes(monkeypatch, 2)

    def refuse(*args, **kwargs):
        raise AssertionError("a volume was built on the direct-warp path")

    for name in ("build_image_volume_set", "add_depth_volumes"):
        monkeypatch.setattr(tncc, name, refuse)
    folder, _ = _dataset(tmp_path / "scene")
    getattr(scene, runner)(folder, device="cpu", verbose=False, use_volumes=False)
    st = _state(folder)
    for v in range(2):
        assert np.isfinite(st[(v, "depths.dmb")]).all() and (st[(v, "depths.dmb")] > 0).any()


@pytest.mark.parametrize("flags", [["--batched"], ["--batched", "--no-volumes"]],
                         ids=["batched", "batched-no-volumes"])
def test_cli_batched_cpu_end_to_end(tmp_path, flags):
    """On an 80x60 scene (the verify scene's cost on the CPU is minutes on
    the direct path), so > 800 fused points, as the two-round CLI test's
    smaller scene asks (tests/test_torch_cli.py)."""
    width, height = 80, 60
    folder, planes = _dataset(tmp_path / "scene", width, height, views=3)
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "apdmvs_tpu_torch", folder, "--device", "cpu"]
                          + flags, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "views batched" in proc.stdout
    for (v, name), a in _state(folder, views=3).items():
        assert a.shape[:2] == (height, width), (v, name)
    _cloud_ok(folder, planes, min_points=800)


def test_cli_batched_without_a_card_fails(tmp_path):
    """Without --device the batched runner targets the card and refuses to
    run on a machine without one."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    folder, _ = _dataset(tmp_path / "scene")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "apdmvs_tpu_torch", folder, "--batched",
                           "--no-volumes"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr


@pytest.mark.slow
@pytest.mark.parametrize("use_volumes", [False, True], ids=["direct", "volumes"])
def test_run_scene_batched_against_reference(tmp_path, use_volumes):
    """The 4-view 128x96 ring scene through both packages' batched runners
    (their own draws): each cloud lies on the scene's planes, and the
    port's per-view median depth error is within 0.002 of the reference's."""
    from apdmvs_tpu import scene as jscene

    cams, planes = synthetic.make_ring_scene(num_views=4, width=128, height=96)
    _, depths, _ = synthetic.render_scene(cams, planes)
    errs = {}
    for name, run in (("port", lambda f: scene.run_scene_batched(
            f, device="cpu", verbose=False, use_volumes=use_volumes, num_slices=64).ply),
                      ("reference", lambda f: jscene.run_scene_batched(
                          f, n_view_shards=1, verbose=False, use_volumes=use_volumes,
                          num_slices=64))):
        folder = str(tmp_path / name)
        synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
        run(folder)
        coords, _ = formats.read_point_cloud(os.path.join(folder, "APD", "APD.ply"))
        d = np.full(coords.shape[0], np.inf)
        for pl in planes:
            d = np.minimum(d, np.abs((coords.astype(np.float64) - pl.p0) @ pl.n))
        assert coords.shape[0] > 2000 and np.median(d) < 0.04, (name, coords.shape, np.median(d))
        errs[name] = []
        for v in range(4):
            dm = formats.read_bin_mat(os.path.join(folder, "APD", formats.to_format_index(v),
                                                   "depths.dmb"))
            gt = depths[v]
            m = np.zeros_like(gt, bool)
            m[8:-8, 10:-10] = gt[8:-8, 10:-10] > 0
            errs[name].append(float(np.median(np.abs(dm - gt)[m] / gt[m])))
    print(errs)
    assert max(errs["port"]) <= max(errs["reference"]) + 0.002, errs
