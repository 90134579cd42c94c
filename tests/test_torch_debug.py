"""The port's debug probes (``apdmvs_tpu_torch/debug.py``,
``pipeline.DebugProbes``, ``classify.depth_to_weak(return_sweep=)``,
``scene.run_scene(debug_dumps=)``, ``--debug-dumps``) on the CPU.

- ``dump_probes`` writes the JAX package's bytes from the same probes
  (numpy arrays, or int64 tensors on the port's side: the files hold int32
  and int16 as the JAX module writes them), and each package's
  ``read_neighbours`` reads the other's files.
- The sweep ``depth_to_weak(return_sweep=True)`` returns against the JAX
  package's on the inputs of
  ``tests/test_torch_modules.py::test_depth_to_weak_matches``: >= 99 % of
  entries within 1e-4 (the NCC tolerance, tests/test_ncc_volume.py:112).
- ``debug=True`` changes only what the pass returns: every output equal
  bit for bit to ``debug=False`` with the same draws, and the generator
  left in the same state, on the volume path, a spaced set and the
  direct-warp path.
- ``run_scene(debug_dumps=True, min_rounds=2)`` writes the three files of
  every view's round-1 passes, readable; the CLI refuses ``--debug-dumps``
  and ``--profile-dir`` with ``--batched``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import t
from apdmvs_tpu import classify as jcls, debug as jdebug, params as jparams
from apdmvs_tpu_torch import __main__ as cli, classify as tcls, debug as tdebug, geometry, ncc
from apdmvs_tpu_torch import params as tparams, pipeline, rng, scene
from apdmvs_tpu_torch.datasets import synthetic
from apdmvs_tpu_torch.io import formats
from apdmvs_tpu_torch.params import PassConfig, PixelState, RunState
from test_torch_modules import _classify_inputs, sc  # noqa: F401  (sc is a fixture)

torch.set_num_threads(2)

FILES = ("neighbour_map.bin", "neighbour.bin", "weak_cost_line.dmb")
DMIN, DMAX = 2.0 * 0.6, 8.0 * 1.2


class _Probes:
    def __init__(self, weak_xy, anchor_coords, sweep):
        self.weak_xy, self.anchor_coords, self.sweep = weak_xy, anchor_coords, sweep


def _random_probes(H=300, W=40, N=64, live=50):
    """Probes of a worklist of ``live`` distinct pixels padded with -1 to N;
    H > DEBUG_POINT_Y, so the cost line is row 259."""
    rs = np.random.RandomState(0)
    pix = rs.choice(H * W, live, replace=False)
    weak_xy = np.full((N, 2), -1, np.int32)
    weak_xy[:live, 0], weak_xy[:live, 1] = pix % W, pix // W
    coords = rs.randint(-1, min(H, W), (N, 9, 2)).astype(np.int32)
    coords[:, 0] = weak_xy
    sweep = rs.rand(61, H, W).astype(np.float32)
    return weak_xy, coords, sweep


def _read(folder, name):
    with open(os.path.join(folder, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", ["numpy", "tensors", "no_worklist"])
def test_dump_probes_writes_the_jax_modules_bytes(tmp_path, kind):
    weak_xy, coords, sweep = _random_probes()
    H, W = sweep.shape[1:]
    jdebug.dump_probes(str(tmp_path / "jax"), _Probes(
        None if kind == "no_worklist" else weak_xy, coords, sweep), H, W)
    if kind == "tensors":  # the port's worklist and anchors are int64
        probes = _Probes(torch.as_tensor(weak_xy, dtype=torch.int64),
                         torch.as_tensor(coords, dtype=torch.int64), torch.as_tensor(sweep))
    else:
        probes = _Probes(None if kind == "no_worklist" else weak_xy, coords, sweep)
    tdebug.dump_probes(str(tmp_path / "port"), probes, H, W)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert names == (["weak_cost_line.dmb"] if kind == "no_worklist" else sorted(FILES))
    for name in names:
        assert _read(tmp_path / "jax", name) == _read(tmp_path / "port", name), name
    line = formats.read_bin_mat(str(tmp_path / "port" / "weak_cost_line.dmb"))
    np.testing.assert_array_equal(line, sweep[:, tdebug.DEBUG_POINT_Y, :])
    assert (tdebug.DEBUG_POINT_X, tdebug.DEBUG_POINT_Y) == (jdebug.DEBUG_POINT_X,
                                                           jdebug.DEBUG_POINT_Y)


def test_read_neighbours_reads_either_packages_files(tmp_path):
    weak_xy, coords, sweep = _random_probes()
    H, W = sweep.shape[1:]
    jdebug.dump_probes(str(tmp_path / "jax"), _Probes(weak_xy, coords, sweep), H, W, line_y=3)
    tdebug.dump_probes(str(tmp_path / "port"), _Probes(weak_xy, coords, sweep), H, W, line_y=3)
    live = coords[weak_xy[:, 0] >= 0].astype(np.int16)
    for folder in ("jax", "port"):
        path = str(tmp_path / folder / "neighbour.bin")
        for reader in (jdebug.read_neighbours, tdebug.read_neighbours):
            nb = reader(path)
            assert nb.dtype == np.int16 and nb.shape == (50, 9, 2)
            np.testing.assert_array_equal(nb, live)
        nb_map = formats.read_bin_mat(str(tmp_path / folder / "neighbour_map.bin"))
        assert nb_map.dtype == np.int32 and nb_map.shape == (H, W)
        assert nb.shape[0] == int((nb_map >= 0).sum())
        ys, xs = np.nonzero(nb_map >= 0)
        np.testing.assert_array_equal(live[nb_map[ys, xs], 0], np.stack([xs, ys], -1))
        np.testing.assert_array_equal(
            formats.read_bin_mat(str(tmp_path / folder / "weak_cost_line.dmb")), sweep[:, 3])


@pytest.mark.parametrize("geom", [False, True])
def test_depth_to_weak_sweep_matches(sc, geom):  # noqa: F811
    pw, sel, vw = _classify_inputs(sc)
    jcfg = jparams.PassConfig(state=jparams.RunState.REFINE_ITER, geom_consistency=geom,
                              use_APD=False)
    tcfg = tparams.PassConfig(state=tparams.RunState.REFINE_ITER, geom_consistency=geom,
                              use_APD=False)
    js, jsweep = jcls.depth_to_weak(sc["jctx"], jnp.asarray(pw), jnp.asarray(sel),
                                    jnp.asarray(vw), 4, jcfg, return_sweep=True)
    ts, tsweep = tcls.depth_to_weak(sc["tctx"], t(pw), t(sel), t(vw), 4, tcfg,
                                    return_sweep=True)
    assert tsweep.shape == (61, sc["H"], sc["W"]) and tsweep.dtype == torch.float32
    diff = np.abs(tsweep.numpy() - np.asarray(jsweep))
    share = float((diff <= 1e-4).mean())
    print(f"geom={geom}: sweep entries within 1e-4 of the JAX package's {share:.6f}, "
          f"max abs difference {diff.max():.3e}")
    assert share >= 0.99
    # the state is the one the function returns without the sweep
    assert torch.equal(ts, tcls.depth_to_weak(sc["tctx"], t(pw), t(sel), t(vw), 4, tcfg))
    assert float((ts.numpy() == np.asarray(js)).mean()) >= 0.99


@pytest.fixture(scope="module")
def small_scene():
    cams_s, planes = synthetic.make_ring_scene(num_views=3, width=64, height=48,
                                               include_flat_region=True)
    images, depths, normals = synthetic.render_scene(cams_s, planes)
    cams = geometry.make_cameras(
        np.stack([c.K for c in cams_s]), np.stack([c.R for c in cams_s]),
        np.stack([c.t for c in cams_s]), np.full(3, DMIN), np.full(3, DMAX), device="cpu")
    return torch.as_tensor(images), torch.as_tensor(depths), normals, cams


@pytest.mark.parametrize("path", ["volumes", "spaced", "direct"])
def test_debug_changes_no_pass_output(small_scene, path):
    """Tolerance: bit for bit (torch.equal), every field, and the same
    generator state after the pass (no extra draw)."""
    imgs, dm, normals, cams = small_scene
    V, H, W = imgs.shape
    ps = torch.full((H, W), int(PixelState.STRONG), dtype=torch.uint8)
    ps[H // 3:2 * H // 3, W // 3:2 * W // 3] = int(PixelState.WEAK)
    sv = torch.arange(V) > 0
    prior = pipeline.PassState(depth=dm[0], normal_world=torch.as_tensor(normals[0]),
                               pixel_state=ps,
                               selected=sv[:, None, None].expand(V, H, W).clone())
    cfg = PassConfig(state=RunState.REFINE_ITER, geom_consistency=True, use_APD=True,
                     max_iterations=2, weak_peak_radius=4)
    vs = None
    if path == "volumes":
        vs = ncc.add_depth_volumes(ncc.build_image_volume_set(imgs, cams, DMIN, DMAX,
                                                              num_slices=32),
                                   dm, cams, DMIN, DMAX)
    elif path == "spaced":
        vs = ncc.build_volume_set_spaced(imgs, cams, DMIN, DMAX, ["cpu"] * 2, num_slices=32,
                                         depth_maps=dm)
    cap = 1024
    runs = []
    for debug in (False, True):
        draws = rng.TorchDraws(5, H, W, "cpu")
        out = pipeline.patchmatch_pass(cams, sv, prior, draws, cfg, vs, weak_capacity=cap,
                                       ransac_threshold=0.00875, images=imgs, depth_maps=dm,
                                       debug=debug)
        runs.append((out, draws.gen.get_state()))
    (ref, ref_gen), ((out, probes), gen) = runs
    assert isinstance(out, pipeline.PassOutputs) and isinstance(probes, pipeline.DebugProbes)
    for name, a, b in zip(ref._fields, ref, out):
        assert torch.equal(a, b), name
    assert torch.equal(ref_gen, gen)
    weak_count = int((ps == PixelState.WEAK).sum())
    live = probes.weak_xy[:, 0] >= 0
    assert probes.weak_xy.shape == (cap, 2) and int(live.sum()) == weak_count
    assert probes.anchor_coords.shape == (cap, 9, 2)
    assert torch.equal(probes.anchor_coords[:, 0], probes.weak_xy)
    a = probes.anchor_coords[live][:, 1:]
    inside = (a[..., 0] >= 0) & (a[..., 0] < W) & (a[..., 1] >= 0) & (a[..., 1] < H)
    missing = (a[..., 0] == -1) & (a[..., 1] == -1)
    assert bool((inside | missing).all()) and bool(inside.any())
    assert probes.sweep.shape == (61, H, W)
    assert bool(torch.isfinite(probes.sweep).all()) and float(probes.sweep.max()) <= ncc.COST_MAX


def test_run_scene_debug_dumps_two_rounds(tmp_path):
    folder = str(tmp_path / "scene")
    cams, planes = synthetic.make_ring_scene(num_views=3, width=64, height=48,
                                             include_flat_region=True)
    synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
    run = scene.run_scene(folder, device="cpu", min_rounds=2, verbose=False, num_slices=32,
                          debug_dumps=True)
    weak_in = {p.ref_image_id: st.weak_in for spec, p, st in run.passes
               if spec.round_index == 1 and spec.state == RunState.REFINE_INIT}
    for v in range(3):
        rf = os.path.join(folder, "APD", formats.to_format_index(v))
        line = formats.read_bin_mat(os.path.join(rf, "weak_cost_line.dmb"))
        assert line.shape == (61, 64) and np.isfinite(line).all()
        if weak_in[v]:  # the last pass that had a worklist wrote the neighbour files
            nb = tdebug.read_neighbours(os.path.join(rf, "neighbour.bin"))
            nb_map = formats.read_bin_mat(os.path.join(rf, "neighbour_map.bin"))
            assert nb_map.shape == (48, 64) and nb.shape[1:] == (9, 2)
            assert nb.shape[0] == int((nb_map >= 0).sum()) > 0
    assert sum(weak_in.values()) > 0


@pytest.mark.parametrize("flag", [["--debug-dumps"], ["--profile-dir", "trace_dir"]])
def test_cli_refuses_debug_and_profile_flags_with_batched(tmp_path, capsys, flag):
    with pytest.raises(SystemExit) as exc:
        cli.main([str(tmp_path), "--device", "cpu", "--batched"] + flag)
    assert exc.value.code == 2
    assert f"{flag[0]} applies to the sequential runner only" in capsys.readouterr().err
