"""The APD weak machinery (apdmvs_tpu_torch/weak.py) stage by stage against
the reference package's weak.py on the CPU.

Scene: the 3-view 128x96 ring scene with its textureless window, K=64
volumes (with C36, C9 and the depth volumes of the ground truth). Prior:
ground-truth depth with 1 % noise; WEAK pixels are the textureless window
plus a textured box, so the worklist holds both kinds. Both sides get the
same inputs (convert.py) and the reference's random draws
(tests/_torch_parity.py::JaxDraws). The reference's functions run compiled
(jax.jit), as its pass runs them.

Tolerances: the worklist, the nearest-strong map and the probe stage are
exact; anchors equal on >= 99 % of worklist rows; resident columns
bit-exact; deformed and geometric costs within 1e-4 on >= 99.9 % of
entries (a nearest slice may flip at a rounding boundary); the RANSAC fit
planes and one weak sweep within 1e-4 on >= 99 % of entries.

The reference scatters worklist results with -1 for "no write", which JAX
wraps to pixel (H-1, W-1) (apdmvs_tpu/weak.py:604-607, 1169-1197); the
port writes only the pixels meant to change. test_anchor_demotion_*
pins that divergence, and the sweep comparison leaves that pixel out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DMAX, DMIN, JaxDraws, flat_ring_scene, t
from apdmvs_tpu import geometry as jgeom, ncc as jncc, propagation as jprop
from apdmvs_tpu import sampling as jsamp, weak as jweak
from apdmvs_tpu.params import PassConfig, PixelState, RunState
from apdmvs_tpu.scene import _bucket_capacity as j_bucket_capacity
from apdmvs_tpu_torch import convert, ncc as tncc, propagation as tprop, scene as tscene
from apdmvs_tpu_torch import sampling as tsamp, weak as tweak

torch.set_num_threads(2)

W, H, V, K = 128, 96, 3, 64
RTH = 0.00875


@pytest.fixture(scope="module")
def sc():
    scene_ = flat_ring_scene(V, W, H)
    images, depths, normals, jc = (scene_[k] for k in ("images", "depths", "normals", "jcams"))
    sv = np.arange(V) > 0
    jvs = jncc.build_image_volume_set(jnp.asarray(images), jc, DMIN, DMAX, num_slices=K)
    jvs = jncc.add_depth_volumes(jvs, jnp.asarray(depths), jc, DMIN, DMAX)
    jctx = jncc.make_context(jnp.asarray(images), jc, jnp.asarray(sv), jnp.asarray(depths),
                             volumes=jvs)
    tctx = tncc.make_context(convert.to_cameras(jc), t(sv), H, W, convert.to_volume_set(jvs))

    rs = np.random.RandomState(0)
    gt = np.where(depths[0] > 0, depths[0], 4.0).astype(np.float32)
    prior_depth = (gt * (1 + 0.01 * rs.randn(H, W))).astype(np.float32)
    flat = scene_["flat"]
    ps = np.full((H, W), PixelState.STRONG, np.uint8)
    ps[flat] = PixelState.WEAK
    ps[60:72, 90:110] = PixelState.WEAK  # a textured weak box
    ps[3:9, 0:3] = PixelState.WEAK  # in a corner: no anchor triangle holds them
    ps[:3] = PixelState.UNKNOWN
    cap = j_bucket_capacity(int((ps == PixelState.WEAK).sum()), H * W)
    assert cap > int((ps == PixelState.WEAK).sum())  # the worklist has padding

    n_cam = jgeom.normal_world_to_cam(jc.R[0], jnp.asarray(normals[0]))
    x, y = jgeom.pixel_grid(H, W)
    planes = jnp.concatenate(
        [n_cam, jgeom.dist_to_origin(jc.K[0], x, y, jnp.asarray(prior_depth), n_cam)[..., None]], -1)
    sel = jnp.asarray(np.broadcast_to(sv[:, None, None], (V, H, W)))
    jst = jprop.StrongState(planes=planes, costs=jnp.full((H, W), 0.5, jnp.float32),
                            selected=sel, view_weights=jnp.zeros((V, H, W), jnp.float32))
    cfg = PassConfig(state=RunState.REFINE_ITER, geom_consistency=True, use_APD=True,
                     max_iterations=3, weak_peak_radius=4, rotate_time=2)
    key = jax.random.PRNGKey(7)
    jxy = jweak.compact_weak_pixels(jnp.asarray(ps), cap)
    txy = tweak.compact_weak_pixels(t(ps), cap)
    ja, jps = jax.jit(jweak.generate_anchors, static_argnames=("cfg",))(
        jctx, jnp.asarray(prior_depth), jnp.asarray(ps), jxy, jax.random.split(key, 3)[1], cfg,
        jnp.asarray(RTH, jnp.float32))
    return dict(images=images, depths=depths, jc=jc, jctx=jctx, tctx=tctx, ps=ps, cap=cap,
                prior_depth=prior_depth, jst=jst, cfg=cfg, key=key, jxy=jxy, txy=txy,
                ja=ja, jps=jps, ta=tweak.AnchorData(coords=convert.tensor(ja.coords)))


def test_gather_grid_and_select_axis1_match():
    rng = np.random.RandomState(3)
    field = rng.rand(7, 9, 4).astype(np.float32)
    x, y = rng.randint(-2, 12, (5, 3)), rng.randint(-2, 10, (5, 3))  # some out of the grid
    want = jsamp.gather_grid(jnp.asarray(field), jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(tsamp.gather_grid(t(field), t(x), t(y)).numpy(),
                                  np.asarray(want))
    vals, idx = rng.rand(6, 8, 3).astype(np.float32), rng.randint(0, 8, (6, 10))
    want = jsamp.select_axis1(jnp.asarray(vals), jnp.asarray(idx))
    np.testing.assert_array_equal(tsamp.select_axis1(t(vals), t(idx)).numpy(), np.asarray(want))


@pytest.mark.parametrize("size", [(128, 96), (640, 480), (1280, 960), (6048, 4032)])
def test_radius_schedule_matches(size):
    assert tweak.radius_schedule(*size) == jweak.radius_schedule(*size)


@pytest.mark.parametrize("count,total", [(0, 100), (1, 5000), (1024, 5000), (1025, 5000),
                                         (1537, 5000), (3000, 5000), (19200, 307200)])
def test_bucket_capacity_matches(count, total):
    assert tscene._bucket_capacity(count, total) == j_bucket_capacity(count, total)


@pytest.mark.parametrize("capacity", ["bucket", "short"])
def test_compact_weak_pixels_matches(sc, capacity):
    cap = sc["cap"] if capacity == "bucket" else 100  # "short": fewer slots than WEAK pixels
    want = np.asarray(jweak.compact_weak_pixels(jnp.asarray(sc["ps"]), cap))
    np.testing.assert_array_equal(tweak.compact_weak_pixels(t(sc["ps"]), cap).numpy(), want)


def test_nearest_strong_map_matches(sc):
    want = np.asarray(jax.jit(jweak.nearest_strong_map)(jnp.asarray(sc["ps"])))
    np.testing.assert_array_equal(tweak.nearest_strong_map(t(sc["ps"])).numpy(), want)


@pytest.mark.parametrize("rotate_time", [1, 2, 4])
def test_probe_strong_points_matches(sc, rotate_time):
    k_probe = jax.random.split(jax.random.split(sc["key"], 3)[1])[0]
    want = jax.jit(jweak.probe_strong_points, static_argnames=("rotate_time",))(
        jnp.asarray(sc["ps"]), sc["jxy"], k_probe, rotate_time=rotate_time)
    got = tweak.probe_strong_points(t(sc["ps"]), sc["txy"], JaxDraws(sc["key"], H, W),
                                    rotate_time)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].any()


def test_generate_anchors_matches(sc):
    ta, _ = tweak.generate_anchors(sc["tctx"], t(sc["prior_depth"]), t(sc["ps"]), sc["txy"],
                                   JaxDraws(sc["key"], H, W), sc["cfg"], RTH)
    rows = np.all(np.asarray(sc["ja"].coords) == ta.coords.numpy(), axis=(1, 2))
    print(f"anchor rows equal: {rows.mean():.6f}")
    assert rows.mean() >= 0.99, rows.mean()
    assert (ta.coords[:, 1:, 0] >= 0).any()


def test_anchor_demotion_writes_only_worklist_pixels(sc):
    """The reference demotes unreliable WEAK pixels and also turns pixel
    (H-1, W-1), STRONG in this prior, into UNKNOWN (its -1 "no write"
    entries wrap there); the port changes only worklist pixels. They agree
    on every other pixel."""
    _, tps = tweak.generate_anchors(sc["tctx"], t(sc["prior_depth"]), t(sc["ps"]), sc["txy"],
                                    JaxDraws(sc["key"], H, W), sc["cfg"], RTH)
    jps, tps = np.asarray(sc["jps"]), tps.numpy()
    assert sc["ps"][H - 1, W - 1] == PixelState.STRONG
    assert jps[H - 1, W - 1] == PixelState.UNKNOWN and tps[H - 1, W - 1] == PixelState.STRONG
    differ = np.argwhere(jps != tps)
    assert differ.tolist() == [[H - 1, W - 1]]
    changed = tps != sc["ps"]
    assert changed[3:9, 0:3].any() and (sc["ps"][changed] == PixelState.WEAK).all()


def test_weak_cols_match(sc):
    jw = jweak.build_weak_cols(sc["jctx"], sc["jxy"], sc["ja"])
    tw = tweak.build_weak_cols(sc["tctx"], sc["txy"], sc["ta"])
    for f in ("c36", "c9", "d"):
        want, got = convert.tensor(getattr(jw, f)), getattr(tw, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert torch.equal(got, want), f


def _candidate_planes(sc):
    """The 8 anchors' planes, the current plane and a perturbed one [10, N, 4]."""
    a = sc["ja"].coords[:, 1:]
    pg = sc["jst"].planes
    cur = jsamp.gather_grid(pg, sc["jxy"][:, 0], sc["jxy"][:, 1])
    return jnp.concatenate([jnp.moveaxis(jsamp.gather_grid(pg, a[..., 0], a[..., 1]), 1, 0),
                            cur[None], (cur * jnp.asarray([1, 1, 1, 1.1]))[None]])


def test_deformed_and_geom_costs_match(sc):
    jw = jweak.build_weak_cols(sc["jctx"], sc["jxy"], sc["ja"])
    tw = tweak.build_weak_cols(sc["tctx"], sc["txy"], sc["ta"])
    planes = _candidate_planes(sc)
    sel = sc["jst"].selected
    want_d = np.asarray(jax.jit(jweak.deformed_cost_vector, static_argnames=("cfg",))(
        sc["jctx"], sc["jxy"], planes, sc["ja"], sel, sc["cfg"], wcols=jw))
    got_d = tweak.deformed_cost_vector(sc["tctx"], sc["txy"], convert.tensor(planes), sc["ta"],
                                       convert.tensor(sel), tw).numpy()
    want_g = np.asarray(jax.jit(jweak._geom_cost_vector_cols)(sc["jctx"], sc["jxy"], planes, jw))
    got_g = tweak._geom_cost_vector_cols(sc["tctx"], sc["txy"], convert.tensor(planes),
                                         tw).numpy()
    for name, got, want in (("deformed", got_d, want_d), ("geom", got_g, want_g)):
        assert got.shape == want.shape == (V, 10, sc["cap"])
        close = np.abs(got - want) <= 1e-4
        print(f"{name} costs within 1e-4: {close.mean():.6f}")
        assert close.mean() >= 0.999, (name, close.mean())


@pytest.mark.parametrize("chunk_bytes", [1, 4096])
def test_deformed_costs_in_chunks_change_no_bit(sc, monkeypatch, chunk_bytes):
    """The anchor terms and the out-of-bounds tests of
    ``_warp_oob_batched`` a chunk of the 10 candidates at a time (one a
    step; a few a step) give the deformed costs of one step over all of
    them at once, bit for bit."""
    tw = tweak.build_weak_cols(sc["tctx"], sc["txy"], sc["ta"])
    planes = convert.tensor(_candidate_planes(sc))
    sel = convert.tensor(sc["jst"].selected)

    def costs():
        return tweak.deformed_cost_vector(sc["tctx"], sc["txy"], planes, sc["ta"], sel,
                                          tw).view(torch.int32)

    whole = costs()  # at this size one step holds every candidate
    monkeypatch.setattr(tweak, "_CHUNK_BYTES", chunk_bytes)
    assert torch.equal(costs(), whole)


def test_ransac_fit_planes_match(sc):
    k_iters = jax.random.split(sc["key"], 3)[2]
    k_fit = jax.random.split(jax.random.split(jax.random.fold_in(k_iters, 1), 3)[2], 3)[0]
    want = np.asarray(jax.jit(jweak.ransac_fit_planes)(sc["jctx"], sc["jst"].planes, sc["jxy"],
                                                       sc["ja"], k_fit))
    draws = JaxDraws(sc["key"], H, W).fit_ransac(1, (5, sc["cap"], 10, 3))
    got = tweak.ransac_fit_planes(sc["tctx"], convert.tensor(sc["jst"].planes), sc["txy"],
                                  sc["ta"], draws).numpy()
    rows = np.all(np.abs(got - want) <= 1e-4, axis=-1)
    print(f"fit planes within 1e-4: {rows.mean():.6f}")
    assert rows.mean() >= 0.99
    assert (np.abs(want).sum(-1) > 0).mean() > 0.5  # most rows found a plane


def test_propagate_weak_sweep_matches(sc):
    """One weak sweep (geometric pass, iteration 1) on the same state. The
    reference's (H-1, W-1) is left out (see the module docstring), and the
    rewritten costs are compared where the reference patch is textured:
    on the constant window the plain NCC is degenerate, COST_MAX in the
    port and fused-multiply-add noise in the reference
    (test_torch_cols.py)."""
    cfg, it = sc["cfg"], 1
    k_weak = jax.random.split(jax.random.fold_in(jax.random.split(sc["key"], 3)[2], it), 3)[2]
    jw = jweak.build_weak_cols(sc["jctx"], sc["jxy"], sc["ja"])
    tw = tweak.build_weak_cols(sc["tctx"], sc["txy"], sc["ta"])
    want = jax.jit(jweak.propagate_weak, static_argnames=("cfg",))(
        sc["jctx"], sc["jst"], sc["jps"], sc["jxy"], sc["ja"], jnp.asarray(it), k_weak, cfg,
        wcols=jw)
    tst = tprop.StrongState(*(convert.tensor(a) for a in sc["jst"]))
    got = tweak.propagate_weak(sc["tctx"], tst, t(sc["jps"]), sc["txy"], sc["ta"], it,
                               JaxDraws(sc["key"], H, W), cfg, tw)
    keep = np.ones((H, W), bool)
    keep[H - 1, W - 1] = False
    weak = sc["ps"] == PixelState.WEAK
    textured = np.zeros((H, W), bool)
    textured[60:72, 90:110] = True
    for f in ("planes", "selected", "view_weights", "costs"):
        w = np.asarray(getattr(want, f), np.float32)
        g = getattr(got, f).to(torch.float32).numpy()
        m = keep if f != "costs" else keep & ~(weak & ~textured)
        close = np.abs(g - w) <= 1e-4
        close = close[..., m] if f in ("selected", "view_weights") else close[m]
        print(f"sweep {f} within 1e-4: {close.mean():.6f}")
        assert close.mean() >= 0.99, (f, close.mean())
    # the sweep changed weak pixels (and only them)
    moved = np.any(got.planes.numpy() != np.asarray(sc["jst"].planes), axis=-1)
    assert moved[weak].sum() > 100 and not moved[~weak].any()


def test_probe_constants_are_all_the_probe_stage_makes(monkeypatch):
    """The probe stage's device constants come from
    ``weak.probe_constants``, which a compiled pass calls before its
    warm-up, so that no constant is made inside the graph pool: made once
    with the reference's directions and radii, the same tensors on every
    later call, and the probe stage reads them and makes no other."""
    from apdmvs_tpu_torch import rng

    monkeypatch.setattr(tweak, "_DEVICE_CONSTANTS", {})
    rotate_time, w, h = 2, 96, 64
    base, radii = tweak.probe_constants(rotate_time, w, h, "cpu")
    np.testing.assert_array_equal(base.numpy(), np.asarray(jweak._base_directions(rotate_time)))
    np.testing.assert_array_equal(
        radii.numpy(), np.repeat(np.asarray(tweak.radius_schedule(w, h), np.float32),
                                 tweak._JITTERS_PER_RADIUS))
    made = dict(tweak._DEVICE_CONSTANTS)
    again = tweak.probe_constants(rotate_time, w, h, "cpu")
    assert again[0] is base and again[1] is radii
    ps = torch.full((h, w), int(PixelState.STRONG), dtype=torch.uint8)
    ps[20:40, 30:60] = int(PixelState.WEAK)
    xy = tweak.compact_weak_pixels(ps, 1024)
    found, _, _ = tweak.probe_strong_points(ps, xy, rng.TorchDraws(0, h, w, "cpu"), rotate_time)
    assert bool(found.any())
    assert tweak._DEVICE_CONSTANTS.keys() == made.keys()
    assert all(tweak._DEVICE_CONSTANTS[k] is v for k, v in made.items())
