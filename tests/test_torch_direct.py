"""The direct-warp path (no volumes) against the reference package's, on the
CPU, where the reference package itself runs it by default.

Scene: the 3-view 128x96 ring scene with its textureless window
(tests/_torch_parity.py), the ground-truth depth maps as the source views'
depths. Both sides get the same inputs (convert.py) and, for the passes,
the reference's random draws (JaxDraws). The reference's functions run
compiled (jax.jit), as its pass runs them.

Tolerances. Evaluators (``ncc_cost_view`` in grid mode and in point mode
with leading batch dims, ``geom_cost_view``, ``cost_vector`` and
``geom_cost_vector`` without volumes, ``point_cost_volume`` /
``fetch_cost``, the direct and the point-volume branch of
``deformed_cost_vector``): costs within 1e-4 on >= 99.9 % of entries
(both sides round the warp, the bilinear weights and the moments in
float32, in other orders), out-of-bounds masks equal. Passes (FIRST_INIT,
REFINE_ITER with geometric consistency, REFINE_INIT with the APD weak
machinery) against ``patchmatch_pass_impl(volumes=None)``: the agreement
fractions of tests/test_torch_pass.py (FIRST_INIT depth within 1e-3 on
>= 98 % of pixels and within 1e-2 on >= 99 %; the others within 1e-3 on
>= 99 %; pixel state and selected views equal on >= 99 %). The reference
writes pixel (H-1, W-1) through its wrapped -1 scatter indices on APD
passes (tests/test_torch_weak.py), so that pixel is left out there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DMAX, DMIN, JaxDraws, flat_ring_scene, t
from apdmvs_tpu import ncc as jncc, pipeline as jpipe, weak as jweak
from apdmvs_tpu.ops import cost_volume as jcv
from apdmvs_tpu.params import PassConfig, PixelState, RunState
from apdmvs_tpu.scene import _bucket_capacity
from apdmvs_tpu_torch import convert, ncc as tncc, pipeline as tpipe, weak as tweak
from apdmvs_tpu_torch.ops import cost_volume as tcv

torch.set_num_threads(2)

W, H, V, K = 128, 96, 3, 64
RTH = 0.00875
TOL, FRAC = 1e-4, 0.999


def _close(got, want, tol=TOL, frac=FRAC, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    ok = (np.abs(got - want) <= tol) | (np.isnan(got) & np.isnan(want))
    print(f"{name}: within {tol}: {ok.mean():.6f}")
    assert ok.mean() >= frac, (name, ok.mean())


@pytest.fixture(scope="module")
def sc():
    s = flat_ring_scene(V, W, H)
    images, depths, normals, jc = (s[k] for k in ("images", "depths", "normals", "jcams"))
    sv = np.arange(V) > 0
    s["sv"] = sv
    s["jctx"] = jncc.make_context(jnp.asarray(images), jc, jnp.asarray(sv), jnp.asarray(depths))
    s["tc"] = convert.to_cameras(jc)
    s["tctx"] = tncc.make_context(s["tc"], t(sv), H, W, images=t(images), depth_maps=t(depths))
    rs = np.random.RandomState(0)
    gt = np.where(depths[0] > 0, depths[0], 4.0).astype(np.float32)
    s["gt"] = gt
    # plane fields: the ground truth with 1 % depth noise, random depths,
    # and tilted normals
    x, y = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    K0 = np.asarray(jc.K[0])
    dirs = np.stack([(x - K0[0, 2]) / K0[0, 0], (y - K0[1, 2]) / K0[1, 1], np.ones_like(x)], -1)
    n_cam = np.einsum("ij,hwj->hwi", np.asarray(jc.R[0]), normals[0]).astype(np.float32)
    tilt = n_cam + 0.3 * rs.randn(H, W, 3).astype(np.float32)
    tilt[..., 2] = -np.abs(tilt[..., 2]) - 0.2
    tilt /= np.linalg.norm(tilt, axis=-1, keepdims=True)
    fields = []
    for n, d in ((n_cam, gt * (1 + 0.01 * rs.randn(H, W))),
                 (n_cam, rs.uniform(DMIN, DMAX, (H, W))),
                 (tilt, gt)):
        w = -d * np.sum(n * dirs, -1)
        fields.append(np.concatenate([n, w[..., None]], -1))
    s["planes"] = np.stack(fields).astype(np.float32)  # [3, H, W, 4]
    # a worklist over the textureless window and a textured box, and its
    # anchors from the reference's anchor search
    ps = np.full((H, W), PixelState.STRONG, np.uint8)
    ps[s["flat"]] = PixelState.WEAK
    ps[60:72, 90:110] = PixelState.WEAK
    s["ps"] = ps
    s["cap"] = _bucket_capacity(int((ps == PixelState.WEAK).sum()), H * W)
    s["cfg"] = PassConfig(state=RunState.REFINE_ITER, geom_consistency=True, use_APD=True,
                          max_iterations=3, weak_peak_radius=4, rotate_time=2)
    s["jxy"] = jweak.compact_weak_pixels(jnp.asarray(ps), s["cap"])
    ja, _ = jax.jit(jweak.generate_anchors, static_argnames=("cfg",))(
        s["jctx"], jnp.asarray(gt), jnp.asarray(ps), s["jxy"], jax.random.PRNGKey(7), s["cfg"],
        jnp.asarray(RTH, jnp.float32))
    s["ja"] = ja
    s["ta"] = tweak.AnchorData(coords=convert.tensor(ja.coords))
    assert (np.asarray(ja.coords)[:, 1:, 0] >= 0).any()
    return s


def _worklist_planes(sc):
    """Candidate planes at the worklist: the 3 fields gathered there [3, N, 4]."""
    xy = np.asarray(sc["jxy"]).clip(0)
    return sc["planes"][:, xy[:, 1], xy[:, 0]]


_jit_view = jax.jit(jncc.ncc_cost_view, static_argnames=("radius", "increment"))


@pytest.mark.parametrize("window", [(5, 2), (5, 5)])
def test_ncc_cost_view_grid_matches(sc, window):
    r, inc = window
    planes = sc["planes"]
    got = tncc.ncc_cost_view(sc["tctx"], torch.arange(1, V), t(planes), r, inc)
    for v in range(1, V):
        want = _jit_view(sc["jctx"], jnp.asarray(v), jnp.asarray(planes), radius=r, increment=inc)
        _close(got[v - 1].numpy(), want, name=f"grid view {v}")


@pytest.mark.parametrize("layout", ["candidates", "anchors"])
def test_ncc_cost_view_point_matches(sc, layout):
    """Point mode with leading batch dims: planes [C, N, 4] at xs [N] (the
    strong window) and planes [C, N, 1, 4] at the anchors xs [N, 8] (the
    weak window)."""
    planes = _worklist_planes(sc)
    if layout == "candidates":
        xy = np.asarray(sc["jxy"]).astype(np.float32)
        xs, ys, r, inc = xy[:, 0], xy[:, 1], 5, 2
    else:
        a = np.asarray(sc["ja"].coords)[:, 1:].astype(np.float32)
        xs, ys, r, inc = a[..., 0], a[..., 1], 5, 5
        planes = planes[:, :, None]
    got = tncc.ncc_cost_view(sc["tctx"], torch.arange(1, V), t(planes), r, inc, xs=t(xs),
                             ys=t(ys))
    for v in range(1, V):
        want = _jit_view(sc["jctx"], jnp.asarray(v), jnp.asarray(planes), radius=r,
                         increment=inc, xs=jnp.asarray(xs), ys=jnp.asarray(ys))
        _close(got[v - 1].numpy(), want, name=f"{layout} view {v}")


@pytest.mark.parametrize("mode", ["grid", "point"])
def test_geom_cost_view_and_vectors_match(sc, mode):
    """geom_cost_view per view, and both cost vectors without volumes."""
    if mode == "grid":
        planes, xs, ys = sc["planes"], None, None
    else:
        planes = _worklist_planes(sc)
        xy = np.asarray(sc["jxy"]).astype(np.float32)
        xs, ys = xy[:, 0], xy[:, 1]
    jxs = None if xs is None else jnp.asarray(xs)
    jys = None if ys is None else jnp.asarray(ys)
    txs = None if xs is None else t(xs)
    tys = None if ys is None else t(ys)
    got = tncc.geom_cost_view(sc["tctx"], torch.arange(1, V), t(planes), txs, tys)
    for v in range(1, V):
        want = jax.jit(jncc.geom_cost_view)(sc["jctx"], jnp.asarray(v), jnp.asarray(planes),
                                            jxs, jys)
        _close(got[v - 1].numpy(), want, name=f"geom {mode} view {v}")
    want_g = jax.jit(jncc.geom_cost_vector)(sc["jctx"], jnp.asarray(planes), jxs, jys)
    _close(tncc.geom_cost_vector(sc["tctx"], t(planes), txs, tys).numpy(), want_g,
           name=f"geom_cost_vector {mode}")
    want_c = jax.jit(jncc.cost_vector, static_argnames=("radius", "increment"))(
        sc["jctx"], jnp.asarray(planes), radius=5, increment=2, xs=jxs, ys=jys)
    _close(tncc.cost_vector(sc["tctx"], t(planes), 5, 2, txs, tys).numpy(), want_c,
           name=f"cost_vector {mode}")


def test_point_cost_volume_and_fetch_cost_match(sc):
    """The cost volumes read point by point, the oob masks equal; and
    fetch_cost on slices in, below and above the grid."""
    jvs = jncc.build_image_volume_set(jnp.asarray(sc["images"]), sc["jcams"], DMIN, DMAX,
                                      num_slices=K)
    jctx = sc["jctx"]._replace(volumes=jvs)
    tctx = tncc.make_context(sc["tc"], t(sc["sv"]), H, W, convert.to_volume_set(jvs))
    planes = _worklist_planes(sc)
    xy = np.asarray(sc["jxy"])
    a = np.asarray(sc["ja"].coords)[:, 1:]
    for which, pl, xs, ys in (("C36", planes, xy[:, 0], xy[:, 1]),
                              ("C9", planes[:, :, None], a[..., 0], a[..., 1])):
        wc, wo = jax.jit(jncc.point_cost_volume, static_argnames=("which",))(
            jctx, jnp.asarray(pl), jnp.asarray(xs), jnp.asarray(ys), which=which)
        gc, go = tncc.point_cost_volume(tctx, t(pl), t(xs), t(ys), which)
        np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
        _close(gc.numpy(), wc, name=f"point_cost_volume {which}")
    rs = np.random.RandomState(5)
    k = rs.uniform(-3, K + 3, xy.shape[0]).astype(np.float32)
    k[:4] = [0.0, K - 1.0, -1e9, 1e9]
    want = jcv.fetch_cost(jvs.C36[0], jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1]),
                          jnp.asarray(k), 4, 4)
    got = tcv.fetch_cost(convert.tensor(jvs.C36[0]), t(xy[:, 0]), t(xy[:, 1]), t(k), 4, 4)
    _close(got.numpy(), want, tol=1e-6, frac=1.0, name="fetch_cost")


@pytest.mark.parametrize("branch", ["direct", "point volume"])
def test_deformed_cost_vector_matches(sc, branch):
    """Both branches without resident columns: the direct warp (no
    volumes) and the cost volumes read point by point (C36 and C9, no
    WeakCols)."""
    jctx, tctx = sc["jctx"], sc["tctx"]
    if branch == "point volume":
        jvs = jncc.build_image_volume_set(jnp.asarray(sc["images"]), sc["jcams"], DMIN, DMAX,
                                          num_slices=K)
        jctx = jctx._replace(volumes=jvs)
        tctx = tncc.make_context(sc["tc"], t(sc["sv"]), H, W, convert.to_volume_set(jvs))
    planes = _worklist_planes(sc)
    sel = np.broadcast_to(sc["sv"][:, None, None], (V, H, W)).copy()
    sel[2, 40:60] = False  # views unselected at some anchors
    want = jax.jit(jweak.deformed_cost_vector, static_argnames=("cfg",))(
        jctx, sc["jxy"], jnp.asarray(planes), sc["ja"], jnp.asarray(sel), sc["cfg"])
    got = tweak.deformed_cost_vector(tctx, convert.tensor(sc["jxy"]), t(planes), sc["ta"],
                                     t(sel), cfg=sc["cfg"])
    _close(got.numpy(), want, name=f"deformed {branch}")
    assert want.shape == (V, 3, sc["cap"])


PASSES = {
    "first_init": PassConfig(state=RunState.FIRST_INIT, geom_consistency=False, use_APD=False,
                             max_iterations=1, weak_peak_radius=6),
    "refine_iter_geom": PassConfig(state=RunState.REFINE_ITER, geom_consistency=True,
                                   use_APD=False, max_iterations=1, weak_peak_radius=4),
    "refine_init_apd": PassConfig(state=RunState.REFINE_INIT, geom_consistency=False,
                                  use_APD=True, max_iterations=1, weak_peak_radius=6,
                                  rotate_time=2),
}


def _prior(sc, case):
    if case == "first_init":
        return jpipe.PassState(depth=jnp.zeros((H, W)), normal_world=jnp.zeros((H, W, 3)),
                               pixel_state=jnp.full((H, W), PixelState.STRONG, jnp.uint8),
                               selected=jnp.zeros((V, H, W), bool))
    rs = np.random.RandomState(1)
    noise = np.where(sc["flat"], 0.2, 0.005) * rs.randn(H, W)
    ps = np.where(sc["flat"], PixelState.WEAK, PixelState.STRONG).astype(np.uint8)
    return jpipe.PassState(
        depth=jnp.asarray((sc["gt"] * (1 + noise)).astype(np.float32)),
        normal_world=jnp.asarray(sc["normals"][0]), pixel_state=jnp.asarray(ps),
        selected=jnp.asarray(np.broadcast_to(sc["sv"][:, None, None], (V, H, W))))


@pytest.mark.parametrize("case", list(PASSES))
def test_direct_pass_matches_reference(sc, case):
    cfg = PASSES[case]
    prior = _prior(sc, case)
    cap = _bucket_capacity(int((np.asarray(prior.pixel_state) == PixelState.WEAK).sum()),
                           H * W) if cfg.use_APD else 0
    dm = jnp.asarray(sc["depths"]) if cfg.geom_consistency else None
    key = jax.random.PRNGKey(11)
    jout = jpipe.patchmatch_pass(jnp.asarray(sc["images"]), sc["jcams"], jnp.asarray(sc["sv"]),
                                 prior, key, cfg, jnp.asarray(RTH, jnp.float32), depth_maps=dm,
                                 weak_capacity=cap)
    tout = tpipe.patchmatch_pass(sc["tc"], t(sc["sv"]), convert.to_pass_state(prior),
                                 JaxDraws(key, H, W), cfg, weak_capacity=cap,
                                 ransac_threshold=RTH, images=t(sc["images"]),
                                 depth_maps=None if dm is None else t(sc["depths"]))
    jd, td = np.asarray(jout.depth), tout.depth.numpy()
    keep = np.ones((H, W), bool)
    if cfg.use_APD:
        keep[H - 1, W - 1] = False
    rel = (np.abs(td - jd) / np.maximum(np.abs(jd), 1e-6))[keep]
    state_ok = (np.asarray(jout.pixel_state) == tout.pixel_state.numpy())[keep].mean()
    sel_ok = np.all(np.asarray(jout.selected) == tout.selected.numpy(), axis=0)[keep].mean()
    print(f"{case}: depth within 1e-3 {np.mean(rel < 1e-3):.6f}, within 1e-2 "
          f"{np.mean(rel < 1e-2):.6f}, state {state_ok:.6f}, selected {sel_ok:.6f}")
    assert np.mean(rel < 1e-3) >= (0.98 if case == "first_init" else 0.99)
    assert np.mean(rel < 1e-2) >= 0.99
    assert state_ok >= 0.99 and sel_ok >= 0.99
    if case != "first_init":  # the pass did its job on this oracle scene
        m = np.zeros((H, W), bool)
        m[8:-8, 10:-10] = sc["depths"][0][8:-8, 10:-10] > 0
        err = np.abs(td - sc["depths"][0])[m] / sc["depths"][0][m]
        assert np.median(err) < 0.01, np.median(err)


def test_pass_without_volumes_needs_its_inputs(sc):
    cfg = PASSES["refine_iter_geom"]
    prior = convert.to_pass_state(_prior(sc, "refine_iter_geom"))
    with pytest.raises(ValueError, match="images"):
        tpipe.patchmatch_pass(sc["tc"], t(sc["sv"]), prior, JaxDraws(jax.random.PRNGKey(0), H, W),
                              cfg)
    with pytest.raises(ValueError, match="depth maps"):
        tpipe.patchmatch_pass(sc["tc"], t(sc["sv"]), prior, JaxDraws(jax.random.PRNGKey(0), H, W),
                              cfg, images=t(sc["images"]))
    # a volume context carries no images: the direct evaluators refuse it
    jvs = jncc.build_image_volume_set(jnp.asarray(sc["images"]), sc["jcams"], DMIN, DMAX,
                                      num_slices=K, weak_cost_volumes=False)
    vctx = tncc.make_context(sc["tc"], t(sc["sv"]), H, W, convert.to_volume_set(jvs))
    with pytest.raises(ValueError, match="images"):
        tncc.cost_vector(vctx, t(_worklist_planes(sc)), 5, 3,
                         xs=t(np.zeros(sc["cap"], np.float32)),
                         ys=t(np.zeros(sc["cap"], np.float32)))
