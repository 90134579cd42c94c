"""The port's modules against the reference package, stage by stage.

Each test feeds both implementations the same numpy inputs (and, for the
stochastic stages, the same draws) on the CPU. Tolerances, with reasons:

- geometry / sampling / hypotheses: elementwise float32 arithmetic in the
  same order; allclose at 1e-6 relative (the reference's XLA CPU build may
  contract a multiply-add), exact where only selection is involved;
- costs (initial seeding, recost, classify sweeps): < 1e-4 absolute, the
  kernel tolerance of tests/test_ncc_volume.py:112;
- discrete outputs (selected views, pixel states, argmin picks): equal on
  >= 99% of pixels; a near-tie may flip a pixel because the two sides round
  their sums differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DMAX, DMIN, JaxDraws, ring_scene, t
from apdmvs_tpu import classify as jcls, filters as jfil, geometry as jgeom
from apdmvs_tpu import hypotheses as jhyp, ncc as jncc, propagation as jprop, sampling as jsam
from apdmvs_tpu import params as jparams
from apdmvs_tpu_torch import classify as tcls, convert, filters as tfil, geometry as tgeom
from apdmvs_tpu_torch import hypotheses as thyp, ncc as tncc, params as tparams
from apdmvs_tpu_torch import propagation as tprop, rng, sampling as tsam

torch.set_num_threads(2)

K = 64


def close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def sc():
    s = ring_scene(num_views=3, width=128, height=40)
    jvs = jncc.build_image_volume_set(jnp.asarray(s["images"]), s["jcams"], DMIN, DMAX,
                                      num_slices=K, weak_cost_volumes=False)
    jvs = jncc.add_depth_volumes(jvs, jnp.asarray(s["depths"]), s["jcams"], DMIN, DMAX)
    sv = np.array([False, True, True])
    s["jctx"] = jncc.make_context(jnp.asarray(s["images"]), s["jcams"], jnp.asarray(sv),
                                  depth_maps=jnp.asarray(s["depths"]), volumes=jvs)
    tc = convert.to_cameras(s["jcams"])
    s["tc"] = tc
    s["tctx"] = tncc.make_context(tc, t(sv), s["H"], s["W"], convert.to_volume_set(jvs))
    # oracle planes (ref-camera frame) of view 0
    H, W = s["H"], s["W"]
    gt = np.where(s["depths"][0] > 0, s["depths"][0], 4.0).astype(np.float32)
    n_cam = np.einsum("ij,hwj->hwi", np.asarray(s["jcams"].R[0]), s["normals"][0])
    x, y = jgeom.pixel_grid(H, W)
    w = jgeom.dist_to_origin(s["jcams"].K[0], x, y, jnp.asarray(gt), jnp.asarray(n_cam))
    s["planes"] = np.concatenate([n_cam, np.asarray(w)[..., None]], -1).astype(np.float32)
    s["planes_world"] = np.concatenate([s["normals"][0], gt[..., None]], -1).astype(np.float32)
    return s


def test_params_copy_matches():
    for a, b in zip(jparams.build_schedule(2), tparams.build_schedule(2)):
        assert a.__dict__ == b.__dict__
    assert jparams.compute_round_num(1920, 1080) == tparams.compute_round_num(1920, 1080)
    assert jparams.scaled_size(641, 479, 2) == tparams.scaled_size(641, 479, 2)


def test_geometry_matches(sc):
    jc, tc = sc["jcams"], sc["tc"]
    tc2 = tgeom.make_cameras(np.asarray(jc.K), np.asarray(jc.R), np.asarray(jc.t),
                             np.asarray(jc.depth_min), np.asarray(jc.depth_max))
    close(tc2.c, jc.c)
    H, W = sc["H"], sc["W"]
    jx, jy = jgeom.pixel_grid(H, W)
    tx, ty = tgeom.pixel_grid(H, W)
    close(tx, jx, 0, 0)
    close(tgeom.pixel_dirs(tc.K[0], tx, ty), jgeom.pixel_dirs(jc.K[0], jx, jy))
    pl = sc["planes"]
    close(tgeom.depth_from_plane(tc.K[0], t(pl), tx, ty),
          jgeom.depth_from_plane(jc.K[0], jnp.asarray(pl), jx, jy), rtol=1e-5)
    jd, jn = jgeom.planes_to_depth_normal(jc, jnp.asarray(pl), H, W)
    td, tn = tgeom.planes_to_depth_normal(tc, t(pl), H, W)
    close(td, jd, rtol=1e-5)
    close(tn, jn)
    close(tgeom.depth_normal_to_planes(tc, td, tn, H, W),
          jgeom.depth_normal_to_planes(jc, jd, jn, H, W), rtol=1e-5, atol=1e-5)
    close(tgeom.scale_intrinsics(tc.K, 0.5, 0.25), jgeom.scale_intrinsics(jc.K, 0.5, 0.25))


def test_sampling_matches():
    rs = np.random.RandomState(0)
    img = rs.uniform(0, 255, (24, 40)).astype(np.float32)
    xs = rs.uniform(-5, 45, (500,)).astype(np.float32)
    ys = rs.uniform(-5, 29, (500,)).astype(np.float32)
    close(tsam.bilinear_sample(t(img), t(xs), t(ys)),
          jsam.bilinear_sample(jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys)),
          rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(
        tsam.nearest_sample_trunc(t(img), t(xs), t(ys)).numpy(),
        np.asarray(jsam.nearest_sample_trunc(jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys))))
    arr = rs.randn(7, 9, 3).astype(np.float32)
    for dx, dy in [(0, 0), (2, -1), (-3, 4), (9, 0), (-1, -7)]:
        np.testing.assert_array_equal(tsam.shift2d(t(arr), dx, dy, -1.0).numpy(),
                                      np.asarray(jsam.shift2d(jnp.asarray(arr), dx, dy, -1.0)))
    vals = rs.randn(5, 6, 7, 4).astype(np.float32)
    idx = rs.randint(0, 5, (6, 7))
    np.testing.assert_array_equal(tsam.select_index(t(vals), t(idx)).numpy(),
                                  np.asarray(jsam.select_index(jnp.asarray(vals), jnp.asarray(idx))))
    np.testing.assert_array_equal(tsam.patch_offsets(5, 2), jsam.patch_offsets(5, 2))


def test_random_plane_from_injected_draws(sc):
    H, W = sc["H"], sc["W"]
    jctx, tctx = sc["jctx"], sc["tctx"]
    key = jax.random.PRNGKey(11)
    k_init = jax.random.split(key, 3)[0]
    ref = jhyp.random_plane(k_init, sc["jcams"].K[0], jctx.x, jctx.y, jctx.dirs, DMIN, DMAX)
    u, g = JaxDraws(key, H, W).init_plane()
    out = thyp.random_plane(u, g, sc["tc"].K[0], tctx.x, tctx.y, tctx.dirs,
                            sc["tc"].depth_min[0], sc["tc"].depth_max[0])
    close(out, ref, rtol=1e-5, atol=1e-5)


def test_refinement_combos_from_injected_draws(sc):
    H, W = sc["H"], sc["W"]
    jctx, tctx = sc["jctx"], sc["tctx"]
    key = jax.random.PRNGKey(12)
    draws = JaxDraws(key, H, W)
    k_ref = jax.random.split(jax.random.split(jax.random.fold_in(draws.k_iters, 1), 3)[1])[1]
    pl = sc["planes"]
    cur_n = pl[..., :3]
    cur_d = np.asarray(jgeom.depth_from_plane(sc["jcams"].K[0], jnp.asarray(pl), jctx.x, jctx.y))
    jd, jn = jhyp.refinement_combos(k_ref, sc["jcams"].K[0], jctx.x, jctx.y, jctx.dirs,
                                    jnp.asarray(cur_n), jnp.asarray(cur_d), DMIN, DMAX)
    td, tn = thyp.refinement_combos(*draws.refinement(1, 1), sc["tc"].K[0], tctx.x, tctx.y,
                                    tctx.dirs, t(cur_n), t(cur_d),
                                    sc["tc"].depth_min[0], sc["tc"].depth_max[0])
    close(td, jd, rtol=1e-5, atol=1e-5)
    close(tn, jn, rtol=1e-5, atol=1e-5)


def test_torch_draws_are_seeded_and_shaped():
    a = rng.TorchDraws(rng.pass_seed(0, 1, 2), 8, 16, "cpu")
    b = rng.TorchDraws(rng.pass_seed(0, 1, 2), 8, 16, "cpu")
    c = rng.TorchDraws(rng.pass_seed(0, 1, 3), 8, 16, "cpu")
    ua, ga = a.init_plane()
    assert ua.shape == (8, 16) and ga.shape == (8, 16, 3)
    assert torch.equal(ua, b.init_plane()[0]) and not torch.equal(ua, c.init_plane()[0])
    u = a.view_selection(0, 0)
    assert u.shape == (15, 8, 16) and float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert [x.shape for x in a.refinement(0, 1)] == [(8, 16), (8, 16, 3), (8, 16), (8, 16, 3)]


def test_checkerboard_candidates_and_priors_match():
    rs = np.random.RandomState(3)
    costs = rs.uniform(0, 2, (20, 30)).astype(np.float32)
    costs[5, 7] = costs[5, 9]  # a tie: the first strip position wins on both sides
    for a, b in zip(tprop.checkerboard_candidates(t(costs)),
                    jprop.checkerboard_candidates(jnp.asarray(costs))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sel = rs.rand(3, 20, 30) > 0.5
    flags = np.asarray(jprop.checkerboard_candidates(jnp.asarray(costs))[2])
    near = flags[[0, 2, 4, 6]]
    sv = np.array([False, True, True])
    close(tprop.neighbor_view_priors(t(sel), t(near), t(sv)),
          jprop.neighbor_view_priors(jnp.asarray(sel), jnp.asarray(near), jnp.asarray(sv)))


def test_joint_view_selection_matches():
    rs = np.random.RandomState(4)
    H, W = 16, 24
    cost_array = rs.uniform(0, 2, (8, 3, H, W)).astype(np.float32)
    cost_array[:, 0] = 2.0
    priors = rs.uniform(0, 3.6, (3, H, W)).astype(np.float32)
    priors[0] = 0.0
    key = jax.random.PRNGKey(5)
    jw, jn, js = jprop.joint_view_selection(jnp.asarray(cost_array), jnp.asarray(priors),
                                            jnp.asarray(1), key)
    keys = jax.random.split(key, 15)
    u = t(jax.vmap(lambda k: jax.random.uniform(k, (H, W)))(keys))
    tw, tn, ts = tprop.joint_view_selection(t(cost_array), t(priors), 1, u)
    assert float((tw.numpy() == np.asarray(jw)).mean()) >= 0.99
    assert float((ts.numpy() == np.asarray(js)).mean()) >= 0.99
    close(tn, jn, rtol=0, atol=0)  # always 15 draws or 0


def test_median_filter_matches(sc):
    rs = np.random.RandomState(6)
    pw = sc["planes_world"].copy()
    pw[..., 3] += rs.randn(*pw.shape[:2]).astype(np.float32) * 0.1
    costs = rs.uniform(0, 0.01, pw.shape[:2]).astype(np.float32)
    state = rs.choice([0, 1, 1, 1, 2], size=pw.shape[:2]).astype(np.uint8)
    np.testing.assert_array_equal(
        tfil.checkerboard_median_filter(t(pw), t(costs), t(state)).numpy(),
        np.asarray(jfil.checkerboard_median_filter(jnp.asarray(pw), jnp.asarray(costs),
                                                   jnp.asarray(state))))


def test_initial_cost_and_recost_match(sc):
    pl = sc["planes"] * np.array([1, 1, 1, 1.01], np.float32)  # off the oracle a little
    jc, js = jncc.initial_cost_and_views(sc["jctx"], jnp.asarray(pl), 5, 2, 4)
    tc, ts = tncc.initial_cost_and_views(sc["tctx"], t(pl), 5, 2, 4)
    assert float(np.abs(tc.numpy() - np.asarray(jc)).max()) < 1e-4
    assert float((ts.numpy() == np.asarray(js)).all(0).mean()) >= 0.99
    sel = np.asarray(js)
    jc2, jok = jncc.recost_selected_views(sc["jctx"], jnp.asarray(pl), jnp.asarray(sel), 5, 2)
    tc2, tok = tncc.recost_selected_views(sc["tctx"], t(pl), t(sel), 5, 2)
    assert float(np.abs(tc2.numpy() - np.asarray(jc2)).max()) < 1e-4
    assert float((tok.numpy() == np.asarray(jok)).all(0).mean()) >= 0.99


def _classify_inputs(sc):
    rs = np.random.RandomState(8)
    H, W = sc["H"], sc["W"]
    sel = np.ones((3, H, W), bool)
    sel[0] = False
    sel[1] &= rs.rand(H, W) > 0.2
    vw = rs.randint(0, 9, (3, H, W)).astype(np.float32)
    pw = sc["planes_world"].copy()
    pw[..., 3] *= (1 + 0.01 * rs.randn(H, W)).astype(np.float32)
    return pw, sel, vw


@pytest.mark.parametrize("geom", [False, True])
def test_depth_to_weak_matches(sc, geom):
    pw, sel, vw = _classify_inputs(sc)
    jcfg = jparams.PassConfig(state=jparams.RunState.REFINE_ITER, geom_consistency=geom,
                              use_APD=False)
    tcfg = tparams.PassConfig(state=tparams.RunState.REFINE_ITER, geom_consistency=geom,
                              use_APD=False)
    js = jcls.depth_to_weak(sc["jctx"], jnp.asarray(pw), jnp.asarray(sel), jnp.asarray(vw), 4, jcfg)
    ts = tcls.depth_to_weak(sc["tctx"], t(pw), t(sel), t(vw), 4, tcfg)
    assert ts.dtype == torch.uint8
    assert float((ts.numpy() == np.asarray(js)).mean()) >= 0.99


@pytest.mark.parametrize("geom", [False, True])
def test_local_refine_matches(sc, geom):
    pw, sel, vw = _classify_inputs(sc)
    jcfg = jparams.PassConfig(state=jparams.RunState.REFINE_ITER, geom_consistency=geom,
                              use_APD=False)
    tcfg = tparams.PassConfig(state=tparams.RunState.REFINE_ITER, geom_consistency=geom,
                              use_APD=False)
    jr = np.asarray(jcls.local_refine(sc["jctx"], jnp.asarray(pw), jnp.asarray(sel),
                                      jnp.asarray(vw), jcfg))
    tr = tcls.local_refine(sc["tctx"], t(pw), t(sel), t(vw), tcfg).numpy()
    np.testing.assert_array_equal(tr[..., :3], jr[..., :3])
    rel = np.abs(tr[..., 3] - jr[..., 3]) / jr[..., 3]
    assert float((rel < 1e-5).mean()) >= 0.99
    assert float((tr[..., 3] != pw[..., 3]).mean()) > 0.01  # the polish did move depths


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_fuse_eth_matches(sc, backend):
    """ETH fusion of the scene's ground-truth depth maps: the port's copy
    (and its copy of the native core) gives the reference's cloud exactly."""
    from apdmvs_tpu import fusion as jfus
    from apdmvs_tpu_torch import fusion as tfus

    views = {}
    for mod in (jfus, tfus):
        views[mod] = [mod.FusionView(
            K=np.asarray(c.K, np.float64), R=np.asarray(c.R, np.float64),
            t=np.asarray(c.t, np.float64),
            image_bgr=np.repeat(sc["images"][v][..., None], 3, -1).astype(np.uint8),
            depth=sc["depths"][v] * np.float32(1 + 1e-3 * v), normal=sc["normals"][v],
            weak=np.full(sc["depths"][v].shape, 1, np.uint8),
        ) for v, c in enumerate(sc["cams"])]
    srcs = [[1, 2], [0, 2], [0, 1]]
    jc, jcol = jfus.fuse_eth(views[jfus], srcs, backend=backend)
    tc, tcol = tfus.fuse_eth(views[tfus], srcs, backend=backend)
    assert len(tc) > 1000
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tcol, jcol)
