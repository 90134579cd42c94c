"""The port's copy of ``datasets/synthetic.py`` against the JAX package's:
the same numpy code in float64, so renders (image, depth, normal) of the
occlusion, curved and flat-window ring scenes at 64x48, the radiometric
perturbation and the oracle cloud are bit-equal."""

import numpy as np
import pytest

from apdmvs_tpu.datasets import synthetic as jsyn
from apdmvs_tpu_torch.datasets import synthetic as tsyn

W, H = 64, 48


def _scene(mod, family):
    if family == "occlusion":
        return mod.make_occlusion_scene(num_views=4, width=W, height=H, focal=80.0)
    if family == "curved":
        return mod.make_curved_scene(num_views=4, width=W, height=H, focal=80.0)
    return mod.make_ring_scene(num_views=4, width=W, height=H, focal=80.0,
                               include_flat_region=True)


FAMILIES = ["occlusion", "curved", "ring_flat"]


@pytest.fixture(scope="module", params=FAMILIES)
def renders(request):
    fam = request.param
    jc, jp = _scene(jsyn, fam)
    tc, tp = _scene(tsyn, fam)
    return fam, (jc, jp, jsyn.render_scene(jc, jp)), (tc, tp, tsyn.render_scene(tc, tp))


def test_primitives_match(renders):
    fam, (jc, jp, _), (tc, tp, _) = renders
    assert [type(p).__name__ for p in jp] == [type(p).__name__ for p in tp]
    kinds = {type(p).__name__ for p in tp}
    assert kinds == {"occlusion": {"CardPrim", "PlanePrim"}, "curved": {"SpherePrim", "PlanePrim"},
                     "ring_flat": {"PlanePrim"}}[fam]
    for a, b in zip(jp, tp):
        for k, v in vars(a).items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(getattr(b, k)), err_msg=k)
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(a.K, b.K)
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.t, b.t)


@pytest.mark.parametrize("field", ["image", "depth", "normal"])
def test_renders_bit_equal(renders, field):
    fam, (_, _, jr), (_, _, tr) = renders
    i = ["image", "depth", "normal"].index(field)
    assert jr[i].dtype == tr[i].dtype == np.float32
    np.testing.assert_array_equal(jr[i], tr[i])
    # the scene is in view: every family renders hits, and the sphere or
    # card covers part of view 0
    assert (jr[1] > 0).mean() > 0.5


def test_perturb_radiometric_and_gt_cloud_bit_equal(renders):
    _, (jc, _, (images, depths, _)), (tc, _, _) = renders
    for seed in (0, 11):
        np.testing.assert_array_equal(jsyn.perturb_radiometric(images, seed=seed),
                                      tsyn.perturb_radiometric(images, seed=seed))
    for stride in (1, 2):
        np.testing.assert_array_equal(jsyn.gt_cloud(jc, depths, stride=stride),
                                      tsyn.gt_cloud(tc, depths, stride=stride))


def test_sphere_intersect_and_texture_match():
    rng = np.random.RandomState(3)
    js = jsyn.SpherePrim(center=np.array([0.1, 0.0, 4.2]), radius=0.9, seed=5)
    ts = tsyn.SpherePrim(center=np.array([0.1, 0.0, 4.2]), radius=0.9, seed=5)
    origin = np.array([0.0, 0.1, -0.2])
    dirs = rng.randn(200, 3) * 0.3 + np.array([0.0, 0.0, 1.0])
    jt, jn = js.intersect(origin, dirs)
    tt, tn = ts.intersect(origin, dirs)
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(jn, tn)
    assert np.isfinite(tt).any() and (~np.isfinite(tt)).any()
    X = origin + dirs * np.where(np.isfinite(tt), tt, 1.0)[:, None]
    np.testing.assert_array_equal(js.texture(X), ts.texture(X))
