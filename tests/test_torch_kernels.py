"""The port's kernel modules against the reference package's mirrors.

On the CPU each wrapper of ``apdmvs_tpu_torch/ops`` runs its kernel's plain
PyTorch version; these tests hold that version against the exact mirror the
reference package itself runs on the CPU, on the same inputs:

  H1 build_volume      vs ops/volume.py::build_volume_padded
                       (bilinear: <= 1 bf16 ulp; trunc: >= 99.9% equal —
                       a floor-boundary flip moves a sample one pixel)
  H2 ncc_cost          vs ops/ncc_volume.py::ncc_volume_cost_view_ref, same E
                       carried over by convert.py, through all four entry
                       points and ncc_cost_views over every source view
                       (max abs < 1e-4, tests/test_ncc_volume.py:112); and a
                       float32 emulation of the kernel's folded slice
                       coordinate against the same mirror
  H3 rebase_view       vs the CPU branch of build_rebased_view (bit-exact)
  H4 geom_cost         vs geom_volume_cost_view_ref (max abs < 1e-4)

The CUDA kernels themselves run only on the card (chip_smoke.py holds each
against these plain versions there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DMAX, DMIN, ring_scene, t
from apdmvs_tpu import geometry as jgeom, ncc as jncc
from apdmvs_tpu.ops import ncc_volume as jnv, volume as jvol
from apdmvs_tpu_torch import convert, geometry as tgeom, ncc as tncc
from apdmvs_tpu_torch.ops import ncc_volume as tnv, volume as tvol

torch.set_num_threads(2)

K = 64


@pytest.fixture(scope="module")
def scene():
    sc = ring_scene(num_views=3, width=128, height=40)
    jvs = jncc.build_image_volume_set(jnp.asarray(sc["images"]), sc["jcams"], DMIN, DMAX,
                                      num_slices=K, weak_cost_volumes=False)
    jvs = jncc.add_depth_volumes(jvs, jnp.asarray(sc["depths"]), sc["jcams"], DMIN, DMAX)
    sc["jvs"] = jvs
    sc["tvs"] = convert.to_volume_set(jvs)
    return sc


def _u_grid():
    ju, jd = jvol.inv_depth_grid(jnp.float32(DMIN), jnp.float32(DMAX), K)
    tu, td = tvol.inv_depth_grid(DMIN, DMAX, K)
    assert float(ju) == float(tu) and float(jd) == float(td)
    return ju, jd, tu, td


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    return int((ia - ib).abs().max())


def test_warp_constants_match(scene):
    jwc = jgeom.warp_constants(scene["jcams"])
    twc = tgeom.warp_constants(scene["tcams"])
    for f in ("A", "M", "b"):
        np.testing.assert_allclose(getattr(twc, f).numpy(), np.asarray(getattr(jwc, f)),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("view", [1, 2])
def test_build_volume_bilinear_matches_mirror(scene, view):
    ju, jd, tu, td = _u_grid()
    jwc = jgeom.warp_constants(scene["jcams"])
    img = scene["images"][view]
    Kj = scene["jcams"].K[0]
    ref = jvol.build_volume_padded(jnp.asarray(img), jwc.M[view], jwc.b[view], Kj, 48, 128,
                                   ju, jd, K, pad_y=8, pad_x=128, dtype=jnp.bfloat16)
    out = tvol.build_volume(t(img), t(jwc.M[view]), t(jwc.b[view]), t(Kj), 48, 128, tu, td, K,
                            pad_y=8, pad_x=128)
    assert out.shape == (K, 64, 384) and out.dtype == torch.bfloat16
    assert _bf16_ulps(out, convert.tensor(ref)) <= 1


def test_build_volume_trunc_matches_mirror(scene):
    ju, jd, tu, td = _u_grid()
    jwc = jgeom.warp_constants(scene["jcams"])
    dm = scene["depths"][1]
    Kj = scene["jcams"].K[0]
    ref = jvol.build_volume_padded(jnp.asarray(dm), jwc.M[1], jwc.b[1], Kj, 48, 128, ju, jd, K,
                                   pad_y=0, pad_x=0, dtype=jnp.float32, trunc=True)
    out = tvol.build_volume(t(dm), t(jwc.M[1]), t(jwc.b[1]), t(Kj), 48, 128, tu, td, K,
                            pad_y=0, pad_x=0, dtype=torch.float32, trunc=True)
    assert float((out.numpy() == np.asarray(ref)).mean()) >= 0.999


def test_image_volume_set_matches(scene):
    """The port's whole image-volume build against the reference's."""
    tvs = tncc.build_image_volume_set(t(scene["images"]), scene["tcams"], DMIN, DMAX, K)
    ref = scene["tvs"]
    assert tvs.E.shape == ref.E.shape
    assert _bf16_ulps(tvs.E, ref.E) <= 1
    torch.testing.assert_close(tvs.ref_pad, ref.ref_pad, rtol=0, atol=0)
    torch.testing.assert_close(tvs.consts, ref.consts, rtol=1e-6, atol=1e-6)


def test_depth_volumes_match(scene):
    base = tncc.VolumeSet(E=scene["tvs"].E, consts=scene["tvs"].consts,
                          ref_pad=scene["tvs"].ref_pad)
    tvs = tncc.add_depth_volumes(base, t(scene["depths"]), scene["tcams"], DMIN, DMAX)
    ref = scene["tvs"]
    assert float((tvs.D == ref.D).float().mean()) >= 0.999
    torch.testing.assert_close(tvs.geom_consts, ref.geom_consts, rtol=1e-5, atol=1e-5)


def _plane_cases(sc):
    """Channel-first [C, 4, 48, 128] candidate fields padded like the
    reference's evaluators pad them."""
    H, W = sc["H"], sc["W"]
    rs = np.random.RandomState(7)
    K0 = sc["jcams"].K[0]
    R0 = np.asarray(sc["jcams"].R[0])
    x, y = jgeom.pixel_grid(H, W)
    gt = np.where(sc["depths"][0] > 0, sc["depths"][0], 4.0).astype(np.float32)
    n = np.einsum("ij,hwj->hwi", R0, sc["normals"][0]).astype(np.float32)

    def field(depth, normal):
        w = jgeom.dist_to_origin(K0, x, y, jnp.asarray(depth), jnp.asarray(normal))
        return np.concatenate([normal, np.asarray(w)[..., None]], -1)

    def noisy_normal(s):
        nn = n + s * rs.randn(*n.shape).astype(np.float32)
        return nn / np.linalg.norm(nn, axis=-1, keepdims=True)

    cases = {
        "oracle": np.stack([field(gt, n)]),
        "perturbed": np.stack([field(gt * (1 + 0.01 * rs.randn(H, W)).astype(np.float32),
                                     noisy_normal(0.05)) for _ in range(9)]),
        "random_depth": np.stack([field(rs.uniform(DMIN, DMAX, (H, W)).astype(np.float32),
                                        noisy_normal(0.3)) for _ in range(3)]),
        "sweep_chunk": np.stack([field(gt * (1 + 0.004 * (s - 4)), n) for s in range(8)]),
    }
    out = {}
    for name, planes in cases.items():
        pcf = jnp.moveaxis(jnp.asarray(planes, jnp.float32), -1, 1)
        out[name] = np.asarray(jncc._pad_planes_cf(pcf, 48, 128))
    return out


@pytest.mark.parametrize("case", ["oracle", "perturbed", "random_depth", "sweep_chunk"])
@pytest.mark.parametrize("entry", ["direct", "fullk", "rebased", "sweep"])
def test_ncc_cost_matches_mirror(scene, case, entry):
    planes = _plane_cases(scene)[case]
    jvs, tvs = scene["jvs"], scene["tvs"]
    ref = np.asarray(jnv.ncc_volume_cost_view_ref(
        jvs.E[0], jvs.ref_pad, jnp.asarray(planes), jvs.consts[0], K))
    E, ref_pad, consts, p = tvs.E[0], tvs.ref_pad, tvs.consts[0], t(planes)
    if entry == "direct":
        out = tnv.ncc_volume_cost_view(E, ref_pad, p, consts, K)
    elif entry == "fullk":
        out = tnv.ncc_volume_cost_view_fullk(E, ref_pad, p, consts, K)
    else:
        j2 = tnv.J2_REBASE if entry == "rebased" else tnv.SWEEP_J2
        base = tncc._base_slice_map(tvs, t(scene["depths"][0]))
        R, bf = tnv.build_rebased_view(E, base, K, j2=j2)
        fn = tnv.ncc_rebased_cost_view if entry == "rebased" else tnv.ncc_rebased_sweep_cost_view
        out = fn(R, bf, E, ref_pad, p, consts, K)
    assert out.shape == ref.shape
    assert np.isfinite(ref).all()
    assert float(np.abs(out.numpy() - ref).max()) < 1e-4


@pytest.mark.parametrize("case", ["oracle", "perturbed", "random_depth", "sweep_chunk"])
def test_ncc_cost_views_matches_mirror(scene, case):
    """Every source view of the fixture in one call, as the cost harness
    makes it, against the mirror view by view."""
    planes = _plane_cases(scene)[case]
    jvs, tvs = scene["jvs"], scene["tvs"]
    out = tnv.ncc_cost_views(tvs.E, tvs.ref_pad, t(planes), tvs.consts, K)
    assert out.shape == (tvs.E.shape[0],) + planes.shape[:1] + planes.shape[2:]
    for v in range(tvs.E.shape[0]):
        ref = np.asarray(jnv.ncc_volume_cost_view_ref(
            jvs.E[v], jvs.ref_pad, jnp.asarray(planes), jvs.consts[v], K))
        assert np.isfinite(ref).all()
        assert float(np.abs(out[v].numpy() - ref).max()) < 1e-4


def _folded_kernel_emulation(E_pad, ref_pad, planes, consts, num_slices, radius=5,
                             increment=2):
    """The plain version of H2 with the CUDA kernel's slice coordinate: per
    output the plane folds into kr = c2 diry + (c1 dirx + c0), evaluated as
    two float32 fused multiply-adds, where |c0| + |c1| max|dirx| + |c2|
    max|diry| over the window is below 1e30; the plain version's divisions
    elsewhere (csrc/ncc_cost.cu)."""
    c = consts[0]
    fx, fy, cx, cy, u_min, du = (c[m] for m in range(6))
    C, _, H, W = planes.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    ys = ys + c[20]
    n0, n1, n2, w = planes.unbind(1)
    wdu = w * du
    c1, c2 = -n0 / wdu, -n1 / wdu
    c0 = (-(n2 / w) - u_min) / du
    vals = range(-radius, radius + 1, increment)
    dxmax = torch.stack([((xs + float(d) - cx) / fx).abs() for d in vals]).amax(0)
    dymax = torch.stack([((ys + float(d) - cy) / fy).abs() for d in vals]).amax(0)
    folded = c0.abs() + c1.abs() * dxmax + c2.abs() * dymax < 1e30
    E32 = E_pad.float()
    s_r = s_rr = torch.zeros((H, W))
    s_s = s_ss = s_rs = torch.zeros((C, H, W))
    offsets = tnv._offsets(radius, increment)
    for dx, dy in offsets:
        dirx = (xs + float(dx) - cx) / fx
        diry = (ys + float(dy) - cy) / fy
        kr_div = (-(n0 * dirx + n1 * diry + n2) / w - u_min) / du
        kr = torch.where(folded, tnv.fma(c2, diry, tnv.fma(c1, dirx, c0)), kr_div)
        k = torch.clamp(kr, 0.0, num_slices - 1.0)
        E_sh = E32[:, tnv.PAD_Y + dy: tnv.PAD_Y + dy + H, tnv.PAD_X + dx: tnv.PAD_X + dx + W]
        k0 = tnv._slice_index(torch.floor(k), num_slices)
        k1 = torch.clamp(k0 + 1, max=num_slices - 1)
        f = k - k0.float()
        sv = torch.gather(E_sh, 0, k0) * (1.0 - f) + torch.gather(E_sh, 0, k1) * f
        rv = ref_pad[tnv.PAD_Y + dy: tnv.PAD_Y + dy + H, tnv.PAD_X + dx: tnv.PAD_X + dx + W]
        s_r, s_rr = s_r + rv, s_rr + rv * rv
        s_s, s_ss, s_rs = s_s + sv, s_ss + sv * sv, s_rs + rv * sv
    inv = torch.tensor(1.0 / len(offsets), dtype=torch.float32)
    mr, ms = s_r * inv, s_s * inv
    var_r, var_s, cov = tnv.ncc_moments(s_rr, s_ss, s_rs, mr, ms, inv)
    cost = torch.clamp(1.0 - cov * torch.rsqrt(torch.clamp(var_r * var_s, min=1e-30)),
                       0.0, tnv.COST_MAX)
    cost = torch.where((var_r < tnv.MIN_VAR) | (var_s < tnv.MIN_VAR), tnv.COST_MAX, cost)
    # the centre-warp test, unchanged from the plain version
    M, b = c[6:15].reshape(3, 3), c[15:18]
    dirx, diry = (xs - cx) / fx, (ys - cy) / fy
    u_c = -(n0 * dirx + n1 * diry + n2) / w
    q = [M[i, 0] * dirx + M[i, 1] * diry + M[i, 2] + b[i] * u_c for i in range(3)]
    px, py = q[0] / q[2], q[1] / q[2]
    oob = (px < 0) | (px >= c[18]) | (py < 0) | (py >= c[19])
    return torch.where(oob, tnv.COST_MAX, cost), folded


def _degenerate(planes):
    """The perturbed fields with planes the fold cannot take: w = 0 (once
    with n0 = 0 too, so c1 = 0/0), a NaN plane and an infinite normal."""
    p = planes.copy()
    p[0, 3, 3, 5:9] = 0.0
    p[0, 0, 3, 5] = 0.0
    p[1, :, 4, 10] = np.nan
    p[2, 0, 5, 20] = np.inf
    return p


@pytest.mark.parametrize("case", ["oracle", "perturbed", "random_depth", "sweep_chunk",
                                  "degenerate"])
def test_folded_slice_coordinate_matches_mirror(scene, case):
    """H2 rounds kr through the folded plane, not through the plain
    version's divisions; emulated in float32, that stays under 1e-4 of the
    mirror, and planes the fold cannot take give the mirror's result, NaN
    included."""
    cases = _plane_cases(scene)
    planes = _degenerate(cases["perturbed"]) if case == "degenerate" else cases[case]
    jvs, tvs = scene["jvs"], scene["tvs"]
    ref = np.asarray(jnv.ncc_volume_cost_view_ref(
        jvs.E[0], jvs.ref_pad, jnp.asarray(planes), jvs.consts[0], K))
    out, folded = _folded_kernel_emulation(tvs.E[0], tvs.ref_pad, t(planes), tvs.consts[0], K)
    out = out.numpy()
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(out), nan)
    assert float(np.abs(out[~nan] - ref[~nan]).max()) < 1e-4
    # the padding rows (40-47) fold, and so does every real plane here
    assert bool(folded[:, 40:].all())
    assert int((~folded).sum()) == (6 if case == "degenerate" else 0)
    if case == "degenerate":
        assert nan.any()


@pytest.mark.parametrize("j2", [25, 49])
def test_rebase_view_bit_exact(scene, j2):
    jvs, tvs = scene["jvs"], scene["tvs"]
    rs = np.random.RandomState(j2)
    base = rs.uniform(-3.0, K + 3.0, jvs.ref_pad.shape).astype(np.float32)
    base[0, :8] = np.arange(8) + 0.5  # exact halves: round half to even
    jR, jbf = jnv.build_rebased_view(jvs.E[1], jnp.asarray(base), K, j2=j2)
    tR, tbf = tnv.build_rebased_view(tvs.E[1], t(base), K, j2=j2)
    assert torch.equal(tR.view(torch.int16), convert.tensor(jR).view(torch.int16))
    assert torch.equal(tbf, t(jbf))


@pytest.mark.parametrize("case", ["oracle", "perturbed", "sweep_chunk"])
def test_geom_cost_matches_mirror(scene, case):
    planes = _plane_cases(scene)[case]
    jvs, tvs = scene["jvs"], scene["tvs"]
    ref = np.asarray(jnv.geom_volume_cost_view_ref(
        jvs.D[1], jnp.asarray(planes), jvs.geom_consts[1], K))
    out = tnv.geom_volume_cost_view(tvs.D[1], t(planes), tvs.geom_consts[1], K)
    assert float(np.abs(out.numpy() - ref).max()) < 1e-4


def test_pack_consts_match(scene):
    ju, jd, tu, td = _u_grid()
    jwc = jgeom.warp_constants(scene["jcams"])
    twc = tgeom.warp_constants(scene["tcams"])
    jc = jnv.pack_consts(scene["jcams"].K[0], jwc.M[2], jwc.b[2], ju, jd, 128, 40)
    tc = tnv.pack_consts(scene["tcams"].K[0], twc.M[2], twc.b[2], tu, td, 128, 40)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)


def test_wrappers_check_their_inputs(scene):
    tvs = scene["tvs"]
    E, ref_pad, consts = tvs.E[0], tvs.ref_pad, tvs.consts[0]
    planes = torch.zeros((2, 4, 40, 128))  # grid not padded to (16, 128)
    with pytest.raises(ValueError):
        tnv.ncc_cost(E, ref_pad, planes, consts, K)
    planes = torch.zeros((2, 4, 48, 128))
    with pytest.raises(ValueError):  # one view's consts for several views
        tnv.ncc_cost_views(tvs.E, ref_pad, planes, consts, K)
    with pytest.raises(ValueError):  # E of another slice count
        tnv.ncc_cost_views(tvs.E, ref_pad, planes, tvs.consts, K + 1)
    with pytest.raises(ValueError):
        tnv.build_rebased_view(E, torch.zeros(ref_pad.shape), K, j2=K + 1)
    with pytest.raises(ValueError):
        tnv.geom_volume_cost_view(tvs.D[0], torch.zeros((1, 4, 48, 128)), consts, K)
    with pytest.raises(ValueError):
        tvol.build_volume(torch.zeros(8, 8), torch.eye(3), torch.zeros(3), torch.eye(3), 16,
                          128, 0.1, 0.01, 4, dtype=torch.float32)  # bilinear writes bf16
    # a tensor on neither the CPU nor a CUDA card is refused, never computed
    meta = torch.empty((1, 4, 48, 128), device="meta")
    with pytest.raises(ValueError):
        tnv.geom_volume_cost_view(tvs.D[0].to("meta"), meta, tvs.geom_consts[0].to("meta"), K)
