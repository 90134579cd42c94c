"""The port's kernel modules against the reference package's mirrors.

On the CPU each wrapper of ``apdmvs_tpu_torch/ops`` runs its kernel's plain
PyTorch version; these tests hold that version against the exact mirror the
reference package itself runs on the CPU, on the same inputs:

  H1 build_volume      vs ops/volume.py::build_volume_padded
                       (bilinear: <= 1 bf16 ulp; trunc: >= 99.9% equal —
                       a floor-boundary flip moves a sample one pixel)
  H2 ncc_cost          vs ops/ncc_volume.py::ncc_volume_cost_view_ref, same E
                       carried over by convert.py, through all four entry
                       points (max abs < 1e-4, tests/test_ncc_volume.py:112)
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
