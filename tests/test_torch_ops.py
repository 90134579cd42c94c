"""The port's remaining ops entry points against the reference package's
mirrors on the CPU:

  H8 volume_sample        vs ops/volume.py::volume_sample_ref (NaN where
                          the mirror has NaN, elsewhere within 1e-5 of
                          max(|e0|, |e1|): XLA's CPU build may fuse the lerp
                          into a multiply-add), f32 and bf16, with k NaN,
                          +-inf, out of range and integer, on sizes not a
                          multiple of 4 and unaligned inputs
  depth_to_slice -> build_volume -> volume_sample
                          vs the reference's same chain, and vs the port's
                          direct bilinear warp (tests/test_volume.py:87-90)
  H7 gather_rows, gather_rows_sorted
                          vs ops/cols.py::gather_rows_ref, bit-exact
  H2 on K10's case        ncc_volume_cost_view vs ncc_volume_cost_view_ref
                          on the depth-edge group of
                          tests/test_ncc_volume.py:146-197 (< 1e-4)

On the CPU each wrapper runs its plain version; the card-side checks (each
kernel against its plain version) are the ``ops`` phase of chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DMAX, DMIN, off_by_one, ring_scene, t
from apdmvs_tpu import geometry as jgeom, ops as jops
from apdmvs_tpu.ops import cols as jcols, ncc_volume as jnv, volume as jvol
from apdmvs_tpu_torch import convert, geometry as tgeom, ops as tops, sampling
from apdmvs_tpu_torch.ops import cols as tcols, ncc_volume as tnv, volume as tvol

torch.set_num_threads(2)


def test_ops_exports_the_reference_entry_points():
    for name in ("build_volume", "inv_depth_grid", "volume_sample", "volume_sample_ref"):
        assert hasattr(jops, name)
        assert getattr(tops, name) is getattr(tvol, name)
    assert tops.depth_to_slice is tvol.depth_to_slice


# ---------------------------------------------------------------------------
# H8 volume_sample
# ---------------------------------------------------------------------------


def _sample_inputs(dtype):
    """The case of tests/test_volume.py:94-101 (K=64, 16x256) plus lanes
    with k NaN, +-inf, < 0, > K-1, exactly K-1 and integers."""
    rng = np.random.RandomState(1)
    K, H, W = 64, 16, 256
    E = jnp.asarray(rng.rand(K, H, W).astype(np.float32) * 255).astype(dtype)
    k = rng.uniform(-2, K + 2, (H, W)).astype(np.float32)
    k[0, :10] = [np.nan, np.inf, -np.inf, -5.0, K + 10.0, K - 1.0, 0.0, 7.0, 31.0, K - 2.0]
    k[1, ::7] = np.nan
    return E, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_volume_sample_matches_mirror(dtype):
    E, k = _sample_inputs(dtype)
    K = E.shape[0]
    want = np.asarray(jvol.volume_sample_ref(E, jnp.asarray(k)))
    got = tops.volume_sample(convert.tensor(E), torch.from_numpy(k))
    assert got.dtype == torch.float32 and got.shape == k.shape
    got = got.numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert nan.sum() == 1 + len(range(0, k.shape[1], 7))
    # the two slices each lane reads, for the tolerance
    e = np.asarray(E, np.float32)
    k0 = np.floor(np.clip(np.nan_to_num(k, nan=0.0), 0, K - 1)).astype(np.int64)
    e0 = np.take_along_axis(e, k0[None], 0)[0]
    e1 = np.take_along_axis(e, np.minimum(k0 + 1, K - 1)[None], 0)[0]
    scale = np.maximum(np.abs(e0), np.abs(e1))
    assert (np.abs(got - want)[~nan] <= 1e-5 * scale[~nan]).all()


@pytest.mark.parametrize("dtype,case", [
    (torch.float32, "2x8"), (torch.bfloat16, "2x8"),
    (torch.float32, "3x7"), (torch.bfloat16, "3x7"),
    (torch.float32, "offset_1"), (torch.bfloat16, "offset_1"),
], ids=["dtype0", "dtype1", "f32-3x7", "bf16-3x7", "f32-offset_1", "bf16-offset_1"])
def test_volume_sample_special_lanes(dtype, case):
    """+-inf and out-of-range k clamp to the end slices; an integer k reads
    its slice exactly; a NaN k gives NaN; and every lane agrees with the
    reference's volume_sample_ref (exactly where k is not fractional, else
    to the tolerance of test_volume_sample_matches_mirror). Beside 2x8
    pixels, the inputs of chip_smoke.py's H8 edge cases: 3x7 pixels (not a
    multiple of 4) and E and k one element past an aligned start."""
    rs = np.random.RandomState(4)
    K = 12
    H, W = (2, 8) if case == "2x8" else (3, 7)
    E = torch.from_numpy(rs.rand(K, H, W).astype(np.float32) * 255).to(dtype)
    lanes = [np.nan, np.inf, -np.inf, -3.0, K + 4.0, K - 1.0, 0.0, 5.0,
             1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 11.0]
    k = rs.uniform(0.0, K - 1.0, H * W).astype(np.float32)
    k[:16] = lanes
    k = torch.from_numpy(k.reshape(H, W))
    tE, tk = (off_by_one(E), off_by_one(k)) if case == "offset_1" else (E, k)
    out = tvol.volume_sample(tE, tk).reshape(-1)
    e = E.float().reshape(K, -1)
    assert torch.isnan(out[0]) and not torch.isnan(out[1:]).any()
    slices = [K - 1, 0, 0, K - 1, K - 1, 0, 5] + [int(v) for v in lanes[8:]]
    assert torch.equal(out[1:16], e[slices, torch.arange(1, 16)])
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = t(jvol.volume_sample_ref(jnp.asarray(E.float().numpy()).astype(jdtype),
                                    jnp.asarray(k.numpy()))).reshape(-1)
    assert torch.isnan(want[0]) and torch.equal(out[1:16], want[1:16])
    k0 = torch.floor(k.reshape(-1)[16:]).long()
    pix = torch.arange(16, H * W)
    scale = torch.maximum(e[k0, pix].abs(), e[torch.clamp(k0 + 1, max=K - 1), pix].abs())
    assert ((out[16:] - want[16:]).abs() <= 1e-5 * scale).all()


def test_volume_chain_matches_reference_and_direct_warp():
    """depth_to_slice -> build_volume -> volume_sample at view 0's ground
    truth, on the ring scene of tests/test_volume.py: agrees with the
    reference's same chain, and with the direct bilinear warp to
    interpolation accuracy (the thresholds of tests/test_volume.py:87-90)."""
    sc = ring_scene(num_views=2, width=256, height=192)
    H, W, K = sc["H"], sc["W"], 192
    jwc = jgeom.warp_constants(sc["jcams"])
    twc = tgeom.warp_constants(sc["tcams"])
    depth = np.where(sc["depths"][0] > 0, sc["depths"][0], 4.0).astype(np.float32)

    ju, jd = jvol.inv_depth_grid(jnp.float32(DMIN), jnp.float32(DMAX), K)
    jE = jvol.build_volume_padded(jnp.asarray(sc["images"][1]), jwc.M[1], jwc.b[1],
                                  sc["jcams"].K[0], H, W, ju, jd, K, 0, 0, dtype=jnp.bfloat16)
    jk = jvol.depth_to_slice(jnp.asarray(depth), ju, jd)
    want = np.asarray(jvol.volume_sample_ref(jE, jk))

    tu, td = tops.inv_depth_grid(DMIN, DMAX, K)
    tE = tops.build_volume(t(sc["images"][1]), twc.M[1], twc.b[1], sc["tcams"].K[0], H, W, tu,
                           td, K, pad_y=0, pad_x=0)
    tk = tops.depth_to_slice(t(depth), tu, td)
    got = tops.volume_sample(tE, tk).numpy()

    dk = np.abs(tk.numpy() - np.asarray(jk))
    assert dk.max() < 1e-4
    # E agrees within one bf16 ulp (2^-7 of the value at most), and k within
    # dk, over which a sample moves at most 255 grey levels a slice
    e = np.asarray(jE, np.float32)
    k0 = np.floor(np.clip(np.asarray(jk), 0, K - 1)).astype(np.int64)
    scale = np.maximum(np.abs(np.take_along_axis(e, k0[None], 0)[0]),
                       np.abs(np.take_along_axis(e, np.minimum(k0 + 1, K - 1)[None], 0)[0]))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert (np.abs(got - want) <= 2.0 ** -7 * scale + 255.0 * dk + 1e-5).all()

    x, y = tgeom.pixel_grid(H, W)
    dirs = tgeom.pixel_dirs(sc["tcams"].K[0], x, y)
    q = tgeom.mat3_vec(twc.M[1], dirs) + twc.b[1] * (1.0 / t(depth))[..., None]
    sx, sy = q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]
    direct = sampling.bilinear_sample(t(sc["images"][1]), sx, sy).numpy()
    sx, sy = sx.numpy(), sy.numpy()
    inb = (sc["depths"][0] > 0) & (sx > 1) & (sx < W - 2) & (sy > 1) & (sy < H - 2)
    err = np.abs(got - direct)[inb]
    assert inb.mean() > 0.5
    assert np.median(err) < 2.0, np.median(err)
    assert np.mean(err < 8.0) > 0.95, np.mean(err < 8.0)


# ---------------------------------------------------------------------------
# H7 gather_rows / gather_rows_sorted
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["gather_rows", "gather_rows_sorted"])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gather_rows_matches_mirror(entry, order, dtype):
    rng = np.random.RandomState(6)
    R, C, M = 300, 40, 257
    table = jnp.asarray(rng.rand(R, C).astype(np.float32), dtype=dtype)
    idx = rng.randint(0, R, M).astype(np.int32)
    idx[:4] = [-1, R + 5, 0, R - 1]  # clamp to the end rows
    if order == "sorted":
        idx = np.sort(idx)
    want = convert.tensor(jcols.gather_rows_ref(table, jnp.asarray(idx)))
    got = getattr(tcols, entry)(convert.tensor(table), torch.from_numpy(idx))
    assert got.dtype == want.dtype and got.shape == (M, C)
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("case", ["row_72_bytes", "column_slice", "int32_vs_int64"])
def test_gather_rows_edge_cases(case):
    """Cases the kernel moves in narrower units or reads as they come: rows
    that are not a multiple of 16 bytes, a table that is a non-contiguous
    slice of a wider one, and int32 indices against the same int64 ones."""
    rng = np.random.RandomState(8)
    R, M = 200, 131
    idx = rng.randint(-3, R + 3, M)
    if case == "row_72_bytes":  # 36 bf16 a row
        table = torch.from_numpy(rng.rand(R, 36).astype(np.float32)).to(torch.bfloat16)
    else:
        table = torch.from_numpy(rng.rand(R, 48).astype(np.float32))
    if case == "column_slice":
        table = table[:, 5:29]
        assert not table.is_contiguous()
    want = tcols.gather_rows_ref(table, torch.from_numpy(idx.astype(np.int64)))
    mirror = convert.tensor(jcols.gather_rows_ref(jnp.asarray(table.float().numpy()),
                                                  jnp.asarray(idx.astype(np.int32))))
    assert torch.equal(want.float(), mirror)
    bits = torch.int16 if table.dtype == torch.bfloat16 else torch.int32
    for dtype in (torch.int64, torch.int32):
        for entry in (tcols.gather_rows, tcols.gather_rows_sorted):
            got = entry(table, torch.from_numpy(idx).to(dtype))
            assert got.shape == (M, table.shape[1]) and got.dtype == table.dtype
            assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("entry", ["gather_rows", "gather_rows_sorted"])
def test_gather_rows_empty_worklist(entry):
    table = torch.rand(10, 6)
    out = getattr(tcols, entry)(table, torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 6) and out.dtype == table.dtype


def test_gather_rows_reads_volume_rows_as_gather_cols():
    """The two routes to the worklist's K-columns agree: rows of the
    position-major table (the reference's layout) and H5's in-place read."""
    rng = np.random.RandomState(2)
    Vs, K, PH, PW = 2, 8, 24, 40
    vol = torch.from_numpy(rng.rand(Vs, K, PH, PW).astype(np.float32)).to(torch.bfloat16)
    xs = torch.from_numpy(rng.randint(-1, PW - 8, 50).astype(np.int32))
    ys = torch.from_numpy(rng.randint(-1, PH - 4, 50).astype(np.int32))
    idx = tcols.flat_index(xs, ys, 2, 4, PH, PW)
    rows = tcols.gather_rows_sorted(tcols.pack_volume_rows(vol), torch.sort(idx).values)
    cols = tcols.gather_cols(vol, xs, ys, 2, 4)
    order = torch.argsort(idx, stable=True)
    assert torch.equal(rows.reshape(-1, Vs, K).permute(1, 2, 0).view(torch.int16),
                       cols[:, :, order].view(torch.int16))


# ---------------------------------------------------------------------------
# K10 (_band2_kernel) on the port: H2's ncc_volume_cost_view
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def band2_case():
    """The inputs of tests/test_ncc_volume.py:146-197: the 96x256 ring
    scene, K=160, source view 1, and one candidate group of the smooth
    oracle plane and a random-depth plane (a depth edge at every pixel)."""
    H, W, K = 96, 256, 160
    sc = ring_scene(num_views=3, width=W, height=H)
    gc = jgeom.make_cameras(np.stack([c.K for c in sc["cams"]]).astype(np.float32),
                            np.stack([c.R for c in sc["cams"]]).astype(np.float32),
                            np.stack([c.t for c in sc["cams"]]).astype(np.float32),
                            np.full(3, 1.2, np.float32), np.full(3, 9.6, np.float32))
    wc = jgeom.warp_constants(gc)
    u_min, du = jvol.inv_depth_grid(1.2, 9.6, K)
    E = jvol.build_volume_padded(jnp.asarray(sc["images"][1]), wc.M[1], wc.b[1], gc.K[0], H, W,
                                 u_min, du, K, jnv.PAD_Y, jnv.PAD_X, dtype=jnp.float32)
    ref_pad = jnp.pad(jnp.asarray(sc["images"][0]), ((jnv.PAD_Y,) * 2, (jnv.PAD_X,) * 2),
                      mode="edge")
    consts = jnv.pack_consts(gc.K[0], wc.M[1], wc.b[1], u_min, du, W, H)
    x, y = jgeom.pixel_grid(H, W)
    n_cam = jgeom.normal_world_to_cam(gc.R[0], jnp.asarray(sc["normals"][0]))
    depth = jnp.asarray(np.where(sc["depths"][0] > 0, sc["depths"][0], 4.0))
    p0 = jnp.concatenate([n_cam, jgeom.dist_to_origin(gc.K[0], x, y, depth, n_cam)[..., None]], -1)
    d_rand = jnp.asarray(np.random.default_rng(3).uniform(1.3, 9.5, (H, W)).astype(np.float32))
    p_r = jnp.concatenate([n_cam, jgeom.dist_to_origin(gc.K[0], x, y, d_rand, n_cam)[..., None]],
                          -1)
    pcf = jnp.moveaxis(jnp.stack([p0, p_r]), -1, 1)  # [2, 4, H, W]
    want = np.asarray(jnv.ncc_volume_cost_view_ref(E, ref_pad, pcf, consts, K))
    k = (np.asarray(jvol.depth_to_slice(jnp.stack([depth, d_rand]), u_min, du)))
    return dict(E=E, ref_pad=ref_pad, consts=consts, pcf=pcf, want=want, k=k, K=K)


def test_band2_case_needs_the_escalation(band2_case):
    """Non-vacuous: in some 16x128 tile the candidate group's centre slices
    leave a gap between two BAND2-slice windows at the ends of its range,
    so the reference's two bands miss there and escalate to full K."""
    k = band2_case["k"]
    band = jnv.BAND2
    gaps = 0
    for i in range(0, k.shape[1], jnv.NCC_TILE_H):
        for j in range(0, k.shape[2], jnv.TILE_W):
            tile = k[:, i:i + jnv.NCC_TILE_H, j:j + jnv.TILE_W]
            lo, hi = tile.min(), tile.max()
            gaps += int(((tile > lo + band) & (tile < hi - band)).sum())
    assert gaps > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ncc_cost_view_is_exact_on_band2_case(band2_case, dtype):
    c = band2_case
    E = c["E"].astype(dtype)
    want = c["want"] if dtype == "float32" else np.asarray(
        jnv.ncc_volume_cost_view_ref(E, c["ref_pad"], c["pcf"], c["consts"], c["K"]))
    got = tnv.ncc_volume_cost_view(convert.tensor(E), t(c["ref_pad"]), t(c["pcf"]),
                                   t(c["consts"]), c["K"])
    assert got.shape == want.shape == (2, 96, 256)
    assert np.isfinite(want).all()
    assert float(np.abs(got.numpy() - want).max()) < 1e-4


# ---------------------------------------------------------------------------
# a tensor on neither the CPU nor a CUDA card is refused, never computed
# ---------------------------------------------------------------------------


def test_new_wrappers_raise_on_meta_tensors():
    E = torch.empty((4, 2, 8), device="meta")
    k = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError):
        tvol.volume_sample(E, k)
    table = torch.empty((10, 6), device="meta")
    idx = torch.empty((3,), dtype=torch.int64, device="meta")
    for fn in (tcols.gather_rows, tcols.gather_rows_sorted):
        with pytest.raises(ValueError):
            fn(table, idx)
    with pytest.raises(ValueError):  # k of the wrong shape
        tvol.volume_sample(torch.zeros(4, 2, 8), torch.zeros(2, 7))
    with pytest.raises(ValueError):  # float indices
        tcols.gather_rows(torch.zeros(10, 6), torch.zeros(3))
