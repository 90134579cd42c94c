"""The weak path's column kernels (H5 gather_cols, H6 contract_lookup) and
build_cost_volume, plain versions against the reference package on the
CPU.

- H5 against the reference's pack_volume_rows -> flat_index ->
  gather_rows_ref composition (what build_weak_cols runs on the CPU):
  bit-exact, bf16 and f32, with -1 coordinates, and at the slot counts
  and patterns the kernel splits unevenly (one slot, 14, 1001, every
  coordinate -1, many slots over few positions).
- H6 against the reference's tent_lookup / nearest_lookup on the
  transposed layout (what contract_lookup runs on the CPU): tent within
  1.2e-7 (the reference package's own kernel tolerance,
  tests/test_cols.py:74; its CPU build fuses the two products into a
  multiply-add), nearest bit-exact, with NaN, +-inf and out-of-range k.
  A NaN k gives NaN (tent) and 0 (nearest) on both sides. Also at R odd
  or 14, B = 1, and k in a narrow band or over all of K.
- build_cost_volume against the reference: within 1 bf16 ulp on >= 99.9%
  of the entries (the reference's compiled sums may fuse multiply-adds),
  with and without a constant window, and the zero-sum border exactly
  COST_MAX.
The card-side checks (each kernel against its plain version) are phases of
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apdmvs_tpu.ops import cols as jcols, cost_volume as jcv
from apdmvs_tpu_torch import convert
from apdmvs_tpu_torch.ops import cols as tcols, cost_volume as tcv

torch.set_num_threads(2)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 units in the last place (sign-magnitude mapped onto
    a monotone integer line)."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    ia = torch.where(ia < 0, -32768 - ia, ia)
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return (ia - ib).abs()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pad", [(8, 128), (0, 0)])
def test_gather_cols_matches_reference_composition(dtype, pad):
    rng = np.random.RandomState(0)
    Vs, K, PH, PW = 3, 12, 40, 300
    pad_y, pad_x = pad
    vol = jnp.asarray(rng.rand(Vs, K, PH, PW).astype(np.float32), dtype=dtype)
    M = 257
    xs = rng.randint(-1, PW - 2 * pad_x, M).astype(np.int32)
    ys = rng.randint(-1, PH - 2 * pad_y, M).astype(np.int32)
    xs[:9] = -1  # missing anchors / worklist padding
    ys[:9] = -1
    idx = jcols.flat_index(jnp.asarray(xs), jnp.asarray(ys), pad_y, pad_x, PH, PW)
    rows = jcols.gather_rows_ref(jcols.pack_volume_rows(vol), idx)
    want = convert.tensor(jnp.transpose(rows.reshape(M, Vs, K), (1, 2, 0)))
    got = tcols.gather_cols(convert.tensor(vol), torch.from_numpy(xs), torch.from_numpy(ys),
                            pad_y, pad_x)
    assert got.dtype == want.dtype and got.shape == (Vs, K, M)
    assert torch.equal(got.view(torch.int16) if dtype == "bfloat16" else got,
                       want.view(torch.int16) if dtype == "bfloat16" else want)


def _h5_coords(case, rng, PH, PW, pad_y, pad_x):
    """Worklist coordinates of the shapes H5's kernel splits unevenly: one
    slot, slot counts that are odd or leave a thread of 8 (4) slots part
    full, every coordinate -1, and the anchor pattern (many slots over few
    positions)."""
    H, W = PH - 2 * pad_y, PW - 2 * pad_x
    M = {"M=1": 1, "M=14": 14, "M=1001": 1001, "all -1": 515, "repeated": 4096}[case]
    xs = rng.randint(-1, W, M).astype(np.int32)
    ys = rng.randint(-1, H, M).astype(np.int32)
    if case == "all -1":
        xs[:], ys[:] = -1, -1
    if case == "repeated":
        pick = rng.randint(0, 20, M)
        xs, ys = xs[:20][pick], ys[:20][pick]
        xs[::7], ys[::7] = -1, -1  # missing anchors among them
    return xs, ys


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", ["M=1", "M=14", "M=1001", "all -1", "repeated"])
def test_gather_cols_edge_shapes_match_reference_composition(dtype, case):
    rng = np.random.RandomState(3)
    Vs, K, PH, PW, pad_y, pad_x = 2, 10, 24, 40, 4, 8
    vol = jnp.asarray(rng.rand(Vs, K, PH, PW).astype(np.float32), dtype=dtype)
    xs, ys = _h5_coords(case, rng, PH, PW, pad_y, pad_x)
    M = xs.shape[0]
    idx = jcols.flat_index(jnp.asarray(xs), jnp.asarray(ys), pad_y, pad_x, PH, PW)
    rows = jcols.gather_rows_ref(jcols.pack_volume_rows(vol), idx)
    want = convert.tensor(jnp.transpose(rows.reshape(M, Vs, K), (1, 2, 0)))
    got = tcols.gather_cols(convert.tensor(vol), torch.from_numpy(xs), torch.from_numpy(ys),
                            pad_y, pad_x)
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert got.shape == (Vs, K, M)
    assert torch.equal(got.view(bits), want.view(bits))
    if case == "all -1":  # every slot reads position (pad_y - 1, pad_x - 1)
        corner = convert.tensor(vol)[:, :, pad_y - 1, pad_x - 1]
        assert torch.equal(got.view(bits), corner[..., None].expand(-1, -1, M).view(bits))


def _lookup_inputs(dtype, B):
    rng = np.random.RandomState(5)
    Vs, K, R = 3, 24, 640
    cols_t = jnp.asarray(rng.rand(Vs, K, R).astype(np.float32), dtype=dtype)
    k = (rng.rand(B, R) * 30.0 - 3.0).astype(np.float32)  # includes k < 0 and k > K-1
    k[:, :6] = [np.nan, np.inf, -np.inf, 0.0, K - 1.0, 7.5]  # and exact ends, a half
    return cols_t, k


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B", [10, 5])
def test_contract_lookup_tent_matches_reference(dtype, B):
    cols_t, k = _lookup_inputs(dtype, B)
    want = np.asarray(jcols.tent_lookup(jnp.moveaxis(cols_t, 1, -1)[None], jnp.asarray(k)[:, None]))
    got = tcols.contract_lookup(convert.tensor(cols_t), torch.from_numpy(k)).numpy()
    assert got.shape == want.shape == (B, 3, 640)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:, :, 0]).all()  # a zero fit plane's k = 0/0
    np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_contract_lookup_nearest_matches_reference(dtype):
    cols_t, k = _lookup_inputs(dtype, 10)
    want = np.asarray(jcols.nearest_lookup(jnp.moveaxis(cols_t, 1, -1)[None],
                                           jnp.asarray(k)[:, None]))
    got = tcols.contract_lookup(convert.tensor(cols_t), torch.from_numpy(k), nearest=True).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, :, 0] == 0.0).all()  # NaN k: no slice matches
    # round half to even: k = 7.5 reads slice 8
    want8 = np.asarray(cols_t, np.float32)[:, 8, 5]
    np.testing.assert_array_equal(got[:, :, 5], np.broadcast_to(want8, got[:, :, 5].shape))


def _cost_volumes(radius, increment, flat_window):
    rng = np.random.RandomState(2)
    K, PH, PW = 16, 40, 300
    E = jnp.asarray(rng.rand(K, PH, PW).astype(np.float32) * 255.0, jnp.bfloat16)
    ref_pad = (rng.rand(PH, PW) * 255.0).astype(np.float32)
    if flat_window:
        ref_pad[10:30, 100:200] = 128.0
    want = convert.tensor(jcv.build_cost_volume(E, jnp.asarray(ref_pad), radius=radius,
                                                increment=increment))
    got = tcv.build_cost_volume(convert.tensor(E), torch.from_numpy(ref_pad), radius, increment)
    assert got.dtype == torch.bfloat16 and got.shape == (K, PH, PW)
    return got, want


@pytest.mark.parametrize("flat_window", [False, True])
@pytest.mark.parametrize("radius,increment", [(5, 2), (5, 5)])
def test_build_cost_volume_matches_reference(radius, increment, flat_window):
    """With a constant window in the reference image too: there the NCC
    moments decide whether a patch is degenerate (ncc_volume.ncc_moments),
    and the port computes them as the reference does."""
    got, want = _cost_volumes(radius, increment, flat_window)
    ulps = _bf16_ulps(got, want)
    assert float((ulps <= 1).float().mean()) >= 0.999, float((ulps <= 1).float().mean())
    _, PH, PW = got.shape
    border = torch.ones((PH, PW), dtype=torch.bool)
    border[radius:PH - radius, radius:PW - radius] = False
    assert (got[:, border] == 2.0).all() and (want[:, border] == 2.0).all()
    if flat_window:  # not degenerate: the moments' rounding leaves a variance > MIN_VAR
        core = got[:, 15:25, 105:195].float()
        assert (core < 2.0).all() and (torch.abs(core - 1.0) < 0.01).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("case", ["R=1001 over all of K", "R=14 in a band", "B=1 over all of K",
                                  "B=10 in a band"])
def test_contract_lookup_edge_shapes_match_reference(dtype, nearest, case):
    """Shapes H6's kernel splits unevenly (R odd or not a multiple of 4, one
    candidate) and narrow and wide slice ranges: k in a 4-slice band (a
    tile's lookups read a few slices) and k over all of K (each lookup
    reads its own); NaN and +-inf lanes in each."""
    rng = np.random.RandomState(7)
    R = {"R=1001 over all of K": 1001, "R=14 in a band": 14}.get(case, 640)
    B = 1 if case.startswith("B=1 ") else 10
    Vs, K = 3, 40
    cols_t = jnp.asarray(rng.rand(Vs, K, R).astype(np.float32), dtype=dtype)
    if case.endswith("band"):
        k = (20.0 + 4.0 * rng.rand(B, R)).astype(np.float32)
    else:
        k = ((K - 1.0) * rng.rand(B, R)).astype(np.float32)
    k[0, :3] = [np.nan, np.inf, -np.inf]
    look = jcols.nearest_lookup if nearest else jcols.tent_lookup
    want = np.asarray(look(jnp.moveaxis(cols_t, 1, -1)[None], jnp.asarray(k)[:, None]))
    got = tcols.contract_lookup(convert.tensor(cols_t), torch.from_numpy(k),
                                nearest=nearest).numpy()
    assert got.shape == want.shape == (B, Vs, R)
    if nearest:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
