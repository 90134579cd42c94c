"""The cost volumes C36 and C9 of every source view
(``ops/cost_volume.build_cost_volumes``, kernel H9 on a card) on the CPU:
the wrapper writes into the slots it is given, equal bit for bit to the
plain ``build_cost_volume`` of each view and window, at one and four
source views, a width that is not a multiple of 128 (nor of 4), a slice
count that is not a multiple of the plain version's chunk of 8, and a
constant window in the reference and the image volume; the image-volume
set builds its C36 and C9 in the lent slots; the wrapper refuses other
dtypes and shapes; it is a counted kernel wrapper whose counter stays at 0
on the CPU. On a card (the ``chip`` marker; it skips here): H9 against the
plain version, bit for bit, at an odd shape.

This file imports no JAX, so its card test runs on a machine without it:

    python3 -m pytest --noconftest -q tests/test_torch_cost_volume.py -m chip
"""

import os

import numpy as np
import pytest
import torch

from apdmvs_tpu_torch import geometry, ncc, ops
from apdmvs_tpu_torch.ops import _build, cost_volume as cv

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: run with -m chip on a machine that has one")
    return torch.device("cuda")


def _inputs(NV, K, PH, PW, flat, seed=0):
    gen = torch.Generator().manual_seed(seed)
    E = (torch.rand((NV, K, PH, PW), generator=gen) * 255.0).to(torch.bfloat16)
    ref = torch.rand((PH, PW), generator=gen) * 255.0
    if flat:  # a constant patch in both: the moments decide degeneracy there
        ref[PH // 4:PH // 2, PW // 4:PW // 2] = 128.0
        E[:, :, PH // 4:PH // 2, PW // 4:PW // 2] = 128.0
    return E, ref


def _plain(E, ref):
    return (torch.stack([cv.build_cost_volume(E[v], ref, 5, 2) for v in range(E.shape[0])]),
            torch.stack([cv.build_cost_volume(E[v], ref, 5, 5) for v in range(E.shape[0])]))


def _bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("NV,K,PH,PW,flat", [
    (1, 16, 40, 300, False),  # one source view, width 300
    (4, 5, 30, 140, False),   # four source views, K not a multiple of 8
    (4, 11, 26, 133, True),   # a constant window, a width not a multiple of 4
])
def test_build_cost_volumes_fills_the_given_slots_bit_equal_to_the_plain_build(NV, K, PH, PW,
                                                                              flat):
    E, ref = _inputs(NV, K, PH, PW, flat)
    slot36 = torch.full(E.shape, float("nan"), dtype=torch.bfloat16)
    slot9 = torch.full(E.shape, -7.0, dtype=torch.bfloat16)
    got36, got9 = cv.build_cost_volumes(E, ref, slot36, slot9)
    assert got36 is slot36 and got9 is slot9
    want36, want9 = _plain(E, ref)
    assert torch.equal(_bits(got36), _bits(want36))
    assert torch.equal(_bits(got9), _bits(want9))
    # the zero-sum border is COST_MAX in both
    for got in (got36, got9):
        assert (got[..., :5, :] == cv.COST_MAX).all() and (got[..., :, -5:] == cv.COST_MAX).all()
    if flat:  # constant patches are degenerate: COST_MAX inside the window
        assert (got36[:, :, PH // 4 + 5:PH // 2 - 5, PW // 4 + 5:PW // 2 - 5] == cv.COST_MAX).all()


def test_build_cost_volumes_makes_new_tensors_without_slots():
    E, ref = _inputs(2, 3, 24, 40, False, seed=1)
    got36, got9 = cv.build_cost_volumes(E, ref)
    want36, want9 = _plain(E, ref)
    assert torch.equal(_bits(got36), _bits(want36)) and torch.equal(_bits(got9), _bits(want9))


def test_image_volume_set_builds_its_cost_volumes_in_the_lent_slots():
    """``ncc.build_image_volume_set`` with a lender: C36 and C9 are the
    lent tensors (filled with garbage before), equal to the plain build of
    each source view from the set's own E and reference."""
    V, H, W, K = 3, 20, 36, 6
    gen = np.random.RandomState(3)
    images = torch.from_numpy((gen.rand(V, H, W) * 255.0).astype(np.float32))
    Kmat = np.array([[40.0, 0.0, W / 2], [0.0, 40.0, H / 2], [0.0, 0.0, 1.0]])
    R = np.stack([np.eye(3)] * V)
    t = np.stack([np.array([0.1 * v, 0.0, 0.0]) for v in range(V)])
    cams = geometry.make_cameras(np.stack([Kmat] * V), R, t, np.full(V, 2.0), np.full(V, 8.0))
    lent = {}

    def out(role, shape, dtype):
        lent[role] = torch.full(shape, float("nan"), dtype=dtype)
        return lent[role]

    vs = ncc.build_image_volume_set(images, cams, 2.0, 8.0, num_slices=K, out=out)
    assert vs.C36 is lent["volumes.C36"] and vs.C9 is lent["volumes.C9"]
    assert vs.E is lent["volumes.E"]
    want36, want9 = _plain(vs.E, vs.ref_pad)
    assert torch.equal(_bits(vs.C36), _bits(want36)) and torch.equal(_bits(vs.C9), _bits(want9))


@pytest.mark.parametrize("case", ["E_f32", "E_3d", "ref_f64", "ref_shape", "out_dtype",
                                  "out_shape", "out_strided"])
def test_build_cost_volumes_refuses_other_dtypes_and_shapes(case):
    E, ref = _inputs(2, 3, 24, 40, False)
    slot = torch.empty(E.shape, dtype=torch.bfloat16)
    args = {
        "E_f32": (E.float(), ref),
        "E_3d": (E[0], ref),
        "ref_f64": (E, ref.double()),
        "ref_shape": (E, ref[:-1]),
        "out_dtype": (E, ref, slot.float()),
        "out_shape": (E, ref, slot[:1]),
        "out_strided": (E, ref, None, torch.empty((2, 3, 40, 24), dtype=torch.bfloat16)
                        .transpose(2, 3)),
    }[case]
    with pytest.raises(ValueError):
        cv.build_cost_volumes(*args)


def test_build_cost_volumes_is_a_counted_kernel_that_does_not_count_on_the_cpu():
    assert ops.launch_counters()["build_cost_volumes"] is cv.build_cost_volumes
    assert _build.SOURCES["cost_volume"] == "cost_volume.cu"
    assert os.path.exists(os.path.join(_build.CSRC, "cost_volume.cu"))
    before, work = cv.build_cost_volumes.launches, dict(cv.build_cost_volumes.work)
    cv.build_cost_volumes(*_inputs(1, 2, 16, 20, False))
    assert cv.build_cost_volumes.launches == before and cv.build_cost_volumes.work == work
    E, _ = _inputs(2, 3, 24, 40, False)
    assert cv.cost_volumes_work_shape(E) == dict(views=2, slices=3, height=24, width=40)


@pytest.mark.chip
@pytest.mark.parametrize("NV,K,PH,PW", [(4, 19, 61, 333), (1, 7, 40, 260)])
def test_h9_on_the_card_is_bit_equal_to_the_plain_build(card, NV, K, PH, PW):
    """H9 into lent-like slots (filled with NaN) against the plain build on
    the card, at widths that take its scalar (333) and vector (260) loads,
    with a constant patch; its launch counted once."""
    E, ref = _inputs(NV, K, PH, PW, True, seed=5)
    E, ref = E.to(card), ref.to(card)
    slot36 = torch.full(E.shape, float("nan"), dtype=torch.bfloat16, device=card)
    slot9 = torch.full(E.shape, float("nan"), dtype=torch.bfloat16, device=card)
    before = cv.build_cost_volumes.launches
    got36, got9 = cv.build_cost_volumes(E, ref, slot36, slot9)
    torch.cuda.synchronize(card)
    assert cv.build_cost_volumes.launches == before + 1
    want36, want9 = _plain(E, ref)
    assert torch.equal(_bits(got36), _bits(want36)) and torch.equal(_bits(got9), _bits(want9))
