"""The port's measurement helpers on the CPU: ``trace_pass``'s flagship
inputs (the weak sweep's synthetic lookups and the capture of a real
pass's H6 calls, which ``chip_smoke.py`` and ``ab_kernels.py`` time on the
card) at 128x96, K=32, and ``sass_counts``'s reading of SASS text."""

import numpy as np
import pytest
import torch

from apdmvs_tpu_torch import geometry, sass_counts, trace_pass
from apdmvs_tpu_torch.datasets import synthetic
from apdmvs_tpu_torch.ops import cols

torch.set_num_threads(2)

W, H, V, K = 128, 96, 5, 32


@pytest.fixture(scope="module")
def flagship():
    cams_s, planes = synthetic.make_ring_scene(num_views=V, width=W, height=H)
    images, depths, normals = synthetic.render_scene(cams_s, planes)
    cams = geometry.make_cameras(
        np.stack([c.K for c in cams_s]), np.stack([c.R for c in cams_s]),
        np.stack([c.t for c in cams_s]), np.full(V, 1.2), np.full(V, 9.6), device="cpu")
    vs, prior, cap, _ = trace_pass.flagship_state(images, depths, normals, cams, K)
    return cams, vs, prior, cap


def test_weak_lookups_shapes_and_special_lanes(flagship):
    cams, vs, prior, cap = flagship
    weak_xy, a, wcols, k_c, k_a = trace_pass.weak_lookups(cams, vs, prior, cap, K)
    assert weak_xy.shape == (cap, 2) and a.shape == (cap, 8, 2)
    assert wcols.c36.shape == (V - 1, K, cap) and wcols.c9.shape == (V - 1, K, 8 * cap)
    assert k_c.shape == (10, cap) and k_a.shape == (10, 8 * cap)
    for kk in (k_c, k_a):
        assert torch.isnan(kk[0, 0]) and kk[0, 1] == float("inf") and kk[0, 2] == -float("inf")
        assert kk[0, 3] == -5.0 and kk[1, 0] == K + 10.0 and kk[1, 1] == K - 1.0
        assert torch.isnan(kk[9]).all()  # the zero fit plane: k = 0/0
        assert torch.isfinite(kk[2:9]).any()


def test_flagship_h6_calls_capture_each_kind_and_restore_the_wrapper(flagship):
    cams, vs, prior, cap = flagship
    kernel = cols.contract_lookup
    calls = trace_pass.flagship_h6_calls(cams, vs, prior, cap, 1)
    assert cols.contract_lookup is kernel
    assert sorted(calls) == sorted(f"{t}_{m}_B{b}" for t, m in (
        ("c36", "tent"), ("c9", "tent"), ("d", "nearest")) for b in (10, 5))
    for kind, (table, k, nearest) in calls.items():
        R = {"c36": cap, "c9": 8 * cap, "d": cap}[kind.split("_")[0]]
        assert table.shape == (V - 1, K, R) and k.shape == (int(kind.split("_B")[1]), R)
        assert nearest == kind.startswith("d_")
        assert table.dtype == (torch.float32 if nearest else torch.bfloat16)
        out = cols.contract_lookup(table, k, nearest=nearest)
        assert out.shape == (k.shape[0], V - 1, R)


@pytest.mark.parametrize("op, cls", [
    ("LDG.E.U16.CONSTANT", "global_load"), ("STG.E.128", "global_store"),
    ("LDS.U16", "shared"), ("IMAD.WIDE.U32", "addr64"), ("LEA.HI.X", "addr64"),
    ("IADD3.X", "addr64"), ("IMAD.U32", "other"), ("LEA", "other"), ("FFMA", "fp32"),
    ("F2I.FLOOR.NTZ", "convert"), ("BRA", "branch_sync"), ("S2R", "other")])
def test_sass_counts_classify(op, cls):
    assert sass_counts.classify(op) == cls


def test_sass_counts_reads_functions_and_predicated_instructions():
    text = """
        Function : _Z6kernelPKfPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
        /*0010*/              @!P0 LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/                   IMAD.WIDE.U32 R2, R3, R4, R2 ;
        /*0030*/                   STG.E desc[UR4][R2.64], R5 ;
        /*0040*/                   NOP ;
        Function : _Z5otherv
        /*0000*/               @P1 BRA 0x100 ;
        /*0010*/                   EXIT ;
    """
    got = sass_counts.counts(text)
    assert got["_Z6kernelPKfPf"] == {"total": 4, "other": 1, "global_load": 1, "addr64": 1,
                                     "global_store": 1}
    assert got["_Z5otherv"] == {"total": 2, "branch_sync": 2}
