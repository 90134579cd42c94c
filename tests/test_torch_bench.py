"""The flagship fixture (``apdmvs_tpu_torch.bench``) on the CPU at 64x48:
the flagship pass's setup as the repository's ``bench.py`` sets it up (weak
box, worklist capacity), the one definition that the tools take; and
``chip_smoke.py``'s kernel bounds, which are the benchmark's yardstick
(``mvsbench/roofline.py``)."""

import numpy as np
import torch

import chip_smoke
from apdmvs_tpu.scene import _bucket_capacity as jax_bucket_capacity
from apdmvs_tpu_torch import bench, trace_pass
from apdmvs_tpu_torch.params import PixelState
from mvsbench import roofline


def test_flagship_state_is_bench_py_s():
    W, H, V = 64, 48, 5
    images, depths, normals, cams = bench.flagship_scene(W, H, V, "cpu")
    vs, prior, cap, build_ms = bench.flagship_state(images, depths, normals, cams, 16)
    weak = (prior.pixel_state == PixelState.WEAK).numpy()
    assert weak.sum() == (H // 4) * (W // 4)
    assert weak[H // 2 - H // 8:H // 2 + H // 8, W // 2 - W // 8:W // 2 + W // 8].all()
    assert cap == jax_bucket_capacity((H // 4) * (W // 4), H * W)
    np.testing.assert_array_equal(prior.depth.numpy(), depths[0])
    assert vs.D is not None and vs.C36 is not None and min(build_ms) > 0
    assert (bench.DMIN, bench.DMAX) == (2.0 * 0.6, 8.0 * 1.2)
    assert bench.FLAGSHIP_RTH == 0.00875
    cfg = bench.FLAGSHIP_CFG
    assert (cfg.state.name, cfg.geom_consistency, cfg.use_APD, cfg.max_iterations,
            cfg.weak_peak_radius) == ("REFINE_ITER", True, True, 3, 4)
    # one definition: the trace takes its flagship pass from the fixture
    assert trace_pass.flagship_state is bench.flagship_state
    assert trace_pass.flagship_pass is bench.flagship_pass


def test_chip_smoke_bounds_are_the_benchmark_s():
    # the main path's shapes (C = 9 fields over 4 views, C = 8 for H4) and a
    # small grid where the operations, not the bytes, bound H2
    for C, views, Hp, Wp, touched in ((9, 4, 480, 640, 3_100_000), (8, 4, 480, 640, 2_457_600),
                                      (3, 1, 16, 128, 20_000)):
        planes_cf = torch.zeros((C, 4, Hp, Wp))
        assert chip_smoke.h2_bound_views(planes_cf, views, touched) == roofline.bound(
            *roofline.h2_work(C, views, Hp, Wp, touched))
        assert chip_smoke.h4_bound_views(planes_cf, views, touched) == roofline.bound(
            *roofline.h4_work(C, views, Hp, Wp, touched))
    assert {b for _, b in (chip_smoke.h2_bound_views(torch.zeros((3, 4, 16, 128)), 1, 20_000),
                           chip_smoke.h2_bound_views(torch.zeros((9, 4, 480, 640)), 4, 10 ** 9))} \
        == {"operations", "bytes"}
    # no peak, operation count or bound of its own beside the benchmark's
    assert chip_smoke.bound is roofline.bound and chip_smoke.OPS_H1 == roofline.OPS_H1
    assert not any(hasattr(chip_smoke, n) for n in (
        "MEM_BYTES_PER_S", "F32_FLOPS", "OPS_H2_SAMPLE", "OPS_H2_OUT", "OPS_H2_REF", "OPS_H4"))
