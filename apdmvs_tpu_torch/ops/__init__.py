"""Plane-sweep volume kernels of the port, each a CUDA kernel under
``csrc/`` beside its plain PyTorch version, and the TPU kernel of
``apdmvs_tpu/ops/`` that each replaces:

- H1 ``volume.build_volume`` (``build_volume.cu``): ``volume.py:123
  _build_kernel``;
- H2 ``ncc_volume.ncc_cost_views`` (all source views) and
  ``ncc_volume.ncc_cost`` (one view) (``ncc_cost.cu``): ``ncc_volume.py:353
  _kernel`` with ``:625 _fixup_kernel`` and ``:708 _band2_kernel``, ``:574
  _kernel_fullk``, ``:205 _kernel_rb`` and ``:1659 _kernel_rb_offs``, all
  read from E;
- H3 ``ncc_volume.build_rebased_view`` (``rebase_view.cu``):
  ``ncc_volume.py:1029 _rebase_kernel`` (no default path calls it);
- H4 ``ncc_volume.geom_volume_cost_view`` (``geom_cost.cu``):
  ``ncc_volume.py:1370 _geom_kernel``;
- H5 ``cols.gather_cols`` (``gather_cols.cu``): ``cols.py:50
  _make_gather_kernel`` as the weak machinery uses it;
- H6 ``cols.contract_lookup`` (``contract_lookup.cu``): ``cols.py:335
  _contract_kernel``;
- H7 ``cols.gather_rows`` and ``cols.gather_rows_sorted``
  (``gather_rows.cu``): ``cols.py:151 _make_sorted_gather_kernel`` and the
  table entry point of ``cols.py:50``;
- H8 ``volume.volume_sample`` (``volume_sample.cu``): ``volume.py:375
  _select_kernel``.

Exported here, as the reference package's ``ops`` exports them:
``inv_depth_grid``, ``depth_to_slice``, ``volume_sample`` and
``volume_sample_ref``, and ``build_volume``. The port's ``build_volume`` is
the padded H1 wrapper, ``build_volume(src_image, M, b, K0, height, width,
u_min, du, num_slices, pad_y, pad_x, dtype, trunc)``, which writes bf16
(bilinear) or f32 (trunc); the reference's is an unpadded XLA build over
precomputed pixel directions, ``build_volume(src_image, M, b, dirs, u_min,
du, num_slices, dtype, trunc)``. ``pad_y=pad_x=0`` gives the reference's
grid.
"""

from apdmvs_tpu_torch.ops.volume import (  # noqa: F401
    build_volume,
    depth_to_slice,
    inv_depth_grid,
    volume_sample,
    volume_sample_ref,
)
