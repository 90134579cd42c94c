"""Plane-sweep volume kernels of the port: H1 (``volume.build_volume``),
H2 (``ncc_volume.ncc_cost``), H3 (``ncc_volume.build_rebased_view``) and H4
(``ncc_volume.geom_volume_cost_view``), each a CUDA kernel under ``csrc/``
beside its plain PyTorch version."""
