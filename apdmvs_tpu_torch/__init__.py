"""apdmvs_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port of apdmvs_tpu.

APD-MVS PatchMatch multi-view stereo (Wang et al., CVPR 2023). The public
entry points run on ``cuda`` unless the caller asks for the CPU:
``scene.run_scene(dense_folder, device="cuda")`` and
``python -m apdmvs_tpu_torch <dense_folder> [--device cpu]``.
"""

__version__ = "0.1.0"
