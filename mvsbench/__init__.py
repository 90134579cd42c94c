"""The benchmark of the PyTorch and CUDA port (``apdmvs_tpu_torch``).

One command runs one cell once::

    python3 -m mvsbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository's root names the cells, the
configurations and the metrics; each is a file of its own under this
folder (``configs/``, ``workloads/``, ``metrics/``), found by its name.
Nothing here imports JAX or the JAX package: the scenes, the ground truth
and the judge of ``correct`` are plain PyTorch and NumPy.
"""
