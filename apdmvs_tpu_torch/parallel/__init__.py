"""Batched PatchMatch over the problems of a pass (``parallel/sharded.py``).

PyTorch counterpart of the one-card part of ``apdmvs_tpu/parallel/``: the
reference views of a pass run as one batch on one device. The JAX package
shards that batch over a (view, space) device mesh; the port runs a mesh of
one card, and a request for more shards raises (multi-GPU is ROADMAP queue
1 item 5).
"""

from apdmvs_tpu_torch.parallel.sharded import (  # noqa: F401
    build_batch_image_volumes,
    pinned_count,
    problem_row,
    shard_problems,
    sharded_batch_pass,
)
