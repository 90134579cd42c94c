"""Batched PatchMatch over a (view, space) mesh of devices.

PyTorch counterpart of ``apdmvs_tpu/parallel/``: the reference views of a
pass run as one batch, their problems in contiguous blocks over the view
rows of a mesh (``sharded.py``), each problem's volumes optionally as row
slabs over the space shards of its row (``spaced.py``), and the view rows
over several processes of one ``torch.distributed`` group
(``multihost.py``).
"""

from apdmvs_tpu_torch.parallel import multihost  # noqa: F401
from apdmvs_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh,
    build_batch_image_volumes,
    default_view_shards,
    make_mesh,
    pinned_count,
    problem_blocks,
    problem_row,
    shard_problems,
    sharded_batch_pass,
)
from apdmvs_tpu_torch.parallel.spaced import SpacedVolumeSet  # noqa: F401
