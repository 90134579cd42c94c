"""Debug probe files: the reference's compiled-out DEBUG_NEIGHBOUR and
DEBUG_COST_LINE probes (main.h:42-43) as dumps chosen at run time.

PyTorch counterpart of ``apdmvs_tpu/debug.py``. The reference, rebuilt with
the defines on, writes ``neighbour_map.bin`` and ``neighbour.bin`` (the weak
worklist and its anchor coordinates, APD.cu:2421-2438) and fills a per-pixel
61-step disparity cost buffer (APD.cu:2084-2091) that it dumps for the
DEBUG_POINT row. Here the same files come out of a pass run with
``debug=True`` (``pipeline.DebugProbes``), in the same formats, so the
reference's tooling reads them (``scene.run_scene(debug_dumps=True)``,
``--debug-dumps``).
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from apdmvs_tpu_torch.io import formats
from apdmvs_tpu_torch.params import NEIGHBOUR_NUM

#: the reference's probe pixel (main.h:40-41); ``line_y`` overrides the row
DEBUG_POINT_X = 753
DEBUG_POINT_Y = 259


def _host(a) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def dump_probes(result_folder: str, probes, height: int, width: int,
                line_y: Optional[int] = None) -> None:
    """Write a pass's ``DebugProbes`` beside its state files.

    - ``neighbour_map.bin``: int32 [H, W], the worklist index of each weak
      pixel, -1 elsewhere (the reference's ``neighbours_map``,
      APD.cpp:526-538);
    - ``neighbour.bin``: the reference's layout, int32 weak count and int32
      NEIGHBOUR_NUM, then int16 (x, y) pairs (APD.cu:2427-2435);
    - ``weak_cost_line.dmb``: float32 [61, W], the sweep at row ``line_y``
      (default DEBUG_POINT_Y, clamped to the image): the DEBUG_COST_LINE
      curve of every pixel of that row.

    The fields may be tensors on any device or numpy arrays; the worklist's
    int64 is written as int32 and int16, as the JAX package writes it. A
    pass without the weak stages writes the sweep alone."""
    os.makedirs(result_folder, exist_ok=True)
    sweep = _host(probes.sweep)  # [61, H, W]
    y = min(DEBUG_POINT_Y if line_y is None else line_y, height - 1)
    formats.write_bin_mat(os.path.join(result_folder, "weak_cost_line.dmb"),
                          sweep[:, y, :].astype(np.float32))
    if probes.weak_xy is None or probes.anchor_coords is None:
        return
    weak_xy = _host(probes.weak_xy)  # [N, 2], -1 padded
    coords = _host(probes.anchor_coords)  # [N, 9, 2]
    live = np.nonzero(weak_xy[:, 0] >= 0)[0]
    weak_count = len(live)
    nb_map = np.full((height, width), -1, np.int32)
    nb_map[weak_xy[live, 1], weak_xy[live, 0]] = np.arange(weak_count, dtype=np.int32)
    formats.write_bin_mat(os.path.join(result_folder, "neighbour_map.bin"), nb_map)
    pairs = coords[live].astype(np.int16)  # [weak_count, 9, 2] (x, y)
    with open(os.path.join(result_folder, "neighbour.bin"), "wb") as f:
        f.write(struct.pack("<ii", weak_count, NEIGHBOUR_NUM))
        f.write(pairs.tobytes())


def read_neighbours(path: str) -> np.ndarray:
    """A ``neighbour.bin`` (the port's, the JAX package's or the
    reference's) as int16 [weak_count, NEIGHBOUR_NUM, 2] (x, y) anchor
    coordinates."""
    with open(path, "rb") as f:
        weak_count, num = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(weak_count * num * 4), np.int16)
    return data.reshape(weak_count, num, 2)
