"""The yardstick of a kernel's roofline share: the card's peaks and the
operations and bytes of each kernel's function, copied from
``chip_smoke.py``'s bound arithmetic so that the benchmark owns it.

No metric reads it yet: the kernel wrappers count launches, not the work
of a launch (outputs, fields, views, window samples), so a share would
rest on assumed work. A ``<kernel>_roofline`` metric becomes a reader of
its own once the wrappers count their work (PERF.md, Open questions);
its least time is :func:`bound` of the counted bytes and operations, and
its share that time over the kernel's device time.
"""

from __future__ import annotations

from typing import Tuple

#: NVIDIA H100 SXM, published (data sheet; dense, no sparsity, 700 W):
#: HBM3 bytes/s and f32 operations/s outside the tensor cores (the kernels
#: do f32 arithmetic on CUDA cores)
PEAKS = {"NVIDIA H100 80GB HBM3": {"mem_bytes_per_s": 3.35e12, "f32_flops": 67e12}}

#: f32 operations of each kernel's function, counted off its plain
#: version (the work the function needs, not the kernel's instructions):
#: H1 22 an output; H2 17 a window sample of an output, 46 an output and
#: 3 a window sample of a pixel (the reference sums, shared by every view
#: and field); H4 ~60 an output
OPS_H1, OPS_H2_SAMPLE, OPS_H2_OUT, OPS_H2_REF, OPS_H4 = 22, 17, 46, 3, 60


def bound(nbytes: float, ops: float, kind: str = "NVIDIA H100 80GB HBM3") -> Tuple[float, str]:
    """The least milliseconds the card could take: bytes over the memory
    rate or operations over the f32 rate, the larger, and which."""
    peak = PEAKS[kind]
    t_bytes = nbytes / peak["mem_bytes_per_s"] * 1e3
    t_ops = ops / peak["f32_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def h1_work(views: int, slices: int, height: int, width: int) -> Tuple[float, float]:
    """(bytes, operations) of H1 building E [views, slices, H, W] bf16 from
    the source images (f32, read once)."""
    outputs = views * slices * height * width
    return outputs * 2 + views * height * width * 4, outputs * OPS_H1


def h2_work(fields: int, views: int, height: int, width: int, touched: int,
            samples: int = 36) -> Tuple[float, float]:
    """(bytes, operations) of H2 over ``fields`` plane fields of H x W
    against ``views`` source views: the ``touched`` elements of E (bf16)
    the windows read, the padded reference image, the planes in and the
    costs out; the operations of every window sample."""
    nbytes = (touched * 2 + (height + 10) * (width + 10) * 4 + fields * 4 * height * width * 4
              + views * fields * height * width * 4)
    ops = (views * fields * height * width * (samples * OPS_H2_SAMPLE + OPS_H2_OUT)
           + height * width * samples * OPS_H2_REF)
    return nbytes, ops


def h4_work(fields: int, views: int, height: int, width: int, touched: int) -> Tuple[float, float]:
    """(bytes, operations) of H4: the ``touched`` elements of D (f32), the
    planes in and the costs out."""
    nbytes = touched * 4 + fields * 4 * height * width * 4 + views * fields * height * width * 4
    return nbytes, views * fields * height * width * OPS_H4
