"""Device milliseconds of H2 (``ncc_cost_kernel``, csrc/ncc_cost.cu) in the
traced scene, over its view-passes (the profiler's kernel events by
name); None without a trace or where H2 never ran."""

from mvsbench import tracing


def read(record):
    tr = record["trace"]
    if tr is None or not tr["view_passes"]:
        return None
    s = tracing.kernel_seconds(tr["by_name"], "ncc_cost_kernel")
    return None if s is None else 1e3 * s / tr["view_passes"]
