"""GB (1e9 bytes) that the compiled pass's graph pool holds at the end of
the traced scene: the program's counter ``compiled.pool_bytes`` (the
segments of the pools that the captured graphs of the card share, beside
``peak_device_gb``'s allocated bytes). The snapshot keeps only the
counters that moved, and off a card the pool holds nothing (no graph is
captured), so a scene on the CPU without the counter reads 0. None
without a trace, the program's snapshot of the traced scene, or, on a
card, the counter (a program that does not count it)."""

from mvsbench import program_telemetry


def read(record):
    snap = program_telemetry.traced_scene(record)
    if snap is None:
        return None
    pool = snap.get("counters", {}).get("compiled.pool_bytes")
    if pool is None:
        return 0.0 if snap.get("device") == "cpu" else None
    return pool / 1e9
