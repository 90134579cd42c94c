"""Share of the weak worklist's slots that WEAK pixels fill in the traced
scene: the program's counter ``weak.in`` (WEAK pixels entering the
worklist, summed over the APD view-passes) over ``weak.capacity`` (the
worklist's slots, summed the same way; the rest are padding that the APD
machinery runs all the same). None without a trace, the program's
snapshot of the traced scene or an APD view-pass."""

from mvsbench import program_telemetry


def read(record):
    snap = program_telemetry.traced_scene(record)
    if snap is None:
        return None
    counters = snap.get("counters", {})
    return program_telemetry.per(100.0 * counters.get("weak.in", 0),
                                 counters.get("weak.capacity"))
