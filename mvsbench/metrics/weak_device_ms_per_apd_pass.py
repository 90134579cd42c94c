"""Device milliseconds of the APD weak machinery a view-pass that runs it,
in the traced scene: the stage times ``weak_prep`` and ``weak_sweep`` that
the compiled pass's graph records inside every replay (timing events at
each ``apd.<stage>`` boundary), summed, over the program's counter
``apd_view_passes``. None without a trace, the program's snapshot of the
traced scene or an APD view-pass."""

from mvsbench import program_telemetry

STAGES = ("weak_prep", "weak_sweep")


def read(record):
    snap = program_telemetry.traced_scene(record)
    if snap is None:
        return None
    stage_ms = snap.get("stage_ms", {})
    return program_telemetry.per(sum(stage_ms.get(s, 0.0) for s in STAGES) or None,
                                 snap.get("counters", {}).get("apd_view_passes"))
