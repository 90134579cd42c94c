"""One reader per metric, ``<metric name>.py``, each with ``read(record)``:
the metric's value from the run's record (``run.run_cell``), or None where
the record holds nothing for it to read (the harness then leaves the
metric out of the line). ``BENCHMARK.json`` gives each metric's unit,
direction, source, layer and the end-to-end metric it moves."""


def layer_scenes(record) -> list:
    """The scenes a per-layer metric of the host's clock reads: the traced
    one where the run traced a scene (its times are what the breakdown
    explains), else every scene finished in the window."""
    traced = [s for s in record["scenes"] if s.get("traced")]
    return traced or record["scenes"]
