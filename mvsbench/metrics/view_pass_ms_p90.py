"""The 90th percentile of one view-pass's milliseconds
(``ProblemStats.seconds``, ending in the host copy of the pass's state)
over every view-pass of the traced scene, or, in a run that traced none,
of every scene finished in the window: the profiler's scene is slower,
so the two are never mixed."""

import statistics

from mvsbench.metrics import layer_scenes


def read(record):
    ms = [1e3 * p["seconds"] for s in layer_scenes(record) for p in s["passes"]]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10)[8]
