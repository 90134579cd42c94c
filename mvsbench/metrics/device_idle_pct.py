"""Share of the traced scene's window in which no kernel, copy or set ran
on the card: 1 - the union of the device's intervals over the window
(the profiler's events, ``tracing.reduce_events``)."""


def read(record):
    tr = record["trace"]
    if tr is None or tr["window_s"] <= 0 or not tr["device_events"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
