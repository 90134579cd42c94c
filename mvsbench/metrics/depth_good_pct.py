"""Share of pixels whose final depth lies within the workload's
``depth_rel_tol`` (0.01) of the true depth, over the pixels whose true
depth is inside the depth range, in every view of every scene finished in
the window (the judge's counts, ``reference.judge``)."""


def read(record):
    judged = record["judged"]
    valid = sum(j["depth_valid"] for j in judged)
    if not valid:
        return None
    return 100.0 * sum(j["depth_good"] for j in judged) / valid
