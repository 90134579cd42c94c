"""Share of the pixels of the view-passes that ran the APD weak machinery
that entered its worklist (``ProblemStats.weak_in`` over the pixels of
those passes); None in a cell whose passes never run it."""


def read(record):
    cfg = record["config"]
    weak = pixels = 0
    for s in record["scenes"]:
        for p in s["passes"]:
            if p["use_apd"]:
                weak += p["weak_in"]
                pixels += round(cfg["width"] / p["scale"]) * round(cfg["height"] / p["scale"])
    if not pixels:
        return None
    return 100.0 * weak / pixels
