"""Set-up seconds: from the harness's start, imports included, through
rendering and writing the scene and the warm-up scene (host clock)."""


def read(record):
    return record["setup_s"]
