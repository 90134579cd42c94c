"""Seconds a whole scene takes, ``run_scene``'s call to its return with the
fused cloud written and the device synchronised, over the scenes finished
in the window: their sum over their count (host clock)."""


def read(record):
    scenes = record["scenes"]
    if not scenes:
        return None
    return sum(s["wall_s"] for s in scenes) / len(scenes)
