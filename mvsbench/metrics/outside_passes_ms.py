"""Milliseconds of a scene spent outside its view-passes: the scene's wall
less the sum of its view-passes' seconds (fusion, listing the problems,
checking the images), in the traced scene, or, in a run that traced none,
averaged over the scenes finished in the window."""

from mvsbench.metrics import layer_scenes


def read(record):
    scenes = layer_scenes(record)
    if not scenes:
        return None
    return sum(1e3 * (s["wall_s"] - sum(p["seconds"] for p in s["passes"]))
               for s in scenes) / len(scenes)
