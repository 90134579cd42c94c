"""Graph captures per scene in the window: the growth of
``apdmvs_tpu_torch.compiled.captures`` over the window's finished scenes,
over their count. 0 where every key stays captured; a key the warm-up did
not leave behind (a miss, or keys dropped when the scale changes) counts."""


def read(record):
    scenes = record["scenes"]
    if not scenes:
        return None
    return sum(s["captures"] for s in scenes) / len(scenes)
