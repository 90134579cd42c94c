"""A gap ledger over a ``torch.profiler`` Chrome trace: where the card sat
idle, and what the host was doing meanwhile.

    python -m apdmvs_tpu_torch.timeline TRACE.json [--gaps-ms 0.05] [--top 20]

The counterpart of ``scripts/timeline_pass.py`` (which walks a TPU xplane).
It reads the trace that ``scene.run_scene(profile_dir=)``
(``--profile-dir``), ``trace_pass --out`` or ``chip_smoke.py`` writes and
prints one JSON line:

- ``window_ms``: first device event's start to last device event's end;
  the device events are those of category ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``;
- ``busy_ms``: the union of their intervals; ``idle_share``: 1 - busy /
  window (both null in a trace without device events, a CPU run's);
- ``stages``: per ``apd.*`` span (``pipeline.STAGES``), the device busy
  time of the events whose launch lies inside it and the idle time of the
  gaps such an event ends; events launched outside every span count under
  ``"-"``. The stages' busy and idle sum to ``busy_ms`` and the idle time;
- ``gaps``: the count and sum of the gaps of at least ``--gaps-ms``, and
  the ``--top`` longest, each with the stage whose span holds the launch
  of the event that ends it (``stage``), the innermost ``cpu_op`` the
  launching thread was in when the gap began (``host_op``, null between
  operators: Python) and that event's name;
- ``kernels``: device time and launches by name, the most time first;
- ``spans``: the count and host milliseconds of each ``apd.*`` span.

A device event is matched to its launch through ``args.correlation``, which
the CUDA runtime's calls (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...)
and the lower-level ``cuLaunchKernel`` (which kernels loaded from a library
with ``ctypes`` may take) carry alike; the ledger keys on the correlation
id, not on a call's name. A device event whose launch is not in the trace
counts under ``"-"`` and in ``unmatched``.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "apd."
NO_STAGE = "-"


def _cat(e) -> str:
    return str(e.get("cat", "")).lower()


def load_events(path: str) -> List[dict]:
    """The complete ("X") events of a Chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def kernels_by_name(device_events) -> Dict[str, list]:
    """name -> [device microseconds, count] over device events."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for e in device_events:
        out[e["name"]][0] += float(e.get("dur", 0.0))
        out[e["name"]][1] += 1
    return out


class _Intervals:
    """Host intervals of one thread, sorted by start."""

    def __init__(self, events):
        self.items = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                              e["name"]) for e in events), key=lambda it: it[0])
        self.starts = [it[0] for it in self.items]

    def last_holding(self, t: float) -> Optional[str]:
        """The name of the latest-starting interval if it holds ``t``: the
        one holding ``t`` among disjoint intervals (the ``apd.*`` spans)."""
        i = bisect.bisect_right(self.starts, t)
        if i and self.items[i - 1][1] >= t:
            return self.items[i - 1][2]
        return None

    def innermost(self, t: float) -> Optional[str]:
        """The name of the latest-starting interval holding ``t``, the
        innermost of nested intervals (operators calling operators)."""
        for start, end, name in reversed(self.items[:bisect.bisect_right(self.starts, t)]):
            if end >= t:
                return name
        return None


def ledger(events: List[dict], gaps_ms: float = 0.05, top: int = 20) -> dict:
    """The ledger of a trace's complete events (see the module docstring)."""
    by_thread = collections.defaultdict(lambda: {"spans": [], "ops": []})
    launches, device = {}, []
    for e in events:
        cat = _cat(e)
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e
        elif cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            by_thread[(e.get("pid"), e.get("tid"))]["spans"].append(e)
        elif cat == "cpu_op":
            by_thread[(e.get("pid"), e.get("tid"))]["ops"].append(e)
    spans = {k: _Intervals(v["spans"]) for k, v in by_thread.items()}
    ops = {k: _Intervals(v["ops"]) for k, v in by_thread.items()}
    span_stats = collections.defaultdict(lambda: [0, 0.0])
    for v in by_thread.values():
        for s in v["spans"]:
            span_stats[s["name"]][0] += 1
            span_stats[s["name"]][1] += float(s.get("dur", 0.0)) / 1e3

    def launch_of(e):
        return launches.get(e.get("args", {}).get("correlation"))

    def stage_of(launch) -> str:
        if launch is None:
            return NO_STAGE
        ivs = spans.get((launch.get("pid"), launch.get("tid")))
        name = ivs.last_holding(float(launch["ts"])) if ivs else None
        return name or NO_STAGE

    device.sort(key=lambda e: float(e["ts"]))
    stages = collections.defaultdict(lambda: {"busy_ms": 0.0, "idle_ms": 0.0, "events": 0})
    gaps, busy, end, unmatched = [], 0.0, None, 0
    for e in device:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        launch = launch_of(e)
        unmatched += launch is None
        st = stages[stage_of(launch)]
        st["events"] += 1
        if end is not None and ts > end:
            st["idle_ms"] += (ts - end) / 1e3
            gaps.append((ts - end, end, e, launch))
        gained = ts + dur - (ts if end is None else max(ts, end))
        if gained > 0:
            busy += gained
            st["busy_ms"] += gained / 1e3
        end = ts + dur if end is None else max(end, ts + dur)
    out = {"device_events": len(device), "unmatched": unmatched}
    if device:
        window = end - float(device[0]["ts"])
        out.update(window_ms=window / 1e3, busy_ms=busy / 1e3,
                   idle_share=1.0 - busy / window if window > 0 else 0.0)
    else:
        out.update(window_ms=0.0, busy_ms=None, idle_share=None)
    listed = [g for g in gaps if g[0] >= gaps_ms * 1e3]
    listed.sort(key=lambda g: -g[0])
    t0 = float(device[0]["ts"]) if device else 0.0
    top_gaps = []
    for gap, start, e, launch in listed[:top]:
        thread = ops.get((launch.get("pid"), launch.get("tid"))) if launch else None
        top_gaps.append({"ms": gap / 1e3, "at_ms": (start - t0) / 1e3,
                         "stage": stage_of(launch),
                         "host_op": thread.innermost(start) if thread else None,
                         "next": e["name"][:80]})
    out["stages"] = {k: v for k, v in sorted(stages.items(), key=lambda kv: -kv[1]["busy_ms"])}
    out["gaps"] = {"threshold_ms": gaps_ms, "count": len(listed),
                   "sum_ms": sum(g[0] for g in listed) / 1e3, "top": top_gaps}
    out["kernels"] = [{"name": n[:110], "ms": us / 1e3, "launches": c} for n, (us, c) in
                      sorted(kernels_by_name(device).items(), key=lambda kv: -kv[1][0])[:top]]
    out["spans"] = {k: {"count": c, "host_ms": ms} for k, (c, ms) in sorted(span_stats.items())}
    return out


def read(path: str, gaps_ms: float = 0.05, top: int = 20) -> dict:
    """:func:`ledger` of the trace file at ``path``."""
    return dict(trace=path, **ledger(load_events(path), gaps_ms, top))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="apdmvs_tpu_torch.timeline",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("trace", help="a torch.profiler Chrome trace (JSON)")
    ap.add_argument("--gaps-ms", type=float, default=0.05,
                    help="gaps of at least this many ms are counted and listed")
    ap.add_argument("--top", type=int, default=20, help="gaps and kernels listed")
    args = ap.parse_args(argv)
    print(json.dumps(read(args.trace, args.gaps_ms, args.top)))


if __name__ == "__main__":
    main()
