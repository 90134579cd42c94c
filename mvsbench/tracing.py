"""The traced run's reduction: ``torch.profiler``'s events, kept in memory,
to device busy time, idle share, device time by kernel and idle time by
what the host was doing.

The busy arithmetic is ``apdmvs_tpu_torch/timeline.py``'s ``ledger`` (the
union of the device's kernel, copy and set intervals), read from the
profiler's raw events instead of a written Chrome trace, which for a
whole scene would be gigabytes. Idle time is charged to what the host was
doing while it lasted: the innermost span that the harness opened around
a call into the program (:func:`spans`), "-" outside every one. (The
ledger charges a whole gap to the host's state where it began, which puts
a fusion that follows the last state file under the state files.)
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "mvsbench."
NO_SPAN = "-"

#: the calls into the program that the traced run wraps in a span of its
#: own: (module, function), each found by its name in ``apdmvs_tpu_torch``
SPANNED = (("scene", "process_problem"), ("scene", "run_fusion"), ("scene", "_persist"),
           ("scene", "_load_prior"), ("scene", "_load_src_depths"),
           ("scene", "_problem_inputs"), ("ncc", "build_image_volume_set"),
           ("ncc", "add_depth_volumes"), ("pipeline", "patchmatch_pass"))


@contextlib.contextmanager
def spans():
    """Wrap each call of :data:`SPANNED` in ``record_function("mvsbench.
    <function>")`` while the context is open; the functions are put back
    on exit. The program's modules look these names up at call time, so
    the wrapper is what they call."""
    import importlib

    import torch

    saved = []
    try:
        for mod_name, fn_name in SPANNED:
            mod = importlib.import_module("apdmvs_tpu_torch." + mod_name)
            fn = getattr(mod, fn_name)
            saved.append((mod, fn_name, fn))

            def wrapped(*a, __fn=fn, __name=SPAN_PREFIX + fn_name, **kw):
                with torch.profiler.record_function(__name):
                    return __fn(*a, **kw)

            setattr(mod, fn_name, functools.wraps(fn)(wrapped))
        yield
    finally:
        for mod, fn_name, fn in reversed(saved):
            setattr(mod, fn_name, fn)


def _is_device_op(e) -> bool:
    """A kernel, copy or set on the card: an event on a CUDA device that is
    not a span's shadow on the device's timeline."""
    annotation = getattr(e, "is_user_annotation", None)
    return (str(e.device_type()).endswith("CUDA") and not (annotation and annotation())
            and not e.name().startswith((SPAN_PREFIX, "apd.")))


def reduce_events(events, window: Tuple[int, int], top: int = 10) -> dict:
    """Busy and idle time of the device in ``window`` (start, end ns of the
    host clock the profiler uses), device time by operation, and idle time
    by the harness span the host was in while it lasted.

    ``events`` are ``torch.profiler.profile().profiler.kineto_results
    .events()``."""
    device: List[Tuple[int, int, str]] = []
    host_spans: Dict[int, List[Tuple[int, int, str]]] = collections.defaultdict(list)
    for e in events:
        if _is_device_op(e):
            s = e.start_ns()
            device.append((s, s + e.duration_ns(), e.name()))
        elif str(e.device_type()).endswith("CPU") and e.name().startswith(SPAN_PREFIX):
            s = e.start_ns()
            host_spans[e.start_thread_id()].append((s, s + e.duration_ns(), e.name()))
    w0, w1 = window
    device = [(max(s, w0), min(t, w1), n) for s, t, n in device if t > w0 and s < w1]
    device.sort()
    by_name: Dict[str, float] = collections.defaultdict(float)
    busy, end = 0, None
    gaps: List[Tuple[int, int]] = []  # (start, length) of each idle gap
    if device and device[0][0] > w0:
        gaps.append((w0, device[0][0] - w0))
    for s, t, n in device:
        by_name[n] += (t - s) / 1e9
        if end is not None and s > end:
            gaps.append((end, s - end))
        gained = t - (s if end is None else max(s, end))
        if gained > 0:
            busy += gained
        end = t if end is None else max(end, t)
    if end is not None and end < w1:
        gaps.append((end, w1 - end))
    elif end is None:
        gaps.append((w0, w1 - w0))
    thread = max(host_spans, key=lambda k: len(host_spans[k])) if host_spans else None
    idle_by_span = _charge(gaps, host_spans.get(thread, []))
    window_s = (w1 - w0) / 1e9
    return {
        "busy_s": busy / 1e9,
        "window_s": window_s,
        "device_events": len(device),
        "by_name": dict(by_name),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(idle_by_span.items(), key=lambda kv: -kv[1])[:top],
        "idle_s": sum(g for _, g in gaps) / 1e9,
    }


def _segments(spans_: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    """The host's time cut into segments, each labelled with the innermost
    span open in it (spans of one thread nest); time in no span is left
    out."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []  # (end, name), innermost last
    t = None

    def advance(to):
        nonlocal t
        while stack and stack[-1][0] <= to:
            end, name = stack.pop()
            if t < end:
                out.append((t, end, name))
                t = end
        if stack and t < to:
            out.append((t, to, stack[-1][1]))
        t = to if t is None else max(t, to)

    for s, e, name in sorted(spans_, key=lambda x: (x[0], -x[1])):
        if t is None:
            t = s
        advance(s)
        stack.append((e, name))
    if stack:
        advance(max(e for e, _ in stack))
    return out


def _charge(gaps: List[Tuple[int, int]], spans_: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Seconds of the idle gaps by the innermost span the host was in
    while each part of a gap lasted; parts in no span go under ``-``."""
    segs = _segments(spans_)
    starts = [g[0] for g in segs]
    out: Dict[str, float] = collections.defaultdict(float)
    for g0, length in gaps:
        g1 = g0 + length
        covered = 0
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(segs) and segs[i][0] < g1:
            s0, s1, name = segs[i]
            part = min(s1, g1) - max(s0, g0)
            if part > 0:
                out[name] += part / 1e9
                covered += part
            i += 1
        if length > covered:
            out[NO_SPAN] += (length - covered) / 1e9
    return out


def kernel_seconds(by_name: Dict[str, float], fragment: str) -> Optional[float]:
    """Device seconds of the operations whose name holds ``fragment``;
    None where none ran."""
    hits = [s for n, s in by_name.items() if fragment in n]
    return sum(hits) if hits else None
