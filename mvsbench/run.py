"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 -m mvsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up renders the cell's scene from the seed on the card, writes it in the
MVSNet layout under ``$TMPDIR/mvsbench/<cell>``, and runs one warm-up scene
(every kernel built and every graph key of the cell's shapes captured).
The window then runs whole scenes one after another through
``apdmvs_tpu_torch.scene.run_scene``, the entry ``python -m
apdmvs_tpu_torch`` calls, each from a clean result tree, until the next
would end past ``--seconds``; a scene that still ends past it is left out,
its work and its time. Every scene of a run, the warm-up's included, runs
the program with one seed drawn from ``--seed``, so they do the same work.
Once the window has closed and the program's graphs are dropped, the
judge (``reference.py``) holds every finished scene's outputs against the
scene's ground truth; each compared number and its limit is printed last
on standard error and last in the result line, under ``compared``.

``--trace 1`` runs the first scene of the window under ``torch.profiler``
(the CPU and the card, events kept in memory) with a span around each call
into the program's layers (``tracing.SPANNED``), and reports the cell's
per-layer metrics, the device's busy time and the traced window, and a
breakdown. ``--trace 0`` reports the end-to-end metrics. Each metric is a
reader of its own, ``metrics/<name>.py``, named in ``BENCHMARK.json``.

The run exits 2 without a result where no card, or fewer cards than the
cell asks for, is visible; 3 where JAX or the JAX package was loaded; 1
where the program cannot be imported or a run is not correct.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from typing import Optional  # noqa: E402

from mvsbench import catalog  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "apdmvs_tpu")
CACHE = os.path.join(catalog.ROOT, ".mvsbench_cache")


def set_cache_dirs(root: str = CACHE) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own nvcc libraries already land in
    ``apdmvs_tpu_torch/_build/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(root, sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole (``apdmvs_tpu_torch`` is not
    ``apdmvs_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _pass_rows(run) -> list:
    rows = []
    for spec, problem, stats in run.passes:
        rows.append({"round": spec.round_index, "pass": spec.pass_index,
                     "state": spec.state.name, "use_apd": bool(spec.use_APD),
                     "scale": spec.scale_size, "view": problem.ref_image_id,
                     "seconds": stats.seconds, "weak_in": stats.weak_in})
    return rows


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device="cuda",
             base: str = catalog.HERE, workdir: Optional[str] = None, warmup: bool = True,
             max_scenes: Optional[int] = None, run_overrides: Optional[dict] = None,
             plant=None):
    """One run of ``cell``; returns (the result line as a dict, the record
    the metric readers read). ``base`` is the folder whose ``configs/``
    and ``workloads/`` hold the cell's files; ``run_overrides`` are extra
    ``run_scene`` arguments and ``plant(truth)`` a context around the
    window's scenes (a control's, ``controls.py``); ``warmup`` and
    ``max_scenes`` serve the readings and the tests."""
    import torch

    from mvsbench import reference, scenes, tracing

    wl = catalog.workload(catalog.cell_entry(bench, cell)["traffic"], base)
    cfg = catalog.config(wl["config"], base)
    from apdmvs_tpu_torch import compiled, scene as program

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    folder = os.path.join(workdir or tempfile.gettempdir(), "mvsbench", cell)
    shutil.rmtree(folder, ignore_errors=True)
    truth = scenes.make_scene(cfg, wl, seed, dev)
    scenes.write_mvsnet(folder, truth, cfg)
    if on_card:
        torch.cuda.empty_cache()  # the render's blocks go back before the program runs
    run_seed = int(scenes.sub_seed(seed, 3).generate_state(1)[0])
    kwargs = dict(seed=run_seed, device=dev, fusion_variant=wl["run"]["fusion_variant"],
                  verbose=False)
    kwargs.update(cfg.get("run", {}))
    kwargs.update(run_overrides or {})
    result_tree = os.path.join(folder, "APD")
    if warmup:
        program.run_scene(folder, **kwargs)
        _sync(dev)
    setup_s = time.perf_counter() - T_START

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    records, outputs, errors = [], [], []
    left_out = 0
    trace_out = None
    deadline = time.perf_counter() + seconds
    planted = contextlib.ExitStack()
    if plant is not None:
        planted.enter_context(plant(truth))
    while max_scenes is None or len(records) < max_scenes:
        if records and time.perf_counter() + records[-1]["wall_s"] > deadline:
            break
        shutil.rmtree(result_tree, ignore_errors=True)
        traced = trace and not records and trace_out is None
        prof = None
        captures_before = len(compiled.captures)
        try:
            if traced:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if on_card:
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts, record_shapes=False)
                prof.start()
            t0 = time.perf_counter()
            with (tracing.spans() if traced else contextlib.nullcontext()), \
                    torch.profiler.record_function("mvsbench.window"):
                run = program.run_scene(folder, **kwargs)
            _sync(dev)
            wall = time.perf_counter() - t0
        except Exception:  # a scene that raises is a failed answer; the run goes on to judge
            errors.append(traceback.format_exc())
            if prof is not None:
                prof.stop()
            break
        if prof is not None:
            prof.stop()
            trace_out = _reduce_trace(prof, len(run.passes))
            del prof
        if t0 + wall > deadline and not traced:
            left_out += 1
            break
        records.append({"wall_s": wall, "passes": _pass_rows(run), "traced": traced,
                        "captures": len(compiled.captures) - captures_before})
        outputs.append(reference.snapshot(folder, len(truth.cameras)))
    planted.close()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None

    # the program's state goes before the judge runs on the card
    if on_card:
        compiled.drop()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    judged = [reference.judge(truth, out, wl["check"], dev) for out in outputs]
    verdicts = [reference.verdict(nums, wl["check"]["limits"]) for nums in judged]
    failed = len(errors) + sum(not all(c["ok"] for c in v.values()) for v in verdicts)
    attempted = len(records) + len(errors)
    correct = attempted > 0 and failed == 0
    record = {"cell": cell, "workload": wl, "config": cfg, "setup_s": setup_s,
              "scenes": records, "judged": judged, "trace": trace_out, "peak_bytes": peak,
              "left_out": left_out, "errors": errors}
    metrics = {}
    for entry in catalog.metrics_of(bench, cell, trace):
        value = catalog.metric_reader(entry["name"]).read(record)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": 1 if on_card else 0,
                   "memory_peak_bytes": peak if peak is not None else 0}
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device_info}
    if trace and trace_out is not None:
        device_info["busy_s"] = trace_out["busy_s"]
        device_info["window_s"] = trace_out["window_s"]
        line["breakdown"] = {"device_ops": [[n, s] for n, s in trace_out["device_ops"]],
                             "idle_gaps": [[n, s] for n, s in trace_out["idle_gaps"]]}
    line["compared"] = _compared(verdicts, errors)
    return line, record


def _reduce_trace(prof, view_passes: int) -> dict:
    from mvsbench import tracing

    events = prof.profiler.kineto_results.events()
    window = next(((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                   if e.name() == "mvsbench.window"), None)
    if window is None:
        raise RuntimeError("the traced scene's span is not in the profiler's events")
    out = tracing.reduce_events(events, window)
    out["view_passes"] = view_passes
    return out


def _compared(verdicts: list, errors: list) -> dict:
    """Each compared number at its worst over the judged scenes, with its
    limit; a scene that raised shows as ``scene_raised``."""
    out = {}
    for v in verdicts:
        for name, c in v.items():
            if c["value"] is not None and not math.isfinite(c["value"]):
                c = dict(c, value=None)  # JSON has no infinity: no number, failed
            prev = out.get(name)
            worse = (prev is None or c["value"] is None
                     or (prev["value"] is not None and c["value"] > prev["value"]))
            if worse:
                out[name] = {"value": c["value"], "limit": c["limit"]}
    if errors:
        out["scene_raised"] = {"value": len(errors), "limit": 0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mvsbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    os.environ.setdefault("USE_FLAX", "0")
    bench = catalog.benchmark()
    entry = catalog.cell_entry(bench, args.workload)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"the cell needs {entry['chips']} card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import apdmvs_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program apdmvs_tpu_torch cannot be imported: {e}", file=sys.stderr)
        return 1
    line, record = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    return emit(line, record)


def emit(line: dict, record: dict) -> int:
    """Refuse a process that loaded JAX or the JAX package (3, no result);
    else print the scenes, errors and compared numbers on standard error,
    the result line last on standard output, and return 0 where the run
    is correct, 1 where not."""
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}; the benchmark runs without JAX",
              file=sys.stderr)
        return 3
    for err in record["errors"]:
        print(err, file=sys.stderr)
    for i, (s, j) in enumerate(zip(record["scenes"], record["judged"])):
        passes_s = sum(p["seconds"] for p in s["passes"])
        print(f"scene {i}: {s['wall_s']:.3f} s{' traced' if s['traced'] else ''}, "
              f"{len(s['passes'])} view-passes {passes_s:.3f} s, outside them "
              f"{s['wall_s'] - passes_s:.3f} s, {s['captures']} captures; "
              f"judged {json.dumps(j)}", file=sys.stderr)
    if record["left_out"]:
        print("left out: a scene that ended past the window", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
