"""The readings a cell's limits are set from: every number the judge
compares, for the program as the configuration states it and for the
control, one whole scene a seed at the cell's own size.

    python3 -m mvsbench.calibrate --workload <cell> --seeds 1 2 3 [--control NAME] [--device cuda]

Each seed renders the cell's scene, runs it once through
``run_scene`` (no warm-up: a scene's outputs do not depend on whether its
graphs were captured before) and prints one JSON line: the seed, the
control it ran (none for the program as configured), the scene's
seconds and the judge's numbers.

A control (``check.controls`` of the workload file, by name; see
``controls.py``) is the program with something it should
keep broken on purpose: a lower precision where it produces its maps or
its cloud, or fewer inverse-depth slices than the configuration states.
The limits sit above the largest reading of the program and below the
smallest of the control that a number is there to catch (PERF.md gives
both).
"""

from __future__ import annotations

import argparse
import json
import sys

from mvsbench import catalog, controls, run


def readings(cell: str, seeds, control=None, device="cuda", base: str = catalog.HERE,
             workdir=None, bench=None):
    """One dict a seed: ``seed``, ``control``, ``scene_s``, ``correct``
    under the workload's present limits, the last line of the error where
    the scene raised, and the judge's numbers. ``control`` is None (the
    program as configured) or a name from the workload's
    ``check.controls``."""
    bench = bench or catalog.benchmark()
    wl = catalog.workload(catalog.cell_entry(bench, cell)["traffic"], base)
    spec = wl["check"]["controls"][control] if control else {}
    for seed in seeds:
        line, record = run.run_cell(bench, cell, seed, 1e9, False, device=device, base=base,
                                    workdir=workdir, warmup=False, max_scenes=1,
                                    run_overrides=spec.get("run"),
                                    plant=lambda truth: controls.planted(spec, truth))
        judged = record["judged"][0] if record["judged"] else {}
        error = record["errors"][0].strip().splitlines()[-1] if record["errors"] else None
        yield {"seed": seed, "control": control,
               "scene_s": record["scenes"][0]["wall_s"] if record["scenes"] else None,
               "correct": line["correct"],
               "error": error,
               **judged}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mvsbench.calibrate", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default=None, help="a name from the workload's check.controls")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    for r in readings(args.workload, args.seeds, args.control, args.device):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
