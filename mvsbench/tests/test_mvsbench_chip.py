"""On the card, at each cell's own size: each control (the program with
something it should keep broken on purpose, ``check.controls``) comes out
not correct on three seeds, and the program as configured comes out
correct. A whole scene a seed; some minutes a cell.

    python3 -m pytest mvsbench/tests/test_mvsbench_chip.py -q -m chip
"""

import pytest

from mvsbench import calibrate, catalog

CELLS = [w["name"] for w in catalog.benchmark()["workloads"]]
CONTROLS = [(w["name"], c) for w in catalog.benchmark()["workloads"]
            for c in catalog.workload(w["traffic"])["check"]["controls"]]
CONTROL_SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def _show(cell, rows):
    """Each reading's compared numbers (``-rA`` shows them for a pass)."""
    traffic = catalog.cell_entry(catalog.benchmark(), cell)["traffic"]
    limits = catalog.workload(traffic)["check"]["limits"]
    for r in rows:
        print(r["control"], r["seed"], r["correct"], {k: r.get(k) for k in limits})


@pytest.mark.chip
@pytest.mark.parametrize("cell,control", CONTROLS)
def test_control_is_not_correct(card, cell, control):
    rows = list(calibrate.readings(cell, CONTROL_SEEDS, control, device=card))
    _show(cell, rows)
    assert [r["correct"] for r in rows] == [False] * len(CONTROL_SEEDS), rows


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(card, cell):
    rows = list(calibrate.readings(cell, [2 ** 31 + 104], device=card))
    _show(cell, rows)
    assert rows[0]["correct"], rows
