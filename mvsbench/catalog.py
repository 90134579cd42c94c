"""Finds the benchmark's pieces by name: ``BENCHMARK.json`` at the root,
``configs/<config>.json``, ``workloads/<cell>.json`` and the metric readers
``metrics/<metric>.py``. A later cell, configuration or metric is a new file
and a new entry; nothing here names one."""

from __future__ import annotations

import importlib
import json
import os
import re
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def benchmark(root: str = ROOT) -> dict:
    """``BENCHMARK.json`` of the checkout at ``root``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load(kind: str, name: str, base: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(base, kind + "s", name + ".json")
    with open(path) as f:
        data = json.load(f)
    if data.get("name") != name:
        raise ValueError(f"{path} names itself {data.get('name')!r}, not {name!r}")
    return data


def workload(name: str, base: str = HERE) -> dict:
    """The cell's traffic file ``workloads/<name>.json``."""
    return _load("workload", name, base)


def config(name: str, base: str = HERE) -> dict:
    """The configuration file ``configs/<name>.json``."""
    return _load("config", name, base)


def metric_reader(name: str):
    """The module ``mvsbench.metrics.<name>``: its ``read(record)`` gives
    the metric's value, or None where the record holds nothing to read."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    return importlib.import_module("mvsbench.metrics." + name)


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    (``trace`` False) or the per-layer ones, each where its ``workloads``
    key lists the cell or where it has none."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def cell_entry(bench: dict, cell: str) -> Optional[Dict]:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    return None
