"""Every piece BENCHMARK.json names is found by its name and parses, and
names, units and the file's shape keep to the benchmark's contract."""

import importlib
import json
import os

import pytest

from mvsbench import catalog

BENCH = catalog.benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["mvsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_found_by_name(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert catalog.NAME.match(entry["name"])
    assert entry["file"] == f"mvsbench/configs/{entry['name']}.json"
    cfg = catalog.config(entry["name"])
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    for key in ("width", "height", "num_views", "num_sources", "focal_px", "depth_min",
                "depth_max", "rig", "source", "assumed"):
        assert key in cfg
    assert cfg["num_sources"] <= cfg["num_views"] - 1


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_file_found_by_name(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1
    assert catalog.NAME.match(entry["name"]) and catalog.NAME.match(entry["traffic"])
    wl = catalog.workload(entry["traffic"])
    assert wl["config"] == entry["config"]
    assert wl["why"] == entry["why"] and len(entry["why"]) <= 200
    assert catalog.config(wl["config"])
    assert wl["check"]["limits"]["views_bad"] == 0
    assert wl["check"]["controls"]
    assert all(catalog.NAME.match(n) for n in wl["check"]["controls"])


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_reader_found_by_name(entry):
    assert catalog.NAME.match(entry["name"])
    assert catalog.UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    reader = catalog.metric_reader(entry["name"])
    assert callable(reader.read)
    if "bound" in entry:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    else:
        assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert entry["layer"] and "\n" not in entry["layer"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in BENCH["workloads"]:
        e2e = {m["name"] for m in catalog.metrics_of(BENCH, cell["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert catalog.metrics_of(BENCH, cell["name"], True)


def test_readers_give_none_on_an_empty_record():
    record = {"setup_s": 1.0, "scenes": [], "judged": [], "trace": None, "peak_bytes": None,
              "config": catalog.config("dtu_1600x1200_v5")}
    for entry in BENCH["per_layer"] + BENCH["end_to_end"]:
        value = catalog.metric_reader(entry["name"]).read(record)
        assert value is None or entry["name"] == "setup_s"


def test_every_file_under_the_folder_is_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(catalog.HERE):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), catalog.ROOT)
            assert all(catalog.NAME.match(part) for part in rel.split(os.sep)), rel


def test_every_metric_module_imports_and_reads():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(catalog.HERE, "metrics"))
             if f.endswith(".py") and f != "__init__.py"}
    assert names <= files
    for n in files:
        assert callable(importlib.import_module("mvsbench.metrics." + n).read)
