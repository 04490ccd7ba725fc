"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by name."""

import importlib.util
import json
import re

import pytest

from perfbench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = common.manifest()
CELLS = [c["name"] for c in BENCH["workloads"]]
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((common.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contract_keys_and_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for entry in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        texts = [entry.get("why"), entry.get("layer")]
        if section == "configs":
            texts.append(entry["source"])
        for text in filter(None, texts):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
        for cell in entry.get("workloads", []):
            assert cell in CELLS


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    entry, config, cfg_file = common.find_cell(BENCH, cell)
    assert entry["chips"] in (1, 4) and NAME.match(entry["traffic"])
    assert cfg_file["name"] == entry["config"] and cfg_file["source"]
    assert set(config["reduced"]) == set(cfg_file["reduced"])
    traffic = common.traffic_file(entry["traffic"])
    assert (common.BENCH_DIR / "drivers" / f"{traffic['kind']}.py").exists()
    limits = common.limits_file(cell)
    assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer_metric(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [])]
    assert layer
    for m in layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_are_found_by_name_and_move_their_metric(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    path = common.BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.MOVES == entry["moves"] and callable(module.read)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(layer) <= 200 and "\n" not in layer for layer in layers)


def test_config_files_are_frozen_copies_with_their_serving_dtypes():
    for entry in BENCH["configs"]:
        cfg = json.loads((common.ROOT / entry["file"]).read_text())
        assert {"optimizer", "shared", "io", "parallel", "serving"} <= set(cfg)
        assert cfg["source"].startswith("https://")
        assert cfg["serving"]["offline_batches"]["shared.dtype"] == "bfloat16"
