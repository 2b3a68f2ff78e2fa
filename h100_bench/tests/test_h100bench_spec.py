"""Every configuration, cell, driver and per-layer metric is a file the
harness finds by name, and BENCHMARK.json keeps to its contract."""

import json
import re

import pytest

from h100_bench.common import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_by_name(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    data = spec.load_json(spec.ROOT / cfg["file"])
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    entry, config, params = spec.cell(cell["name"])
    assert entry == cell and config["name"] == cell["config"]
    drv = spec.driver(params["driver"])
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(drv, fn))
    assert spec.metrics_for(cell["name"], "per_layer"), "every cell reports a per-layer metric"
    e2e = {m["name"] for m in spec.metrics_for(cell["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert callable(spec.metric_reader(metric["name"]).read)
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in layer and 1 <= len(layer) <= 200 for layer in layers)


def test_four_chip_cells_within_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
