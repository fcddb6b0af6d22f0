"""Every file that BENCHMARK.json names is found and parsed, and holds what the harness
reads from it."""
from __future__ import annotations

import importlib
import json

import pytest

from benchmark import common, run

SPEC = common.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_contract_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    config = common.load_json(common.ROOT / entry["file"])
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    assert all(k in config and k in config["published"] for k in entry["reduced"])
    ops, shapes = common.flops_module(config).model_ops(config, 2, 3)
    assert ops and shapes


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    c, config, traffic, limits = common.cell_files(SPEC, cell)
    importlib.import_module(f"benchmark.traffic.{traffic['driver']}")
    assert limits and all(v > 0 for v in limits.values())
    assert run.cell_metrics(SPEC, cell, False) and run.cell_metrics(SPEC, cell, True)


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert callable(run.reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    for cell in metric["workloads"]:
        assert metric["moves"] in {m["name"] for m in run.cell_metrics(SPEC, cell, False)}
