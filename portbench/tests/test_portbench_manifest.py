"""BENCHMARK.json against the rules the harness and its checker keep:
names, units, the files each entry names, and what each cell reports."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _cell(name):
    return json.loads((ROOT / "portbench" / "cells" / f"{name}.json").read_text())


def _reader(name):
    import importlib.util

    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.endswith("_torch")


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    cell = _cell(w["name"])
    assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"],
                                                                w["chips"])
    assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    assert all(v > 0 for v in cell["limits"].values())


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    path = ROOT / c["file"]
    assert path.is_file() and c["file"].startswith("portbench/")
    data = json.loads(path.read_text())
    assert data["reduced"] == c["reduced"]
    widths = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|proj|head|width)")
    assert not any(widths.search(k) for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader(m):
    reader = _reader(m["name"])
    assert (reader.LAYER, reader.SOURCE, reader.MOVES, reader.UNIT, reader.BETTER) == (
        m["layer"], m["source"], m["moves"], m["unit"], m["better"])
    assert reader.WORKLOADS == m["workloads"]
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m["workloads"]) <= cells
    moves = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
    # every cell that reports the metric reports the end-to-end metric it moves
    assert set(m["workloads"]) <= set(moves.get("workloads", cells))


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(e2e) >= 2 and any(m["name"] == "setup_s" for m in e2e)
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
        rate = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json")
                          .read_text())["rate_metric"]
        assert rate in [m["name"] for m in e2e]


def test_layers_one_spelling():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    lowered = {x.lower().replace(" ", "") for x in layers}
    assert len(lowered) == len(layers)
