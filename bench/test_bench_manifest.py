"""BENCHMARK.json against the benchmark's contract: every entry loads by
name, names and units use the allowed characters, each per-layer metric's
cells report the end-to-end metric it moves, and the run length fits the
check's budget."""
from __future__ import annotations

import json
import math
import re
from pathlib import Path

import pytest

import harness

ROOT = Path(__file__).resolve().parent.parent
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(MAN) == TOP
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and
               not p.startswith("/") and ".." not in p.split("/")
               for p in MAN["paths"])
    assert 1 <= len(MAN["command"]) <= 32
    assert 1 <= len(MAN["configs"]) <= 24 and 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16
    assert 1 <= len(MAN["per_layer"]) <= 128


def test_each_config_and_traffic_pair_once():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs), pairs
    for _, traffic in pairs:
        assert (ROOT / "bench" / "traffic" / f"{traffic}.json").is_file()


def test_names_and_units():
    names = [c["name"] for c in MAN["configs"]] + CELLS + \
        [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]] + \
        [w["traffic"] for w in MAN["workloads"]] + \
        [k for c in MAN["configs"] for k in c["reduced"]]
    assert all(NAME.fullmatch(n) for n in names), names
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in MAN[group]}) == len(MAN[group])
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.fullmatch(m["unit"]) and m["better"] in
               ("lower", "higher") for m in metrics)
    for text in [c["source"] for c in MAN["configs"]] + \
            [x["why"] for x in MAN["configs"] + MAN["workloads"]] + \
            [m["layer"] for m in MAN["per_layer"]] + MAN["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.Cell.load(cell)
    assert c.spec["lowers_to"] and c.spec["check"]["per_call"] >= 1
    assert "limits" in c.spec and c.spec["limits"]
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(harness.load_reader(m["name"]))
        assert m["moves"] in reported


def test_configs_files_and_use():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(MAN["paths"][0] + "/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(MAN["workloads"]) // 4)


def test_per_layer_moves_and_layers():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    by_layer = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    perf = (ROOT / "PERF.md").read_text()
    for layer in by_layer:
        assert f"`{layer}`" in perf, f"layer {layer} not listed in PERF.md"


def test_run_seconds_fit_the_check_budget():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_rooflines_and_mfu_names():
    for m in MAN["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] and m["moves"] == "queries_per_s"
               for m in MAN["per_layer"])
    assert not math.isnan(MAN["run_seconds"])


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    """A run that read no trace, no counter and no work leaves the metric
    out of its line: the reader returns None, never 0."""
    m = next(x for x in MAN["per_layer"] if x["name"] == metric)
    cell = harness.Cell.load(m.get("workloads", CELLS)[0])
    view = harness.RunView(cell, 0.0, None, None, {}, {}, {})
    assert harness.load_reader(metric)(view) is None
