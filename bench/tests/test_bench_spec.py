"""BENCHMARK.json against the contract, and every file it names."""
import json
import re

import pytest

from bench.harness import spec
from bench.harness.traffic import Traffic
from bench.tests.helpers import CELLS

S = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_command():
    assert set(S) == KEYS
    assert 1 <= len(S["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in S["paths"])
    assert 1 <= len(S["command"]) <= 32 and all(map(_line, S["command"]))
    assert 1 <= S["run_seconds"] <= 51 and isinstance(S["run_seconds"], int)
    # a full check of 24 cells (2 + 14 runs a cell, each run_seconds +
    # 60 s, 180 s a cell to compile, 1,200 s spare) fits in 43,200 s
    runs = 2 + 14 * 24
    assert runs * (S["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(S).encode()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in S[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_units_and_kinds():
    allowed = {"name", "unit", "better", "bound", "source", "workloads"}
    for m in S["end_to_end"]:
        assert set(m) <= allowed and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in S["end_to_end"])
    allowed = {"name", "unit", "better", "source", "layer", "moves",
               "workloads"}
    e2e = {m["name"] for m in S["end_to_end"]}
    for m in S["per_layer"]:
        assert set(m) <= allowed and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_configs_point_at_their_files():
    files = [c["file"] for c in S["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in S["workloads"]}
    for c in S["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(S["paths"][0] + "/")
        assert spec.ROOT.joinpath(c["file"]) == spec.config_file(c["name"])
        assert spec.config(c["name"])["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in used


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_by_name(cell):
    w = spec.workload(S, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and _line(w["why"])
    assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    cfg = spec.config(w["config"])
    t = Traffic.from_json(spec.traffic(w["traffic"]))
    assert t.limits and cfg["records"] > 0
    for name in ("pool", "warm_batches", "call", "keep", "reference",
                 "judge"):
        assert callable(getattr(t.driver, name))
    for part in cfg["store"]["parts"]:
        assert callable(spec.module("families", part["family"]).make)
        assert callable(spec.module("centres", part["centres"]["dist"]).draw)
    e2e = {m["name"] for m in spec.end_to_end(S, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer(S, cell)
    assert layer
    for m in layer:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in e2e


def test_every_cell_has_its_files_and_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in S["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert 1 <= len(S["workloads"]) <= 24
    for w in S["workloads"]:
        assert spec.config_file(w["config"]).is_file()
        assert spec.traffic_file(w["traffic"]).is_file()
    four = sum(w["chips"] == 4 for w in S["workloads"])
    assert four <= max(1, len(S["workloads"]) // 4)
