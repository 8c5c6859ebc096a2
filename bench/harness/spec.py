"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
the harness finds ``bench/configs/<config>.json``,
``bench/traffic/<traffic>.json`` and, for each per-layer metric,
``bench/metrics/<name>.py`` by those names alone. The files name the code
they need the same way: a configuration's record families
(``bench/families/<family>.py``) and centre distributions
(``bench/centres/<dist>.py``), a mix's driver (``bench/drivers/<kind>.py``).
So a new cell, mix, configuration, family, distribution, driver or metric
is a new file and a new entry.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = ROOT / "BENCHMARK.json"


def load(path: Path = SPEC) -> dict:
    return json.loads(Path(path).read_text())


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in spec['workloads']]}")


def config_file(name: str) -> Path:
    return BENCH / "configs" / f"{name}.json"


def traffic_file(name: str) -> Path:
    return BENCH / "traffic" / f"{name}.json"


def config(name: str) -> dict:
    return json.loads(config_file(name).read_text())


def traffic(name: str) -> dict:
    return json.loads(traffic_file(name).read_text())


def applies(metric: dict, spec: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: the cells it lists, or
    where it lists none, every cell that reports the end-to-end metric it
    moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    for m in spec["end_to_end"]:
        if m["name"] == metric.get("moves"):
            return "workloads" not in m or cell in m["workloads"]
    return True


def end_to_end(spec: dict, cell: str) -> list:
    return [m for m in spec["end_to_end"] if applies(m, spec, cell)]


def per_layer(spec: dict, cell: str) -> list:
    return [m for m in spec["per_layer"] if applies(m, spec, cell)]


_MODULES = {}


def module(folder: str, name: str):
    """The module ``bench/<folder>/<name>.py``, loaded once."""
    key = (folder, name)
    if key not in _MODULES:
        path = BENCH / folder / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {path.relative_to(ROOT)}")
        mod_name = "bench_{}_{}".format(
            folder, name.replace(".", "_").replace("-", "_"))
        s = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def reader(name: str):
    """The ``read(recording)`` function of per-layer metric ``name``."""
    return module("metrics", name).read
