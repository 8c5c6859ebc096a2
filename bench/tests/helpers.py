"""Shared sizes of the benchmark's CPU tests: tiny stores and batches, and
the cells of ``BENCHMARK.json``, read from it so that a cell added there is
tested without an edit here."""
import sys
from pathlib import Path

from bench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

SMALL = {"batch": 48, "pool": 192}
RECORDS = 3000
CELLS = tuple(w["name"] for w in spec.load()["workloads"])
