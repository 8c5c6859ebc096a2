"""No module of a run has JAX's or the JAX package's top-level name, and a
checkout of the benchmark alone refuses to run."""
import os
import shutil
import subprocess
import sys
import types

from bench.harness import cell
from bench.tests.helpers import CELLS, ROOT

RUN = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
from bench.harness import cell
out = cell.run({cell!r}, 7, 0.2, True, device="cpu", records=2000,
               traffic_over={{"batch": 32, "pool": 64}})
assert out["correct"], out
print("FOUND", cell.forbidden_modules())
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_a_run_loads_no_jax():
    r = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(ROOT), src=str(ROOT / "src"),
                                          cell=CELLS[-1])],
        capture_output=True, text=True, timeout=300,
        env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FOUND []" in r.stdout


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.fake_sub", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("y"))
    found = cell.forbidden_modules()
    assert "jax.fake_sub" in found and "repro.fake" in found
    assert not [m for m in found if m.partition(".")[0] == "repro_torch"]


def test_benchmark_alone_exits_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=_env())
    assert r.returncode != 0
    assert r.stdout.strip() == ""
