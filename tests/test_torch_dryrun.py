"""The dry run (``launch.dryrun``), on the CPU with no card: the GLIN cell
on both production meshes, one reduced cell of each LM family on a (4, 2)
mesh laid out as the production meshes are (each position its own chip)
and as the one-card meshes are (every position on one device), a skipped
cell, and one full-width production cell through the command line
(granite_3_2b ``decode_32k`` on ``single``: 256 positions). The dry run's
input stand-ins are held against the reference's shapes.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

from _sharded import cpu_mesh
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.core.device import input_specs_like
from repro_torch.core.distributed import TABLE_KEYS, glin_input_specs
from repro_torch.kernels.refine import sharded_refine_cost
from repro_torch.launch import dryrun
from repro_torch.utils import roofline

ROOT = pathlib.Path(__file__).resolve().parents[1]
MEMORY = ("argument_size_in_bytes", "output_size_in_bytes",
          "temp_size_in_bytes", "alias_size_in_bytes",
          "total_bytes_per_device")
COST = ("flops_per_chip", "bytes_per_chip", "collectives_per_chip",
        "collective_total_per_chip")
ROOF = ("compute_s", "memory_s", "collective_s", "dominant", "bound_s",
        "compute_fraction")


def _finite(rec, lm: bool = True):
    """Every key of a record present, its numbers finite and positive
    where they must be."""
    mem = rec["memory"]
    for k in MEMORY:
        assert math.isfinite(mem[k]) and mem[k] >= 0, k
    assert mem["total_bytes_per_device"] == (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
    c = rec["cost"]
    assert set(COST) <= set(c)
    assert c["flops_per_chip"] > 0 and c["bytes_per_chip"] > 0
    assert c["collective_total_per_chip"] >= max(
        c["collectives_per_chip"].values(), default=0)
    r = rec["roofline"]
    assert set(ROOF) <= set(r) and r["dominant"] in ("compute", "memory",
                                                    "collective")
    assert all(math.isfinite(r[k]) for k in ROOF if k != "dominant")
    if lm:
        assert rec["model_flops"] > 0
        assert 0 < rec["useful_flops_ratio"] < 10


def test_input_specs_match_the_reference():
    pytest.importorskip("jax")
    from repro.core import device as rdev
    from repro.core import distributed as rdist

    snap, win, table = glin_input_specs(1 << 20, 512, None)
    rsnap, rwin, rtable = rdist.glin_input_specs(1 << 20, 512, None)
    for f in rsnap.__dataclass_fields__:
        got, want = getattr(snap, f), getattr(rsnap, f)
        if isinstance(got, tuple):
            assert got[0] == tuple(want.shape), f
            assert str(got[1]).split(".")[1] == str(want.dtype), f
        else:
            assert got == want, f
    assert win[0] == tuple(rwin.shape)
    assert set(table) == set(rtable) == set(TABLE_KEYS)
    for k in table:
        assert table[k][0] == tuple(rtable[k].shape), k
    want = rdev.input_specs_like(64)["windows"]
    assert input_specs_like(64)["windows"][0] == tuple(want.shape)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_glin_cell(mesh):
    """The GLIN cell: the reference's analytic cost per chip, the placed
    table's bytes a position (2^28 or 2^29 records over 16 or 32 record
    shards: 64 bytes of record columns and a 6.5-slot mean ring of 8-byte
    vertices each)."""
    rec = dryrun.run_cell("glin", "query", mesh)
    assert rec["status"] == "ok" and rec["chips"] == (512 if mesh == "multi"
                                                      else 256)
    _finite(rec, lm=False)
    n, shards = ((1 << 29, 32) if mesh == "multi" else (1 << 28, 16))
    want = sharded_refine_cost(q=4096, n=n, budget=512, shards=shards,
                               verts=16)
    assert rec["cost"]["flops_per_chip"] == want["flops"]
    assert rec["cost"]["collective_total_per_chip"] == want[
        "collective_bytes"]
    table = n // shards * (64 + 13 // 2 * 8 + 4)
    assert rec["memory"]["argument_size_in_bytes"] > table


FAMILIES = [("granite_3_2b", "train"), ("mixtral_8x22b", "train"),
            ("mamba2_2p7b", "train"), ("hymba_1p5b", "train"),
            ("qwen2_vl_2b", "prefill"), ("musicgen_medium", "decode")]


@pytest.mark.parametrize("arch,kind,devices", [
    (a, k, "own") for a, k in FAMILIES] + [
    ("granite_3_2b", "train", "one_card"),
    ("mamba2_2p7b", "train", "one_card")])
def test_reduced_cells(arch, kind, devices):
    """One reduced cell of each family (dense, moe, ssm, hybrid, vlm,
    audio), 3 layers, on (4, 2): every key present and finite; a train
    step's parameters and moments aliased, a prefill's cache new."""
    import dataclasses

    cfg = dataclasses.replace(get_arch(arch).reduced(), n_layers=3)
    shape = ShapeConfig("s", 16, 8, kind)
    devs = list(range(8)) if devices == "own" else [0] * 8
    rec = dryrun.reckon(cfg, shape, cpu_mesh(), microbatches=2,
                        devices=devs)
    _finite(rec)
    assert rec["layers_counted"] == [1, 2, 3]
    assert rec["model_flops"] == roofline.model_flops(cfg, shape)
    mem = rec["memory"]
    if kind == "train":
        assert rec["microbatches"] == 2
        assert 0 < mem["alias_size_in_bytes"] <= mem["argument_size_in_bytes"]
    elif kind == "prefill":
        assert mem["alias_size_in_bytes"] == 0


def test_skipped_cell_keeps_the_reason():
    rec = dryrun.run_cell("granite_3_2b", "long_500k", "single")
    assert rec["status"] == "skip" and "sub-quadratic" in rec["reason"]


def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(tmp_path)], capture_output=True, text=True, env=env,
        cwd=str(ROOT), timeout=300)


def test_cli_production_cell(tmp_path):
    """granite_3_2b ``decode_32k`` on the (16, 16) mesh: 256 positions, a
    32,768-slot cache split over ``model``, one record."""
    r = _cli(tmp_path, "--arch", "granite_3_2b", "--shape", "decode_32k",
             "--mesh", "single")
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((tmp_path / "granite_3_2b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["reckon_s"] > 0 and "lower_compile_s" not in rec
    _finite(rec)
    assert rec["cost"]["collectives_per_chip"]["all-gather"] > 0
    assert "[ok] granite_3_2b__decode_32k__single" in r.stdout


def test_cli_exits_1_on_a_failed_cell(tmp_path):
    r = _cli(tmp_path, "--arch", "no_such_arch", "--shape", "train_4k",
             "--mesh", "single")
    assert r.returncode == 1
    rec = json.loads((tmp_path / "no_such_arch__train_4k__single.json")
                     .read_text())
    assert rec["status"] == "fail" and "KeyError" in rec["error"]
