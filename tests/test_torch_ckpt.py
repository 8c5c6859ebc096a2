"""The port's checkpoints and train launcher on the CPU, against the
reference's.

* The reference's checkpoint tests through the port (atomic commit over a
  torn write, async saves and a same-step overwrite, the monotonic
  ``LATEST``), and the host snapshot ``save_async`` takes before it
  returns.
* bf16 leaves round-trip by their bits (every one of the 65,536 patterns,
  NaNs and -0 included); other dtypes as they are.
* Checkpoints between the packages: a reference-written fp32 tree restored
  by the port and a port-written one by the reference (same keys:
  ``params/...``, ``opt/mu/...``, ``opt/step``); a reference-written bf16
  leaf (``np.savez`` stores its ``ml_dtypes`` array as ``|V2``) read by the
  port by its bits, where the reference's own restore cannot cast it.
* The launcher (``python -m repro_torch.launch.train --device cpu``):
  crash at step 13 and resume to step 24, as the reference's
  ``test_crash_and_resume``, with final parameters equal bit for bit to an
  uninterrupted run of the same seed; ``--device cuda`` on a machine
  without a card exits non-zero.
"""
import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.ckpt import checkpoint as ckpt

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_atomic_commit_ignores_partial(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 3, {"x": torch.arange(4.0)})
    (tmp_path / ".tmp_step_000000009").mkdir()      # a torn write
    assert ckpt.latest_step(d) == 3
    step, tree = ckpt.restore(d, {"x": torch.zeros(4, dtype=torch.float64)})
    assert step == 3 and tree["x"].dtype == torch.float64
    assert torch.equal(tree["x"], torch.arange(4.0, dtype=torch.float64))


def test_async_checkpoint_and_overwrite(tmp_path):
    d = str(tmp_path)
    f1 = ckpt.save_async(d, 1, {"x": torch.ones(8)})
    f2 = ckpt.save_async(d, 2, {"x": torch.ones(8) * 2})
    f1.result()
    f2.result()
    assert ckpt.latest_step(d) == 2
    ckpt.save(d, 2, {"x": torch.ones(8) * 5})   # same-step overwrite
    _, t = ckpt.restore(d, {"x": torch.zeros(8)})
    assert torch.all(t["x"] == 5)


def test_latest_pointer_is_monotonic(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 24, {"x": torch.arange(4.0)})
    ckpt.save(d, 20, {"x": torch.zeros(4)})     # a late out-of-order commit
    assert ckpt.latest_step(d) == 24
    step, tree = ckpt.restore(d, {"x": torch.zeros(4)}, step=20)
    assert step == 20 and torch.equal(tree["x"], torch.zeros(4))
    ckpt.save(d, 24, {"x": torch.ones(4)})
    _, tree = ckpt.restore(d, {"x": torch.zeros(4)})
    assert torch.equal(tree["x"], torch.ones(4))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"x": torch.zeros(4)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_save_async_snapshots_before_returning(tmp_path, dtype):
    """The host copy is taken before save_async returns: a change made in
    place while the write waits behind a slow one does not reach it."""
    x = torch.arange(6.0).to(dtype)
    gate = threading.Event()
    ckpt._EXECUTOR.submit(gate.wait, 30)      # hold the writer thread
    fut = ckpt.save_async(str(tmp_path), 1, {"x": x})
    x.add_(100)                     # training changes it in place
    gate.set()
    fut.result(timeout=30)
    _, tree = ckpt.restore(str(tmp_path), {"x": torch.zeros(6, dtype=dtype)})
    assert torch.equal(tree["x"], torch.arange(6.0).to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int32])
def test_leaves_round_trip_by_their_bits(tmp_path, dtype):
    if dtype == torch.bfloat16:      # every bf16 bit pattern
        x = torch.arange(-32768, 32768, dtype=torch.int32).to(
            torch.int16).view(torch.bfloat16).reshape(256, 256)
    else:
        x = torch.randn(17, 3).mul(1e3).to(dtype)
    tree = {"params": {"w": x, "s": torch.tensor(3, dtype=torch.int32)}}
    ckpt.save(str(tmp_path), 7, tree)
    man = json.loads((tmp_path / "step_000000007" / "manifest.json")
                     .read_text())
    assert man["leaves"]["params/w"] == {
        "shape": list(x.shape), "dtype": str(dtype).split(".")[1]}
    like = {"params": {"w": torch.empty_like(x),
                       "s": torch.tensor(0, dtype=torch.int32)}}
    step, got = ckpt.restore(str(tmp_path), like, device="cpu")
    assert step == 7 and got["params"]["w"].dtype == dtype
    bits = (torch.int16 if dtype == torch.bfloat16 else torch.int32)
    assert torch.equal(got["params"]["w"].view(bits), x.view(bits))
    assert int(got["params"]["s"]) == 3


def test_restore_refuses_another_shape(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"x": torch.zeros(5)})


# ----------------------------------------------- between the two packages
def _tree(rng):
    return {"params": {"blocks": {"attn": {"wq": rng.standard_normal(
        (2, 4, 6)).astype(np.float32)}}, "embed": rng.standard_normal(
        (5, 4)).astype(np.float32)},
        "opt": {"mu": {"embed": rng.standard_normal((5, 4)).astype(
            np.float32)}, "step": np.asarray(9, np.int32)}}


def _like(tree):
    return {k: _like(v) if isinstance(v, dict) else torch.zeros(
        v.shape, dtype=torch.from_numpy(np.asarray(v)).dtype)
        for k, v in tree.items()}


def _equal(got, want):
    for k, v in want.items():
        if isinstance(v, dict):
            _equal(got[k], v)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), v)


def test_reference_fp32_checkpoint_restored_by_port(tmp_path):
    jnp = pytest.importorskip("jax.numpy")
    from repro.ckpt import checkpoint as rckpt

    want = _tree(np.random.default_rng(0))
    import jax
    rckpt.save(str(tmp_path), 12, jax.tree_util.tree_map(jnp.asarray, want))
    step, got = ckpt.restore(str(tmp_path), _like(want))
    assert step == 12
    _equal(jax.tree_util.tree_map(lambda t: t.numpy(), got), want)


def test_port_fp32_checkpoint_restored_by_reference(tmp_path):
    jax = pytest.importorskip("jax")
    from repro.ckpt import checkpoint as rckpt

    want = _tree(np.random.default_rng(1))
    ckpt.save(str(tmp_path), 4, jax.tree_util.tree_map(torch.from_numpy,
                                                       want))
    step, got = rckpt.restore(str(tmp_path), want)
    assert step == 4
    _equal(jax.tree_util.tree_map(np.asarray, got), want)


def test_reference_bf16_leaf_read_by_its_bits(tmp_path):
    """F8: the reference writes a bf16 leaf that its own restore cannot
    cast (``|V2`` to bfloat16); the port reads it by its bits."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.ckpt import checkpoint as rckpt

    vals = np.random.default_rng(2).standard_normal(12).astype(np.float32)
    rckpt.save(str(tmp_path), 1, {"w": jnp.asarray(vals, jnp.bfloat16)})
    man = json.loads((tmp_path / "step_000000001" / "manifest.json")
                     .read_text())
    assert man["leaves"]["w"]["dtype"] == "bfloat16"
    with np.load(tmp_path / "step_000000001" / "arrays.npz") as data:
        assert data["w"].dtype.kind == "V"
    _, got = ckpt.restore(str(tmp_path), {
        "w": torch.zeros(12, dtype=torch.bfloat16)})
    assert torch.equal(got["w"], torch.from_numpy(vals).to(torch.bfloat16))
    with pytest.raises(ValueError):
        rckpt.restore(str(tmp_path), {"w": jnp.zeros(12, jnp.bfloat16)})


# ------------------------------------------------------------ the launcher
def _run_train(args, expect_rc=0):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *args], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == expect_rc, (r.returncode, r.stdout,
                                       r.stderr[-3000:])
    return r.stdout


COMMON = ["--arch", "granite_3_2b", "--reduced", "--steps", "24",
          "--batch", "4", "--seq", "32", "--ckpt-every", "5",
          "--log-every", "4", "--device", "cpu"]


def _params(d, step):
    with np.load(pathlib.Path(d) / f"step_{step:09d}" / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


def test_crash_and_resume_ends_as_an_uninterrupted_run(tmp_path):
    d, ref = str(tmp_path / "run"), str(tmp_path / "whole")
    out1 = _run_train([*COMMON, "--ckpt-dir", d,
                       "--simulate-failure-at", "13"], expect_rc=42)
    assert "simulating crash at step 13" in out1
    resumed_from = ckpt.latest_step(d)
    assert resumed_from is not None and 5 <= resumed_from <= 13
    out2 = _run_train([*COMMON, "--ckpt-dir", d, "--resume"])
    assert f"resumed from step {resumed_from}" in out2
    assert "step=23" in out2
    assert f"step={resumed_from - 1} " not in out2   # no batch taken twice
    assert ckpt.latest_step(d) == 24
    _run_train([*COMMON, "--ckpt-dir", ref])
    got, want = _params(d, 24), _params(ref, 24)
    assert sorted(got) == sorted(want)
    assert "opt/step" in got and int(got["opt/step"]) == 24
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_launcher_refuses_a_card_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "granite_3_2b", "--reduced", "--steps",
                        "1"], capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert "[train] step=" not in r.stdout
