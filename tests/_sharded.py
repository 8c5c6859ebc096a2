"""Shared by the sharded-step tests: the reference run in a subprocess with
eight host devices, the arrays it saves, and the tolerances the sharded
steps are held to (as ``tests/test_torch_sharded_train.py``)."""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np

from repro_torch.core.distributed import make_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
WAIT_S = 600


def start_reference(code: str, d: pathlib.Path, **fmt):
    """Start ``code`` (formatted with ``fmt``) in a subprocess with eight
    host devices; it writes ``d / "ref.npz"``. Returns (process, logs)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    logs = [open(d / "stdout.txt", "w"), open(d / "stderr.txt", "w")]
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code).format(**fmt),
         str(d / "ref.npz")], env=env, stdout=logs[0], stderr=logs[1],
        cwd=str(ROOT))
    return proc, logs


def stop_reference(proc, logs) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    for f in logs:
        f.close()


def wait_reference(proc, d: pathlib.Path) -> dict:
    rc = proc.wait(timeout=WAIT_S)
    err = (d / "stderr.txt").read_text()[-4000:]
    assert rc == 0, f"reference subprocess failed:\n{err}"
    with np.load(d / "ref.npz") as z:
        return {k: z[k] for k in z.files}


def tree(data, prefix):
    """The arrays under ``prefix/`` as a nested dict."""
    out = {}
    for k, v in data.items():
        if k.startswith(prefix + "/"):
            node = out
            parts = k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return out


def cpu_mesh(shape=(4, 2), axes=("data", "model")):
    return make_mesh(shape, axes, ["cpu"] * 8)


def close_rel(got, want, rel=1e-5):
    assert abs(got - want) <= rel * max(abs(want), 1e-30), (got, want)


def leaf_close(got, want, rel=1e-5):
    """Within ``rel`` of the leaf's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max() / scale)


def params_close(got, want, lr):
    """Within 2 lr everywhere and 1e-6 on all but 0.1% of elements."""
    loose = n = 0
    for a, b in zip(got, want):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        assert d.max() <= 2 * lr, d.max()
        loose += int((d > 1e-6).sum())
        n += d.size
    assert loose <= 1e-3 * n, (loose, n)
    return loose


def spec_tuple(spec):
    """A PartitionSpec of either package as a plain tuple: entries None, an
    axis name, or a tuple of names; no trailing None."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)
