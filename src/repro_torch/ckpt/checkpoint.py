"""Fault-tolerant checkpointing: atomic manifests, async writes, restore onto
a torch device. The port's own copy of the reference's ``ckpt/checkpoint.py``
with its layout on disk::

    <dir>/step_000123/
        manifest.json      # step, leaf paths, shapes, dtypes
        arrays.npz         # one entry per leaf (path-encoded)
    <dir>/LATEST           # atomic pointer (rename-committed)

A tree is a nested dict of tensors; a leaf's key is its
path joined by ``/`` (``params/blocks/attn/wq``, ``opt/mu/...``,
``opt/step``), as the reference's, so fp32 checkpoints read in both
directions. A bf16 leaf is written as its 2-byte words (uint16) with
``"bfloat16"`` in the manifest and read back by its bits; a ``|V2`` leaf
of a bf16 manifest entry (what ``np.savez`` makes of the reference's
``ml_dtypes`` bf16 arrays) is read the same way.

A leaf placed on a device mesh (``sharding.placement.Sharded``) is saved
as its gathered array, in the same format; :func:`restore` with
``shardings`` places each leaf by its layout on the current mesh. So a
checkpoint saved on one mesh restores onto one device, or onto another
mesh (elastic restore), as the reference's.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..sharding.placement import Sharded, gather, place, shape_dtype
from ..utils.tree import paths, unflatten

__all__ = ["save", "save_async", "restore", "latest_step", "wait_all"]

_EXECUTOR = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
_LOCK = threading.Lock()
BF16 = "bfloat16"


def _host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A leaf as (a numpy copy, its dtype's name): a bf16 tensor as its
    uint16 words. A copy also of a CPU tensor, whose ``.numpy()`` would
    share its memory with the live tensor. A placed leaf is gathered on
    the host."""
    t = gather(leaf, "cpu") if isinstance(leaf, Sharded) else leaf.detach()
    if t.dtype == torch.bfloat16:
        return (t.view(torch.int16).to("cpu", copy=True).numpy()
                .view(np.uint16), BF16)
    a = t.to("cpu", copy=True).numpy()
    return a, str(a.dtype)


def _snapshot(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {k: _host(v) for k, v in paths(tree)}


def _write(directory: str, step: int, flat) -> str:
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    final = d / f"step_{step:09d}"
    tmp = d / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in flat.items()})
    manifest = {
        "step": int(step),
        "leaves": {k: {"shape": list(a.shape), "dtype": dt}
                   for k, (a, dt) in flat.items()},
        "format": 1,
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                    # atomic commit
    with _LOCK:
        # Monotonic pointer: a slow async save finishing after a newer save
        # (the trainer's final sync save racing an in-flight background
        # one) must never swing LATEST back to an older step.
        cur = latest_step(str(d))
        if cur is None or step >= cur:
            ptr = d / ".LATEST_tmp"
            ptr.write_text(final.name)
            os.replace(ptr, d / "LATEST")     # atomic pointer swap
    return str(final)


def save(directory: str, step: int, tree: Any) -> str:
    """Synchronous atomic checkpoint. Returns the committed path."""
    return _write(directory, step, _snapshot(tree))


def save_async(directory: str, step: int, tree: Any) -> Future:
    """Non-blocking checkpoint: a host copy of every leaf is taken before
    this returns (training may then change the tensors in place), and
    written in a background thread."""
    return _EXECUTOR.submit(_write, directory, step, _snapshot(tree))


def wait_all() -> None:
    _EXECUTOR.submit(lambda: None).result()


def latest_step(directory: str) -> Optional[int]:
    d = pathlib.Path(directory)
    ptr = d / "LATEST"
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (d / name / "manifest.json").exists():
        return None
    return int(name.split("_")[-1])


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored leaf as a tensor of its stored dtype (bf16 by its bits)."""
    if dtype == BF16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf stored as {arr.dtype}")
        words = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore(directory: str, like: Any, step: Optional[int] = None,
            device=None, shardings: Any = None) -> Tuple[int, Any]:
    """Restore into the structure of ``like`` (a nested dict whose leaves
    give each leaf's shape and dtype: tensors, placed values or ``(shape,
    dtype)`` pairs). Each leaf is cast to that dtype and, where
    ``shardings`` (a matching tree of ``NamedSharding`` s) is given,
    placed by its layout on its mesh; otherwise put on ``device`` (default:
    the ``like`` leaf's device, or the CPU for a pair)."""
    d = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = d / f"step_{step:09d}"
    dtypes = {k: v["dtype"] for k, v in json.loads(
        (path / "manifest.json").read_text())["leaves"].items()}
    data = np.load(path / "arrays.npz")
    layouts = dict(paths(shardings)) if shardings is not None else {}
    flat = []
    for key, ref in paths(like):
        arr = data[key]
        shape, dtype = shape_dtype(ref)
        if tuple(arr.shape) != shape:
            raise ValueError(f"leaf {key}: checkpoint shape {arr.shape} != "
                             f"expected {shape}")
        t = _tensor(arr, dtypes[key]).to(dtype)
        if key in layouts:
            flat.append(place(t, layouts[key].mesh, layouts[key].spec))
            continue
        if device is None and isinstance(ref, torch.Tensor):
            flat.append(t.to(ref.device))
        else:
            flat.append(t.to("cpu" if device is None else device))
    return step, unflatten(like, flat)
