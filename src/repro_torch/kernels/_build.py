"""Build and bind the CUDA kernels of ``kernels/csrc``.

At first use, ``nvcc`` compiles each ``csrc/*.cu`` into an object file, one
process per source, all started together, and links them into one shared
library with a plain C interface, which ``ctypes`` loads. The library lands
in ``build/repro_torch_kernels/`` at the repository root, named by a hash of
the sources and the flags, so one process builds at most once and an edited
source never loads a stale library. Each source's own nvcc time lands in
:data:`source_seconds` (their sum is what one serial nvcc over all sources
takes; the parallel build takes about the longest). Nothing here runs at
import time: the CPU-only tests import every module and never build.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``--fmad=false``
(no multiply-add contraction: the kernels' fp32 arithmetic rounds as the
eager torch versions do), ``-Xptxas -v`` (per-kernel registers, shared
memory and spills in :data:`build_log`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argument types of the C entry points (pointers and the stream as void*)
_SIGNATURES = {
    "glin_refine_count": [_P] * 8 + [_I] * 4 + [_P],
    "glin_refine_compact": [_P] * 9 + [_I] * 6 + [_P],
    "glin_refine_fused": [_P] * 20 + [_I] * 9 + [_F] + [_I] * 4 + [_P],
    "glin_refine_mask": [_P, _P, _P, _P, _I, _I, _P],
    "glin_knn_topk": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "glin_morton_encode": [_P, _P, _P, _P, _I, _P],
    "glin_flash_attention_bf16": [_P] * 4 + [_I] * 6 + [_F, _I] + [_L] * 9
    + [_P],
    "glin_flash_attention_fp32": [_P] * 4 + [_I] * 6 + [_F, _I] + [_L] * 9
    + [_P],
    "glin_flash_attention_bf16_smem": [_I],
    "glin_decode_attention": [_P] * 8 + [_I] * 6 + [_F, _I, _I] + [_L] * 6
    + [_P, _P],
    "glin_ssd_scan": [_P] * 10 + [_I] * 6 + [_L] * 9 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""            # nvcc's output of this process's build, if any
build_seconds = 0.0       # wall time of that build (0 when loaded cached)
source_seconds = {}       # each source's own nvcc wall time in that build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libglin_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd) -> tuple:
    """One nvcc process -> (its result, its own wall seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    return r, time.perf_counter() - t0


def _compile(out: Path) -> None:
    """nvcc each source to an object, all at once, then link ``out``."""
    global build_log, build_seconds, source_seconds
    cu, _ = sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
            for src, o in zip(cu, objs)]
    tmp = out.with_name(f"{tag}.tmp.so")
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(cmds)) as pool:
            done = list(pool.map(_run, cmds))
        source_seconds = {src.name: sec for src, (_, sec) in zip(cu, done)}
        if not any(r.returncode for r, _ in done):
            cmds.append(link)
            done.append(_run(link))
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(r.stdout + r.stderr for r, _ in done)
    failed = [f"nvcc failed ({r.returncode}): {' '.join(cmd)}"
              for cmd, (r, _) in zip(cmds, done) if r.returncode]
    if failed:
        raise RuntimeError("\n".join(failed) + "\n" + build_log)
    os.replace(tmp, out)


def kernel_resources(log: Optional[str] = None) -> dict:
    """Each kernel's resources as ptxas printed them (``-v``) in ``log``
    (default :data:`build_log`): {mangled name: {"registers",
    "smem_static_bytes", "spill_stores_bytes", "spill_loads_bytes"}}.
    Empty when this process loaded an earlier build. Dynamic shared memory
    is set at launch and is not in ptxas's lines."""
    out, cur = {}, None
    for line in (build_log if log is None else log).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {"registers": None,
                                              "smem_static_bytes": 0,
                                              "spill_stores_bytes": 0,
                                              "spill_loads_bytes": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores_bytes"] = int(m.group(1))
            cur["spill_loads_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem_static_bytes"] = int(m.group(1)) if m else 0
    return out


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first use (raises with nvcc's output
    when the build fails)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _compile(out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.glin_error_string.argtypes = [ctypes.c_int]
        lib.glin_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def call(name: str, *args) -> None:
    """Launch through entry point ``name`` and raise on a CUDA error."""
    lib = load()
    err = getattr(lib, name)(*args)
    if err:
        msg = lib.glin_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
