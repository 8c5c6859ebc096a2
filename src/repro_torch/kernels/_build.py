"""Build and bind the CUDA kernels of ``kernels/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into one shared library
with a plain C interface, which ``ctypes`` loads. The library lands in
``build/repro_torch_kernels/`` at the repository root, named by a hash of the
sources and the flags, so one process builds at most once and an edited
source never loads a stale library. Nothing here runs at import time: the
CPU-only tests import every module and never build.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``--fmad=false``
(no multiply-add contraction: the kernels' fp32 arithmetic rounds as the
eager torch versions do), ``-Xptxas -v`` (per-kernel registers, shared
memory and spills in :data:`build_log`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of the C entry points (pointers and the stream as void*)
_SIGNATURES = {
    "glin_refine_count": [_P, _P, _P, _P, _I, _I, _P],
    "glin_refine_compact": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "glin_refine_fused": [_P] * 17 + [_I] * 9 + [_F, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""            # nvcc's output of this process's build, if any
build_seconds = 0.0       # wall time of that build (0 when loaded cached)


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
    return BUILD_DIR / f"librefine_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first use (raises with nvcc's output
    when the build fails)."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            cu, _ = sources()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log = r.stdout + r.stderr
            if r.returncode:
                raise RuntimeError(f"nvcc failed ({r.returncode}): "
                                   f"{' '.join(cmd)}\n{build_log}")
            os.replace(tmp, out)
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
