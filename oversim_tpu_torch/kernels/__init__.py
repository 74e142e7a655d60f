"""Hand-written Hopper kernels of the port, built at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (``build/kernels/lib<name>.so``
at the checkout root) and is loaded with ``ctypes``.  ``build_all``
starts one ``nvcc`` per source, all at once.  Nothing here runs at
import time: the CPU tests import every module and never build.

``LAUNCHES`` counts, per kernel, the launches made by its wrapper; a
caller that wants to show a run went through the kernels sets the
counts to 0 first and reads them after.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
SOURCES = ("inbox", "outbox", "compact")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"inbox_select_gather": 0, "alloc_dest": 0, "inbox_select": 0,
            "compact_indices": 0, "inbox_gather": 0}
_LIBS: dict = {}

_VP = ctypes.c_void_p
_I = ctypes.c_int
# source -> {exported function: argument types}
_SIGNATURES = {
    "inbox": {"inbox_select_gather": [_VP] * 8 + [_I] * 4 + [_VP],
              "inbox_select": [_VP] * 6 + [_I] * 3 + [_VP],
              "inbox_gather": [_VP] * 3 + [_I] * 3 + [_VP]},
    "outbox": {"alloc_dest": [_VP] * 5 + [_I] * 2 + [_VP]},
    "compact": {"compact_indices": [_VP] * 5 + [_I] * 3 + [_VP]},
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    mtime = lib.stat().st_mtime
    deps = [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))
    return any(d.stat().st_mtime > mtime for d in deps)


def build_all(names=SOURCES, verbose: bool = False) -> dict:
    """Compile every stale source in parallel; returns {name: log}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(_lib_path(name)), str(CSRC / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    return logs


def library(name: str):
    """The loaded ctypes library for ``csrc/<name>.cu`` (built if needed)."""
    if name not in _LIBS:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require(t, dtype, shape, name):
    """Wrapper-side argument check: device, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")

