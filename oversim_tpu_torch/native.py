"""ctypes bindings for the repo's host-side C sources (``native/*.c``).

Counterpart of ``oversim_tpu/native.py`` for the two sources the port
uses: ``native/tracescan.c`` (the trace-file scanner, GlobalTraceManager's
mmap reader) and ``native/vecwriter.c`` (the OMNeT++ ``.vec``/``.sca``
formatter, ``recorder.py``).  Each builds at first use with the system C
compiler (``cc -O2 -shared -fPIC``) into ``build/native/`` of the
checkout, never into ``native/``; a build goes to a temporary name and is
renamed into place, so parallel processes may race it.  Where no
compiler works, ``library`` returns None and the callers use their
pure-Python paths (same output, slower on million-line files).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
SRC_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "native"
_lock = threading.Lock()
_libs: dict = {}

CMD_NAMES = ("JOIN", "LEAVE", "PUT", "GET",
             "CONNECT_NODETYPES", "DISCONNECT_NODETYPES")


class TsEvent(ctypes.Structure):
    _fields_ = [("time", ctypes.c_double),
                ("node", ctypes.c_int32),
                ("cmd", ctypes.c_int32),
                ("arg0_off", ctypes.c_int64),
                ("arg0_len", ctypes.c_int32),
                ("arg1_off", ctypes.c_int64),
                ("arg1_len", ctypes.c_int32)]


def _build(name: str) -> Path | None:
    src = SRC_DIR / f"{name}.c"
    so = BUILD_DIR / f"{name}.so"
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{name}.{os.getpid()}.so"
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run([cc, "-O2", "-shared", "-fPIC", str(src),
                                "-o", str(tmp)], capture_output=True,
                               timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            continue
        if r.returncode == 0:
            os.replace(tmp, so)
            return so
    return None


def _bind_tracescan(lib):
    lib.ts_scan.restype = ctypes.c_void_p
    lib.ts_scan.argtypes = [ctypes.c_char_p]
    lib.ts_count.restype = ctypes.c_long
    lib.ts_count.argtypes = [ctypes.c_void_p]
    lib.ts_buf.restype = ctypes.c_void_p
    lib.ts_buf.argtypes = [ctypes.c_void_p]
    lib.ts_events.restype = ctypes.POINTER(TsEvent)
    lib.ts_events.argtypes = [ctypes.c_void_p]
    lib.ts_free.restype = ctypes.c_long
    lib.ts_free.argtypes = [ctypes.c_void_p]


def _bind_vecwriter(lib):
    lib.vw_open.restype = ctypes.c_void_p
    lib.vw_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.vw_declare.restype = ctypes.c_int
    lib.vw_declare.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_char_p]
    lib.vw_rows.restype = None
    lib.vw_rows.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                            ctypes.POINTER(ctypes.c_double),
                            ctypes.POINTER(ctypes.c_double)]
    lib.vw_scalar.restype = None
    lib.vw_scalar.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_char_p, ctypes.c_double]
    lib.vw_close.restype = None
    lib.vw_close.argtypes = [ctypes.c_void_p]


_BIND = {"tracescan": _bind_tracescan, "vecwriter": _bind_vecwriter}


def library(name: str):
    """The built ``native/<name>.c`` as a bound CDLL, or None when it
    cannot be compiled (tried once per process)."""
    with _lock:
        if name not in _libs:
            so = _build(name)
            lib = None
            if so is not None:
                lib = ctypes.CDLL(str(so))
                _BIND[name](lib)
            _libs[name] = lib
        return _libs[name]


def scan_trace(path):
    """Native trace scan -> list of (time, node, cmd, args) tuples, or
    None when the scanner is unavailable or the file cannot be read."""
    lib = library("tracescan")
    if lib is None:
        return None
    handle = lib.ts_scan(str(path).encode())
    if not handle:
        return None
    try:
        n = lib.ts_count(handle)
        evs = lib.ts_events(handle)
        buf = lib.ts_buf(handle)
        out = []
        for i in range(n):
            e = evs[i]
            args = tuple(ctypes.string_at(buf + off, ln).decode()
                         for off, ln in ((e.arg0_off, e.arg0_len),
                                         (e.arg1_off, e.arg1_len))
                         if off >= 0 and ln > 0)
            out.append((e.time, e.node, CMD_NAMES[e.cmd], args))
        return out
    finally:
        lib.ts_free(handle)
