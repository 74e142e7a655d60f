"""Result recording: OMNeT++-format .vec/.sca output for a running sim.

Counterpart of ``oversim_tpu/recorder.py``.  The reference records every
statistic through the OMNeT++ envir — cOutVector series into
``results/*.vec`` and finish()-time scalars into ``results/*.sca``
(GlobalStatistics recordScalar / addStdDev).  Here the recorder samples
the running simulation at a host-side period (one ``summary`` per
``run_until`` chunk boundary) and writes whole row blocks at close.  The
formatter is ``native/vecwriter.c`` (built by ``native.py`` into
``build/native/``); a pure-Python writer with byte-identical output is
the fallback.

    rec = VectorRecorder(sim, "out.vec", run_id="Chord-0")
    state = rec.run(state, t_sim=600.0, sample_every=5.0)
    rec.close()
    write_scalars(sim, state, "out.sca", run_id="Chord-0")

Recorded vectors: every engine counter, the workload counters and the
alive population.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np

from oversim_tpu_torch import native

NS = 1_000_000_000
_warned = []


class PyWriter:
    """The pure-Python writer, byte-identical to native/vecwriter.c."""

    def __init__(self, path, run_id):
        self.f = open(path, "w")
        self.next_id = 0
        self.f.write(f"version 2\nrun {run_id}\n")

    def declare(self, module, name):
        vid = self.next_id
        self.next_id += 1
        self.f.write(f"vector {vid} {module} {name} TV\n")
        return vid

    def rows(self, vid, t, v):
        w = self.f.write
        for ti, vi in zip(t, v):
            w(f"{vid}\t{ti:.9g}\t{vi:.12g}\n")

    def scalar(self, module, name, value):
        self.f.write(f"scalar {module} {name} {value:.12g}\n")

    def close(self):
        self.f.close()


class CWriter:
    def __init__(self, lib, path, run_id):
        self.lib = lib
        self.h = lib.vw_open(str(path).encode(), run_id.encode())
        if not self.h:
            raise OSError(f"vw_open failed: {path}")

    def declare(self, module, name):
        return self.lib.vw_declare(self.h, module.encode(), name.encode())

    def rows(self, vid, t, v):
        t = np.ascontiguousarray(t, np.float64)
        v = np.ascontiguousarray(v, np.float64)
        dp = ctypes.POINTER(ctypes.c_double)
        self.lib.vw_rows(self.h, vid, len(t), t.ctypes.data_as(dp),
                         v.ctypes.data_as(dp))

    def scalar(self, module, name, value):
        self.lib.vw_scalar(self.h, module.encode(), name.encode(),
                           float(value))

    def close(self):
        self.lib.vw_close(self.h)
        self.h = None


def writer(path, run_id):
    """The C writer where it builds, else the Python one."""
    lib = native.library("vecwriter")
    if lib is not None:
        return CWriter(lib, path, run_id)
    if not _warned:
        _warned.append(True)
        sys.stderr.write("oversim_tpu_torch.recorder: the native vecwriter "
                         "did not build; using the Python writer (same "
                         "bytes, slower on large vectors)\n")
    return PyWriter(path, run_id)


class VectorRecorder:
    """Samples a Simulation's counters into an OMNeT++ .vec file."""

    MODULE = "OverSimTpu.globalStatistics"

    def __init__(self, sim, path, run_id: str = "run-0"):
        self.sim = sim
        self.w = writer(path, run_id)
        self._ids = {}
        self._buf_t = []
        self._buf = {}

    def _vec(self, name):
        if name not in self._ids:
            self._ids[name] = self.w.declare(self.MODULE, name)
            self._buf[name] = []
        return self._ids[name]

    def sample(self, state):
        """Snapshot the counter set at the state's current sim time."""
        out = self.sim.summary(state)
        self._buf_t.append(out["_t_sim"])
        flat = {"aliveNodes": float(out["_alive"])}
        for k, v in out.items():
            if k.startswith("_") and k != "_engine":
                continue
            if k == "_engine":
                for ek, evv in v.items():
                    flat[f"engine.{ek}"] = float(evv)
            elif isinstance(v, dict):
                flat[f"{k}.mean"] = float(v.get("mean", 0.0))
            elif isinstance(v, (int, float)):
                flat[k] = float(v)
        for name, val in flat.items():
            self._vec(name)
            self._buf[name].append(val)

    def run(self, state, t_sim: float, sample_every: float = 10.0):
        """run_until with a sample every ``sample_every`` simulated s."""
        t = float(int(state.t_now)) / NS
        while t < t_sim:
            t = min(t + sample_every, t_sim)
            state = self.sim.run_until(state, t)
            t = float(int(state.t_now)) / NS
            self.sample(state)
        return state

    def close(self):
        for name, vid in self._ids.items():
            vals = self._buf[name]
            self.w.rows(vid, self._buf_t[:len(vals)], vals)
        self.w.close()


def write_scalars(sim, state, path, run_id: str = "run-0"):
    """finish()-time .sca dump (GlobalStatistics' recordScalar set)."""
    w = writer(path, run_id)
    mod = VectorRecorder.MODULE
    out = sim.summary(state)
    rename = {"_alive": "aliveNodes", "_t_sim": "simTime",
              "_ticks": "ticks"}
    for k, v in out.items():
        if k == "_engine":
            for ek, evv in v.items():
                w.scalar(mod, f"engine.{ek}", float(evv))
        elif isinstance(v, dict):
            for kk in ("mean", "stddev", "min", "max", "count"):
                if kk in v:
                    w.scalar(mod, f"{k}.{kk}", float(v[kk]))
        elif isinstance(v, (int, float)):
            w.scalar(mod, rename.get(k, k), float(v))
    w.close()
