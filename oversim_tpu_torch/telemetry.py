"""Device-resident telemetry: KPI time series kept inside the tick (PyTorch).

Counterpart of ``oversim_tpu/telemetry.py`` (its ring buffers,
host-side series, the Perfetto trace builder and the config hash that
checkpoints carry; the ``.vec`` and manifest exporters are still to be
ported, ROADMAP Queue A).  Preallocated ``[W, ...]`` rings
ride as one more ``SimState`` leaf (``SimState.telemetry``), and every
``TelemetryParams.sample_ticks`` ticks ``fold`` writes one sample at the
end of the tick's alloc phase: the tapped stats accumulators ("s:",
"h:", "c:"; the app's ``kpi_spec()`` picks them), every engine counter,
the alive population, the sim time and the tick number.

The write never branches on the host: the row ``n % W`` is rewritten on
every tick, with the new values on a sample tick and its own old values
otherwise, so only ``n`` differs between the two.  It draws no random
numbers and touches no other leaf, so every non-telemetry leaf equals a
telemetry-off run's.  A campaign stacks the rings to ``[S, W, ...]`` for
its per-replica series and cross-replica bands (``ensemble_series``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess

import numpy as np
import torch

I64 = torch.int64
NS = 1_000_000_000


@dataclasses.dataclass(frozen=True)
class TelemetryParams:
    """``sample_ticks``: snapshot period in ticks, 0 disables telemetry
    (``SimState.telemetry`` stays None and the tick is unchanged);
    ``window``: W, the ring's capacity (the last W samples survive);
    ``include``: stat-key substring filters (empty: the app's
    ``kpi_spec()``, or every key when the app declares none)."""

    sample_ticks: int = 0
    window: int = 256
    include: tuple = ()


@dataclasses.dataclass
class TelemetryState:
    """Sample ``j`` (0-based) lives at row ``j % W``; ``n`` counts the
    samples taken."""

    n: torch.Tensor          # i64 scalar
    t_ns: torch.Tensor       # [W] i64
    tick: torch.Tensor       # [W] i64
    alive: torch.Tensor      # [W] i64
    series: dict             # stats key -> [W, *leaf.shape]
    counters: dict           # engine counter name -> [W] i64


def resolve_taps(stats: dict, tp: TelemetryParams, app=None) -> tuple:
    """The stats keys the rings snapshot: ``include`` filters, else the
    app's ``kpi_spec()`` (names without their class prefix), else every
    key; a selection that matches nothing falls back to every key."""
    keys = tuple(stats)
    if tp.include:
        sel = tuple(k for k in keys if any(p in k for p in tp.include))
        return sel or keys
    if app is not None and hasattr(app, "kpi_spec"):
        want = set(app.kpi_spec())
        sel = tuple(k for k in keys if k[2:] in want)
        return sel or keys
    return keys


def init(stats: dict, counter_names, tp: TelemetryParams,
         app=None) -> TelemetryState | None:
    """Zeroed rings for the resolved taps on the stats' device; None
    when telemetry is off."""
    if tp is None or tp.sample_ticks <= 0:
        return None
    w = int(tp.window)
    if w < 1:
        raise ValueError(f"telemetry.window must be >= 1, got {w}")
    dev = next(iter(stats.values())).device if stats else "cpu"

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return TelemetryState(
        n=zeros((), I64), t_ns=zeros((w,), I64), tick=zeros((w,), I64),
        alive=zeros((w,), I64),
        series={k: zeros((w,) + tuple(stats[k].shape), stats[k].dtype)
                for k in resolve_taps(stats, tp, app=app)},
        counters={name: zeros((w,), I64) for name in counter_names})


def fold(tel: TelemetryState | None, tp: TelemetryParams, *, t_end, tick,
         alive, stats: dict, counters: dict):
    """The in-tick sample point, fed the END-of-tick values.  Row
    ``n % W`` takes the new values on a sample tick (``tick %
    sample_ticks == 0``) and keeps its own otherwise."""
    if tel is None or tp is None or tp.sample_ticks <= 0:
        return tel
    w = tel.t_ns.shape[-1]
    do = (tick % tp.sample_ticks) == 0
    row = (tel.n % w).reshape(1)

    def put(buf, v):
        v = v.to(buf.dtype).reshape((1,) + tuple(buf.shape[1:]))
        return buf.index_copy(0, row, torch.where(do, v, buf[row]))

    return TelemetryState(
        n=tel.n + do.to(I64),
        t_ns=put(tel.t_ns, t_end), tick=put(tel.tick, tick),
        alive=put(tel.alive, torch.sum(alive.to(I64))),
        series={k: put(buf, stats[k]) for k, buf in tel.series.items()},
        counters={k: put(buf, counters[k])
                  for k, buf in tel.counters.items()})


# -- host side: ring unwrap and KPI series ------------------------------------

def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _map(fn, tel) -> TelemetryState:
    return TelemetryState(
        n=fn(tel.n), t_ns=fn(tel.t_ns), tick=fn(tel.tick),
        alive=fn(tel.alive),
        series={k: fn(v) for k, v in tel.series.items()},
        counters={k: fn(v) for k, v in tel.counters.items()})


def _ring_order(n: int, w: int) -> np.ndarray:
    """Row indices, oldest first, of a ring that has taken n samples."""
    if n <= w:
        return np.arange(n)
    return (n + np.arange(w)) % w


def unwrap(tel) -> dict:
    """Time-ordered rings of a TelemetryState (tensors or arrays):
    {"k": samples kept, "n": samples taken, "t_ns"/"tick"/"alive": [K],
    "series": {key: [K, ...]}, "counters": {name: [K]}}, oldest first."""
    tel = _map(_np, tel)
    n = int(tel.n)
    order = _ring_order(n, int(tel.t_ns.shape[-1]))
    return {"k": len(order), "n": n, "t_ns": tel.t_ns[order],
            "tick": tel.tick[order], "alive": tel.alive[order],
            "series": {k: v[order] for k, v in tel.series.items()},
            "counters": {k: v[order] for k, v in tel.counters.items()}}


def kpi_series(tel) -> dict:
    """Flat named series: ``name.mean`` (NaN before the first event) and
    ``name.count`` for scalar accumulators, counters by name, engine
    counters as ``engine.<name>``, ``aliveNodes``, and the derived
    ``kbr_delivery_ratio`` where the KBRTest counters are tapped;
    histogram snapshots stay ``[K, B]`` under ``hists``."""
    u = unwrap(tel)
    series = {"aliveNodes": u["alive"].astype(float)}
    hists = {}
    for key, v in u["series"].items():
        name = key[2:]
        if key.startswith("s:"):
            cnt = v[:, 0]
            with np.errstate(invalid="ignore", divide="ignore"):
                series[name + ".mean"] = np.where(
                    cnt > 0, v[:, 1] / np.maximum(cnt, 1.0), np.nan)
            series[name + ".count"] = cnt
        elif key.startswith("h:"):
            hists[name] = v
        else:
            series[name] = v.astype(float)
    for name, v in u["counters"].items():
        series["engine." + name] = np.asarray(v, float)
    if "kbr_sent" in series and "kbr_delivered" in series:
        sent = series["kbr_sent"]
        with np.errstate(invalid="ignore", divide="ignore"):
            series["kbr_delivery_ratio"] = np.where(
                sent > 0, series["kbr_delivered"] / np.maximum(sent, 1.0),
                np.nan)
    return {"k": u["k"], "n": u["n"], "t_s": u["t_ns"].astype(float) / NS,
            "tick": u["tick"], "series": series, "hists": hists}


def _clean(a):
    return [None if (isinstance(x, float) and x != x) else float(x)
            for x in np.asarray(a, float)]


def series_report(tel) -> dict:
    """``kpi_series`` as JSON-safe lists (NaN -> None)."""
    ks = kpi_series(tel)
    return {"metric": "telemetry_series", "samples": ks["k"],
            "samples_taken": ks["n"], "t_s": _clean(ks["t_s"]),
            "tick": np.asarray(ks["tick"]).astype(int).tolist(),
            "series": {k: _clean(v) for k, v in ks["series"].items()},
            "hists": {k: np.asarray(v).astype(int).tolist()
                      for k, v in ks["hists"].items()}}


def ensemble_series(tel_stacked, confidence: float = 0.95) -> dict:
    """Per-replica KPI series and cross-replica CI bands of an
    ``[S, W, ...]``-stacked TelemetryState.  Replicas share the sampling
    cadence (every ``sample_ticks`` ticks), so sample j compares across
    replicas; every series is cut to the shortest replica's."""
    from oversim_tpu_torch import stats as stats_mod
    tel_stacked = _map(_np, tel_stacked)
    s_count = int(tel_stacked.n.shape[0])
    per = [kpi_series(_map(lambda x, r=r: x[r], tel_stacked))
           for r in range(s_count)]
    k = min(p["k"] for p in per)
    names = sorted(per[0]["series"])
    stacked = {name: np.stack([p["series"][name][:k] for p in per])
               for name in names}
    return {
        "enabled": True, "samples": k, "replicas": s_count,
        "confidence": confidence,
        "tick": (np.asarray(per[0]["tick"][:k]).astype(int).tolist()
                 if k else []),
        "t_s": [_clean(p["t_s"][:k]) for p in per],
        "per_replica": {name: [_clean(row) for row in stacked[name]]
                        for name in names},
        "bands": {name: stats_mod.series_summary(stacked[name], confidence)
                  for name in names}}


# -- Perfetto / Chrome-trace exporter -----------------------------------------

class PerfettoTrace:
    """Chrome-trace-JSON builder (the format ui.perfetto.dev and
    chrome://tracing load) for the service loop's spans.  Timestamps are
    absolute seconds (``time.perf_counter`` readings); ``to_dict``
    rebases to the first event so a trace starts at 0."""

    def __init__(self, process_name: str = "oversim-tpu-torch"):
        self.events = []
        self.process_name = process_name

    def span(self, name, t0_s, dur_s, *, tid=0, pid=0, args=None):
        """Complete event ("ph": "X"): a [t0, t0+dur) slice."""
        ev = {"name": name, "ph": "X", "ts": float(t0_s) * 1e6,
              "dur": max(float(dur_s), 0.0) * 1e6, "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def to_dict(self) -> dict:
        base = min((e["ts"] for e in self.events), default=0.0)
        events = []
        for e in self.events:
            e = dict(e)
            e["ts"] = round(e["ts"] - base, 3)
            events.append(e)
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": self.process_name}}] if events else []
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def write(self, path) -> None:
        """Atomic write (tmp + replace): a kill mid-run leaves the
        previous complete trace."""
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f)
        os.replace(tmp, str(path))


# -- run identity ---------------------------------------------------------------

def config_hash(config) -> str:
    """Stable sha256 prefix over a JSON-serializable config mapping
    (sorted keys, ``default=str`` for dataclasses and paths): the JAX
    package's hash of the same mapping."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def git_rev(root=None) -> str | None:
    """``git rev-parse HEAD`` of the checkout, None outside a git tree."""
    try:
        r = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10,
            cwd=root or os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
        return r.stdout.strip() or None if r.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        return None
