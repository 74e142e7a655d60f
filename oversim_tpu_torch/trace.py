"""GlobalTraceManager + TraceChurn: trace-file driven simulations.

Counterpart of ``oversim_tpu/trace.py``.  A trace (``simulations/dht.trace``
format) drives node creation and destruction, per-node DHT commands and
network partitions:

    <time> <nodeID> JOIN | LEAVE | PUT <key> <value> | GET <key>
    <time> 0 CONNECT_NODETYPES <a> <b> | DISCONNECT_NODETYPES <a> <b>

The whole trace is parsed on the host at build time into static
schedules: JOIN/LEAVE into the per-slot times of the ``"trace"`` churn
model, PUT/GET into a ``TraceWorkload`` of per-slot command queues that
the DHT drains (``apps/dht.py``), CONNECT/DISCONNECT_NODETYPES into a
``PartitionSchedule`` for the underlay's connection matrix
(``underlay/simple.py``).  String keys are hashed with sha1
(``core/keys.py sha1_key``).  Files go through the native scanner
(``native/tracescan.c`` via ``native.py``) when it builds; literal text
uses the Python parser, which gives the same events.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from oversim_tpu_torch import churn as churn_mod
from oversim_tpu_torch.core import keys as K


@dataclasses.dataclass
class TraceEvent:
    time: float
    node: int
    cmd: str
    args: tuple


@dataclasses.dataclass
class TraceWorkload:
    """Per-slot command queues ([N, Q] numpy arrays, host-side).

    ``kind``: 0 none, 1 PUT, 2 GET; ``key`` the sha1 key lanes, ``value``
    a stable integer id per value string, ``key_pool`` the distinct keys
    (the GlobalDhtTestMap truth pool) and ``g`` each command's index in
    it."""

    t: np.ndarray        # [N, Q] f64 seconds (inf padded)
    kind: np.ndarray     # [N, Q] i32
    key: np.ndarray      # [N, Q, KL] u32
    value: np.ndarray    # [N, Q] i32
    key_pool: np.ndarray  # [G, KL] u32
    g: np.ndarray        # [N, Q] i32


@dataclasses.dataclass
class PartitionSchedule:
    """CONNECT/DISCONNECT_NODETYPES events (GlobalNodeList's
    connectionMatrix)."""

    t: np.ndarray        # [E] f64 seconds
    a: np.ndarray        # [E] i32
    b: np.ndarray        # [E] i32
    connect: np.ndarray  # [E] bool


def parse_text(text: str) -> list[TraceEvent]:
    """The Python parser: events of ``text``, sorted by time (stable)."""
    events = []
    for line in str(text).splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 3:
            raise ValueError(f"bad trace line: {line!r}")
        events.append(TraceEvent(time=float(parts[0]), node=int(parts[1]),
                                 cmd=parts[2].upper(),
                                 args=tuple(parts[3:])))
    events.sort(key=lambda e: e.time)
    return events


def parse_trace(path_or_text: str | Path) -> list[TraceEvent]:
    """A trace file (native scanner, else the Python parser) or literal
    text (the Python parser), time-sorted."""
    p = Path(str(path_or_text))
    if "\n" not in str(path_or_text) and p.exists():
        from oversim_tpu_torch import native
        rows = native.scan_trace(p)
        if rows is not None:
            events = [TraceEvent(time=t, node=n, cmd=c, args=a)
                      for (t, n, c, a) in rows]
            events.sort(key=lambda e: e.time)
            return events
        return parse_text(p.read_text())
    return parse_text(path_or_text)


def churn_from_trace(events, num_slots: int | None = None,
                     **kw) -> churn_mod.ChurnParams:
    """JOIN/LEAVE events -> ``ChurnParams(model="trace")``; slot = nodeID
    - the smallest ID seen, one session per ID."""
    joins: dict[int, float] = {}
    leaves: dict[int, float] = {}
    ids = [e.node for e in events if e.cmd in ("JOIN", "LEAVE")]
    if not ids:
        raise ValueError("trace contains no JOIN/LEAVE events")
    base = min(ids)
    for e in events:
        slot = e.node - base
        if e.cmd == "JOIN":
            if slot in joins:
                raise ValueError(
                    f"node {e.node}: multiple JOINs unsupported")
            joins[slot] = e.time
        elif e.cmd == "LEAVE":
            if slot not in joins or joins[slot] > e.time:
                raise ValueError(
                    f"node {e.node}: LEAVE without a prior JOIN")
            leaves[slot] = e.time
    n = num_slots or (max(joins) + 1)
    return churn_mod.ChurnParams(
        model="trace", target_num=n,
        trace_create=tuple(joins.get(i) for i in range(n)),
        trace_kill=tuple(leaves.get(i) for i in range(n)), **kw)


def workload_from_trace(events, num_slots: int,
                        spec: K.KeySpec = K.DEFAULT_SPEC) -> TraceWorkload:
    """PUT/GET events -> per-slot command queues in trace order."""
    ids = [e.node for e in events if e.cmd in ("JOIN", "LEAVE")]
    base = min(ids) if ids else 0
    per_slot: dict[int, list] = {}
    values: dict[str, int] = {}
    pool: dict[str, int] = {}
    pool_keys: list = []
    for e in events:
        if e.cmd not in ("PUT", "GET"):
            continue
        slot = e.node - base
        if not 0 <= slot < num_slots:
            raise ValueError(f"trace command for unknown node {e.node}")
        key = K.sha1_key(e.args[0].encode(), spec)
        if e.args[0] not in pool:
            pool[e.args[0]] = len(pool_keys)
            pool_keys.append(key)
        gi = pool[e.args[0]]
        if e.cmd == "PUT":
            vid = values.setdefault(e.args[1], len(values) + 1)
            per_slot.setdefault(slot, []).append((e.time, 1, key, vid, gi))
        else:
            per_slot.setdefault(slot, []).append((e.time, 2, key, -1, gi))
    q = max((len(v) for v in per_slot.values()), default=1)
    t = np.full((num_slots, q), np.inf)
    kind = np.zeros((num_slots, q), np.int32)
    keys = np.zeros((num_slots, q, spec.lanes), np.uint32)
    value = np.full((num_slots, q), -1, np.int32)
    g = np.zeros((num_slots, q), np.int32)
    for slot, cmds in per_slot.items():
        for j, (tt, kk, key, vid, gi) in enumerate(cmds):
            t[slot, j] = tt
            kind[slot, j] = kk
            keys[slot, j] = key
            value[slot, j] = vid
            g[slot, j] = gi
    return TraceWorkload(t=t, kind=kind, key=keys, value=value,
                         key_pool=np.stack(pool_keys) if pool_keys
                         else np.zeros((1, spec.lanes), np.uint32), g=g)


def partitions_from_trace(events) -> PartitionSchedule:
    """CONNECT/DISCONNECT_NODETYPES events -> the partition schedule."""
    rows = [(e.time, int(e.args[0]), int(e.args[1]),
             e.cmd == "CONNECT_NODETYPES")
            for e in events
            if e.cmd in ("CONNECT_NODETYPES", "DISCONNECT_NODETYPES")]
    if not rows:
        return PartitionSchedule(t=np.zeros((0,)), a=np.zeros((0,), np.int32),
                                 b=np.zeros((0,), np.int32),
                                 connect=np.zeros((0,), bool))
    t, a, b, c = zip(*rows)
    return PartitionSchedule(t=np.asarray(t), a=np.asarray(a, np.int32),
                             b=np.asarray(b, np.int32),
                             connect=np.asarray(c, bool))
