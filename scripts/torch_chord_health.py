#!/usr/bin/env python3
"""Chord's delivery in the reference and in the port, side by side.

    python3 scripts/torch_chord_health.py [--n 1000] [--seed 1]
        [--ends 35,45,55,65,75,85] [--window 10] [--device cpu]

Runs bench.py's Chord + KBRTest configuration (``LookupConfig(slots=8)``,
test interval 0.2 s, NoChurn join ramp, window 0.2 s, pool factor 8)
with 16 inbox and 32 outbox slots (chip_smoke.py's) and
``init_deviation = jitter = 0``, once in the JAX package (in its own
interpreter, with the test suite's XLA flags, on the CPU) and once in
the port (``--device``, the CPU by default), and prints one JSON line
per measured window for each: KBRTest sends and deliveries, delivery
ratio, ``kbr_lookup_failed``, ``lookup_failed``, ``lookup_success`` and
the mean lookup hops of the window, and the engine's overflow counters.
With the normal draws off the two runs are leaf-exact, so every line
pair must agree; the script exits non-zero where they do not.  The JAX
side takes about four minutes at N=1,000 on a few CPU cores.

``--static-timeouts`` is a diagnostic of the port alone (no JAX run, no
comparison): every lookup RPC gets the static ``rpc_timeout_ns`` (1.5 s)
in place of the NeighborCache's adaptive timeout, which is clipped
below at 0.2 s.  It is not Chord's configuration; it tests whether
those short timeouts cost the deliveries.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("kbr_sent", "kbr_delivered", "kbr_lookup_failed",
          "lookup_failed", "lookup_success")


def build(pkg, n):
    """(Simulation class, logic, churn, underlay and engine params) of
    ``pkg`` ("jax" or "torch") for ``n`` nodes."""
    if pkg == "jax":
        from oversim_tpu import churn
        from oversim_tpu.apps import kbrtest
        from oversim_tpu.common import lookup
        from oversim_tpu.engine import sim
        from oversim_tpu.overlay.chord import ChordLogic
        from oversim_tpu.underlay import simple
    else:
        from oversim_tpu_torch import churn
        from oversim_tpu_torch.apps import kbrtest
        from oversim_tpu_torch.common import lookup
        from oversim_tpu_torch.engine import sim
        from oversim_tpu_torch.overlay.chord import ChordLogic
        from oversim_tpu_torch.underlay import simple
    logic = ChordLogic(
        app=kbrtest.KbrTestApp(kbrtest.KbrTestParams(test_interval=0.2)),
        lcfg=lookup.LookupConfig(slots=8))
    return (sim.Simulation, logic,
            churn.ChurnParams(model="none", target_num=n,
                              init_interval=20.0 / n, init_deviation=0.0),
            simple.UnderlayParams(jitter=0.0),
            sim.EngineParams(window=0.2, inbox_slots=16, outbox_slots=32,
                             pool_factor=8))


def windows(pkg, n, seed, ends, width, device):
    """Yield one dict per window (end - width, end]."""
    cls, logic, cp, up, ep = build(pkg, n)
    kw = {} if pkg == "jax" else {"device": device}
    sim = cls(logic, cp, up, ep, **kw)
    s = sim.init(seed=seed)
    if pkg == "jax":
        import jax
        import jax.numpy as jnp
        s = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), s)
    prev = None
    marks = sorted({e - width for e in ends} | set(ends))
    for t in marks:
        while int(s.t_now) < int(t * 1e9):
            s = sim.run_chunk(s, 1)
        out = sim.summary(s)
        cur = {k: int(out[k]) for k in FIELDS}
        cur["hops_count"] = int(out["lookup_hops"]["count"])
        cur["hops_sum"] = float(out["lookup_hops"]["mean"]) * cur[
            "hops_count"] if cur["hops_count"] else 0.0
        if t in ends and prev is not None and prev[0] == t - width:
            d = {k: cur[k] - prev[1][k] for k in FIELDS}
            hc = cur["hops_count"] - prev[1]["hops_count"]
            yield {"side": pkg, "n": n, "window_end_s": t,
                   "t_sim": out["_t_sim"], "ticks": out["_ticks"], **d,
                   "delivery": d["kbr_delivered"] / d["kbr_sent"]
                   if d["kbr_sent"] else 0.0,
                   "lookup_hops_mean": round((cur["hops_sum"]
                                              - prev[1]["hops_sum"]) / hc, 6)
                   if hc else None,
                   "pool_overflow": out["_engine"]["pool_overflow"],
                   "outbox_overflow": out["_engine"]["outbox_overflow"]}
        prev = (t, cur)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ends", default="35,45,55,65,75,85")
    ap.add_argument("--window", type=float, default=10.0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--side", default="both", choices=("both", "jax"))
    ap.add_argument("--static-timeouts", action="store_true")
    a = ap.parse_args()
    ends = [float(x) for x in a.ends.split(",")]
    if a.side == "jax":
        sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]
        import conftest  # noqa: F401  (the suite's XLA flags, x64, CPU)
        for line in windows("jax", a.n, a.seed, ends, a.window, None):
            print(json.dumps(line), flush=True)
        return 0
    sys.path.insert(0, ROOT)
    if a.static_timeouts:
        import torch
        from oversim_tpu_torch.common import neighborcache

        def static(nc, default_ns):
            return lambda cands: torch.full_like(cands, default_ns,
                                                 dtype=torch.int64)

        neighborcache.adaptive_timeout_fn = static
        for line in windows("torch", a.n, a.seed, ends, a.window, a.device):
            print(json.dumps(dict(line, side="torch_static_timeouts")),
                  flush=True)
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--side", "jax",
         "--n", str(a.n), "--seed", str(a.seed), "--ends", a.ends,
         "--window", str(a.window)],
        stdout=subprocess.PIPE, text=True, env=env)
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    mine = []
    for line in windows("torch", a.n, a.seed, ends, a.window, a.device):
        mine.append(line)
        print(json.dumps(line), flush=True)
    out, _ = ref.communicate()
    theirs = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    for line in theirs:
        print(json.dumps(line), flush=True)
    if ref.returncode != 0 or len(theirs) != len(mine):
        print("the JAX run failed", file=sys.stderr)
        return 1
    keys = FIELDS + ("delivery", "lookup_hops_mean", "pool_overflow",
                     "outbox_overflow", "ticks")
    bad = [(x["window_end_s"], k) for x, y in zip(mine, theirs)
           for k in keys if x[k] != y[k]]
    print(json.dumps({"equal": not bad, "differences": bad[:10]}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
