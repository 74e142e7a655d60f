#!/usr/bin/env python3
"""The DHT's success ratios in the reference and in the port, side by side.

    python3 scripts/torch_dht_health.py [--n 1000] [--seed 1]
        [--ends 40,50,60,70,80,90,100,110] [--window 10] [--device cpu]

Runs chip_smoke.py's ``dht_path`` configuration — Kademlia
(``LookupConfig(slots=8, merge=True)``) + DHT + DHTTestApp with
default.ini's DHT settings (4 replicas, 4 get requests, ratioIdentical
0.5, test interval 60 s, TTL 300 s, 32 storage slots) and a truth ring
of 16,384 keys, under LifetimeChurn (Weibull, mean 1,000 s, graceful
leave at its defaults) at ``--n`` target nodes (2 n slots), window
0.2 s, 16 inbox and 32 outbox slots, pool factor 8 — with
``init_deviation = jitter = 0``, once in the JAX package (in its own
interpreter, with the test suite's XLA flags, on the CPU) and once in
the port (``--device``, the CPU by default).  It prints one JSON line
per measured window for each side: puts and gets issued, their success
ratios, ``dht_get_wrong``, ``dht_get_notfound``, ``dht_mnt_puts``,
``dht_stored``, ``dht_lookup_failed``, the engine's overflow counters
and the truth ring's cursor.  With the normal draws off the two runs
are leaf-exact, so every line pair must agree; the script exits
non-zero where they do not.  The last line is the reference window that
``chip_smoke.py``'s ``dht_path`` gate compares with (the window ending
at 110 s: verify.ini's 100 s transition, then 10 s measured).
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("dht_put_attempts", "dht_put_success", "dht_get_attempts",
          "dht_get_success", "dht_get_wrong", "dht_get_notfound",
          "dht_mnt_puts", "dht_stored", "dht_lookup_failed")
GATE_END = 110.0


def build(pkg, n):
    """(Simulation class, logic, churn, underlay and engine params) of
    ``pkg`` ("jax" or "torch") for ``n`` target nodes."""
    if pkg == "jax":
        from oversim_tpu import churn
        from oversim_tpu.apps import dht
        from oversim_tpu.common import lookup
        from oversim_tpu.engine import sim
        from oversim_tpu.overlay.kademlia import KademliaLogic
        from oversim_tpu.underlay import simple
    else:
        from oversim_tpu_torch import churn
        from oversim_tpu_torch.apps import dht
        from oversim_tpu_torch.common import lookup
        from oversim_tpu_torch.engine import sim
        from oversim_tpu_torch.overlay.kademlia import KademliaLogic
        from oversim_tpu_torch.underlay import simple
    logic = KademliaLogic(
        app=dht.DhtApp(dht.DhtParams(
            num_replica=4, num_get_requests=4, ratio_identical=0.5,
            test_interval=60.0, test_ttl=300.0, storage_slots=32,
            num_test_keys=16384)),
        lcfg=lookup.LookupConfig(slots=8, merge=True))
    return (sim.Simulation, logic,
            churn.ChurnParams(model="lifetime", target_num=n,
                              init_interval=20.0 / n, init_deviation=0.0,
                              lifetime_mean=1000.0, lifetime_dist="weibull",
                              lifetime_par1=1.0),
            simple.UnderlayParams(jitter=0.0),
            sim.EngineParams(window=0.2, inbox_slots=16, outbox_slots=32,
                             pool_factor=8))


def ratio(num, den):
    return num / den if den else 0.0


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
        if t in ends and prev is not None and prev[0] == t - width:
            d = {k: cur[k] - prev[1][k] for k in FIELDS}
            yield {"side": pkg, "n": n, "window_end_s": t,
                   "t_sim": out["_t_sim"], "ticks": out["_ticks"],
                   "alive": out["_alive"], **d,
                   "put_success_ratio": ratio(d["dht_put_success"],
                                              d["dht_put_attempts"]),
                   "get_success_ratio": ratio(d["dht_get_success"],
                                              d["dht_get_attempts"]),
                   "ring_cursor": int(s.logic.app_glob.cursor),
                   "pool_overflow": out["_engine"]["pool_overflow"],
                   "outbox_overflow": out["_engine"]["outbox_overflow"]}
        prev = (t, cur)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ends", default="40,50,60,70,80,90,100,110")
    ap.add_argument("--window", type=float, default=10.0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--side", default="both", choices=("both", "jax"))
    a = ap.parse_args()
    ends = [float(x) for x in a.ends.split(",")]
    if a.side == "jax":
        sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]
        import conftest  # noqa: F401  (the suite's XLA flags, x64, CPU)
        for line in windows("jax", a.n, a.seed, ends, a.window, None):
            print(json.dumps(line), flush=True)
        return 0
    sys.path.insert(0, ROOT)
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
    keys = [k for k in mine[0] if k not in ("side", "t_sim")]
    bad = [(x["window_end_s"], k) for x, y in zip(mine, theirs)
           for k in keys if x[k] != y[k]]
    print(json.dumps({"equal": not bad, "differences": bad[:10]}))
    gate = [x for x in theirs if x["window_end_s"] == GATE_END]
    if gate:
        print(json.dumps({"reference_window": [GATE_END - a.window, GATE_END],
                          "put_success_ratio": gate[0]["put_success_ratio"],
                          "get_success_ratio": gate[0]["get_success_ratio"]}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
