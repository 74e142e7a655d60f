#!/usr/bin/env python3
"""Delivery and population under ParetoChurn in the reference and in the
port, side by side.

    python3 scripts/torch_pareto_health.py [--scenario pareto|pastry]
        [--n 1000] [--seed 1] [--ends 25,30] [--window 5] [--device cpu]
        [--side both|jax|torch] [--inbox-slots 16]

Builds one of ``chip_smoke.py``'s ParetoChurn scenarios from its ini
text: ``pareto`` is ``pareto_path``'s (Kademlia + KBRTest at test
interval 0.2 s, ``lifetimeMean = deadtimeMean = 1000s``), ``pastry`` is
``pastry_path``'s (the same churn and KBRTest over Pastry at
bitsPerDigit 4 with 16 leaves and 160-bit keys, semi-recursive with
per-hop ACKs).  It runs at ``--n`` target nodes (3 n slots) with the
join ramp scaled to the same 20 s
(``initPhaseCreationInterval = 20 / n``), through each package's
``config/scenario.py build_simulation`` with the chip's engine
parameters (window 0.2 s, 16 inbox and 32 outbox slots, pool factor 8)
and ``init_deviation = jitter = 0``: once in the JAX package (in its own
interpreter, with the test suite's XLA flags, on the CPU) and once in the
port (``--device``, the CPU by default).  It prints one JSON line per
measured window for each: the scenario's counters (KBRTest sends and
deliveries; for Pastry also wrong-node deliveries, dropped routes and
joins), the delivery ratio, the mean hop count and hop histogram of the
window's deliveries, the alive population at the window's end, and the
overflow counters.  With the normal draws off the two runs are
leaf-exact, so every line pair must agree; the script exits non-zero
where they do not.  ``--side jax`` or ``--side torch`` runs one package
alone and prints its lines only.  ``--inbox-slots`` below 16 makes the
JAX program smaller: its Pastry step unrolls the inbox loop, and at 16
slots and 160-bit keys XLA's CPU compile of it needs more than 27 GB of
host memory.  ``chip_smoke.PARETO_REFERENCE`` and ``PASTRY_REFERENCE``
hold the 25-30 s window at N=1,000 and 16 inbox slots.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# scenario → (chip_smoke's ini function, config name, counters)
SCENARIOS = {
    "pareto": ("pareto_ini", "Pareto",
               ("kbr_sent", "kbr_delivered", "kbr_lookup_failed")),
    "pastry": ("pastry_ini", "Pastry",
               ("kbr_sent", "kbr_delivered", "kbr_wrong_node",
                "route_dropped", "pastry_joins")),
}


def build(pkg, scenario_name, n, device, inbox_slots=16):
    sys.path.insert(0, ROOT)
    import chip_smoke
    if pkg == "jax":
        from oversim_tpu.config import ini, scenario
        from oversim_tpu.engine import sim
        kw = {}
    else:
        from oversim_tpu_torch.config import ini, scenario
        from oversim_tpu_torch.engine import sim
        kw = {"device": device}
    ep = sim.EngineParams(window=0.2, inbox_slots=inbox_slots,
                          outbox_slots=32, pool_factor=8)
    ini_fn, config, _ = SCENARIOS[scenario_name]
    s = scenario.build_simulation(
        ini.IniFile.loads(getattr(chip_smoke, ini_fn)(n)), config,
        engine_params=ep, **kw)
    s.cp = dataclasses.replace(s.cp, init_deviation=0.0)
    s.up = dataclasses.replace(s.up, jitter=0.0)
    return s


def _hops(out):
    h = out["kbr_hopcount"]
    return h["count"], h["count"] * h["mean"] if h["count"] else 0.0


def windows(pkg, scenario, n, seed, ends, width, device, inbox_slots=16):
    """Yield one dict per window (end - width, end]."""
    fields = SCENARIOS[scenario][2]
    sim = build(pkg, scenario, n, device, inbox_slots)
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
        cur = ({k: int(out[k]) for k in fields}, _hops(out),
               out["kbr_hop_hist"])
        if t in ends and prev is not None and prev[0] == t - width:
            p_cnt, (p_n, p_sum), p_hist = prev[1]
            d = {k: cur[0][k] - p_cnt[k] for k in fields}
            n_h = cur[1][0] - p_n
            yield {"side": pkg, "scenario": scenario, "n": n,
                   "slots": sim.n, "window_end_s": t,
                   "t_sim": out["_t_sim"], "ticks": out["_ticks"], **d,
                   "delivery": d["kbr_delivered"] / d["kbr_sent"]
                   if d["kbr_sent"] else 0.0,
                   "hop_mean": (cur[1][1] - p_sum) / n_h if n_h else 0.0,
                   "hop_hist": [a - b for a, b in zip(cur[2], p_hist)],
                   "alive": out["_alive"],
                   "pool_overflow": out["_engine"]["pool_overflow"],
                   "outbox_overflow": out["_engine"]["outbox_overflow"]}
        prev = (t, cur)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="pareto", choices=tuple(SCENARIOS))
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ends", default="25,30")
    ap.add_argument("--window", type=float, default=5.0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--inbox-slots", type=int, default=16)
    ap.add_argument("--side", default="both",
                    choices=("both", "jax", "torch"))
    a = ap.parse_args()
    ends = [float(x) for x in a.ends.split(",")]
    if a.side != "both":
        # one package alone: its lines, no comparison
        if a.side == "jax":
            sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]
            import conftest  # noqa: F401  (the suite's XLA flags, x64, CPU)
        for line in windows(a.side, a.scenario, a.n, a.seed, ends, a.window,
                            a.device, a.inbox_slots):
            print(json.dumps(line), flush=True)
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--side", "jax",
         "--scenario", a.scenario, "--n", str(a.n), "--seed", str(a.seed),
         "--ends", a.ends, "--window", str(a.window),
         "--inbox-slots", str(a.inbox_slots)],
        stdout=subprocess.PIPE, text=True, env=env)
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    mine = []
    for line in windows("torch", a.scenario, a.n, a.seed, ends, a.window,
                        a.device, a.inbox_slots):
        mine.append(line)
        print(json.dumps(line), flush=True)
    out, _ = ref.communicate()
    theirs = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    for line in theirs:
        print(json.dumps(line), flush=True)
    if ref.returncode != 0 or len(theirs) != len(mine):
        print("the JAX run failed", file=sys.stderr)
        return 1
    keys = SCENARIOS[a.scenario][2] + (
        "delivery", "hop_mean", "hop_hist", "alive", "pool_overflow",
        "outbox_overflow", "ticks")
    bad = [(x["window_end_s"], k) for x, y in zip(mine, theirs)
           for k in keys if x[k] != y[k]]
    print(json.dumps({"equal": not bad, "differences": bad[:10]}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
