#!/usr/bin/env python3
"""The chip paths' health numbers in the reference and in the port, side
by side.

    python3 scripts/torch_pareto_health.py
        [--scenario pareto|pastry|koorde|broose|epichord|inet|chord|dht|
                    gia|vast|quon|nice|pubsub|ntree|scribe|simmud|p2pns]
        [--n 1000] [--seed 1] [--ends ...] [--window ...] [--device cpu]
        [--side both|jax|torch] [--inbox-slots 16] [--static-timeouts]

Each scenario is one of ``chip_smoke.py``'s paths at ``--n`` target nodes
with the join ramp scaled to the same 20 s (``initPhaseCreationInterval =
20 / n``), the chip's engine parameters (window 0.2 s, 16 inbox and 32
outbox slots, pool factor 8) and ``init_deviation = jitter = 0``, run
once in the JAX package (in its own interpreter, with the test suite's
XLA flags, on the CPU) and once in the port (``--device``, the CPU by
default).  It prints one JSON line per measured window for each side.
With the normal draws off the two runs are leaf-exact, so every line
pair must agree; the script exits non-zero where they do not.  ``--side
jax`` or ``--side torch`` runs one package alone and prints its lines
only.

- ``pareto`` (``pareto_path``): Kademlia + KBRTest at test interval
  0.2 s under ParetoChurn (``lifetimeMean = deadtimeMean = 1000s``, 3 n
  slots), from ``chip_smoke.pareto_ini``; ``pastry`` (``pastry_path``):
  the same churn and KBRTest over Pastry at bitsPerDigit 4 with 16
  leaves, semi-recursive with per-hop ACKs (``pastry_ini``).  Default
  window 20-25 and 25-30 s.
- ``koorde`` and ``broose`` (``koorde_path``, ``broose_path``):
  ``chip_smoke.db_sim``, the Chord path's scenario (NoChurn, KBRTest at
  0.2 s) with each overlay's default parameters at 160-bit keys.
  Default windows 20-25 and 25-30 s (Koorde), 35-40 and 40-45 s
  (Broose, whose join machine settles later).
- ``epichord`` (``epichord_path``): the same scenario with EpiChord's
  defaults (cache of 64); windows of 5 s ending at 20-45 s, with the
  READY share and the mean live cache entries per READY node.
- ``inet`` (``inet_path``): the main path (bench.py's Kademlia +
  KBRTest, NoChurn, test interval 0.2 s) over InetUnderlay with 16
  access routers; windows 15-20, 20-25 and 25-30 s, with the mean
  one-way latency of the window's deliveries.
- Those six print KBRTest's sends and deliveries (and the scenario's
  other counters), the delivery ratio, the mean hop count and hop
  histogram of the window's deliveries, the alive population at the
  window's end and the overflow counters.
- ``chord`` (``chord_path``): bench.py's Chord + KBRTest
  (``LookupConfig(slots=8)``, NoChurn, test interval 0.2 s); windows of
  10 s ending at 35-85 s; KBRTest sends and deliveries, delivery,
  ``kbr_lookup_failed``, ``lookup_failed``, ``lookup_success``, the
  mean lookup hops.  ``--static-timeouts`` is a diagnostic of the port
  alone: every lookup RPC gets the static 1.5 s timeout in place of the
  NeighborCache's adaptive one.
- ``dht`` (``dht_path``): Kademlia (``LookupConfig(slots=8,
  merge=True)``) + DHT + DHTTestApp with default.ini's DHT settings and
  a truth ring of 16,384 keys under LifetimeChurn (Weibull mean
  1,000 s, 2 n slots); windows of 10 s ending at 40-110 s; puts and gets,
  their success ratios, wrong and not-found gets, maintenance puts,
  stored records, failed lookups, the truth ring's cursor; the last line
  is the window (100-110 s) that ``dht_path``'s gate compares with.

- ``gia`` (``gia_path``): GIA at GiaParams()'s defaults under NoChurn;
  windows of 5 s ending at 25-50 s: searches, successes, timeouts, query
  drops and joins, the success ratio beside the walk bound
  ``(maxHopCount + 1)(maxNeighbors + 1)/(READY nodes - 1)`` that
  ``gia_path``'s gate uses, the hop and latency means of the window's
  answers, the READY share and the summed degree of READY nodes.
- ``vast`` and ``quon`` (``vast_identity``'s scenario, ``chip_smoke.
  game_sim``): each overlay at its defaults under NoChurn; windows of 5 s
  ending at 10-30 s: joins, moves, position updates, hints and forwarded
  JOINs, the READY share and the summed neighbor count of READY nodes.
- ``nice`` (``nice_path``, ``chip_smoke.nice_sim``): NICE at
  NiceParams()'s defaults with ALMTest under NoChurn over a 10 s ramp
  (``initPhaseCreationInterval = 10 / n``), window 0.05 s and
  ``nice_path``'s 64 outbox slots and pool factor; windows of 2 s ending
  at 76-82 s (every node joined, publishing): publishes, deliveries,
  duplicates, joins, splits, merges, evictions and dropped forwards, the
  coverage (deliveries over publishes x (READY nodes - 1)), the
  duplicate share, the mean layer count of the window's publishers and
  the READY share; the last line is the window (80-82 s) whose coverage
  ``nice_path``'s gate uses (``chip_smoke.NICE_REFERENCE``).
- ``pubsub`` (``alm_identity``'s scenario, ``chip_smoke.game_sim``):
  PubSubMMOG at its defaults under NoChurn; windows of 5 s ending at
  25-40 s (moves are published once the 20 s ramp is over): moves,
  move lists sent and received, events in and past their timeslot,
  rejected subscriptions, joins and the READY share.
- ``ntree`` (``alm_identity``'s scenario, ``chip_smoke.ntree_sim``):
  NTree at NTreeParams()'s defaults over the Chord path's scenario;
  windows of 5 s ending at 25-50 s: registrations, divides, collapses,
  events sent and delivered, failed lookups and the READY share.
- ``scribe`` (``scribe_path``, ``chip_smoke.scribe_sim``): Scribe with
  ALMTest at ScribeParams()'s defaults over the Chord path's scenario,
  with the script's inbox and outbox slots and pool factor;
  ``simmud`` and ``p2pns``: SimMud and P2PNS at their defaults over the
  same scenario (``app_identity``'s cases, with the script's engine);
  windows of 5 s ending at 20-40 s: publishes, receipts, redirects,
  joins and failed lookups (Scribe, SimMud) with the coverage (the
  window's receipts over its publishes times the READY members of each
  publisher's group) and the mean hops and latency of the receipts;
  registrations, resolutions, cache hits, successes, failures and
  stores (P2PNS); the READY share.  Scribe's 35-40 s window is
  ``scribe_path``'s reference (``chip_smoke.SCRIBE_REFERENCE``).

``--inbox-slots`` below 16 makes the JAX program smaller: its Pastry and
Broose steps unroll the inbox loop, and at 16 slots and 160-bit keys
XLA's CPU compile of Pastry's needs more than 27 GB of host memory.
``chip_smoke.PARETO_REFERENCE``, ``PASTRY_REFERENCE``, ``DB_REFERENCE``,
``DHT_REFERENCE``, ``NICE_REFERENCE`` and ``SCRIBE_REFERENCE`` hold
the gate windows at N=1,000.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KBR = ("kbr_sent", "kbr_delivered")
# scenario → (counters, default ends, default window)
SCENARIOS = {
    "pareto": (KBR + ("kbr_lookup_failed",), "25,30", 5.0),
    "pastry": (KBR + ("kbr_wrong_node", "route_dropped", "pastry_joins"),
               "25,30", 5.0),
    "koorde": (KBR + ("kbr_wrong_node", "lookup_failed", "chord_joins"),
               "25,30", 5.0),
    "broose": (KBR + ("kbr_wrong_node", "lookup_failed", "broose_joins",
                      "broose_join_retries"), "40,45", 5.0),
    "epichord": (KBR + ("kbr_wrong_node", "lookup_failed", "epi_joins",
                        "epi_slice_lookups"), "20,25,30,35,40,45", 5.0),
    "inet": (KBR + ("kbr_wrong_node", "kbr_lookup_failed"), "20,25,30",
             5.0),
    "chord": (KBR + ("kbr_lookup_failed", "lookup_failed",
                     "lookup_success"), "35,45,55,65,75,85", 10.0),
    "dht": (("dht_put_attempts", "dht_put_success", "dht_get_attempts",
             "dht_get_success", "dht_get_wrong", "dht_get_notfound",
             "dht_mnt_puts", "dht_stored", "dht_lookup_failed"),
            "40,50,60,70,80,90,100,110", 10.0),
    "gia": (("gia_searches", "gia_search_success", "gia_search_failed",
             "gia_query_drops", "gia_joins"), "25,30,35,40,45,50", 5.0),
}
for _x in ("vast", "quon"):
    SCENARIOS[_x] = (tuple(f"{_x}_{k}" for k in (
        "joins", "moves", "updates", "hints", "join_fwd")),
        "10,15,20,25,30", 5.0)
SCENARIOS["nice"] = (("nice_pub", "nice_recv", "nice_dup", "nice_joins",
                      "nice_splits", "nice_merges", "nice_evicts",
                      "nice_fwd_drop"), "76,78,80,82", 2.0)
SCENARIOS["pubsub"] = (("ps_moves", "ps_lists_sent", "ps_lists_recv",
                        "ps_events_ok", "ps_events_late", "ps_rejects",
                        "ps_joins"), "25,30,35,40", 5.0)
SCENARIOS["ntree"] = (("ntree_registers", "ntree_divides", "ntree_collapses",
                       "ntree_events", "ntree_event_delivered",
                       "ntree_lookup_failed"), "25,30,35,40,45,50", 5.0)
ALM_TEST = ("alm_published", "alm_received", "alm_sub_redirects",
            "alm_joins", "alm_lookup_failed")
SCENARIOS["scribe"] = (ALM_TEST, "20,25,30,35,40", 5.0)
SCENARIOS["simmud"] = (ALM_TEST, "20,25,30,35,40", 5.0)
SCENARIOS["p2pns"] = (("p2pns_registers", "p2pns_resolves",
                       "p2pns_cache_hits", "p2pns_resolve_success",
                       "p2pns_resolve_failed", "p2pns_stored"),
                      "20,25,30,35,40", 5.0)
GAME = ("gia", "vast", "quon")
ALM = ("nice", "pubsub", "ntree", "scribe", "simmud", "p2pns")
NICE_GATE_END = 82.0
SCRIBE_GATE_END = 40.0
INI_SCENARIOS = {"pareto": ("pareto_ini", "Pareto"),
                 "pastry": ("pastry_ini", "Pastry")}
DHT_GATE_END = 110.0


def _engine(sim, inbox_slots):
    return sim.EngineParams(window=0.2, inbox_slots=inbox_slots,
                            outbox_slots=32, pool_factor=8)


def _mods(pkg):
    if pkg == "jax":
        from oversim_tpu import churn
        from oversim_tpu.apps import dht, kbrtest
        from oversim_tpu.common import lookup
        from oversim_tpu.engine import sim
        from oversim_tpu.underlay import simple
    else:
        from oversim_tpu_torch import churn
        from oversim_tpu_torch.apps import dht, kbrtest
        from oversim_tpu_torch.common import lookup
        from oversim_tpu_torch.engine import sim
        from oversim_tpu_torch.underlay import simple
    return churn, dht, kbrtest, lookup, sim, simple


def _overlay(pkg, name):
    import importlib
    base = "oversim_tpu" if pkg == "jax" else "oversim_tpu_torch"
    return importlib.import_module(f"{base}.overlay.{name}")


def build(pkg, scenario, n, device, inbox_slots=16):
    """The scenario's Simulation in ``pkg`` ("jax" or "torch")."""
    sys.path.insert(0, ROOT)
    churn, dht, kbrtest, lookup, sim, simple = _mods(pkg)
    kw = {} if pkg == "jax" else {"device": device}
    ep = _engine(sim, inbox_slots)
    if scenario in INI_SCENARIOS:
        import chip_smoke
        if pkg == "jax":
            from oversim_tpu.config import ini, scenario as sc
        else:
            from oversim_tpu_torch.config import ini, scenario as sc
        ini_fn, config = INI_SCENARIOS[scenario]
        s = sc.build_simulation(
            ini.IniFile.loads(getattr(chip_smoke, ini_fn)(n)), config,
            engine_params=ep, **kw)
        s.cp = dataclasses.replace(s.cp, init_deviation=0.0)
        s.up = dataclasses.replace(s.up, jitter=0.0)
        return s
    nochurn = churn.ChurnParams(model="none", target_num=n,
                                init_interval=20.0 / n, init_deviation=0.0)
    kbr = kbrtest.KbrTestApp(kbrtest.KbrTestParams(test_interval=0.2))
    if scenario == "koorde":
        logic = _overlay(pkg, "koorde").KoordeLogic(app=kbr)
        cp = nochurn
    elif scenario == "broose":
        logic = _overlay(pkg, "broose").BrooseLogic(app=kbr)
        cp = nochurn
    elif scenario == "epichord":
        logic = _overlay(pkg, "epichord").EpiChordLogic(app=kbr)
        cp = nochurn
    elif scenario == "inet":
        import importlib
        inet = importlib.import_module(
            ("oversim_tpu" if pkg == "jax" else "oversim_tpu_torch")
            + ".underlay.inet")
        logic = _overlay(pkg, "kademlia").KademliaLogic(
            app=kbr, lcfg=lookup.LookupConfig(slots=8, merge=True))
        return sim.Simulation(logic, nochurn, inet.InetUnderlayParams(
            routers=16, jitter=0.0), ep, underlay_module=inet, **kw)
    elif scenario == "chord":
        logic = _overlay(pkg, "chord").ChordLogic(
            app=kbr, lcfg=lookup.LookupConfig(slots=8))
        cp = nochurn
    elif scenario == "gia":
        logic = _overlay(pkg, "gia").GiaLogic()
        cp = nochurn
    elif scenario in GAME:
        mod = _overlay(pkg, scenario)
        logic = getattr(mod, scenario.capitalize() + "Logic")()
        cp = nochurn
    elif scenario == "nice":
        import chip_smoke as cs
        logic = _overlay(pkg, "nice").NiceLogic()
        cp = churn.ChurnParams(model="none", target_num=n,
                               init_interval=cs.NICE_RAMP_S / n,
                               init_deviation=0.0)
        ep = sim.EngineParams(window=cs.NICE_WINDOW, inbox_slots=inbox_slots,
                              outbox_slots=cs.NICE_MOUT,
                              pool_factor=cs.NICE_POOL_FACTOR)
    elif scenario == "pubsub":
        logic = _overlay(pkg, "pubsubmmog").PubSubMMOGLogic()
        cp = nochurn
    elif scenario in ("ntree", "scribe", "simmud", "p2pns"):
        import importlib
        app = importlib.import_module(
            ("oversim_tpu" if pkg == "jax" else "oversim_tpu_torch")
            + ".apps." + scenario)
        app = {"ntree": lambda: app.NTreeApp(),
               "scribe": lambda: app.ScribeApp(),
               "simmud": lambda: app.SimMudApp(),
               "p2pns": lambda: app.P2pnsApp(num_slots=n)}[scenario]()
        logic = _overlay(pkg, "chord").ChordLogic(
            app=app, lcfg=lookup.LookupConfig(slots=8))
        cp = nochurn
        if scenario == "scribe":
            import chip_smoke as cs
            ep = sim.EngineParams(window=0.2, inbox_slots=cs.R,
                                  outbox_slots=cs.MOUT,
                                  pool_factor=cs.POOL_FACTOR)
    else:
        logic = _overlay(pkg, "kademlia").KademliaLogic(
            app=dht.DhtApp(dht.DhtParams(
                num_replica=4, num_get_requests=4, ratio_identical=0.5,
                test_interval=60.0, test_ttl=300.0, storage_slots=32,
                num_test_keys=16384)),
            lcfg=lookup.LookupConfig(slots=8, merge=True))
        cp = churn.ChurnParams(model="lifetime", target_num=n,
                               init_interval=20.0 / n, init_deviation=0.0,
                               lifetime_mean=1000.0, lifetime_dist="weibull",
                               lifetime_par1=1.0)
    return sim.Simulation(logic, cp, simple.UnderlayParams(jitter=0.0), ep,
                          **kw)


def _hops(out, stat):
    h = out[stat]
    return h["count"], h["count"] * h["mean"] if h["count"] else 0.0


def _ratio(num, den):
    return num / den if den else 0.0


def _mean(cur, prev):
    """A statistic's mean over a window from its (count, sum) pairs."""
    n = cur[0] - prev[0]
    return (cur[1] - prev[1]) / n if n else 0.0


def _np(x):
    import numpy as np
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def coverage_den(sim, s, seq0):
    """Scribe's coverage denominator (``chip_smoke.scribe_coverage``):
    the window's publishes (``seq`` since ``seq0``) times the READY
    members of the publisher's group."""
    import numpy as np
    app = s.logic.app
    group = _np(app.group)
    ready = _np(s.alive) & _np(sim.logic.ready_mask(s.logic)) & (group >= 0)
    grp = np.maximum(group, 0)
    members = np.bincount(grp[ready], minlength=sim.logic.app.p.num_groups)
    pubs = _np(app.seq).astype(np.int64) - seq0
    return int((pubs * members[grp] * (group >= 0)).sum())


def window_line(pkg, scenario, n, sim, s, out, d, cur, prev, end):
    """One window's line in the scenario's format."""
    head = {"side": pkg}
    if scenario == "chord":
        hc = cur["hops"][0] - prev["hops"][0]
        return {**head, "n": n, "window_end_s": end, "t_sim": out["_t_sim"],
                "ticks": out["_ticks"], **d,
                "delivery": _ratio(d["kbr_delivered"], d["kbr_sent"]),
                "lookup_hops_mean": round((cur["hops"][1] - prev["hops"][1])
                                          / hc, 6) if hc else None,
                "pool_overflow": out["_engine"]["pool_overflow"],
                "outbox_overflow": out["_engine"]["outbox_overflow"]}
    if scenario == "dht":
        return {**head, "n": n, "window_end_s": end, "t_sim": out["_t_sim"],
                "ticks": out["_ticks"], "alive": out["_alive"], **d,
                "put_success_ratio": _ratio(d["dht_put_success"],
                                            d["dht_put_attempts"]),
                "get_success_ratio": _ratio(d["dht_get_success"],
                                            d["dht_get_attempts"]),
                "ring_cursor": int(s.logic.app_glob.cursor),
                "pool_overflow": out["_engine"]["pool_overflow"],
                "outbox_overflow": out["_engine"]["outbox_overflow"]}
    if scenario in ALM:
        ready = s.alive & sim.logic.ready_mask(s.logic)
        n_ready = int(ready.sum())
        line = {**head, "scenario": scenario, "n": n, "window_end_s": end,
                "t_sim": out["_t_sim"], "ticks": out["_ticks"], **d,
                "ready_share": n_ready / max(1, int(s.alive.sum())),
                "pool_overflow": out["_engine"]["pool_overflow"],
                "outbox_overflow": out["_engine"]["outbox_overflow"]}
        if scenario in ("scribe", "simmud"):
            line["coverage"] = _ratio(d["alm_received"], coverage_den(
                sim, s, prev["seq"]))
            line["hops_mean"] = _mean(cur["hops"], prev["hops"])
            line["latency_mean_s"] = _mean(cur["lat"], prev["lat"])
        if scenario == "nice":
            n_l = cur["layers"][0] - prev["layers"][0]
            line.update({
                "coverage": _ratio(d["nice_recv"],
                                   d["nice_pub"] * (n_ready - 1)),
                "duplicate_share": _ratio(d["nice_dup"],
                                          d["nice_recv"] + d["nice_dup"]),
                "layers_mean": (cur["layers"][1] - prev["layers"][1]) / n_l
                if n_l else 0.0})
        return line
    if scenario in GAME:
        st = s.logic
        ready = s.alive & (st.state == 2)
        n_ready = int(ready.sum())
        deg = (st.nbr >= 0).sum(1)
        line = {**head, "scenario": scenario, "n": n, "window_end_s": end,
                "t_sim": out["_t_sim"], "ticks": out["_ticks"], **d,
                "ready_share": n_ready / max(1, int(s.alive.sum())),
                "degree_sum_ready": int(deg[ready].sum()),
                "pool_overflow": out["_engine"]["pool_overflow"],
                "outbox_overflow": out["_engine"]["outbox_overflow"]}
        if scenario == "gia":
            n_h = cur["hops"][0] - prev["hops"][0]
            n_l = cur["lat"][0] - prev["lat"][0]
            p = sim.logic.p
            line.update({
                "success_ratio": _ratio(d["gia_search_success"],
                                        d["gia_searches"]),
                "walk_bound": (p.search_ttl + 1) * (p.max_neighbors + 1)
                / max(1, n_ready - 1),
                "hop_mean": (cur["hops"][1] - prev["hops"][1]) / n_h
                if n_h else 0.0,
                "latency_mean_s": (cur["lat"][1] - prev["lat"][1]) / n_l
                if n_l else 0.0})
        return line
    n_h = cur["hops"][0] - prev["hops"][0]
    extra = {}
    if scenario == "epichord":
        ready = s.logic.state == 2
        n_ready = int(ready.sum())
        extra = {"ready_share": n_ready / max(1, int(s.alive.sum())),
                 "cache_live_per_ready": float(
                     ((s.logic.cache >= 0) & ready[:, None]).sum())
                 / max(1, n_ready)}
    elif scenario == "inet":
        n_l = cur["lat"][0] - prev["lat"][0]
        extra = {"latency_mean_s": (cur["lat"][1] - prev["lat"][1]) / n_l
                 if n_l else 0.0}
    return {**head, "scenario": scenario, "n": n, "slots": sim.n, **extra,
            "window_end_s": end, "t_sim": out["_t_sim"],
            "ticks": out["_ticks"], **d,
            "delivery": _ratio(d["kbr_delivered"], d["kbr_sent"]),
            "hop_mean": (cur["hops"][1] - prev["hops"][1]) / n_h
            if n_h else 0.0,
            "hop_hist": [a - b for a, b in zip(cur["hist"], prev["hist"])],
            "alive": out["_alive"],
            "pool_overflow": out["_engine"]["pool_overflow"],
            "outbox_overflow": out["_engine"]["outbox_overflow"]}


def windows(pkg, scenario, n, seed, ends, width, device, inbox_slots=16):
    """Yield one dict per window (end - width, end]."""
    fields = SCENARIOS[scenario][0]
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
        cur = {"cnt": {k: int(out[k]) for k in fields}}
        if scenario == "chord":
            c = int(out["lookup_hops"]["count"])
            cur["hops"] = (c, float(out["lookup_hops"]["mean"]) * c
                           if c else 0.0)
        elif scenario == "gia":
            cur["hops"] = _hops(out, "gia_search_hops")
            cur["lat"] = _hops(out, "gia_search_latency_s")
        elif scenario == "nice":
            cur["layers"] = _hops(out, "nice_layers")
        elif scenario in ("scribe", "simmud"):
            cur["seq"] = _np(s.logic.app.seq).astype("int64")
            cur["hops"] = _hops(out, "alm_hops")
            cur["lat"] = _hops(out, "alm_latency_s")
        elif scenario not in GAME + ALM + ("dht",):
            cur["hops"] = _hops(out, "kbr_hopcount")
            cur["hist"] = out["kbr_hop_hist"]
            cur["lat"] = _hops(out, "kbr_latency_s")
        if t in ends and prev is not None and prev[0] == t - width:
            d = {k: cur["cnt"][k] - prev[1]["cnt"][k] for k in fields}
            yield window_line(pkg, scenario, n, sim, s, out, d, cur,
                              prev[1], t)
        prev = (t, cur)


def _static_timeouts():
    """Every lookup RPC gets the static timeout (the chord diagnostic)."""
    import torch
    from oversim_tpu_torch.common import neighborcache

    def static(nc, default_ns):
        return lambda cands: torch.full_like(cands, default_ns,
                                             dtype=torch.int64)

    neighborcache.adaptive_timeout_fn = static


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="pareto", choices=tuple(SCENARIOS))
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ends", default=None)
    ap.add_argument("--window", type=float, default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--inbox-slots", type=int, default=16)
    ap.add_argument("--side", default="both",
                    choices=("both", "jax", "torch"))
    ap.add_argument("--static-timeouts", action="store_true")
    a = ap.parse_args()
    _, ends_default, window_default = SCENARIOS[a.scenario]
    a.ends = a.ends or ends_default
    a.window = window_default if a.window is None else a.window
    ends = [float(x) for x in a.ends.split(",")]
    if a.static_timeouts:
        if a.scenario != "chord":
            raise SystemExit("--static-timeouts is a chord diagnostic")
        sys.path.insert(0, ROOT)
        _static_timeouts()
        for line in windows("torch", a.scenario, a.n, a.seed, ends,
                            a.window, a.device, a.inbox_slots):
            print(json.dumps(dict(line, side="torch_static_timeouts")),
                  flush=True)
        return 0
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
    keys = [k for k in mine[0] if k not in ("side", "t_sim")]

    def same(k, x, y):
        # a float64 statistics sum agrees to about 1e-15 (ROADMAP Queue C)
        if k in ("latency_mean_s", "hop_mean", "hops_mean", "layers_mean"):
            return abs(x - y) <= 1e-12 * max(abs(x), abs(y))
        return x == y

    bad = [(x["window_end_s"], k) for x, y in zip(mine, theirs)
           for k in keys if not same(k, x[k], y[k])]
    print(json.dumps({"equal": not bad, "differences": bad[:10]}))
    gate = [x for x in theirs if x["window_end_s"] == NICE_GATE_END]
    if a.scenario == "nice" and gate:
        print(json.dumps({"reference_window": [NICE_GATE_END - a.window,
                                               NICE_GATE_END],
                          "coverage": gate[0]["coverage"]}))
    gate = [x for x in theirs if x["window_end_s"] == SCRIBE_GATE_END]
    if a.scenario == "scribe" and gate:
        print(json.dumps({"reference_window": [SCRIBE_GATE_END - a.window,
                                               SCRIBE_GATE_END],
                          "alm_published": gate[0]["alm_published"],
                          "alm_received": gate[0]["alm_received"],
                          "coverage": gate[0]["coverage"]}))
    gate = [x for x in theirs if x["window_end_s"] == DHT_GATE_END]
    if a.scenario == "dht" and gate:
        print(json.dumps({"reference_window": [DHT_GATE_END - a.window,
                                               DHT_GATE_END],
                          "put_success_ratio": gate[0]["put_success_ratio"],
                          "get_success_ratio": gate[0]["get_success_ratio"]}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
