#!/usr/bin/env python3
"""Where the DHT's records live, against where its gets look for them.

    python3 scripts/torch_dht_replicas.py [--n 1000] [--t 110] [--seed 1]
        [--device cpu] [--sample 400]

Runs chip_smoke.py's ``dht_path`` configuration (Kademlia + DHT under
LifetimeChurn, 2 n slots) in the port with ``init_deviation = jitter =
0`` to ``--t`` simulated seconds, then prints one JSON line:

* ``replicas_holding``: for up to ``--sample`` live truth-map keys, how
  many of the key's 4 closest live READY nodes by XOR distance (its
  true replica set) store the key with its current value (a histogram
  over 0-4), and the mean count of live nodes holding the key at all;
* ``sibling_tables``: for up to ``--sample`` live READY nodes, how many
  of their true 8 closest live READY nodes their sibling table holds (a
  histogram over 0-8);
* the run's cumulative DHT counters.

A get succeeds when at least half of the 4 nodes its lookup returns
hold the record, so both histograms bound the get success ratio that
``scripts/torch_pareto_health.py --scenario dht`` prints.  A diagnostic
of the port alone: the parity tests hold it to the JAX package.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def top64(k):
    """The top two u32 lanes of ``[..., KL]`` keys as uint64 (the order
    the DHT ranks distances by)."""
    return (k[..., 0].astype(np.uint64) << np.uint64(32)) | \
        k[..., 1].astype(np.uint64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--t", type=float, default=110.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--sample", type=int, default=400)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    sim = chip_smoke.dht_sim(a.n, torch.device(a.device), "scatter",
                             deviation=0.0, jitter=0.0)
    s = sim.run_until(sim.init(a.seed), a.t, chunk=25)
    keys = s.node_keys.cpu().numpy()
    up = s.alive.cpu().numpy() & (s.logic.state.cpu().numpy() == 2)
    glob = s.logic.app_glob
    gv, ge = glob.val.cpu().numpy(), glob.expire.cpu().numpy()
    gk = glob.keys.cpu().numpy()
    sk, sv = s.logic.app.s_key.cpu().numpy(), s.logic.app.s_val.cpu().numpy()
    far = np.uint64(2 ** 64 - 1)
    live = np.where((gv != -1) & (ge > int(s.t_now)))[0][:a.sample]
    held, holders = [], []
    for g in live:
        d = np.where(up, top64(keys ^ gk[g]), far)
        closest = np.argsort(d, kind="stable")[:4]
        has = np.all(sk == gk[g], -1) & (sv != -1)
        held.append(int(sum((has[i] & (sv[i] == gv[g])).any()
                            for i in closest)))
        holders.append(int(has.any(-1)[up].sum()))
    sib = s.logic.sib.cpu().numpy()
    tables = []
    for i in np.where(up)[0][:a.sample]:
        d = np.where(up, top64(keys ^ keys[i]), far)
        d[i] = far
        true8 = set(np.argsort(d, kind="stable")[:8].tolist())
        tables.append(len(true8 & set(sib[i][sib[i] >= 0].tolist())))
    out = sim.summary(s)
    print(json.dumps({
        "n": a.n, "slots": sim.n, "t_sim": out["_t_sim"],
        "up": int(up.sum()), "live_keys": int(len(live)),
        "replicas_holding": np.bincount(held, minlength=5).tolist(),
        "mean_live_holders": float(np.mean(holders)) if holders else None,
        "sibling_tables": np.bincount(tables, minlength=9).tolist(),
        **{k: out[k] for k in out if k.startswith("dht_")
           and not k.endswith("_s")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
