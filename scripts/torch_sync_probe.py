#!/usr/bin/env python3
"""List the host synchronisations in the PyTorch port's tick on the card.

    python3 scripts/torch_sync_probe.py [--ticks 10]

Runs the sparse tick (the 24-slot lifetime-churn configuration of
tests/test_torch_sparse.py, kernels on) and the dense tick (bench.py's
Kademlia configuration at N=16, kernels on) for a few ticks under
``torch.cuda.set_sync_debug_mode("warn")`` and prints one JSON line per
path: the number of synchronising operations per tick and the port's
source lines that issued them (innermost frame inside the package).  A
tick that the host never waits on has none.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sync_sites(sim, state, ticks):
    """(syncs per tick, {file:line: count}) over ``ticks`` ticks."""
    import torch
    sites = collections.Counter()
    pkg = os.path.join(ROOT, "oversim_tpu_torch")

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if f.filename.startswith(pkg)]
        where = frames[-1] if frames else None
        sites[f"{os.path.relpath(where.filename, ROOT)}:{where.lineno}"
              if where else f"{filename}:{lineno}"] += 1

    torch.cuda.synchronize()
    old = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(ticks):
                state = sim.step(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = old
    torch.cuda.synchronize()
    return sum(sites.values()) / ticks, dict(sites.most_common())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--warm", type=int, default=30)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("torch_sync_probe: needs a CUDA card\n")
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    dev = torch.device("cuda", 0)
    for name, sim in (
            ("sparse", chip_smoke.tiny_sparse_sim(dev, "pallas")),
            ("dense", chip_smoke.bench_sim(16, dev, "pallas", deviation=0.0,
                                           jitter=0.0, inbox=8, outbox=16))):
        s = sim.run_chunk(sim.init(chip_smoke.SEED), args.warm)
        per_tick, sites = sync_sites(sim, s, args.ticks)
        print(json.dumps({"path": name, "ticks": args.ticks,
                          "syncs_per_tick": per_tick, "sites": sites}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
