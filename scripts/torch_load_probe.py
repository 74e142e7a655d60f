#!/usr/bin/env python3
"""Where the port's main path piles up load, on the card.

    python3 scripts/torch_load_probe.py [--n 10000] [--slots R:MOUT ...]

Runs chip_smoke.py's main-path configuration (bench.py's Kademlia +
KBRTest, pool factor 8) once per inbox:outbox slot pair, for 55
simulated seconds on the kernels, and prints one JSON line every 5
simulated seconds: pool occupancy, the most messages due for one
destination, how many destinations have more due than R, the KBRTest
deliveries of the last 5 s, and the engine's loss counters.  Needs a
CUDA card.
"""

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from oversim_tpu_torch.engine import pool as pool_mod  # noqa: E402


def probe(n, r, mout, device):
    sim = chip_smoke.bench_sim(n, device, "pallas", inbox=r, outbox=mout)
    s = sim.init(chip_smoke.SEED)
    prev = sim.summary(s)
    t0 = time.perf_counter()
    for _ in range(11):
        s = sim.run_chunk(s, 25)
        _, t_end, _ = sim._phase_horizon(s)
        due, _ = pool_mod.due_masks(s.pool, sim.n, t_end, s.alive)
        cnt = torch.bincount(
            torch.clamp(s.pool.dst, 0, sim.n - 1).long()[due],
            minlength=sim.n)
        out = sim.summary(s)
        print(json.dumps({
            "n": n, "inbox_slots": r, "outbox_slots": mout,
            "t_sim": round(out["_t_sim"], 3),
            "wall_s": round(time.perf_counter() - t0, 3),
            "pool_valid": int(s.pool.valid.sum()),
            "max_due_per_dst": int(cnt.max()),
            "dsts_over_r": int((cnt > r).sum()),
            "sent_5s": out["kbr_sent"] - prev["kbr_sent"],
            "delivered_5s": out["kbr_delivered"] - prev["kbr_delivered"],
            "engine": out["_engine"]}), flush=True)
        prev = out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=chip_smoke.N_MAIN)
    ap.add_argument("--slots", nargs="+", default=["8:16", "16:16", "16:32"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_load_probe: needs a CUDA card")
    print(chip_smoke.nvidia_smi_line(), flush=True)
    for pair in args.slots:
        r, mout = (int(x) for x in pair.split(":"))
        probe(args.n, r, mout, torch.device("cuda", 0))


if __name__ == "__main__":
    main()
