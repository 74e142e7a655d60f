#!/usr/bin/env python3
"""Koorde's and Broose's KBRTest windows over a long run, on the card.

    python3 scripts/torch_db_windows.py [--overlays koorde,broose]
        [--n 10000] [--until 90] [--window 5] [--device cuda]

Runs ``chip_smoke.db_sim`` (the ``koorde_path`` / ``broose_path``
scenario: NoChurn over a 20 s ramp, KBRTest at 0.2 s, the chip's engine
and the kernels) to ``--until`` simulated seconds and prints, per
``--window`` seconds from the end of the ramp, the KBRTest sends,
deliveries and wrong-node deliveries, the failed lookups, the delivery
ratio and the alive population: where each overlay's delivery settles
and whether its wrong-node deliveries stop.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("kbr_sent", "kbr_delivered", "kbr_wrong_node", "lookup_failed")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--overlays", default="koorde,broose")
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--until", type=float, default=90.0)
    ap.add_argument("--window", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke
    dev = torch.device(a.device)
    for overlay in a.overlays.split(","):
        sim = chip_smoke.db_sim(overlay, a.n, dev, "pallas")
        s = sim.init(chip_smoke.SEED)
        prev, t0, end = None, time.perf_counter(), 20.0
        while end <= a.until:
            s = sim.run_until_device(s, end, chunk=chip_smoke.CHUNK)
            out = sim.summary(s)
            cur = {k: out[k] for k in FIELDS}
            if prev is not None:
                d = {k: cur[k] - prev[k] for k in FIELDS}
                print(json.dumps({
                    "overlay": overlay, "n": a.n,
                    "window_s": [end - a.window, end], **d,
                    "delivery": d["kbr_delivered"] / d["kbr_sent"]
                    if d["kbr_sent"] else 0.0,
                    "alive": out["_alive"],
                    "wall_s": round(time.perf_counter() - t0, 1)}),
                    flush=True)
            prev = cur
            end += a.window
    return 0


if __name__ == "__main__":
    sys.exit(main())
