#!/usr/bin/env python3
"""Wall time per tick of the port's dense main path, for A/B runs.

    python3 scripts/torch_tick_ab.py --root DIR [--ticks 25]

Imports ``oversim_tpu_torch`` and ``chip_smoke`` from the checkout DIR (so
two commits can be compared in one call on one card: run parent, change,
change, parent), builds the kernels there, runs ``chip_smoke.bench_sim``
at N=10,000 with the kernels to 45 simulated s and then times ``--ticks``
ticks with the host clock after a device synchronisation.  Prints one
JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--ticks", type=int, default=25)
    ap.add_argument("--n", type=int, default=10_000)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("torch_tick_ab: needs a CUDA card\n")
        return 2
    import chip_smoke
    from oversim_tpu_torch import kernels
    kernels.build_all()
    dev = torch.device("cuda", 0)
    sim = chip_smoke.bench_sim(args.n, dev, "pallas")
    s = sim.run_until_device(sim.init(chip_smoke.SEED), chip_smoke.WARM_S,
                             chunk=chip_smoke.CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = sim.run_chunk(s, args.ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(json.dumps({"root": args.root, "n": args.n, "ticks": args.ticks,
                      "wall_ms_per_tick": wall * 1e3 / args.ticks,
                      "t_sim": float(s.t_now) / 1e9}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
