#!/usr/bin/env python3
"""Whether one torch.profiler session slows the ticks after it, on the card.

    python3 scripts/torch_profile_aftereffect.py [--ticks 25] [--runs 2]

Warms ``chip_smoke.db_sim("koorde", 10000)`` (the ``koorde_path``
scenario on the kernels) to 25 simulated s, then times ``--ticks``
ticks twice, profiles one tick with ``torch.profiler`` (CPU and CUDA
activities, as ``chip_smoke.py``'s profile phases do) and times the
ticks twice more.  Each run is a fresh process, alternately with
``TEARDOWN_CUPTI=0`` and ``=1`` (whether the profiler's CUPTI session is
torn down when it ends), ``--runs`` of each, on the same card; one JSON
line per run with the wall ms per tick before and after the profile.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(ticks):
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke
    from oversim_tpu_torch import kernels
    from torch.profiler import ProfilerActivity, profile
    for name in kernels.SOURCES:
        kernels.library(name)
    dev = torch.device("cuda", 0)
    sim = chip_smoke.db_sim("koorde", 10_000, dev, "pallas")
    s = sim.run_until_device(sim.init(1), 25.0, chunk=chip_smoke.CHUNK)

    def timed(s):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = sim.run_chunk(s, ticks)
        torch.cuda.synchronize()
        return s, (time.perf_counter() - t0) / ticks * 1e3

    before, after = [], []
    for _ in range(2):
        s, ms = timed(s)
        before.append(ms)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        s = sim.run_chunk(s, 1)
        torch.cuda.synchronize()
    for _ in range(2):
        s, ms = timed(s)
        after.append(ms)
    print(json.dumps({"teardown_cupti": os.environ.get("TEARDOWN_CUPTI"),
                      "wall_ms_per_tick_before": before,
                      "wall_ms_per_tick_after_profile": after}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=25)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--child", action="store_true")
    a = ap.parse_args()
    if a.child:
        child(a.ticks)
        return 0
    for _ in range(a.runs):
        for teardown in ("0", "1"):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", "--ticks", str(a.ticks)],
                           env=dict(os.environ, TEARDOWN_CUPTI=teardown),
                           check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
