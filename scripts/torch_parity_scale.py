#!/usr/bin/env python3
"""The port against the JAX package at a larger N, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_parity_scale.py [--n 1000]
        [--ticks 275] [--every 25]

Steps bench.py's Kademlia + KBRTest configuration (init_deviation=0,
jitter=0, inbox_impl="scatter") tick by tick on both packages with the
test suite's XLA flags, and every ``--every`` ticks prints one JSON line:
the leaves that differ (float64 statistic sums held to 1e-12 relative,
every other leaf exact), the largest relative gap of those sums, and the
engine counters.  Stops at the first differing leaf.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)

import conftest  # noqa: E402,F401  (the suite's XLA flags, x64, CPU)
import numpy as np  # noqa: E402

from oversim_tpu_torch import interop  # noqa: E402
from test_torch_engine import jax_leaves, own  # noqa: E402
from test_torch_kademlia import bench_sims  # noqa: E402


def compare(fa, fb):
    bad, worst = [], 0.0
    for k in sorted(fa):
        x, y = fa[k], fb[k]
        if k.startswith(".stats['s:"):
            ok = (np.array_equal(x[[0, 3, 4]], y[[0, 3, 4]])
                  and np.allclose(x[1:3], y[1:3], rtol=1e-12, atol=0))
            if x[0] > 0:
                rel = np.abs(x[1:3] - y[1:3]) / np.abs(x[1:3])
                worst = max(worst, float(rel.max()))
        else:
            ok = x.dtype == y.dtype and np.array_equal(x, y)
        if not ok:
            bad.append(k)
    return bad, worst


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--ticks", type=int, default=275)
    ap.add_argument("--every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    js, ts = bench_sims("scatter", n=args.n)
    a, b = own(js.init(seed=args.seed)), ts.init(seed=args.seed)
    t0, worst = time.perf_counter(), 0.0
    for t in range(1, args.ticks + 1):
        a = js.run_chunk(a, 1)
        b = ts.step(b)
        if t % args.every and t != args.ticks:
            continue
        bad, w = compare(jax_leaves(a), interop.state_to_numpy(b))
        worst = max(worst, w)
        out = js.summary(a)
        print(json.dumps({
            "tick": t, "t_sim": round(out["_t_sim"], 3), "differ": bad[:5],
            "worst_rel_stat_sum": worst, "engine": out["_engine"],
            "kbr_sent": out["kbr_sent"],
            "kbr_delivered": out["kbr_delivered"],
            "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
        if bad:
            sys.exit(1)


if __name__ == "__main__":
    main()
