#!/usr/bin/env python3
"""Is a float64 sum on the card the same from run to run?

    python3 scripts/torch_cumsum_probe.py [--repeats 200]

The port's statistics sum their event arrays as the last element of a
cumulative sum (``stats._seq_sum``: XLA-CPU's row-major order on the
CPU).  On a CUDA tensor ``torch.cumsum`` is a parallel scan.  For each
size this prints how many distinct bit patterns ``repeats`` calls on the
same input give, for ``cumsum(x)[-1]`` and for ``torch.sum(x)``; more
than one means the result depends on the run.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def distinct(fn, x, repeats):
    vals = torch.stack([fn(x) for _ in range(repeats)])
    return len(set(vals.cpu().numpy().view(np.int64).tolist()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("torch_cumsum_probe: needs a CUDA card\n")
        return 2
    rng = np.random.default_rng(0)
    rows = []
    for n in (2_500, 40_000, 160_000, 1_048_576):
        # latency-like values: positive, a few decimal digits of spread
        x = torch.as_tensor(rng.exponential(0.15, size=n), device="cuda")
        rows.append({
            "n": n,
            "cumsum_last_distinct": distinct(
                lambda v: torch.cumsum(v, 0)[-1], x, args.repeats),
            "sum_distinct": distinct(torch.sum, x, args.repeats)})
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "repeats": args.repeats,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
