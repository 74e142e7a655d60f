#!/usr/bin/env python3
"""Count where ``xlamath.pow`` and ``torch.pow`` differ from the C
library's ``pow`` (which XLA-CPU calls for float64 ``jnp.power``) on
ParetoChurn's inputs: ``u`` uniform in [1e-12, 1) at the exponents -1/3
(the schedule's alpha 3), -1/2 (the residual draws' alpha 2) and -2/3
(``pareto_shifted`` at ``lifetimeDistPar1 = 1.5``).  Python's
``math.pow`` is the C library's.  Torch only, on the CPU.

    python3 scripts/torch_pow_probe.py [draws per exponent, default 12e6]
"""

import math
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from oversim_tpu_torch import xlamath  # noqa: E402


def main():
    n = int(float(sys.argv[1])) if len(sys.argv) > 1 else 12_000_000
    rng = np.random.default_rng(7)
    for y in (-1 / 3, -1 / 2, -2 / 3):
        u = np.maximum(rng.random(n), 1e-12)
        t0 = time.perf_counter()
        got = xlamath.pow(torch.from_numpy(u), y).numpy()
        secs = time.perf_counter() - t0
        want = np.fromiter((math.pow(v, y) for v in u), np.float64, n)
        plain = torch.pow(torch.from_numpy(u), y).numpy()
        print({"exponent": y, "draws": n,
               "xlamath_pow_mismatches": int(np.sum(got != want)),
               "torch_pow_mismatches": int(np.sum(plain != want)),
               "xlamath_pow_cpu_s": round(secs, 3)}, flush=True)


if __name__ == "__main__":
    main()
