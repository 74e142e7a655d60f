#!/usr/bin/env python3
"""Where a tier-1 run's time goes, and what one JAX program costs.

As a pytest plugin (``scripts`` on ``PYTHONPATH``, ``-p
torch_tier1_profile``, log file in ``$TIER1_PROFILE_LOG``) it writes one
JSON line per test (xdist worker, node id, start and end) and one per
``tests/test_torch_engine.py JaxCall`` (the JAX interpreter's wall and
CPU seconds, and how long the test waited for it):

    TIER1_PROFILE_LOG=t1.jsonl PYTHONPATH=scripts:tests JAX_PLATFORMS=cpu \\
        python -m pytest tests/ -q -p xdist -n 6 --dist loadfile \\
        -p torch_tier1_profile ...
    python3 scripts/torch_tier1_profile.py summary t1.jsonl

``summary`` prints each worker's files (over 30 s) in order, the files
that end last and the JAX interpreters' CPU, largest first.

    python3 scripts/torch_tier1_profile.py jax-cost test_torch_pastry semi

traces, lowers and compiles each named run's JAX tick (``jax_sim(name)``
of the test module, one ``run_chunk`` tick), then runs the module's
ticks for it, with the suite's XLA flags and again with
``tests/test_torch_engine.py``'s ``JAX_XLA_FLAGS`` (each in a fresh
interpreter), printing wall and CPU seconds per stage and a hash of the
final leaves: equal hashes mean the same leaves.
"""

import json
import os
import resource
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _log(rec):
    with open(os.environ.get("TIER1_PROFILE_LOG", "tier1_profile.jsonl"),
              "a") as f:
        f.write(json.dumps(rec) + "\n")


# -- the pytest plugin ----------------------------------------------------

def pytest_configure(config):
    import test_torch_engine as te
    init, result = te.JaxCall.__init__, te.JaxCall.result

    def timed_init(self, module, func, **kw):
        self._profile = (module, func, time.time())
        init(self, module, func, **kw)

    def timed_result(self):
        t0 = time.time()
        r0 = resource.getrusage(resource.RUSAGE_CHILDREN)
        out = result(self)
        r1 = resource.getrusage(resource.RUSAGE_CHILDREN)
        module, func, started = self._profile
        _log({"jax": [module, func], "wall_s": round(time.time() - started,
                                                     1),
              "waited_s": round(time.time() - t0, 1),
              "cpu_s": round(r1.ru_utime + r1.ru_stime - r0.ru_utime
                             - r0.ru_stime, 1)})
        return out

    te.JaxCall.__init__, te.JaxCall.result = timed_init, timed_result


def pytest_runtest_protocol(item, nextitem):
    item._profile_t0 = time.time()


def pytest_runtest_makereport(item, call):
    if call.when == "teardown":
        _log({"w": os.environ.get("PYTEST_XDIST_WORKER", "main"),
              "id": item.nodeid, "t0": item._profile_t0,
              "t1": time.time()})


# -- the commands ---------------------------------------------------------

def summary(path):
    rows = [json.loads(line) for line in open(path)]
    tests = [r for r in rows if "id" in r]
    t0 = min(r["t0"] for r in tests)
    files = {}
    for r in sorted(tests, key=lambda r: r["t0"]):
        f = r["id"].split("::")[0].rsplit("/", 1)[-1]
        d = files.setdefault(f, {"w": r["w"], "start": r["t0"] - t0,
                                 "end": r["t1"] - t0})
        d["end"] = max(d["end"], r["t1"] - t0)
    for w in sorted({d["w"] for d in files.values()}):
        mine = sorted((d["start"], d["end"], f) for f, d in files.items()
                      if d["w"] == w)
        print(w, "ends", round(mine[-1][1]), " ".join(
            f"{f}[{s:.0f}-{e:.0f}]" for s, e, f in mine if e - s > 30))
    print("last to end:")
    for f, d in sorted(files.items(), key=lambda x: -x[1]["end"])[:10]:
        print(f"  {f} {d['w']} {d['start']:.0f}-{d['end']:.0f}")
    jax = [r for r in rows if "jax" in r]
    print("JAX interpreters' CPU s:", round(sum(r["cpu_s"] for r in jax)))
    for r in sorted(jax, key=lambda r: -r["cpu_s"])[:15]:
        print("  ", r)


_COST = r"""
import hashlib, importlib, json, resource, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import conftest
import jax
import numpy as np
from test_torch_engine import own
mod = importlib.import_module(sys.argv[3])
for name in sys.argv[4].split(","):
    ru = resource.getrusage(resource.RUSAGE_SELF)
    sim = mod.jax_sim(name)
    a = own(sim.init(seed=3))
    t = [time.time()]
    traced = type(sim).run_chunk.trace(sim, a, 1)
    t.append(time.time())
    lowered = traced.lower()
    t.append(time.time())
    lowered.compile()
    t.append(time.time())
    spec = mod.RUNS[name]
    ticks = max(spec[-1]) if isinstance(spec, tuple) else spec
    for _ in range(ticks):
        a = sim.run_chunk(a, 1)
    a.t_now.block_until_ready()
    t.append(time.time())
    ru2 = resource.getrusage(resource.RUSAGE_SELF)
    h = hashlib.sha256()
    for _, v in jax.tree_util.tree_flatten_with_path(a)[0]:
        h.update(np.asarray(v).tobytes())
    print(json.dumps({"run": name, "ticks": ticks,
                      "trace_s": round(t[1] - t[0], 1),
                      "lower_s": round(t[2] - t[1], 1),
                      "compile_s": round(t[3] - t[2], 1),
                      "run_s": round(t[4] - t[3], 1),
                      "cpu_s": round(ru2.ru_utime + ru2.ru_stime
                                     - ru.ru_utime - ru.ru_stime, 1),
                      "leaves_sha256": h.hexdigest()[:16]}), flush=True)
"""


def jax_cost(module, names):
    sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]
    from test_torch_engine import JAX_XLA_FLAGS
    for flags in ("", JAX_XLA_FLAGS):
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
        print(json.dumps({"extra_xla_flags": flags}), flush=True)
        subprocess.run([sys.executable, "-c", _COST,
                        os.path.join(ROOT, "tests"), ROOT, module, names],
                       env=env, check=True)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "summary":
        summary(sys.argv[2])
        return 0
    if len(sys.argv) >= 4 and sys.argv[1] == "jax-cost":
        jax_cost(sys.argv[2], sys.argv[3])
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
