"""Broose + KBRTest on both packages, leaf-exact at 160-bit keys.

The runs (every SimState leaf compared, float32 included, tolerance 0)
use 12 target nodes under LifetimeChurn (lifetime mean 8 s, 1 s graceful
leave), ``EngineParams(window=0.1, inbox_slots=4, pool_factor=4)``,
KBRTest's one-way and RPC tests every 1 s and ``init_deviation = jitter
= 0`` (the engine's normal draws, where PyTorch's erfinv cannot match
XLA's bit for bit), 100 ticks each:

(a) a join machine that finishes inside the run (``joinDelay`` 2 s, a 5 s
    per-state deadline, the same on both sides), iterative lookups: some
    node is seen in each of INIT, RSET, BSET and READY, and KBRTest
    messages are delivered;
(b) Broose's default parameters, iterative;
(c) semi-recursive routing with per-hop ACKs and the join machine of (a):
    the route key, step, direction and last hop ride the head of the
    routed message's node list.

The JAX programs run one after another in one fresh interpreter
(``JaxCall``; test_torch_engine.py says why) while the port steps.
"""

import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay import broose as tbr
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import first_difference
from test_torch_pastry import (EP, LIFETIME, SEED, at, finish,
                               jax_leaves_at, start_jax)

torch.set_num_threads(1)

TICKS = 100
FAST_JOIN = dict(join_delay=2.0, join_state_timeout=5.0)
# run name -> (routing mode, BrooseParams overrides)
RUNS = {"join": (None, FAST_JOIN), "defaults": (None, {}),
        "semi": ("semi", FAST_JOIN)}


def _logic(pkg, name):
    mode, over = RUNS[name]
    if pkg == "jax":
        from oversim_tpu.apps import kbrtest as kb
        from oversim_tpu.common import route as rt
        from oversim_tpu.core import keys as keys
        from oversim_tpu.overlay import broose as br
    else:
        from oversim_tpu_torch.apps import kbrtest as kb
        from oversim_tpu_torch.common import route as rt
        from oversim_tpu_torch.core import keys as keys
        br = tbr
    rcfg = rt.RouteConfig(mode=mode) if mode else None
    app = kb.KbrTestApp(kb.KbrTestParams(test_interval=1.0, rpc_test=True),
                        rcfg=rcfg)
    return br.BrooseLogic(keys.KeySpec(160), br.BrooseParams(**over),
                          app=app, rcfg=rcfg)


def port_sim(name, device="cpu"):
    return tsim.Simulation(_logic("torch", name),
                           tchurn.ChurnParams(**LIFETIME),
                           tul.UnderlayParams(jitter=0.0),
                           tsim.EngineParams(**EP), device=device)


def jax_sim(name):
    from oversim_tpu import churn as jchurn
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.underlay import simple as jul
    return jsim.Simulation(_logic("jax", name), jchurn.ChurnParams(**LIFETIME),
                           jul.UnderlayParams(jitter=0.0),
                           jsim.EngineParams(**EP))


def jax_broose_runs(seed, names):
    out = {}
    for name in names:
        out.update(jax_leaves_at(jax_sim(name), seed, (TICKS,), name))
    return out


def stepped(sim, s, ticks):
    """Step one tick at a time: (state, the join states seen at tick
    ends)."""
    states = set()
    for _ in range(ticks):
        s = sim.run_chunk(s, 1)
        states |= set(s.logic.state[s.alive].tolist())
    return s, states


@pytest.fixture(scope="module")
def runs():
    calls = start_jax("test_torch_broose", RUNS, func="jax_broose_runs")
    port = {}
    for name in RUNS:
        sim = port_sim(name)
        port[name] = (sim,) + stepped(sim, sim.init(SEED), TICKS)
    return finish(calls, port)


def assert_delivered(sim, state):
    out = sim.summary(state)
    assert out["kbr_delivered"] > 0 and out["kbr_wrong_node"] == 0, out
    assert out["broose_joins"] > 0 and out["lookup_success"] > 0, out
    return out


def test_join_machine_leaf_exact(runs):
    ref, port = runs
    sim, b, states = port["join"]
    assert first_difference(at(ref, "join", TICKS), b) is None
    assert {tbr.INIT, tbr.RSET, tbr.BSET, tbr.READY} <= states, states
    assert_delivered(sim, b)
    # the lookups carried their extension words
    assert bool((b.logic.lk.ext != 0).any())


def test_defaults_leaf_exact(runs):
    ref, port = runs
    sim, b, _ = port["defaults"]
    assert first_difference(at(ref, "defaults", TICKS), b) is None
    assert_delivered(sim, b)


def test_semi_recursive_leaf_exact(runs):
    ref, port = runs
    sim, b, _ = port["semi"]
    assert first_difference(at(ref, "semi", TICKS), b) is None
    assert_delivered(sim, b)
    # routed payloads were parked for their ACKs
    assert int(b.logic.rr.gen.sum()) > 0
