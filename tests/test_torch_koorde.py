"""Koorde + KBRTest on both packages, leaf-exact at 160-bit keys.

The runs (every SimState leaf compared, float32 included, tolerance 0)
use 12 target nodes under LifetimeChurn (lifetime mean 8 s, 1 s graceful
leave), ``EngineParams(window=0.1, inbox_slots=4, pool_factor=4)``,
KBRTest's one-way and RPC tests every 1 s, Koorde's default parameters
and ``init_deviation = jitter = 0`` (the engine's normal draws, where
PyTorch's erfinv cannot match XLA's bit for bit):

(a) iterative lookups from a fresh start, 100 ticks;
(b) the JAX state at 25 ticks of (a) carried into the port for 75 more;
(c) semi-recursive routing with per-hop ACKs (the de Bruijn route key and
    step ride the head of the routed message's node list), 100 ticks.

Inside the compared ticks each run shows, on the port's side, that a de
Bruijn lookup (purpose ``P_DEBRUIJN``) completed and set the pointer, that
a FindNode response handed a lookup an updated extension, that a de
Bruijn pointer whose node failed was replaced, and that KBRTest messages
were delivered.  The JAX programs run one after another in one fresh
interpreter (``JaxCall``; test_torch_engine.py says why) while the port
steps.
"""

import contextlib

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay import koorde as tko
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import first_difference
from test_torch_pastry import (EP, LIFETIME, SEED, at, finish,
                               jax_leaves_at, start_jax)

torch.set_num_threads(1)

# run name -> (routing mode, ticks kept)
RUNS = {"iter": (None, (0, 25, 100)), "semi": ("semi", (100,))}


def _logic(pkg, name):
    mode = RUNS[name][0]
    if pkg == "jax":
        from oversim_tpu.apps import kbrtest as kb
        from oversim_tpu.common import route as rt
        from oversim_tpu.core import keys as keys
        from oversim_tpu.overlay import koorde as ko
    else:
        from oversim_tpu_torch.apps import kbrtest as kb
        from oversim_tpu_torch.common import route as rt
        from oversim_tpu_torch.core import keys as keys
        ko = tko
    rcfg = rt.RouteConfig(mode=mode) if mode else None
    app = kb.KbrTestApp(kb.KbrTestParams(test_interval=1.0, rpc_test=True),
                        rcfg=rcfg)
    return ko.KoordeLogic(keys.KeySpec(160), ko.KoordeParams(), app=app,
                          rcfg=rcfg)


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


def jax_koorde_runs(seed, names):
    out = {}
    for name in names:
        out.update(jax_leaves_at(jax_sim(name), seed, RUNS[name][1], name))
    return out


@contextlib.contextmanager
def spies(seen):
    """Count, while the port steps, the de Bruijn resolutions that set a
    pointer and the pointer repairs after a failure."""
    h_failed, on_comp = tko.KoordeLogic._handle_failed, \
        tko.KoordeLogic._on_completion

    def handle_failed(self, ctx, st, me_key, node_idx, failed, now):
        out = h_failed(self, ctx, st, me_key, node_idx, failed, now)
        hit = torch.any(st.db_node[:, None] == failed, 1) & (
            st.db_node != tko.NO_NODE) & (out.db_node != st.db_node)
        seen["repaired"] += int(hit.sum())
        return out

    def on_completion(self, ctx, st, comp, taken, suc_l):
        enr = taken & (comp["purpose"] == tko.P_DEBRUIJN) & suc_l
        seen["resolved"] += int(enr.sum())
        return on_comp(self, ctx, st, comp, taken, suc_l)

    tko.KoordeLogic._handle_failed = handle_failed
    tko.KoordeLogic._on_completion = on_completion
    try:
        yield seen
    finally:
        tko.KoordeLogic._handle_failed = h_failed
        tko.KoordeLogic._on_completion = on_comp


def stepped(sim, s, ticks):
    """Step ``s`` one tick at a time for ``ticks`` ticks: (state, what
    happened inside them)."""
    seen = dict(repaired=0, resolved=0, ext_updated=0)
    with spies(seen):
        for _ in range(ticks):
            p = s.logic.lk
            s = sim.run_chunk(s, 1)
            c = s.logic.lk
            kept = p.active & c.active & (p.gen == c.gen)
            seen["ext_updated"] += int((kept & torch.any(
                p.ext != c.ext, -1)).sum())
    return s, seen


def assert_koorde_worked(sim, state, seen):
    assert seen["resolved"] > 0 and seen["ext_updated"] > 0, seen
    assert seen["repaired"] > 0, seen
    out = sim.summary(state)
    assert out["kbr_delivered"] > 0 and out["kbr_wrong_node"] == 0, out
    assert bool((state.logic.db_node >= 0).any())


@pytest.fixture(scope="module")
def runs():
    calls = start_jax("test_torch_koorde", RUNS, func="jax_koorde_runs")
    port = {}
    for name, (_, ticks) in RUNS.items():
        sim = port_sim(name)
        s0 = sim.init(SEED)
        port[name] = (sim, s0) + stepped(sim, s0, max(ticks))
    return finish(calls, port)


def test_iterative_fresh_start_leaf_exact(runs):
    ref, port = runs
    sim, s0, b, seen = port["iter"]
    assert first_difference(at(ref, "iter", 0), s0) is None
    assert first_difference(at(ref, "iter", 100), b) is None
    assert_koorde_worked(sim, b, seen)
    assert not bool(b.logic.rr.active.any())


def test_carried_state_leaf_exact(runs):
    ref, _ = runs
    sim = port_sim("iter")
    b = interop.state_from_numpy(at(ref, "iter", 25), sim, "cpu")
    assert first_difference(at(ref, "iter", 25), b) is None
    b, seen = stepped(sim, b, 75)
    assert first_difference(at(ref, "iter", 100), b) is None
    assert_koorde_worked(sim, b, seen)


def test_semi_recursive_lifetime_churn_leaf_exact(runs):
    ref, port = runs
    sim, _, b, seen = port["semi"]
    assert first_difference(at(ref, "semi", 100), b) is None
    assert_koorde_worked(sim, b, seen)
    # routed payloads were parked for their ACKs
    assert int(b.logic.rr.gen.sum()) > 0
    assert np.asarray(sim.summary(b)["kbr_hop_hist"]).sum() > 0
