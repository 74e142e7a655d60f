"""Chord's three recursive routing modes and KBRTest's recursive hooks on
both packages.

(a) Chord + KBRTest (one-way and routed-RPC tests every 1 s) with
    ``RouteConfig(mode=...)`` for the semi-recursive, full-recursive and
    source-routing modes (verify.ini's ChordSource), 12 target under
    LifetimeChurn (24 slots), ``LookupConfig(slots=8)``,
    ``EngineParams(window=0.1, inbox_slots=4, pool_factor=4)``, normal
    draws off: 80 ticks, every SimState leaf equal.  The routed RPC's
    reply travels direct (semi), routed back to the originator's key
    (full) or source-routed along the request's visited hops (source);
(b) each mode from the JAX state at 60 ticks carried into the port for 8
    more;
KBRTest's duplicate ring and deliver hooks are in
test_torch_kbr_hooks.py.

The JAX runs start in one fresh interpreter at the fixture, one mode
after another, beside the port's.
"""

import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch.apps import kbrtest as tkbr
from oversim_tpu_torch.common import lookup as tlk
from oversim_tpu_torch.common import route as trt
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay.chord import ChordLogic as TChord
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import JaxCall, first_difference
from test_torch_pastry import (EP, LIFETIME, SEED, at, finish,
                               jax_leaves_at)

torch.set_num_threads(1)

MODES = ("semi", "full", "source")
TICKS = 80
CARRY = 60


def _sim(pkg, mode):
    if pkg == "jax":
        from oversim_tpu import churn
        from oversim_tpu.apps import kbrtest as kbr
        from oversim_tpu.common import lookup as lk
        from oversim_tpu.common import route as rt
        from oversim_tpu.engine import sim
        from oversim_tpu.overlay.chord import ChordLogic
        from oversim_tpu.underlay import simple as ul
        kw = {}
    else:
        churn, kbr, lk, rt, sim, ul = tchurn, tkbr, tlk, trt, tsim, tul
        ChordLogic, kw = TChord, {"device": "cpu"}
    rc = rt.RouteConfig(mode=mode)
    app = kbr.KbrTestApp(kbr.KbrTestParams(test_interval=1.0, rpc_test=True),
                         rcfg=rc)
    return sim.Simulation(ChordLogic(app=app, rcfg=rc,
                                     lcfg=lk.LookupConfig(slots=8)),
                          churn.ChurnParams(**LIFETIME),
                          ul.UnderlayParams(jitter=0.0),
                          sim.EngineParams(**EP), **kw)


def jax_mode_runs(seed, names):
    out = {}
    for name in names:
        out.update(jax_leaves_at(_sim("jax", name), seed,
                                 (CARRY, CARRY + 8, TICKS), name))
    return out


@pytest.fixture(scope="module")
def runs():
    calls = {"jax": JaxCall("test_torch_route_modes", "jax_mode_runs",
                            seed=SEED, names=list(MODES))}
    port = {}
    for m in MODES:
        sim = _sim("torch", m)
        port[m] = (sim, sim.run_chunk(sim.init(SEED), TICKS))
    return finish(calls, port)


@pytest.mark.parametrize("mode", MODES)
def test_chord_recursive_mode_leaf_exact(runs, mode):
    ref, port = runs
    sim, b = port[mode]
    assert first_difference(at(ref, mode, TICKS), b) is None
    out = sim.summary(b)
    assert out["kbr_delivered"] > 0 and out["kbr_rpc_success"] > 0, out
    # the routed payloads were parked for their hop ACKs
    assert int(b.logic.rr.gen.sum()) > 0
    assert b.logic.app.seen_src.shape[1] == 8


@pytest.mark.parametrize("mode", MODES)
def test_chord_recursive_mode_carried_state_leaf_exact(runs, mode):
    ref, _ = runs
    sim = _sim("torch", mode)
    b = interop.state_from_numpy(at(ref, mode, CARRY), sim, "cpu")
    assert int(b.logic.rr.gen.sum()) > 0
    b = sim.run_chunk(b, 8)
    assert first_difference(at(ref, mode, CARRY + 8), b) is None
