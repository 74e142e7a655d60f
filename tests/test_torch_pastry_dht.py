"""DHT + DHTTestApp over Pastry from an ini and a trace, the ini builder,
and the CLI on a Pastry ini.

(a) BASELINE config 3's stack: Pastry + DHT + DHTTestApp built from an
    ini (``**.keyLength = 64``, as test_torch_pastry.py's runs) by both
    packages' ``config/scenario.py build_simulation`` with
    ``chip_smoke.tiny_trace()``'s events (16 JOINs, PUT/GET lines, a
    partition, LEAVEs) and ``EngineParams(window=0.1, inbox_slots=4,
    pool_factor=4)``, normal draws off: 80 ticks, every SimState leaf
    equal, the truth map and storage included.  The DHT is generic over
    the overlay's Common-API update(): Pastry reports the nodes that
    entered its leaf set;
(b) the ini builder: a Pastry and a Bamboo ini build the same simulation
    as the hand-built logic (init and 24 ticks, every leaf equal);
    ``**.routingType`` is in test_torch_routing_type.py;
(c) ``python -m oversim_tpu_torch -f pastry.ini -c C --device cpu
    --json`` runs a Pastry ini.

The JAX run starts in a fresh interpreter at the fixture (test_torch_
engine.py ``fresh_jax_call`` says why) and runs beside the port's.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

import chip_smoke
from oversim_tpu_torch.apps import kbrtest as tkbr
from oversim_tpu_torch.common import lookup as tlk
from oversim_tpu_torch.config import ini as tini
from oversim_tpu_torch.config import scenario as tsc
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay import pastry as tpa
from test_torch_engine import JaxCall, first_difference
from test_torch_pastry import EP, SEED, at, finish, jax_leaves_at

TRACE_INI = ("[Config C]\n**.keyLength = 64\n" + chip_smoke.PASTRY_INI
             + chip_smoke.DHT_INI)
TRACE_TICKS = 80


def _trace_sim(pkg):
    if pkg == "jax":
        from oversim_tpu import trace
        from oversim_tpu.config import ini, scenario
        from oversim_tpu.engine import sim
        kw, events = {}, trace.parse_trace(chip_smoke.tiny_trace())
    else:
        from oversim_tpu_torch import trace
        ini, scenario, sim = tini, tsc, tsim
        kw, events = {"device": "cpu"}, trace.parse_text(
            chip_smoke.tiny_trace())
    s = scenario.build_simulation(
        ini.IniFile.loads(TRACE_INI), "C", engine_params=sim.EngineParams(
            **EP), trace_events=events, **kw)
    s.cp = dataclasses.replace(s.cp, init_deviation=0.0)
    s.up = dataclasses.replace(s.up, jitter=0.0)
    return s


def jax_trace_run(seed, name):
    return jax_leaves_at(_trace_sim("jax"), seed, (TRACE_TICKS,), name)


@pytest.fixture(scope="module")
def trace_run():
    call = JaxCall("test_torch_pastry_dht", "jax_trace_run", seed=SEED,
                   name="trace")
    sim = _trace_sim("torch")
    port = {"trace": (sim, None, sim.run_chunk(sim.init(SEED), TRACE_TICKS))}
    return finish({"trace": call}, port)


def test_ini_built_dht_stack_with_a_trace_leaf_exact(trace_run):
    ref, port = trace_run
    sim, _, b = port["trace"]
    assert type(sim.logic) is tpa.PastryLogic
    assert first_difference(at(ref, "trace", TRACE_TICKS), b) is None
    out = sim.summary(b)
    assert out["_engine"]["partition_lost"] > 0
    assert out["dht_put_attempts"] > 0 and out["dht_get_attempts"] > 0
    assert out["dht_stored"] > 0 and out["pastry_joins"] > 0
    assert bool((b.logic.app.s_val >= 0).any())


KBR_INI = """[Config C]
**.overlayType = "oversim.overlay.{mod}"
**.tier1Type = "oversim.applications.kbrtestapp.KBRTestAppModules"
**.tier1*.kbrTestApp.testMsgInterval = 0.5s
**.targetOverlayTerminalNum = 8
**.initPhaseCreationInterval = 0.1s
**.routingType = "semi-recursive"
"""


@pytest.mark.parametrize("mod", ["pastry.PastryModules",
                                 "bamboo.BambooModules"])
def test_ini_built_pastry_equals_hand_built(mod):
    a = tsc.build_simulation(tini.IniFile.loads(KBR_INI.format(mod=mod)),
                             "C", engine_params=tsim.EngineParams(**EP),
                             device="cpu")
    bamboo = "bamboo" in mod
    cls = tpa.BambooLogic if bamboo else tpa.PastryLogic
    assert type(a.logic) is cls
    logic = cls(params=tpa.PastryParams(num_leaves=8 if bamboo else 16,
                                        join_delay=20),
                lcfg=tlk.LookupConfig(),
                app=tkbr.KbrTestApp(tkbr.KbrTestParams(test_interval=0.5)))
    b = tsim.Simulation(logic, a.cp, a.up, a.ep, device="cpu")
    sa, sb = a.init(SEED), b.init(SEED)
    assert first_difference(chip_smoke.flat_state(sa), sb) is None
    assert first_difference(chip_smoke.flat_state(a.run_chunk(sa, 24)),
                            b.run_chunk(sb, 24)) is None
    # Pastry binds its route config into the app: the duplicate ring
    assert a.logic.app.rcfg is not None and a.logic.app.buf == 8


def test_cli_runs_a_pastry_ini(tmp_path):
    from oversim_tpu_torch.__main__ import main
    path = tmp_path / "pastry.ini"
    path.write_text(KBR_INI.format(mod="pastry.PastryModules"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["-f", str(path), "-c", "C", "--device", "cpu", "--json",
                   "--until", "0.5"])
    rec = json.loads(buf.getvalue().splitlines()[-1])
    assert rc == 0 and rec["_t_sim"] >= 0.5 and rec["_alive"] >= 4
    assert rec["pastry_joins"] > 0
    assert np.isfinite(rec["lookup_hops"]["count"])
