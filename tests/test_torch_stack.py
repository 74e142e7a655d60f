"""The TierStack over Kademlia, the Common-API ``forward()`` veto on the
recursive path, and the connectivity probe, on both packages.

(a) JAX's ``tests/test_stack.py`` stack, ``TierStack(KbrTestApp,
    DhtApp)`` (tests every 20 s, records for 600 s), over Kademlia: 16
    target nodes joining every 0.5 s, ``EngineParams(window=0.2,
    inbox_slots=4, pool_factor=16)``, normal draws off, 200 ticks from a
    fresh start, every SimState leaf equal (tolerance 0); the same stack
    built from an ini by both builders: the JAX builder's simulation has
    the hand-built run's configuration (compared in the JAX
    interpreter) and the port's ini-built simulation steps that run's
    leaves;
(b) an app with a ``forward()`` hook (``VetoKbrTestApp``: KBRTest that
    vetoes every routed hop whose key's low lane is 0 mod 4) over Chord
    semi-recursive (test_torch_route_modes.py's scenario: 12 target under
    LifetimeChurn, one-way and routed RPC tests every 1 s), alone and as
    the first member of ``TierStack(VetoKbrTestApp, BroadcastTestApp)``,
    80 ticks, every leaf equal; the plain run with the veto ignored (the
    port before the repair) diverges;
(c) ``route.prepass`` with a veto against the JAX function (vmapped
    over the node axis) on seeded inputs: the path Broose and EpiChord
    take; Broose, EpiChord and Pastry accept the hook, and EpiChord and
    Pastry (whose own slot loop asks it) drop more routed hops with it
    than without;
(d) the stack's optional hooks mirror its members as the JAX stack's
    do, and ``connectivity_probe`` equals the JAX function on a Vast
    state.

The JAX runs go one after another in one fresh interpreter
(``JaxCall``; test_torch_engine.py says why) while the port steps.
"""

import contextlib
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch.apps import base as tbase
from oversim_tpu_torch.apps import broadcast as tbc
from oversim_tpu_torch.apps import dht as tdht
from oversim_tpu_torch.apps import kbrtest as tkbr
from oversim_tpu_torch.apps import p2pns as tp2
from oversim_tpu_torch.apps import probe as tprobe
from oversim_tpu_torch.apps import scribe as tscribe
from oversim_tpu_torch.apps import stack as tstack
from oversim_tpu_torch.common import lookup as tlk
from oversim_tpu_torch.common import route as trt
from oversim_tpu_torch.common.wire import KBR_ROUTE
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay import broose as tbroose
from oversim_tpu_torch.overlay import chord as tchord
from oversim_tpu_torch.overlay import epichord as tepi
from oversim_tpu_torch.overlay import kademlia as tkad
from oversim_tpu_torch.overlay import pastry as tpastry
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import JaxCall, first_difference
from test_torch_ini_run import zero_normals
from test_torch_pastry import EP as ROUTE_EP
from test_torch_pastry import LIFETIME as ROUTE_CHURN
from test_torch_pastry import SEED, at, finish, jax_leaves_at
from test_torch_route import (NID, _nodes, _same, jbox, jmsg, jrs, msgs,
                              route_state, same_outbox, same_state, tbox,
                              tmsg, trs, MSG_FIELDS, N as RN, R, RMAX)

torch.set_num_threads(1)

TICKS = 200
VETO_TICKS = 80
KBR = dict(test_interval=20.0)
DHT = dict(test_interval=20.0, test_ttl=600.0)
NOCHURN = dict(model="none", target_num=16, init_interval=0.5,
               init_deviation=0.0)
EP = dict(window=0.2, inbox_slots=4, pool_factor=16)
INI = textwrap.dedent("""\
    [General]
    **.overlayType = "oversim.overlay.kademlia.KademliaModules"
    **.targetOverlayTerminalNum = 16
    **.initPhaseCreationInterval = 0.5
    **.tier1Type = "oversim.applications.kbrtestapp.KBRTestAppModules"
    **.tier2Type = "oversim.applications.dht.DHTModules"
    **.tier3Type = "oversim.applications.xmlrpcinterface.XmlRpcInterfaceModules"
    **.tier1.kbrTestApp.testMsgInterval = 20s
    **.tier2.dhtTestApp.testInterval = 20s
    **.tier2.dhtTestApp.testTtl = 600s
    """)


def veto(msgs):
    """The test's forward() veto: routed hops of keys whose low lane is
    0 mod 4 (elementwise, so it serves both packages and any batch)."""
    return msgs.valid & (msgs.key[..., 0] % 4 == 0)


def _pkg(pkg):
    if pkg == "torch":
        return dict(churn=tchurn, kbr=tkbr, dht=tdht, bc=tbc, stack=tstack,
                    lk=tlk, rt=trt, sim=tsim, chord=tchord, kad=tkad,
                    ul=tul, kw={"device": "cpu"})
    from oversim_tpu import churn
    from oversim_tpu.apps import broadcast, dht, kbrtest, stack
    from oversim_tpu.common import lookup, route
    from oversim_tpu.engine import sim
    from oversim_tpu.overlay import chord, kademlia
    from oversim_tpu.underlay import simple
    return dict(churn=churn, kbr=kbrtest, dht=dht, bc=broadcast, stack=stack,
                lk=lookup, rt=route, sim=sim, chord=chord, kad=kademlia,
                ul=simple, kw={})


def veto_app(m, rcfg):
    """``VetoKbrTestApp`` of ``m``'s KbrTestApp with the routed tests."""
    class VetoKbrTestApp(m["kbr"].KbrTestApp):
        def forward(self, app, msgs, ctx):
            return veto(msgs)
    return VetoKbrTestApp(m["kbr"].KbrTestParams(
        test_interval=1.0, rpc_test=True), rcfg=rcfg)


def make_sim(pkg, name):
    m = _pkg(pkg)
    if name == "kad_stack":
        app = m["stack"].TierStack([
            m["kbr"].KbrTestApp(m["kbr"].KbrTestParams(**KBR)),
            m["dht"].DhtApp(m["dht"].DhtParams(**DHT))])
        return m["sim"].Simulation(
            m["kad"].KademliaLogic(app=app), m["churn"].ChurnParams(**NOCHURN),
            m["ul"].UnderlayParams(jitter=0.0), m["sim"].EngineParams(**EP),
            **m["kw"])
    rc = m["rt"].RouteConfig(mode="semi")
    app = veto_app(m, rc)
    if name == "veto_stack":
        app = m["stack"].TierStack([app, m["bc"].BroadcastTestApp(
            m["bc"].BroadcastTestParams(interval=3.0))])
    return m["sim"].Simulation(
        m["chord"].ChordLogic(app=app, rcfg=rc,
                              lcfg=m["lk"].LookupConfig(slots=8)),
        m["churn"].ChurnParams(**ROUTE_CHURN),
        m["ul"].UnderlayParams(jitter=0.0), m["sim"].EngineParams(**ROUTE_EP),
        **m["kw"])


RUNS = {"kad_stack": TICKS, "veto_chord": VETO_TICKS,
        "veto_stack": VETO_TICKS}


def ini_sim(pkg):
    if pkg == "jax":
        from oversim_tpu.config import ini, scenario
        from oversim_tpu.engine import sim
    else:
        from oversim_tpu_torch.config import ini, scenario
        sim = tsim
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return zero_normals(scenario.build_simulation(
        ini.IniFile.loads(INI), "General",
        engine_params=sim.EngineParams(**EP), **kw))


def config_of(sim):
    """Everything that shapes a run of ``sim`` besides the seed."""
    lg = sim.logic
    return repr((type(lg).__name__, lg.key_spec, lg.p, lg.lcfg,
                 [(type(a).__name__, a.p) for a in lg.app.apps], sim.cp,
                 sim.up, sim.ep))


def jax_stack_runs(seed, names):
    out = {}
    for name in names:
        out.update(jax_leaves_at(make_sim("jax", name), seed, (RUNS[name],),
                                 name))
    out["ini_config"] = np.array(int(
        config_of(ini_sim("jax")) == config_of(make_sim("jax", "kad_stack"))))
    return out


@contextlib.contextmanager
def vetoes():
    """Count the routed hops the port's ``forward()`` hooks are asked
    about and veto while the port steps."""
    global veto
    seen = {"asked": 0, "vetoed": 0, "routed_vetoed": 0}
    plain = veto

    def counting(msgs):
        out = plain(msgs)
        seen["asked"] += int(msgs.valid.sum())
        seen["vetoed"] += int(out.sum())
        seen["routed_vetoed"] += int((out & (msgs.kind == KBR_ROUTE)).sum())
        return out

    veto = counting
    try:
        yield seen
    finally:
        veto = plain


@pytest.fixture(scope="module")
def runs():
    calls = {"jax": JaxCall("test_torch_stack", "jax_stack_runs", seed=SEED,
                            names=list(RUNS))}
    port = {}
    for name, ticks in RUNS.items():
        sim = make_sim("torch", name)
        with vetoes() as seen:
            b = sim.run_chunk(sim.init(SEED), ticks)
        port[name] = (sim, b, seen)
    return finish(calls, port)


def test_kademlia_stack_fresh_and_ini_built_leaf_exact(runs):
    ref, port = runs
    sim, b, _ = port["kad_stack"]
    assert first_difference(at(ref, "kad_stack", TICKS), b) is None
    out = sim.summary(b)
    assert out["kbr_delivered"] > 0 and out["dht_put_success"] > 0, out
    assert out["_engine"]["pool_overflow"] == 0, out["_engine"]
    assert int(ref["ini_config"]) == 1
    isim = ini_sim("torch")
    assert isinstance(isim.logic.app, tstack.TierStack)
    assert config_of(isim) == config_of(sim)
    c = isim.run_chunk(isim.init(SEED), TICKS)
    assert first_difference(at(ref, "kad_stack", TICKS), c) is None


@pytest.mark.parametrize("name", ["veto_chord", "veto_stack"])
def test_forward_veto_on_chord_leaf_exact(runs, name, monkeypatch):
    """The vetoing app's run equals the JAX package's, leaf for leaf, with
    hops vetoed and dropped; with the veto ignored, as the port's Chord
    did before, the plain run diverges."""
    ref, port = runs
    sim, b, seen = port[name]
    assert first_difference(at(ref, name, VETO_TICKS), b) is None
    assert seen["routed_vetoed"] > 0 and seen["asked"] > seen["vetoed"], seen
    out = sim.summary(b)
    assert out["kbr_delivered"] > 0 and out["route_dropped"] > 0, out
    if name == "veto_stack":
        assert out["bcast_received"] > 0, out
    if name == "veto_chord":
        monkeypatch.setattr(tbase, "app_veto", lambda *a: None)
        old = make_sim("torch", name)
        old = old.run_chunk(old.init(SEED), VETO_TICKS)
        assert first_difference(at(ref, name, VETO_TICKS), old) is not None


def test_prepass_veto_and_recursive_overlays():
    """``route.prepass`` with a veto equals the JAX function on seeded
    inputs (Broose's and EpiChord's path); Broose, EpiChord and Pastry
    take an app with the hook on their recursive path, and EpiChord and
    Pastry drop more routed hops with it than KBRTest without it."""
    rng = np.random.default_rng(31)
    cj = _pkg("jax")["rt"].RouteConfig()
    ct = trt.RouteConfig()
    st = route_state(rng)
    m = msgs(rng, kinds=(7, 8, 9, 30))
    res = _nodes(rng, (RN, R, RMAX), 0.3)
    sib = rng.random((RN, R)) < 0.3
    ready = rng.random(RN) < 0.9
    jrt = _pkg("jax")["rt"]

    def pre(rt, mm, res, sib, ready, me):
        ob = jbox()
        rt, mm, drop = jrt.prepass(rt, ob, mm, res, sib, ready, me, cj,
                                   forward_veto=veto)
        return rt, mm, drop, ob.finish()

    jst, jm, jdrop, jout = jax.jit(jax.vmap(pre))(
        jrs(st), jmsg(m), jnp.asarray(res), jnp.asarray(sib),
        jnp.asarray(ready), jnp.asarray(NID))
    ob = tbox()
    tst, tm, tdrop = trt.prepass(trs(st), ob, tmsg(m), torch.as_tensor(res),
                                 torch.as_tensor(sib),
                                 torch.as_tensor(ready),
                                 torch.as_tensor(NID), ct,
                                 forward_veto=veto)
    same_state(jst, tst)
    for k in MSG_FIELDS:
        _same(getattr(jm, k), getattr(tm, k))
    assert np.array_equal(np.asarray(jdrop), tdrop.numpy())
    same_outbox(jout, ob)
    # the veto dropped hops the plain pre-pass forwards
    ob = tbox()
    _, _, plain = trt.prepass(trs(st), ob, tmsg(m), torch.as_tensor(res),
                              torch.as_tensor(sib), torch.as_tensor(ready),
                              torch.as_tensor(NID), ct)
    assert int(tdrop.sum()) > int(plain.sum())

    # Broose's pre-pass is the one above; EpiChord and Pastry (its own
    # slot loop) at run level: the vetoing app drops more routed hops
    # than KBRTest without the hook, on the same scenario
    rc = trt.RouteConfig(mode="semi")
    assert tbroose.BrooseLogic(app=veto_app(_pkg("torch"), None), rcfg=rc)
    for cls, kw in ((tepi.EpiChordLogic, {"rcfg": rc}),
                    (tpastry.PastryLogic, {})):     # semi by default
        dropped = []
        for app in (veto_app(_pkg("torch"), None), tkbr.KbrTestApp(
                tkbr.KbrTestParams(test_interval=1.0, rpc_test=True))):
            sim = tsim.Simulation(cls(app=app, **kw),
                                  tchurn.ChurnParams(**ROUTE_CHURN),
                                  tul.UnderlayParams(jitter=0.0),
                                  tsim.EngineParams(**ROUTE_EP), device="cpu")
            with vetoes() as seen:
                b = sim.run_chunk(sim.init(SEED), 60)
            dropped.append(sim.summary(b)["route_dropped"])
            if hasattr(app, "forward"):
                assert seen["routed_vetoed"] > 0, (cls.__name__, seen)
        assert dropped[0] > dropped[1], (cls.__name__, dropped)


def test_stack_hooks_and_connectivity_probe():
    """A stack has an optional hook exactly when the JAX stack of the same
    members has it (the overlays probe with ``hasattr``), and
    ``connectivity_probe`` gives the JAX function's metrics on a Vast
    state with missing neighbors and drift."""
    from oversim_tpu.apps import broadcast as jbc
    from oversim_tpu.apps import dht as jdht
    from oversim_tpu.apps import kbrtest as jkbr
    from oversim_tpu.apps import p2pns as jp2
    from oversim_tpu.apps import probe as jprobe
    from oversim_tpu.apps import scribe as jscribe
    from oversim_tpu.apps import stack as jstack
    hooks = ("on_msg", "on_msgs", "forward", "on_update", "on_tick",
             "route_policy", "on_route_fired", "timer_event",
             "on_lookup_done_batch", "kpi_spec", "rcfg", "dist_fn")
    jm, tm = _pkg("jax"), _pkg("torch")
    for members in (
            lambda s, k, d, b, p: [s.ScribeApp()],
            lambda s, k, d, b, p: [k.KbrTestApp(), d.DhtApp()],
            lambda s, k, d, b, p: [s.ScribeApp(), p.P2pnsApp(num_slots=4),
                                   b.BroadcastTestApp()]):
        js = jstack.TierStack(members(jscribe, jkbr, jdht, jbc, jp2))
        ts = tstack.TierStack(members(tscribe, tkbr, tdht, tbc, tp2))
        assert ([h for h in hooks if hasattr(js, h)]
                == [h for h in hooks if hasattr(ts, h)])
    js = jstack.TierStack([veto_app(jm, None), jbc.BroadcastTestApp()])
    ts = tstack.TierStack([veto_app(tm, None), tbc.BroadcastTestApp()])
    assert ([h for h in hooks if hasattr(js, h)]
            == [h for h in hooks if hasattr(ts, h)])
    assert hasattr(ts, "forward")

    from test_torch_vast import port_sim as vast_sim
    sim = vast_sim("vast_dense")
    b = sim.run_chunk(sim.init(SEED), 60)
    lg = b.logic
    aoi = sim.logic.p.aoi
    want = jprobe.connectivity_probe(
        lg.pos.numpy(), b.alive.numpy(), lg.nbr.numpy(), lg.nbr_pos.numpy(),
        aoi)
    got = tprobe.connectivity_probe(lg.pos, b.alive, lg.nbr, lg.nbr_pos, aoi)
    assert got == want
    assert want["node_count"] > 0 and want["avg_drift"] > 0, want
