"""Scribe with ALMTest, P2PNS, BroadcastTestApp and SimMud on both
packages, leaf-exact, and SimMud's regions against the jitted JAX
function.

The runs (every SimState leaf compared, float32 included, tolerance 0)
use 16 target nodes joining every 0.5 s, ``EngineParams(window=0.2,
inbox_slots=4, pool_factor=16)``, 160-bit keys and ``init_deviation =
jitter = 0`` (the engine's normal draws, where PyTorch's erfinv cannot
match XLA's bit for bit):

(a) one ``TierStack(ScribeApp, P2pnsApp, BroadcastTestApp)`` over Chord
    (one JAX program runs the three apps' code and the stack's tag
    multiplexing) under NoChurn on the dense tick, and under
    LifetimeChurn (mean 40 s; a graceful leave hands P2PNS records over) on
    the sparse tick held against the JAX package's sparse tick, from a
    fresh start;
(b) the JAX states at ``CARRY`` ticks carried into the port;
(c) SimMud over Chord (fast movement over a small field, so players
    cross region borders) and its regions on and off every border
    against the jitted JAX ``_region_of``;
(d) the same stack and SimMud built from an ini by the port's builder,
    stepping the JAX runs' leaves; the JAX builder builds SimMud as the
    hand-built run and raises for P2PNS (it passes no ``num_slots``:
    ROADMAP Queue C);
(e) the kernels' plain versions (``inbox_impl="pallas"`` on the CPU)
    against the scatter inbox.

Inside the compared ticks the port's side counts, and the fresh runs
require, Scribe joins (self-roots), subscribe redirects, multicast
receipts, P2PNS registrations, stores, cache hits and resolutions,
broadcasts received, and SimMud's border crossings.  The JAX runs go one
after another in one fresh interpreter (``JaxCall``;
test_torch_engine.py says why) while the port steps.
"""

import contextlib
import textwrap

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch.apps import broadcast as tbc
from oversim_tpu_torch.apps import p2pns as tp2
from oversim_tpu_torch.apps import scribe as tscribe
from oversim_tpu_torch.apps import simmud as tmud
from oversim_tpu_torch.apps import stack as tstack
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay import chord as tchord
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import first_difference
from test_torch_ini_run import zero_normals
from test_torch_pastry import SEED, at, finish, jax_leaves_at, start_jax

torch.set_num_threads(1)

N = 16
TICKS = 200
CARRY = 120
# the dense stack's apps, tuned so that every branch runs in TICKS;
# the sparse stack and SimMud run what the ini builds (the defaults)
TUNED = dict(scribe=dict(num_groups=3, publish_interval=10.0,
                         subscribe_refresh=8.0, child_timeout=20.0,
                         children=2),
             p2pns=dict(resolve_interval=5.0, keepalive=20.0,
                        cache_ttl=30.0, cache_size=2, storage_slots=4),
             broadcast=dict(interval=15.0))
DEFAULT = dict(scribe=dict(num_groups=3), p2pns={}, broadcast={})
NOCHURN = dict(model="none", target_num=N, init_interval=0.5,
               init_deviation=0.0)
LIFETIME = dict(model="lifetime", target_num=N, init_interval=0.5,
                init_deviation=0.0, lifetime_mean=40.0)
EP = dict(window=0.2, inbox_slots=4, pool_factor=16)
# run name -> (apps, churn, tick impl, ticks kept)
RUNS = {"stack_dense": (TUNED, NOCHURN, "dense", (0, CARRY, TICKS)),
        "stack_sparse": (DEFAULT, LIFETIME, "sparse", (0, CARRY, TICKS)),
        "simmud": ("simmud", NOCHURN, "dense", (0, CARRY, TICKS))}
INI = textwrap.dedent("""\
    [General]
    **.overlayType = "oversim.overlay.chord.ChordModules"
    **.targetOverlayTerminalNum = 16
    **.initPhaseCreationInterval = 0.5

    [Config Stack]
    **.churnGeneratorTypes = "oversim.common.LifetimeChurn"
    **.lifetimeMean = 40s
    **.tier1Type = "oversim.applications.almtest.ALMTestModules"
    **.tier2Type = "oversim.tier2.p2pns.P2pnsModules"
    **.tier3Type = "oversim.tier2.broadcasttestapp.BroadcastTestAppModules"
    **.tier2.almTest.groupNum = 3

    [Config SimMud]
    **.tier1Type = "oversim.applications.scribe.ScribeModules"
    **.tier2Type = "oversim.tier2.simmud.SimMudModules"
    """)


def _ep(name, impl="scatter"):
    return dict(EP, tick_impl=RUNS[name][2], inbox_impl=impl)


def _apps(pkg, kind, slots):
    """The run's app from ``pkg``'s modules (a namespace of the
    package's ``scribe``, ``simmud``, ``p2pns``, ``broadcast`` and
    ``stack`` app modules); P2PNS names ``slots`` nodes, as the port's
    ini builder sizes it."""
    if kind == "simmud":
        return pkg.simmud.SimMudApp(pkg.simmud.SimMudParams())
    return pkg.stack.TierStack([
        pkg.scribe.ScribeApp(pkg.scribe.ScribeParams(**kind["scribe"])),
        pkg.p2pns.P2pnsApp(pkg.p2pns.P2pnsParams(**kind["p2pns"]),
                           num_slots=slots),
        pkg.broadcast.BroadcastTestApp(
            pkg.broadcast.BroadcastTestParams(**kind["broadcast"]))])


class _Port:
    scribe, simmud, p2pns, broadcast, stack = tscribe, tmud, tp2, tbc, tstack


def port_sim(name, impl="scatter", device="cpu"):
    kind, cp = RUNS[name][:2]
    cp = tchurn.ChurnParams(**cp)
    return tsim.Simulation(tchord.ChordLogic(app=_apps(_Port, kind,
                                                       cp.num_slots)),
                           cp,
                           tul.UnderlayParams(jitter=0.0),
                           tsim.EngineParams(**_ep(name, impl)),
                           device=device)


def jax_sim(name):
    from oversim_tpu import churn as jchurn
    from oversim_tpu.apps import broadcast, p2pns, scribe, simmud, stack
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.overlay import chord as jchord
    from oversim_tpu.underlay import simple as jul

    class _Jax:
        pass
    for m in (scribe, simmud, p2pns, broadcast, stack):
        setattr(_Jax, m.__name__.rsplit(".", 1)[1], m)
    kind, cp = RUNS[name][:2]
    cp = jchurn.ChurnParams(**cp)
    return jsim.Simulation(jchord.ChordLogic(app=_apps(_Jax, kind,
                                                       cp.num_slots)),
                           cp,
                           jul.UnderlayParams(jitter=0.0),
                           jsim.EngineParams(**_ep(name)))


def ini_sim(pkg, config):
    """``INI``'s ``config`` built by ``pkg``'s builder with the runs'
    engine knobs."""
    if pkg == "jax":
        from oversim_tpu.config import ini, scenario
        from oversim_tpu.engine import sim
    else:
        from oversim_tpu_torch.config import ini, scenario
        sim = tsim
    kw = {} if pkg == "jax" else {"device": "cpu"}
    name = "stack_sparse" if config == "Stack" else "simmud"
    return zero_normals(scenario.build_simulation(
        ini.IniFile.loads(INI), config,
        engine_params=sim.EngineParams(**_ep(name)), **kw))


def region_inputs(seed=5):
    """Positions in SimMud's 1,000-unit field: random, on every region
    border and a float32 step either side of it, and the field's
    edges."""
    rs = np.random.default_rng(seed)
    border = np.arange(0, 1001, 62.5, dtype=np.float32)
    edge = np.stack([border, border[::-1]], -1)
    near = np.float32([500.0, np.nextafter(np.float32(500), 0),
                       np.nextafter(np.float32(500), 1000)])
    return np.concatenate([
        rs.uniform(0, 1000, (2000, 2)).astype(np.float32),
        rs.choice(near, (2000, 2)), edge, np.nextafter(edge, np.float32(0)),
        np.nextafter(edge, np.float32(2000))]).astype(np.float32)


def config_of(sim):
    """Everything that shapes a run of ``sim`` besides the seed."""
    lg = sim.logic
    apps = getattr(lg.app, "apps", (lg.app,))
    return repr((type(lg).__name__, lg.key_spec, lg.p, lg.lcfg,
                 [(type(a).__name__, a.p, getattr(a, "n", None))
                  for a in apps], sim.cp, sim.up, sim.ep))


def jax_regions(pos):
    import jax
    import jax.numpy as jnp
    app = jax_sim("simmud").logic.app
    return np.array(jax.jit(app._region_of)(jnp.asarray(pos)))


def jax_builder_outcomes():
    """1 where the JAX builder's SimMud simulation has the hand-built
    run's configuration; 1 where it raises for P2PNS's ``num_slots``."""
    same = config_of(ini_sim("jax", "SimMud")) == config_of(jax_sim("simmud"))
    try:
        ini_sim("jax", "Stack")
        raises = 0
    except ValueError as e:
        raises = int("num_slots" in str(e))
    return dict(ini_simmud=np.array(int(same)),
                ini_p2pns_raises=np.array(raises))


def jax_scribe_runs(seed, names):
    out = {}
    for name in names:
        out.update(jax_leaves_at(jax_sim(name), seed, RUNS[name][3], name))
    out.update(jax_builder_outcomes())
    out["regions"] = jax_regions(region_inputs())
    return out


COUNTS = {"joins": "c:alm_joins", "redirects": "c:alm_sub_redirects",
          "alm_received": "c:alm_received", "registers": "c:p2pns_registers",
          "stored": "c:p2pns_stored", "cache_hits": "c:p2pns_cache_hits",
          "resolved": "c:p2pns_resolve_success",
          "bcast_received": "c:bcast_received"}
BRANCHES = {"stack_dense": tuple(COUNTS),
            "stack_sparse": ("joins", "alm_received", "registers", "stored",
                             "bcast_received"),
            "simmud": ("joins", "alm_received", "crossings")}
CARRIED = {"stack_dense": ("alm_received", "registers", "bcast_received"),
           "stack_sparse": ("alm_received",), "simmud": ("alm_received",)}


@contextlib.contextmanager
def spies():
    """Count, while the port steps, the apps' events (``COUNTS``) and
    SimMud's border crossings."""
    seen = dict.fromkeys(tuple(COUNTS) + ("crossings",), 0)
    step = tchord.ChordLogic.step

    def spy(self, ctx, st, msgs, rng, node_idx, **kw):
        before = getattr(st.app, "region_moves", None)
        out = step(self, ctx, st, msgs, rng, node_idx, **kw)
        for k, name in COUNTS.items():
            if name in out[2]:
                seen[k] += int(out[2][name].sum())
        if before is not None:
            seen["crossings"] += int(
                (out[0].app.region_moves - before).sum())
        return out

    tchord.ChordLogic.step = spy
    try:
        yield seen
    finally:
        tchord.ChordLogic.step = step


def stepped(sim, s, ticks):
    with spies() as seen:
        for _ in range(ticks):
            s = sim.run_chunk(s, 1)
    return s, seen


def assert_worked(name, sim, state, seen, want=BRANCHES):
    missing = [k for k in want[name] if seen[k] <= 0]
    assert not missing, (name, missing, seen)
    eng = sim.summary(state)["_engine"]
    assert eng["pool_overflow"] == 0 and eng["outbox_overflow"] == 0, eng


@pytest.fixture(scope="module")
def runs():
    calls = start_jax("test_torch_scribe", RUNS, func="jax_scribe_runs")
    port = {}
    for name in RUNS:
        sim = port_sim(name)
        s0 = sim.init(SEED)
        port[name] = (sim, s0) + stepped(sim, s0, TICKS)
    return finish(calls, port)


@pytest.mark.parametrize("name", list(RUNS))
def test_fresh_start_leaf_exact(runs, name):
    ref, port = runs
    sim, s0, b, seen = port[name]
    assert first_difference(at(ref, name, 0), s0) is None, name
    assert first_difference(at(ref, name, TICKS), b) is None, name
    assert_worked(name, sim, b, seen)


def test_carried_state_leaf_exact(runs):
    ref, _ = runs
    for name in RUNS:
        sim = port_sim(name)
        b = interop.state_from_numpy(at(ref, name, CARRY), sim, "cpu")
        b, seen = stepped(sim, b, TICKS - CARRY)
        assert first_difference(at(ref, name, TICKS), b) is None, name
        assert_worked(name, sim, b, seen, want=CARRIED)


def test_ini_built_and_regions_leaf_exact(runs):
    """The port's ini-built stack and SimMud have the hand-built runs'
    configurations and step the JAX runs' leaves; SimMud's regions of
    positions on and off every border equal the jitted JAX
    ``_region_of`` (a multiply by the region width's float32
    reciprocal, as XLA compiles the division)."""
    ref, port = runs
    assert int(ref["ini_simmud"]) == 1
    assert int(ref["ini_p2pns_raises"]) == 1
    for config, name in (("Stack", "stack_sparse"), ("SimMud", "simmud")):
        sim = ini_sim("torch", config)
        assert config_of(sim) == config_of(port[name][0]), config
        b = sim.run_chunk(sim.init(SEED), TICKS)
        assert first_difference(at(ref, name, TICKS), b) is None, config

    got = tmud.region_of(torch.from_numpy(region_inputs()),
                         port["simmud"][0].logic.app.p).numpy()
    np.testing.assert_array_equal(got, ref["regions"])


def test_kernel_plain_versions_match_scatter(runs):
    """The kernels' plain versions (the CPU half of ``inbox_impl=
    "pallas"``: inbox selection, payload gather, pool allocation and,
    on the sparse tick, the active-set compaction) step every leaf as
    the scatter inbox does."""
    _, port = runs
    for name in ("stack_dense", "stack_sparse"):
        _, s0, b, _ = port[name]
        c = port_sim(name, impl="pallas").run_chunk(s0, TICKS)
        fb, fc = interop.state_to_numpy(b), interop.state_to_numpy(c)
        bad = [k for k in fb if not np.array_equal(fb[k], fc[k])]
        assert not bad, (name, bad[:5])
