"""NTree over Chord and MyOverlay on both packages, leaf-exact, and the
one-slot app dispatch (``apps/base.py on_msgs_fold``).

The runs (every SimState leaf compared, float32 included, tolerance 0)
use 16 target nodes joining every 0.5 s, ``EngineParams(window=0.2,
inbox_slots=4, pool_factor=16)``, 160-bit keys and ``init_deviation =
jitter = 0`` (the engine's normal draws, where PyTorch's erfinv cannot
match XLA's bit for bit):

(a) NTree (``NTreeParams(max_children=3)``) over Chord and MyOverlay
    with MyApp (a 2 s send period) under NoChurn on the dense tick, and
    under LifetimeChurn (mean 20 s, 1 s graceful leave) on the sparse
    tick held against the JAX package's sparse tick, from a fresh
    start;
(b) the JAX states at ``CARRY`` ticks carried into the port;
(c) NTree built from an ini by both packages' builders: the JAX
    builder's simulation has the dense run's configuration (compared
    field by field in the JAX interpreter), and the port's ini-built
    simulation steps that run's leaves; the quadtree cell functions
    against the jitted JAX ones on and off every cell border;
(d) NTree over Kademlia: an app with only the one-slot ``on_msg``,
    which the port's Kademlia and Chord hand their inbox slot by slot,
    as the JAX overlays' per-slot fold does;
(e) the kernels' plain versions (``inbox_impl="pallas"`` on the CPU)
    against the scatter inbox.

Inside the compared ticks the port's side counts, and the fresh NTree
runs require, registrations, a DIVIDE, a COLLAPSE and event deliveries,
the fresh MyOverlay runs ring joins and delivered payloads; the carried
runs registrations and deliveries.  The JAX runs go one
after another in one fresh interpreter (``JaxCall``;
test_torch_engine.py says why) while the port steps.
"""

import contextlib
import textwrap
import types

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch.apps import base as tbase
from oversim_tpu_torch.apps import dummy as tdummy
from oversim_tpu_torch.apps import ntree as tntree
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay import chord as tchord
from oversim_tpu_torch.overlay import kademlia as tkad
from oversim_tpu_torch.overlay import myoverlay as tmy
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import first_difference
from test_torch_ini_run import zero_normals
from test_torch_pastry import SEED, at, finish, jax_leaves_at, start_jax

torch.set_num_threads(1)

TICKS = 200
CARRY = 120
NT = dict(max_children=3)
MY = dict(interval=2.0)
MYOV = dict(join_delay=2.0, hello_interval=4.0)
NOCHURN = dict(model="none", target_num=16, init_interval=0.5,
               init_deviation=0.0)
LIFETIME = dict(model="lifetime", target_num=16, init_interval=0.5,
                init_deviation=0.0, lifetime_mean=20.0,
                graceful_leave_delay=1.0)
EP = dict(window=0.2, inbox_slots=4, pool_factor=16)
# run name -> (overlay, churn, tick impl, ticks kept)
RUNS = {"ntree_dense": ("chord", NOCHURN, "dense", (0, CARRY, TICKS)),
        "ntree_sparse": ("chord", LIFETIME, "sparse", (0, CARRY, TICKS)),
        "ntree_kad": ("kademlia", NOCHURN, "dense", (TICKS,)),
        "my_dense": ("my", NOCHURN, "dense", (0, CARRY, TICKS)),
        "my_sparse": ("my", LIFETIME, "sparse", (0, CARRY, TICKS))}
INI = textwrap.dedent("""\
    [General]
    **.overlayType = "oversim.overlay.ntree.NTreeModules"
    **.targetOverlayTerminalNum = 16
    **.initPhaseCreationInterval = 0.5
    **.maxChildren = 3
    """)


def _ep(name, impl="scatter"):
    return dict(EP, tick_impl=RUNS[name][2], inbox_impl=impl)


def port_sim(name, impl="scatter", device="cpu"):
    ov, cp = RUNS[name][:2]
    if ov == "my":
        logic = tmy.MyOverlayLogic(
            params=tmy.MyOverlayParams(**MYOV),
            app=tdummy.MyApp(tdummy.MyAppParams(**MY)))
    else:
        cls = tchord.ChordLogic if ov == "chord" else tkad.KademliaLogic
        logic = cls(app=tntree.NTreeApp(tntree.NTreeParams(**NT)))
    return tsim.Simulation(logic, tchurn.ChurnParams(**cp),
                           tul.UnderlayParams(jitter=0.0),
                           tsim.EngineParams(**_ep(name, impl)),
                           device=device)


def ini_sim(pkg):
    """``INI`` built by ``pkg``'s builder with the runs' engine knobs."""
    if pkg == "jax":
        from oversim_tpu.config import ini, scenario
        from oversim_tpu.engine import sim
    else:
        from oversim_tpu_torch.config import ini, scenario
        sim = tsim
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return zero_normals(scenario.build_simulation(
        ini.IniFile.loads(INI), "General",
        engine_params=sim.EngineParams(**_ep("ntree_dense")), **kw))


def jax_sim(name):
    from oversim_tpu import churn as jchurn
    from oversim_tpu.apps import dummy as jdummy
    from oversim_tpu.apps import ntree as jntree
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.overlay import chord as jchord
    from oversim_tpu.overlay import kademlia as jkad
    from oversim_tpu.overlay import myoverlay as jmy
    from oversim_tpu.underlay import simple as jul
    ov, cp = RUNS[name][:2]
    if ov == "my":
        logic = jmy.MyOverlayLogic(
            params=jmy.MyOverlayParams(**MYOV),
            app=jdummy.MyApp(jdummy.MyAppParams(**MY)))
    else:
        cls = jchord.ChordLogic if ov == "chord" else jkad.KademliaLogic
        logic = cls(app=jntree.NTreeApp(jntree.NTreeParams(**NT)))
    return jsim.Simulation(logic, jchurn.ChurnParams(**cp),
                           jul.UnderlayParams(jitter=0.0),
                           jsim.EngineParams(**_ep(name)))


def config_of(sim):
    """Everything that shapes a run of ``sim`` besides the seed."""
    lg = sim.logic
    return repr((type(lg).__name__, lg.key_spec, lg.p, lg.lcfg, lg.app.p,
                 type(lg.app).__name__, sim.cp, sim.up, sim.ep))


def cell_inputs(seed=11):
    """Positions in the 1,000-unit field (random, on the cell borders of
    every depth, and its edges) and a depth per position."""
    rs = np.random.default_rng(seed)
    border = np.arange(0, 1001, 62.5, dtype=np.float32)
    pos = np.concatenate([
        rs.uniform(0, 1000, (200, 2)).astype(np.float32),
        np.stack([border, border[::-1]], -1),
        np.nextafter(np.stack([border, border], -1), np.float32(0))])
    return pos, rs.integers(0, 4, len(pos)).astype(np.int32)


def jax_cells(pos, depth):
    """JAX ``cell_of`` at every static depth and ``cell_of_dyn``,
    jitted."""
    import jax
    import jax.numpy as jnp
    from oversim_tpu.apps import ntree as jntree
    p = jntree.NTreeParams()
    static = [np.array(jax.jit(lambda x, d=d: jntree.cell_of(x, d, p))(
        jnp.asarray(pos))) for d in range(p.max_depth + 1)]
    dyn = np.array(jax.jit(lambda x, d: jntree.cell_of_dyn(x, d, p))(
        jnp.asarray(pos), jnp.asarray(depth)))
    return np.stack(static + [dyn])


def jax_ntree_runs(seed, names):
    """Each run's leaves at its kept ticks, ``ini_config`` (1 when the
    JAX builder's simulation of ``INI`` has the dense run's
    configuration) and ``cells`` (``jax_cells`` of ``cell_inputs``)."""
    out = {}
    for name in names:
        out.update(jax_leaves_at(jax_sim(name), seed, RUNS[name][3], name))
    out["ini_config"] = np.array(int(
        config_of(ini_sim("jax")) == config_of(jax_sim("ntree_dense"))))
    out["cells"] = jax_cells(*cell_inputs())
    return out


BRANCHES = {"ntree": ("registers", "divides", "collapses", "delivered"),
            "my": ("ring_joins", "delivered")}
CARRIED = {"ntree": ("registers",), "my": ("delivered",)}


@contextlib.contextmanager
def spies():
    """Count, while the port steps, NTree's registrations, DIVIDE and
    COLLAPSE answers and event deliveries, MyOverlay's ring joins and
    delivered payloads, and the one-slot ``on_msg`` calls the overlays
    fold in (``folded``)."""
    seen = dict.fromkeys(("registers", "divides", "collapses", "delivered",
                          "ring_joins", "folded"), 0)
    on_msg = tntree.NTreeApp.on_msg
    steps = {cls: cls.step for cls in (tchord.ChordLogic, tkad.KademliaLogic,
                                       tmy.MyOverlayLogic)}

    def spy_on_msg(self, app, m, ctx, ob, ev, is_sib):
        seen["folded"] += 1
        return on_msg(self, app, m, ctx, ob, ev, is_sib)

    def spy_step(cls):
        def step(self, ctx, st, msgs, rng, node_idx, **kw):
            out = steps[cls](self, ctx, st, msgs, rng, node_idx, **kw)
            ev = out[2]
            for k, name in (("registers", "c:ntree_registers"),
                            ("divides", "c:ntree_divides"),
                            ("collapses", "c:ntree_collapses"),
                            ("delivered", "c:ntree_event_delivered"),
                            ("delivered", "c:myapp_delivered"),
                            ("ring_joins", "c:ring_joins")):
                if name in ev:
                    seen[k] += int(ev[name].sum())
            return out
        return step

    tntree.NTreeApp.on_msg = spy_on_msg
    for cls in steps:
        cls.step = spy_step(cls)
    try:
        yield seen
    finally:
        tntree.NTreeApp.on_msg = on_msg
        for cls, fn in steps.items():
            cls.step = fn


def stepped(sim, s, ticks):
    with spies() as seen:
        for _ in range(ticks):
            s = sim.run_chunk(s, 1)
    return s, seen


def assert_worked(name, sim, state, seen, want=BRANCHES):
    kind = "my" if name.startswith("my") else "ntree"
    missing = [k for k in want[kind] if seen[k] <= 0]
    assert not missing, (name, seen)
    eng = sim.summary(state)["_engine"]
    assert eng["pool_overflow"] == 0 and eng["outbox_overflow"] == 0, eng


@pytest.fixture(scope="module")
def runs():
    calls = start_jax("test_torch_ntree", RUNS, func="jax_ntree_runs")
    port = {}
    for name in RUNS:
        sim = port_sim(name)
        s0 = sim.init(SEED)
        port[name] = (sim, s0) + stepped(sim, s0, TICKS)
    return finish(calls, port)


@pytest.mark.parametrize("kind", ["ntree", "my"])
def test_fresh_start_leaf_exact(runs, kind):
    ref, port = runs
    for impl in ("dense", "sparse"):
        name = f"{kind}_{impl}"
        sim, s0, b, seen = port[name]
        assert first_difference(at(ref, name, 0), s0) is None, name
        assert first_difference(at(ref, name, TICKS), b) is None, name
        assert_worked(name, sim, b, seen)


def test_carried_state_leaf_exact(runs):
    ref, _ = runs
    for name in ("ntree_dense", "ntree_sparse", "my_dense", "my_sparse"):
        sim = port_sim(name)
        b = interop.state_from_numpy(at(ref, name, CARRY), sim, "cpu")
        b, seen = stepped(sim, b, TICKS - CARRY)
        assert first_difference(at(ref, name, TICKS), b) is None, name
        assert_worked(name, sim, b, seen, want=CARRIED)


def test_ini_built_and_cells_leaf_exact(runs):
    """The ini-built simulation steps the dense run's leaves; the
    quadtree cells of positions on and off every border equal the
    jitted JAX ``cell_of`` (a multiply by the width's reciprocal) and
    ``cell_of_dyn`` (a true division)."""
    ref, port = runs
    assert int(ref["ini_config"]) == 1
    sim = ini_sim("torch")
    assert type(sim.logic) is tchord.ChordLogic
    assert sim.logic.app.p == tntree.NTreeParams(**NT)
    assert config_of(sim) == config_of(port["ntree_dense"][0])
    b = sim.run_chunk(sim.init(SEED), TICKS)
    assert first_difference(at(ref, "ntree_dense", TICKS), b) is None

    pos, depth = (torch.from_numpy(x) for x in cell_inputs())
    p = tntree.NTreeParams()
    got = torch.stack([tntree.cell_of(pos, d, p)
                       for d in range(p.max_depth + 1)]
                      + [tntree.cell_of_dyn(pos, depth, p)]).numpy()
    np.testing.assert_array_equal(got, ref["cells"])


def test_one_slot_app_folds_per_slot(runs):
    """NTree has only ``on_msg``: Kademlia and Chord call it once per
    inbox slot per step (``on_msgs_fold``), and the runs are the JAX
    per-slot fold's, leaf for leaf."""
    ref, port = runs
    assert not hasattr(tntree.NTreeApp, "on_msgs")
    sim, _, b, seen = port["ntree_kad"]
    assert first_difference(at(ref, "ntree_kad", TICKS), b) is None
    assert seen["folded"] == TICKS * EP["inbox_slots"]
    assert seen["registers"] > 0 and seen["delivered"] > 0, seen
    assert port["ntree_dense"][3]["folded"] == TICKS * EP["inbox_slots"]

    # an app with on_msgs gets the whole inbox in one call
    calls = []

    class Batched(tdummy.TierDummyApp):
        def on_msgs(self, app, msgs, ctx, ob, ev, is_sib, node_idx=None):
            calls.append(tuple(msgs.valid.shape))
            return app

    msgs = types.SimpleNamespace(valid=torch.zeros((3, 4), dtype=bool))
    tbase.on_msgs_fold(Batched(), None, msgs, None, None, None,
                       torch.zeros((3, 4), dtype=bool))
    assert calls == [(3, 4)]


def test_kernel_plain_versions_match_scatter(runs):
    """The kernels' plain versions (the CPU half of ``inbox_impl=
    "pallas"``: inbox selection, payload gather, pool allocation and,
    on the sparse tick, the active-set compaction) step every leaf as
    the scatter inbox does."""
    _, port = runs
    for name in ("ntree_dense", "ntree_sparse", "my_sparse"):
        _, s0, b, _ = port[name]
        c = port_sim(name, impl="pallas").run_chunk(s0, TICKS)
        fb, fc = interop.state_to_numpy(b), interop.state_to_numpy(c)
        bad = [k for k in fb if not np.array_equal(fb[k], fc[k])]
        assert not bad, (name, bad[:5])
