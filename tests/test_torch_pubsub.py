"""PubSubMMOG on both packages, leaf-exact, from fresh starts and carried
states.

The runs (every SimState leaf compared, float32 positions included,
tolerance 0) use 16 target nodes joining every 0.5 s,
``EngineParams(window=0.1, inbox_slots=4, outbox_slots=64,
pool_factor=8)``, ``init_deviation = jitter = 0`` (the engine's normal
draws, where PyTorch's erfinv cannot match XLA's bit for bit) and a
400-unit field (``PP``: 100-unit subspaces under the 100-unit AOI, so a
player overlaps up to four and crosses their borders as it moves) with
three children per duty, so that subscriptions are rejected:

(a) NoChurn on the dense tick and LifetimeChurn (mean 20 s, 1 s graceful
    leave) on the sparse tick, held against the JAX package's sparse
    tick, from a fresh start;
(b) the JAX states at ``CARRY`` ticks carried into the port;
(c) PubSubMMOG built from an ini by both packages' builders (the
    namespace's seven keys): the JAX builder's simulation has the dense
    run's configuration (compared field by field in the JAX
    interpreter), and the port's ini-built simulation steps that run's
    leaves;
(d) the lobby's last-requester rule against the JAX package's scatter;
(e) the kernels' plain versions (``inbox_impl="pallas"`` on the CPU)
    against the scatter inbox.

Inside the compared ticks the port's side counts, and each fresh run
requires, duties assigned by the lobby, accepted and rejected
subscriptions, unsubscriptions, moves collected and move lists
received; each carried run moves and move lists.  The JAX runs go one
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
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay import pubsubmmog as tps
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import first_difference
from test_torch_ini_run import zero_normals
from test_torch_pastry import SEED, at, finish, jax_leaves_at, start_jax

torch.set_num_threads(1)

TICKS = 200
CARRY = 120
PP = dict(field=400.0, max_children=3)
NOCHURN = dict(model="none", target_num=16, init_interval=0.5,
               init_deviation=0.0)
LIFETIME = dict(model="lifetime", target_num=16, init_interval=0.5,
                init_deviation=0.0, lifetime_mean=20.0,
                graceful_leave_delay=1.0)
EP = dict(window=0.1, inbox_slots=4, outbox_slots=64, pool_factor=8)
# run name -> (churn, tick impl, ticks kept)
RUNS = {"dense": (NOCHURN, "dense", (0, CARRY, TICKS)),
        "sparse": (LIFETIME, "sparse", (0, CARRY, TICKS))}
# the namespace's seven keys, two off their defaults
INI = textwrap.dedent("""\
    [General]
    **.overlayType = "oversim.overlay.pubsubmmog.PubSubMMOGModules"
    **.targetOverlayTerminalNum = 16
    **.initPhaseCreationInterval = 0.5
    **.overlay.pubsubmmog.areaDimension = 400
    **.overlay.pubsubmmog.numSubspaces = 4
    **.overlay.pubsubmmog.AOIWidth = 100
    **.overlay.pubsubmmog.movementRate = 2
    **.overlay.pubsubmmog.parentTimeout = 2s
    **.overlay.pubsubmmog.maxMoveDelay = 1s
    **.overlay.pubsubmmog.maxChildren = 3
    """)


def _ep(name, impl="scatter"):
    return dict(EP, tick_impl=RUNS[name][1], inbox_impl=impl)


def port_sim(name, impl="scatter", device="cpu"):
    return tsim.Simulation(tps.PubSubMMOGLogic(params=tps.PubSubParams(**PP)),
                           tchurn.ChurnParams(**RUNS[name][0]),
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
        engine_params=sim.EngineParams(**_ep("dense")), **kw))


def jax_sim(name):
    from oversim_tpu import churn as jchurn
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.overlay import pubsubmmog as jps
    from oversim_tpu.underlay import simple as jul
    return jsim.Simulation(jps.PubSubMMOGLogic(params=jps.PubSubParams(**PP)),
                           jchurn.ChurnParams(**RUNS[name][0]),
                           jul.UnderlayParams(jitter=0.0),
                           jsim.EngineParams(**_ep(name)))


def config_of(sim):
    """Everything that shapes a run of ``sim`` besides the seed."""
    lg = sim.logic
    return repr((type(lg).__name__, lg.key_spec, lg.p, sim.cp, sim.up,
                 sim.ep))


LOBBY_WANTS = ((3, -1, 3, 0, 15, 3, -1, 15), (-1,) * 8, (7,) * 8,
               tuple(range(8)))


def jax_lobby(wants):
    """The JAX lobby's assignment from an empty table: ``resp`` per
    subspace for each row of ``wants``."""
    import jax
    import jax.numpy as jnp
    from oversim_tpu.overlay import pubsubmmog as jps
    logic = jps.PubSubMMOGLogic()
    st = logic.init(jax.random.PRNGKey(0), len(wants[0]))

    class Ctx:
        alive = jnp.ones((len(wants[0]),), bool)

    post = jax.jit(lambda s, w: logic.post_step(Ctx, s, {"g:ps_want": w}))
    return np.stack([np.array(post(st, jnp.asarray(w, jnp.int32)).glob.resp)
                     for w in wants])


def jax_pubsub_runs(seed, names):
    """Each run's leaves at its kept ticks, ``ini_config`` (1 when the
    JAX builder's simulation of ``INI`` has the dense run's
    configuration) and ``lobby`` (``jax_lobby`` of ``LOBBY_WANTS``)."""
    out = {}
    for name in names:
        out.update(jax_leaves_at(jax_sim(name), seed, RUNS[name][2], name))
    out["ini_config"] = np.array(int(
        config_of(ini_sim("jax")) == config_of(jax_sim("dense"))))
    out["lobby"] = jax_lobby(LOBBY_WANTS)
    return out


BRANCHES = ("assigned", "sub_ok", "rejected", "unsub", "moves", "lists")


@contextlib.contextmanager
def spies():
    """Count, while the port steps, lobby assignments, accepted and
    rejected subscriptions (SUB_RES), UNSUBs received by a duty holder,
    moves collected and move lists received."""
    seen = dict.fromkeys(BRANCHES, 0)
    step, post = tps.PubSubMMOGLogic.step, tps.PubSubMMOGLogic.post_step

    def spy_step(self, ctx, st, msgs, rng, node_idx, **kw):
        out = step(self, ctx, st, msgs, rng, node_idx, **kw)
        v = msgs.valid
        res = v & (msgs.kind == tps.PS_SUB_RES)
        seen["sub_ok"] += int((res & (msgs.c != 0)).sum())
        seen["rejected"] += int(out[2]["c:ps_rejects"].sum())
        holds = torch.any(st.duty[:, None, :] == msgs.a[:, :, None], -1)
        seen["unsub"] += int((v & (msgs.kind == tps.PS_UNSUB) & holds).sum())
        seen["moves"] += int(out[2]["c:ps_moves"].sum())
        seen["lists"] += int(out[2]["c:ps_lists_recv"].sum())
        return out

    def spy_post(self, ctx, st, events):
        out = post(self, ctx, st, events)
        seen["assigned"] += int(((out.glob.resp >= 0)
                                 & (out.glob.resp != st.glob.resp)).sum())
        return out

    tps.PubSubMMOGLogic.step = spy_step
    tps.PubSubMMOGLogic.post_step = spy_post
    try:
        yield seen
    finally:
        tps.PubSubMMOGLogic.step, tps.PubSubMMOGLogic.post_step = step, post


def stepped(sim, s, ticks):
    with spies() as seen:
        for _ in range(ticks):
            s = sim.run_chunk(s, 1)
    return s, seen


def assert_worked(sim, state, seen, want=BRANCHES):
    missing = [k for k in want if seen[k] <= 0]
    assert not missing, seen
    eng = sim.summary(state)["_engine"]
    assert eng["pool_overflow"] == 0 and eng["outbox_overflow"] == 0, eng


@pytest.fixture(scope="module")
def runs():
    calls = start_jax("test_torch_pubsub", RUNS, func="jax_pubsub_runs")
    port = {}
    for name in RUNS:
        sim = port_sim(name)
        s0 = sim.init(SEED)
        port[name] = (sim, s0) + stepped(sim, s0, TICKS)
    return finish(calls, port)


@pytest.mark.parametrize("name", ["dense", "sparse"])
def test_fresh_start_leaf_exact(runs, name):
    ref, port = runs
    sim, s0, b, seen = port[name]
    assert first_difference(at(ref, name, 0), s0) is None
    assert first_difference(at(ref, name, TICKS), b) is None
    assert_worked(sim, b, seen)


@pytest.mark.parametrize("name", ["dense", "sparse"])
def test_carried_state_leaf_exact(runs, name):
    ref, _ = runs
    sim = port_sim(name)
    b = interop.state_from_numpy(at(ref, name, CARRY), sim, "cpu")
    b, seen = stepped(sim, b, TICKS - CARRY)
    assert first_difference(at(ref, name, TICKS), b) is None
    assert_worked(sim, b, seen, want=("moves", "lists"))


def test_ini_built_and_lobby_leaf_exact(runs):
    """The ini-built simulation steps the dense run's leaves; the lobby
    gives each vacant wanted subspace to its last requester, as the JAX
    package's scatter does."""
    ref, port = runs
    assert int(ref["ini_config"]) == 1
    sim = ini_sim("torch")
    assert type(sim.logic) is tps.PubSubMMOGLogic
    assert sim.logic.p == tps.PubSubParams(**PP)
    assert config_of(sim) == config_of(port["dense"][0])
    b = sim.run_chunk(sim.init(SEED), TICKS)
    assert first_difference(at(ref, "dense", TICKS), b) is None

    logic = tps.PubSubMMOGLogic()
    n = len(LOBBY_WANTS[0])
    st = logic.init(torch.zeros((2,), dtype=torch.int64), n)
    ctx = type("Ctx", (), {"alive": torch.ones((n,), dtype=torch.bool)})
    got = np.stack([logic.post_step(ctx, st, {"g:ps_want": torch.tensor(
        w, dtype=torch.int32)}).glob.resp.numpy() for w in LOBBY_WANTS])
    np.testing.assert_array_equal(got, ref["lobby"])
    assert got[0, 3] == 5 and got[0, 15] == 7 and got[0, 0] == 3


def test_kernel_plain_versions_match_scatter(runs):
    """The kernels' plain versions (the CPU half of ``inbox_impl=
    "pallas"``: inbox selection, payload gather, pool allocation and,
    on the sparse tick, the active-set compaction) step every leaf as
    the scatter inbox does."""
    _, port = runs
    for name in RUNS:
        _, s0, b, _ = port[name]
        c = port_sim(name, impl="pallas").run_chunk(s0, TICKS)
        fb, fc = interop.state_to_numpy(b), interop.state_to_numpy(c)
        bad = [k for k in fb if not np.array_equal(fb[k], fc[k])]
        assert not bad, (name, bad[:5])
