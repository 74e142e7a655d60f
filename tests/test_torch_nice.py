"""NICE on both packages, leaf-exact, from fresh starts and carried
states.

The runs (every SimState leaf compared, tolerance 0) use 16 target nodes
joining every 0.5 s, ``EngineParams(window=0.2, inbox_slots=4,
outbox_slots=64, pool_factor=16)``, ``init_deviation = jitter = 0`` (the
engine's normal draws, where PyTorch's erfinv cannot match XLA's bit for
bit) and NICE with its defaults but shorter heartbeat, maintenance and
query intervals (``NP``), so that the clusters split and the ALMTest
publishes (every 20 s) flood the hierarchy inside the compared ticks:

(a) NoChurn on the dense tick and LifetimeChurn (mean 20 s, 1 s graceful
    leave) on the sparse tick, held against the JAX package's sparse
    tick, from a fresh start;
(b) the JAX states at ``CARRY`` ticks carried into the port;
(c) NICE built from an ini by both packages' builders (the namespace's
    five keys): the JAX builder's simulation has the dense run's
    configuration (compared field by field in the JAX interpreter), and
    the port's ini-built simulation steps that run's leaves;
(d) the MERGE insertion (``NiceLogic._merge_into``) against the JAX
    package's per-member loop, jitted, on random member lists;
(e) the kernels' plain versions (``inbox_impl="pallas"`` on the CPU)
    against the scatter inbox.

Inside the compared ticks the port's side counts, and each fresh run
requires, joins through the descent, probe rounds, a split, publishes
and deliveries, the churn run also duplicates, evictions and a merge;
each carried run deliveries.  The JAX runs go one after another in one
fresh interpreter (``JaxCall``; test_torch_engine.py says why) while the
port steps.
"""

import contextlib
import textwrap

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay import nice as tnice
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import first_difference
from test_torch_ini_run import zero_normals
from test_torch_pastry import SEED, at, finish, jax_leaves_at, start_jax

torch.set_num_threads(1)

TICKS = 300
CARRY = 180
NP = dict(hb_interval=2.0, maint_interval=1.5, query_interval=1.0)
NOCHURN = dict(model="none", target_num=16, init_interval=0.5,
               init_deviation=0.0)
LIFETIME = dict(model="lifetime", target_num=16, init_interval=0.5,
                init_deviation=0.0, lifetime_mean=20.0,
                graceful_leave_delay=1.0)
EP = dict(window=0.2, inbox_slots=4, outbox_slots=64, pool_factor=16)
# run name -> (churn, tick impl, ticks kept)
RUNS = {"dense": (NOCHURN, "dense", (0, CARRY, TICKS)),
        "sparse": (LIFETIME, "sparse", (0, CARRY, TICKS))}
INI = textwrap.dedent("""\
    [General]
    **.overlayType = "oversim.overlay.nice.NiceModules"
    **.targetOverlayTerminalNum = 16
    **.initPhaseCreationInterval = 0.5
    **.overlay.nice.k = 3
    **.overlay.nice.heartbeatInterval = 2s
    **.overlay.nice.maintenanceInterval = 1.5s
    **.overlay.nice.queryInterval = 1s
    **.overlay.nice.peerTimeoutHeartbeats = 3
    """)
MERGE_CASES = 64


def _ep(name, impl="scatter"):
    return dict(EP, tick_impl=RUNS[name][1], inbox_impl=impl)


def port_sim(name, impl="scatter", device="cpu"):
    return tsim.Simulation(tnice.NiceLogic(params=tnice.NiceParams(**NP)),
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
    from oversim_tpu.overlay import nice as jnice
    from oversim_tpu.underlay import simple as jul
    return jsim.Simulation(jnice.NiceLogic(params=jnice.NiceParams(**NP)),
                           jchurn.ChurnParams(**RUNS[name][0]),
                           jul.UnderlayParams(jitter=0.0),
                           jsim.EngineParams(**_ep(name)))


def config_of(sim):
    """Everything that shapes a run of ``sim`` besides the seed."""
    lg = sim.logic
    return repr((type(lg).__name__, lg.key_spec, lg.p, sim.cp, sim.up,
                 sim.ep))


def merge_inputs(cmax=tnice.NiceParams().cmax, seed=5):
    """``MERGE_CASES`` (member list, absorbed list) pairs over node ids
    0..7: some slots free, repeats inside and across the lists."""
    rs = np.random.default_rng(seed)
    mem = rs.integers(-1, 8, (MERGE_CASES, cmax)).astype(np.int32)
    mem[rs.random((MERGE_CASES, cmax)) < 0.4] = -1
    nodes = rs.integers(-1, 8, (MERGE_CASES, cmax)).astype(np.int32)
    return mem, nodes


def jax_merge(mem, nodes):
    """The JAX MERGE handler's insertion loop (nice.py's step), jitted
    and vmapped over the cases."""
    import jax
    import jax.numpy as jnp
    cmax = mem.shape[1]

    def one(mem, nodes):
        for ci in range(cmax):
            nd = nodes[ci]
            put = ((nd != -1) & ~jnp.any(mem == nd)
                   & jnp.any(mem == -1))
            slot = jnp.argmax(mem == -1).astype(jnp.int32)
            mem = mem.at[jnp.where(put, slot, cmax)].set(nd, mode="drop")
        return mem

    return np.array(jax.jit(jax.vmap(one))(jnp.asarray(mem),
                                            jnp.asarray(nodes)))


def jax_nice_runs(seed, names):
    """Each run's leaves at its kept ticks, ``ini_config`` (1 when the
    JAX builder's simulation of ``INI`` has the dense run's
    configuration) and ``merge`` (``jax_merge`` of ``merge_inputs``)."""
    out = {}
    for name in names:
        out.update(jax_leaves_at(jax_sim(name), seed, RUNS[name][2], name))
    out["ini_config"] = np.array(int(
        config_of(ini_sim("jax")) == config_of(jax_sim("dense"))))
    out["merge"] = jax_merge(*merge_inputs())
    return out


BRANCHES = ("joins", "probes", "splits", "pub", "recv")
CHURN_BRANCHES = ("dup", "evicts", "merges")


@contextlib.contextmanager
def spies():
    """Count, while the port steps, joins, PROBE_RES answers, splits,
    publishes, deliveries, duplicates, evictions and merges."""
    seen = dict.fromkeys(BRANCHES + CHURN_BRANCHES, 0)
    step = tnice.NiceLogic.step

    def spy_step(self, ctx, st, msgs, rng, node_idx, **kw):
        out = step(self, ctx, st, msgs, rng, node_idx, **kw)
        ev = out[2]
        for k in ("joins", "splits", "pub", "recv", "dup", "evicts",
                  "merges"):
            seen[k] += int(ev[f"c:nice_{k}"].sum())
        seen["probes"] += int((msgs.valid
                               & (msgs.kind == tnice.NICE_PROBE_RES)).sum())
        return out

    tnice.NiceLogic.step = spy_step
    try:
        yield seen
    finally:
        tnice.NiceLogic.step = step


def stepped(sim, s, ticks):
    with spies() as seen:
        for _ in range(ticks):
            s = sim.run_chunk(s, 1)
    return s, seen


def assert_worked(sim, state, seen, churn=False):
    missing = [k for k in BRANCHES + (CHURN_BRANCHES if churn else ())
               if seen[k] <= 0]
    assert not missing, seen
    eng = sim.summary(state)["_engine"]
    assert eng["pool_overflow"] == 0 and eng["outbox_overflow"] == 0, eng


@pytest.fixture(scope="module")
def runs():
    calls = start_jax("test_torch_nice", RUNS, func="jax_nice_runs")
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
    assert_worked(sim, b, seen, churn=name == "sparse")


@pytest.mark.parametrize("name", ["dense", "sparse"])
def test_carried_state_leaf_exact(runs, name):
    ref, _ = runs
    sim = port_sim(name)
    b = interop.state_from_numpy(at(ref, name, CARRY), sim, "cpu")
    b, seen = stepped(sim, b, TICKS - CARRY)
    assert first_difference(at(ref, name, TICKS), b) is None
    assert seen["recv"] > 0, seen


def test_ini_built_and_merge_leaf_exact(runs):
    """The ini-built simulation steps the dense run's leaves; the MERGE
    insertion equals the JAX loop's on every case."""
    ref, port = runs
    assert int(ref["ini_config"]) == 1
    sim = ini_sim("torch")
    assert type(sim.logic) is tnice.NiceLogic
    assert sim.logic.p == tnice.NiceParams(**NP)
    assert config_of(sim) == config_of(port["dense"][0])
    b = sim.run_chunk(sim.init(SEED), TICKS)
    assert first_difference(at(ref, "dense", TICKS), b) is None

    mem, nodes = merge_inputs()
    got = tnice.NiceLogic._merge_into(torch.from_numpy(mem),
                                      torch.from_numpy(nodes)).numpy()
    np.testing.assert_array_equal(got, ref["merge"])
    assert (got != mem).any(axis=1).sum() > MERGE_CASES // 2


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
