"""GIA on both packages, leaf-exact, from fresh starts and carried states.

The runs (every SimState leaf compared, float32 included, tolerance 0)
use 12 target nodes, ``EngineParams(window=0.1, inbox_slots=4,
pool_factor=4)``, 160-bit keys, ``init_deviation = jitter = 0`` (the
engine's normal draws, where PyTorch's erfinv cannot match XLA's bit for
bit) and GIA with small timers and degree bounds (``GP``), so that every
branch fires inside the compared ticks:

(a) NoChurn over a 2.4 s ramp on the dense tick, 120 ticks from a fresh
    start, and from the JAX state at 40 ticks carried into the port;
(b) LifetimeChurn (mean 8 s, 1 s graceful leave) on the sparse tick,
    held against the JAX package's sparse tick, fresh and carried;
(c) (a)'s churn and engine built from an ini by both packages' builders
    (GIA's six ini keys, none at its default);
(d) the kernels' plain versions (``inbox_impl="pallas"`` on the CPU)
    against the scatter inbox, dense and sparse: every leaf equal.

Inside the compared ticks the port's side counts, and each run requires,
a NEIGHBOR_CALL rejected, a weakest neighbor replaced with a DISCONNECT,
a token granted to a neighbor, a query forwarded, a query parked for a
token and one dropped after ``token_wait_max`` parks, a response at the
originator and a search timeout; the churn runs also a reset that keeps
a survivor's capacity.  The JAX runs go one after another in one fresh
interpreter (``JaxCall``; test_torch_engine.py says why) while the port
steps.
"""

import contextlib
import textwrap

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch.common import wire
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay import gia as tgia
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import first_difference
from test_torch_ini_run import zero_normals
from test_torch_pastry import SEED, at, finish, jax_leaves_at, start_jax

torch.set_num_threads(1)

TICKS = 120
CARRY = 40
GP = dict(min_neighbors=2, max_neighbors=3, adapt_interval=1.0,
          token_interval=0.5, max_tokens=2, search_interval=2.0,
          search_ttl=4, search_timeout=1.5, join_delay=1.0, token_wait=0.3,
          token_wait_max=2)
NOCHURN = dict(model="none", target_num=12, init_interval=0.2,
               init_deviation=0.0)
LIFETIME = dict(model="lifetime", target_num=12, init_interval=0.2,
                init_deviation=0.0, lifetime_mean=8.0,
                graceful_leave_delay=1.0)
EP = dict(window=0.1, inbox_slots=4, pool_factor=4)
# run name -> (churn, tick impl, ticks kept)
RUNS = {"dense": (NOCHURN, "dense", (0, CARRY, TICKS)),
        "sparse": (LIFETIME, "sparse", (0, CARRY, TICKS)),
        "ini": (None, "dense", (TICKS,))}
# GIA's six ini keys (none at its default) over the dense run's churn
INI = textwrap.dedent("""\
    [General]
    **.overlayType = "oversim.overlay.gia.GiaModules"
    **.tier1Type = "oversim.applications.giasearchapp.GIASearchAppModules"
    **.targetOverlayTerminalNum = 12
    **.initPhaseCreationInterval = 0.2
    **.overlay.gia.minNeighbors = 2
    **.overlay.gia.maxNeighbors = 3
    **.overlay.gia.maxTopAdaptionInterval = 1
    **.overlay.gia.maxHopCount = 4
    **.overlay.gia.maxResponses = 2
    **.overlay.gia.tokenWaitTime = 0.3
    """)
INI_PARAMS = dict(min_neighbors=2, max_neighbors=3, adapt_interval=1.0,
                  search_ttl=4, max_responses=2, token_wait=0.3)


def _ep(name, impl="scatter"):
    return dict(EP, tick_impl=RUNS[name][1], inbox_impl=impl)


def port_sim(name, impl="scatter", device="cpu"):
    return tsim.Simulation(tgia.GiaLogic(params=tgia.GiaParams(**GP)),
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
        engine_params=sim.EngineParams(**_ep("ini")), **kw))


def jax_sim(name):
    from oversim_tpu import churn as jchurn
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.overlay import gia as jgia
    from oversim_tpu.underlay import simple as jul
    if name == "ini":
        return ini_sim("jax")
    return jsim.Simulation(jgia.GiaLogic(params=jgia.GiaParams(**GP)),
                           jchurn.ChurnParams(**RUNS[name][0]),
                           jul.UnderlayParams(jitter=0.0),
                           jsim.EngineParams(**_ep(name)))


def jax_gia_runs(seed, names):
    out = {}
    for name in names:
        out.update(jax_leaves_at(jax_sim(name), seed, RUNS[name][2], name))
    return out


BRANCHES = ("call_rejected", "replaced", "token_granted", "forwarded",
            "parked", "dropped_after_parks", "responses", "timeouts")


def tally_step(seen, logic, msgs, node_idx, st0, out, ob):
    """Add one step's branches to ``seen``: the inbox and the state
    before it, the outbox and the events after it."""
    p = logic.p
    fields, valid, _ = ob.finish()
    kind = torch.where(valid, fields["kind"], -1)
    me = node_idx[:, None]
    seen["call_rejected"] += int(((kind == wire.GIA_NEIGHBOR_RES)
                                  & (fields["c"] == 0)).sum())
    seen["replaced"] += int((kind == wire.GIA_DISCONNECT).sum())
    query = kind == wire.GIA_QUERY
    seen["forwarded"] += int((query & (fields["hops"] > 0)
                              & (fields["dst"] != me)).sum())
    seen["parked"] += int((query & (fields["dst"] == me)).sum())
    events = out[2]
    seen["responses"] += int(events["c:gia_search_success"].sum())
    seen["timeouts"] += int(events["c:gia_search_failed"].sum())
    ready = st0.state == tgia.READY
    for r in range(msgs.valid.shape[1]):
        m = msgs.slot(r)
        v = m.valid
        is_nbr = torch.any(st0.nbr == m.src[:, None], 1)
        seen["token_granted"] += int((v & (m.kind == wire.GIA_TOKEN)
                                      & is_nbr).sum())
        # a query at its last park that left no forward and no answer
        last = v & (m.kind == wire.GIA_QUERY) & ready & (
            m.d >= p.token_wait_max) & (m.hops < p.search_ttl)
        for i in torch.nonzero(last)[:, 0].tolist():
            went = query[i] & (fields["a"][i] == m.a[i]) & (
                fields["b"][i] == m.b[i])
            answered = (kind[i] == wire.GIA_QUERY_RES) & (
                fields["dst"][i] == m.a[i]) & (fields["b"][i] == m.b[i])
            seen["dropped_after_parks"] += int(not bool(
                (went | answered).any()))


@contextlib.contextmanager
def spies():
    """Count the branches (``tally_step``) and the churn resets that keep
    a survivor's capacity while the port steps."""
    seen = dict.fromkeys(BRANCHES + ("kept_capacity",), 0)
    step, reset = tgia.GiaLogic.step, tgia.GiaLogic.reset

    def spy_step(self, ctx, st, msgs, rng, node_idx, **kw):
        out = step(self, ctx, st, msgs, rng, node_idx, **kw)
        tally_step(seen, self, msgs, node_idx, st, out, out[1])
        return out

    def spy_reset(self, st, clear, join, t_now, rng):
        out = reset(self, st, clear, join, t_now, rng)
        if bool(clear.any()):
            kept = ~clear & (out.capacity == st.capacity)
            assert bool(kept[~clear].all())
            seen["kept_capacity"] += int(kept.sum())
        return out

    tgia.GiaLogic.step, tgia.GiaLogic.reset = spy_step, spy_reset
    try:
        yield seen
    finally:
        tgia.GiaLogic.step, tgia.GiaLogic.reset = step, reset


def stepped(sim, s, ticks):
    with spies() as seen:
        for _ in range(ticks):
            s = sim.run_chunk(s, 1)
    return s, seen


def assert_gia_worked(sim, state, seen, churn=False):
    missing = [k for k in BRANCHES if seen[k] <= 0]
    assert not missing, seen
    if churn:
        assert seen["kept_capacity"] > 0, seen
    out = sim.summary(state)
    assert out["gia_searches"] > 0 and out["gia_search_success"] > 0, out
    eng = out["_engine"]
    assert eng["pool_overflow"] == 0 and eng["outbox_overflow"] == 0, eng


@pytest.fixture(scope="module")
def runs():
    calls = start_jax("test_torch_gia", RUNS, func="jax_gia_runs")
    port = {}
    for name in ("dense", "sparse"):
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
    assert_gia_worked(sim, b, seen, churn=name == "sparse")


@pytest.mark.parametrize("name", ["dense", "sparse"])
def test_carried_state_leaf_exact(runs, name):
    ref, _ = runs
    sim = port_sim(name)
    b = interop.state_from_numpy(at(ref, name, CARRY), sim, "cpu")
    assert first_difference(at(ref, name, CARRY), b) is None
    b, seen = stepped(sim, b, TICKS - CARRY)
    assert first_difference(at(ref, name, TICKS), b) is None
    assert_gia_worked(sim, b, seen, churn=name == "sparse")


def test_ini_built_leaf_exact(runs):
    ref, _ = runs
    sim = ini_sim("torch")
    assert sim.logic.p == tgia.GiaParams(**INI_PARAMS)
    b, _ = stepped(sim, sim.init(SEED), TICKS)
    assert first_difference(at(ref, "ini", TICKS), b) is None
    assert sim.summary(b)["gia_search_success"] > 0


def test_kernel_plain_versions_match_scatter(runs):
    """The kernels' plain versions (the CPU half of ``inbox_impl=
    "pallas"``: inbox selection, payload gather, pool allocation and,
    on the sparse tick, the active-set compaction) step every leaf as
    the scatter inbox does."""
    _, port = runs
    for name in ("dense", "sparse"):
        sim_a, s0, b, _ = port[name]
        sim = port_sim(name, impl="pallas")
        c = sim.run_chunk(s0, TICKS)
        fa, fc = interop.state_to_numpy(b), interop.state_to_numpy(c)
        assert sorted(fa) == sorted(fc)
        bad = [k for k in fa if not np.array_equal(fa[k], fc[k])]
        assert not bad, (name, bad[:5])
