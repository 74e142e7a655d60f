"""The sparse active-set tick under lifetime churn: port against JAX.

Kademlia + KBRTest (test interval 1 s) under LifetimeChurn at the JAX
package's sparse-test size (tests/test_zz_sparse.py: 12 target = 24
slots, lifetime mean 8 s, init interval 0.2 s, window 0.1 s, 4 inbox
slots, pool factor 4), with ``init_deviation = jitter = 0`` (the two
normal draws, ROADMAP Queue C) and a 1 s graceful-leave delay, so that
final kills and their rebirth draws happen inside the 64 ticks:

(b) the port's dense tick, leaf-exact with JAX's dense tick;
(c) the port's sparse tick (torch ops), leaf-exact with JAX's sparse
    tick, sparse counters included; and a JAX sparse state carried into
    the port at tick 48 stays leaf-exact to tick 64;
(d) port sparse = port dense at the auto cap (full N here) once the
    sparse counters are dropped;
(e) ``active_cap=2``: leaf-exact with JAX at the same cap, and deferring;
(f) an all-asleep window compacts to sentinels with zero tallies;
(g) the plain versions of the two sparse kernels equal the JAX package's
    Pallas kernels in interpret mode;
(h) ``inbox_impl="pallas"`` on CPU tensors (the plain kernel versions)
    equals ``"scatter"``.

The JAX side runs in a fresh interpreter (test_torch_engine.py says why).
"""

import dataclasses

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch.apps import kbrtest as tkbr
from oversim_tpu_torch.engine import pool as tpool
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.kernels import compact as tcompact
from oversim_tpu_torch.kernels import inbox as tinbox
from oversim_tpu_torch.overlay.kademlia import KademliaLogic as TKademlia
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import first_difference, fresh_jax_call, own

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

SEED = 3
TICKS = 64
CP = dict(model="lifetime", target_num=12, init_interval=0.2,
          init_deviation=0.0, lifetime_mean=8.0, graceful_leave_delay=1.0)
# name -> (tick_impl, active_cap)
RUNS = {"dense": ("dense", 0), "sparse": ("sparse", 0),
        "cap2": ("sparse", 2)}


def _ep(tick_impl, cap, impl="scatter"):
    return dict(window=0.1, inbox_slots=4, pool_factor=4, inbox_impl=impl,
                tick_impl=tick_impl, active_cap=cap)


def jax_lifetime_states(seed, ticks):
    """``{run/tick|path: leaf}`` for every run of RUNS, stepped one tick
    at a time."""
    import jax
    from oversim_tpu import churn as jchurn
    from oversim_tpu.apps import kbrtest as jkbr
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.overlay.kademlia import KademliaLogic as JKademlia
    from oversim_tpu.underlay import simple as jul
    out = {}
    for name, (tick_impl, cap) in RUNS.items():
        sim = jsim.Simulation(
            JKademlia(app=jkbr.KbrTestApp(jkbr.KbrTestParams(
                test_interval=1.0))),
            jchurn.ChurnParams(**CP), jul.UnderlayParams(jitter=0.0),
            jsim.EngineParams(**_ep(tick_impl, cap)))
        a, t = own(sim.init(seed=seed)), 0
        for want in sorted(ticks):
            while t < want:
                a = sim.run_chunk(a, 1)
                t += 1
            for p, v in jax.tree_util.tree_flatten_with_path(a)[0]:
                out[f"{name}/{t}|{jax.tree_util.keystr(p)}"] = np.array(v)
    return out


def at(flat, name, tick):
    head = f"{name}/{tick}|"
    return {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}


def port_sim(tick_impl="sparse", cap=0, impl="scatter"):
    return tsim.Simulation(
        TKademlia(app=tkbr.KbrTestApp(tkbr.KbrTestParams(test_interval=1.0))),
        tchurn.ChurnParams(**CP), tul.UnderlayParams(jitter=0.0),
        tsim.EngineParams(**_ep(tick_impl, cap, impl)), device="cpu")


def strip_sparse(state):
    return dataclasses.replace(state, counters={
        k: v for k, v in state.counters.items()
        if k not in tsim.SPARSE_COUNTERS})


@pytest.fixture(scope="module")
def ref():
    return fresh_jax_call("test_torch_sparse", "jax_lifetime_states",
                          seed=SEED, ticks=[0, 48, TICKS])


@pytest.fixture(scope="module")
def port_runs():
    """The port's state after TICKS ticks for each run of RUNS, plus the
    sparse tick with the kernel wrappers on CPU tensors."""
    out = {}
    for name, (tick_impl, cap) in RUNS.items():
        sim = port_sim(tick_impl, cap)
        out[name] = (sim, sim.run_chunk(sim.init(SEED), TICKS))
    sim = port_sim(impl="pallas")
    out["pallas"] = (sim, sim.run_chunk(sim.init(SEED), TICKS))
    return out


def test_dense_tick_under_lifetime_churn_leaf_exact(ref, port_runs):
    sim, b = port_runs["dense"]
    assert first_difference(at(ref, "dense", 0), sim.init(SEED)) is None
    assert first_difference(at(ref, "dense", TICKS), b) is None
    out = sim.summary(b)
    # churn ran: final kills dropped messages to dead slots
    assert out["_engine"]["dest_unavailable_lost"] > 0
    assert out["kbr_sent"] > 0 and out["_alive"] > 0


def test_sparse_tick_leaf_exact(ref, port_runs):
    sim, b = port_runs["sparse"]
    assert sim.counter_names == tsim.ENGINE_COUNTERS + tsim.SPARSE_COUNTERS
    assert first_difference(at(ref, "sparse", 0), sim.init(SEED)) is None
    assert first_difference(at(ref, "sparse", TICKS), b) is None
    eng = sim.summary(b)["_engine"]
    assert eng["awake_nodes"] > 0 and eng["active_dst"] > 0
    assert eng["active_deferred"] == 0


def test_carried_sparse_state_leaf_exact(ref):
    sim = port_sim()
    b = interop.state_from_numpy(at(ref, "sparse", 48), sim, "cpu")
    assert first_difference(at(ref, "sparse", 48), b) is None
    b = sim.run_chunk(b, TICKS - 48)
    assert first_difference(at(ref, "sparse", TICKS), b) is None


def test_sparse_equals_dense_at_auto_cap(port_runs):
    sim, sparse = port_runs["sparse"]
    assert sim.acap == sim.n == 24
    fa = interop.state_to_numpy(port_runs["dense"][1])
    fb = interop.state_to_numpy(strip_sparse(sparse))
    assert sorted(fa) == sorted(fb)
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_capped_sparse_leaf_exact_and_deferring(ref, port_runs):
    sim, b = port_runs["cap2"]
    assert sim.acap == 2
    assert first_difference(at(ref, "cap2", TICKS), b) is None
    assert sim.summary(b)["_engine"]["active_deferred"] > 0


def test_pallas_on_cpu_equals_scatter(port_runs):
    fa = interop.state_to_numpy(port_runs["sparse"][1])
    fb = interop.state_to_numpy(port_runs["pallas"][1])
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)


@pytest.mark.parametrize("impl", ["scatter", "pallas"])
def test_all_asleep_window_compacts_to_sentinels(impl):
    """Before the first creation nothing is alive, pooled or due."""
    sim = port_sim(impl=impl)
    s = sim.init(SEED)
    t_end = torch.tensor(10**8)
    inbox, delivered, _ = sim._phase_inbox_select_sparse(s, t_end, s.alive)
    act, delivered, active = sim._phase_active_compact(
        s, t_end, s.alive, torch.zeros_like(s.alive), s.logic, inbox,
        delivered)
    assert act.shape == (sim.acap,) and bool((act == sim.n).all())
    assert not bool(delivered.any())
    assert [int(v) for v in active] == [0, 0, 0]


def test_acap_auto_and_explicit():
    def acap(slots, cap=0):
        cp = tchurn.ChurnParams(model="lifetime", target_num=slots // 2)
        return tsim.Simulation(TKademlia(), cp, engine_params=tsim.EngineParams(
            tick_impl="sparse", active_cap=cap), device="cpu").acap
    assert [acap(24), acap(1000), acap(65_536)] == [24, 125, 8192]
    assert [acap(24, 2), acap(24, 100)] == [2, 24]


# -- (g) the plain kernels against the Pallas kernels in interpret mode -------

@pytest.mark.parametrize("trial", range(8))
def test_inbox_select_plain_equals_pallas_select(trial):
    import jax.numpy as jnp
    from oversim_tpu import kernels as jkernels
    from test_torch_kernels import _random_pool
    rng = np.random.default_rng(100 + trial)
    n, p, r = 9, 48, 3
    occ = [0.0, 0.2, 0.6, 1.0][trial % 4]
    jp, tp = _random_pool(rng, p, n, occ)
    alive = rng.random(n) < 0.8
    hold = rng.random(p) < 0.3 if trial >= 4 else None
    t_end = int(rng.integers(1, 8))
    want = jkernels.inbox.fused_select(
        jp, n, r, jnp.int64(t_end), jnp.asarray(alive),
        hold=None if hold is None else jnp.asarray(hold), interpret=True)
    got = tinbox.fused_select(
        tp, n, r, torch.tensor(t_end), torch.as_tensor(alive),
        None if hold is None else torch.as_tensor(hold))
    for a, b, name in zip(want, got, ("inbox", "delivered", "to_dead")):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    due, _ = tpool.due_masks(tp, n, torch.tensor(t_end),
                             torch.as_tensor(alive),
                             None if hold is None else torch.as_tensor(hold))
    plain = tinbox.inbox_select_plain(due, torch.clamp(tp.dst, 0, n - 1),
                                      tp.t_deliver, n, r)
    assert np.array_equal(np.asarray(want[0]), plain[0].numpy())


@pytest.mark.parametrize("case", ["random", "over_cap", "empty", "full",
                                  "cap_one", "m_one", "cap_above_m",
                                  "count_equals_cap"])
def test_compact_plain_equals_pallas_compact(case):
    import jax.numpy as jnp
    from oversim_tpu import kernels as jkernels
    rng = np.random.default_rng(7)
    m = 1 if case == "m_one" else 40
    mask = {"random": rng.random(m) < 0.3, "over_cap": rng.random(m) < 0.7,
            "empty": np.zeros(m, bool), "full": np.ones(m, bool),
            "cap_one": rng.random(m) < 0.5, "m_one": np.ones(m, bool),
            "cap_above_m": rng.random(m) < 0.5,
            "count_equals_cap": np.zeros(m, bool)}[case]
    cap = {"over_cap": 10, "cap_one": 1, "cap_above_m": 48}.get(case, 16)
    if case == "count_equals_cap":
        mask[rng.choice(m, cap, replace=False)] = True
    vals = ((np.arange(m) + 13) % m).astype(np.int32)
    jl, jc = jkernels.outbox.compact_indices(
        jnp.asarray(mask), jnp.asarray(vals), cap, m, interpret=True)
    for fn in (tcompact.compact_indices, tcompact.compact_indices_plain):
        tl, tc = fn(torch.as_tensor(mask), torch.as_tensor(vals), cap, m)
        assert np.array_equal(np.asarray(jl), tl.numpy()), (case, fn)
        assert int(jc) == int(tc) == int(mask.sum()), (case, fn)
