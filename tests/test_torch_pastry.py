"""Pastry and Bamboo + KBRTest on both packages, leaf-exact, and
Pastry's key helpers against the JAX functions.

The runs (``RUNS``; every SimState leaf compared, float32 included) use
the tests' small shape: 64-bit keys (two lanes: JAX's Pastry step
compiles for minutes on the CPU, and the lane count drives it), 12
target nodes under LifetimeChurn (24 slots, lifetime mean 8 s, 1 s
graceful leave) or NoChurn over a ramp, ``EngineParams(window=0.1,
inbox_slots=4, pool_factor=4)``, KBRTest's one-way and RPC tests every
1 s, and ``init_deviation = jitter = 0`` (the engine's normal draws,
where PyTorch's erfinv cannot match XLA's bit for bit):

(a) Pastry semi-recursive with per-hop ACKs (the reference's default)
    for 80 ticks from a fresh start, and from the JAX state at 60 ticks
    carried into the port for 8 more;
(b) Bamboo (Bamboo's leaf set of 8) routing iteratively with adaptive
    lookup timeouts (the NeighborCache fold of FindNode RTTs) under
    NoChurn, 80 ticks: one JAX program for Bamboo and the iterative mode
    (Bamboo is Pastry with 8 leaves; JAX's Pastry step compiles for
    minutes, so each program counts);
(d) Pastry semi-recursive on the sparse tick (the auto lane cap), held
    against the JAX package's sparse tick, not its dense one (ROADMAP
    Queue C: the sparse tick is not a fixed point of the dense one); route
    ACK timeouts are in ``next_event``, so a sleeping node wakes for them;
(e) the distance, digit and prefix helpers on edge keys at 160, 100 and
    32 bits, and the statistics and state leaves both packages name.

``_find_node`` and the table learning at 160-bit keys are in
test_torch_pastry_tables.py.

The DHT over Pastry (from an ini and a trace), the ini builder and the
CLI are in test_torch_pastry_dht.py.  The JAX runs start in one fresh
interpreter (``JaxCall``; test_torch_engine.py ``fresh_jax_call`` says
why), one run after another, and the port steps meanwhile.  The
helpers here serve test_torch_pastry_dht.py and
test_torch_route_modes.py too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch.apps import kbrtest as tkbr
from oversim_tpu_torch.core import keys as tkeys
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay import pastry as tpa
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import JaxCall, first_difference, own

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

SEED = 3
SPEC64 = 64
LIFETIME = dict(model="lifetime", target_num=12, init_interval=0.2,
                init_deviation=0.0, lifetime_mean=8.0,
                graceful_leave_delay=1.0)
NOCHURN = dict(model="none", target_num=12, init_interval=0.2,
               init_deviation=0.0)
EP = dict(window=0.1, inbox_slots=4, pool_factor=4)
DP = dict(test_interval=2.0, num_test_keys=64, storage_slots=8)
# run name -> (overlay, app, churn, tick_impl, ticks kept)
RUNS = {"semi": ("pastry", "kbr", LIFETIME, "dense", (0, 60, 68, 80)),
        "bamboo_iter": ("bamboo_iter", "kbr", NOCHURN, "dense", (80,)),
        "sparse": ("pastry", "kbr", LIFETIME, "sparse", (0, 80)),
        "dht": ("pastry", "dht", LIFETIME, "dense", ())}


def _logic(pkg, name):
    ov, app_kind, _, _, _ = RUNS[name]
    if pkg == "jax":
        from oversim_tpu.apps import dht as dht_mod
        from oversim_tpu.apps import kbrtest as kbr_mod
        from oversim_tpu.core import keys
        from oversim_tpu.overlay import pastry as pa
    else:
        from oversim_tpu_torch.apps import dht as dht_mod
        kbr_mod, pa, keys = tkbr, tpa, tkeys
    spec = keys.KeySpec(SPEC64)
    if app_kind == "kbr":
        app = kbr_mod.KbrTestApp(kbr_mod.KbrTestParams(test_interval=1.0,
                                                       rpc_test=True))
    else:
        app = dht_mod.DhtApp(dht_mod.DhtParams(**DP))
    if ov == "bamboo_iter":
        return pa.BambooLogic(spec, dataclasses.replace(
            pa.bamboo_params(), routing_mode="iterative",
            adaptive_timeouts=True), app=app)
    return pa.PastryLogic(spec, params=pa.PastryParams(), app=app)


def port_sim(name, device="cpu"):
    _, _, cp, tick_impl, _ = RUNS[name]
    return tsim.Simulation(_logic("torch", name), tchurn.ChurnParams(**cp),
                           tul.UnderlayParams(jitter=0.0),
                           tsim.EngineParams(**EP, tick_impl=tick_impl),
                           device=device)


def jax_sim(name):
    from oversim_tpu import churn as jchurn
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.underlay import simple as jul
    _, _, cp, tick_impl, _ = RUNS[name]
    return jsim.Simulation(_logic("jax", name), jchurn.ChurnParams(**cp),
                           jul.UnderlayParams(jitter=0.0),
                           jsim.EngineParams(**EP, tick_impl=tick_impl))


def jax_leaves_at(sim, seed, ticks, prefix):
    """``{prefix/tick|path: leaf}`` after each tick count in ``ticks``,
    stepping one tick at a time."""
    out = {}
    a, t = own(sim.init(seed=seed)), 0
    for want in ticks:
        while t < want:
            a = sim.run_chunk(a, 1)
            t += 1
        for p, v in jax.tree_util.tree_flatten_with_path(a)[0]:
            out[f"{prefix}/{t}|{jax.tree_util.keystr(p)}"] = np.array(v)
    return out


def jax_pastry_run(seed, name):
    """The JAX leaves of run ``name`` at its kept ticks."""
    return jax_leaves_at(jax_sim(name), seed, RUNS[name][-1], name)


def jax_pastry_runs(seed, names):
    """``jax_pastry_run`` for each of ``names``, one after another."""
    out = {}
    for name in names:
        out.update(jax_pastry_run(seed, name))
    return out


def at(flat, name, tick):
    head = f"{name}/{tick}|"
    return {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}


def start_jax(module, runs, func="jax_pastry_runs"):
    """The runs in one fresh interpreter, started now, one after another:
    each JAX program compiles for minutes, and one interpreter per file
    keeps a test file from oversubscribing the host under parallel
    workers."""
    return {"jax": JaxCall(module, func, seed=SEED, names=list(runs))}


def finish(calls, port):
    """Wait for the JAX runs: ``(ref, port)``."""
    ref = {}
    for call in calls.values():
        ref.update(call.result())
    return ref, port


def port_run(name):
    sim = port_sim(name)
    s0 = sim.init(SEED)
    return sim, s0, sim.run_chunk(s0, max(RUNS[name][-1]))


def assert_routed(sim, state):
    """KBRTest traffic went through the recursive or iterative path and
    was delivered."""
    out = sim.summary(state)
    assert out["kbr_sent"] > 0 and out["kbr_delivered"] > 0, out
    assert out["kbr_rpc_sent"] > 0, out
    assert out["pastry_joins"] > 0, out
    return out


@pytest.fixture(scope="module")
def runs():
    names = ("semi", "bamboo_iter", "sparse")
    calls = start_jax("test_torch_pastry", names)
    return finish(calls, {name: port_run(name) for name in names})


def test_semi_recursive_fresh_start_leaf_exact(runs):
    ref, port = runs
    sim, s0, b = port["semi"]
    assert first_difference(at(ref, "semi", 0), s0) is None
    assert first_difference(at(ref, "semi", 80), b) is None
    assert_routed(sim, b)
    # routed payloads were parked for their ACKs and the dedup ring used
    assert int(b.logic.rr.gen.sum()) > 0
    assert bool((b.logic.app.seen_src >= 0).any())
    assert sim.summary(b)["_engine"]["dest_unavailable_lost"] > 0


def test_semi_recursive_carried_state_leaf_exact(runs):
    ref, _ = runs
    sim = port_sim("semi")
    b = interop.state_from_numpy(at(ref, "semi", 60), sim, "cpu")
    assert first_difference(at(ref, "semi", 60), b) is None
    assert bool((b.logic.rt >= 0).any())
    b = sim.run_chunk(b, 8)
    assert first_difference(at(ref, "semi", 68), b) is None


def test_bamboo_iterative_with_adaptive_timeouts_leaf_exact(runs):
    ref, port = runs
    sim, _, b = port["bamboo_iter"]
    assert first_difference(at(ref, "bamboo_iter", 80), b) is None
    out = assert_routed(sim, b)
    assert out["_alive"] == 12 and b.logic.leaf_cw.shape[1] == 4
    # iterative: nothing parked for ACKs; the RTT cache was fed
    assert not bool(b.logic.rr.active.any())
    assert bool((b.logic.nc.rtt_mean > 0).any())


def test_sparse_tick_leaf_exact(runs):
    ref, port = runs
    sim, s0, b = port["sparse"]
    assert first_difference(at(ref, "sparse", 0), s0) is None
    assert first_difference(at(ref, "sparse", 80), b) is None
    assert_routed(sim, b)
    out = sim.summary(b)
    assert 0 < out["_engine"]["awake_nodes"] < 80 * sim.n


# -- the key helpers and the layout -----------------------------------------


def test_key_helpers_against_jax():
    from oversim_tpu.core import keys as jkeys
    rng = np.random.default_rng(12)
    for bits in (160, 100, 32):
        js, ts = jkeys.KeySpec(bits), tkeys.KeySpec(bits)
        lanes = ts.lanes
        a = rng.integers(0, 2**32, (256, lanes), dtype=np.uint64
                         ).astype(np.uint32)
        a[:, 0] &= np.uint32(ts.top_lane_mask)
        b = a.copy()
        b[::2, -1] ^= 1                           # near-equal keys
        b[1::4] = rng.integers(0, 2**32, (64, lanes), dtype=np.uint64
                               ).astype(np.uint32)
        b[:, 0] &= np.uint32(ts.top_lane_mask)
        b[3] = a[3]
        b[5, 0] = a[5, 0] ^ np.uint32(1 << (ts.top_lane_bits - 1))  # half
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        ta, tb = (torch.as_tensor(x.astype(np.int64)) for x in (a, b))
        want = np.asarray(jkeys.bidir_ring_distance(ja, jb, js))
        assert np.array_equal(want.astype(np.int64), tkeys.bidir_ring_distance(
            ta, tb, ts).numpy())
        for bpd in (4, 2, 3):
            idx = rng.integers(0, bits // bpd + 2, 256)
            want = np.asarray(jax.vmap(lambda k, i: jkeys.digit(
                k, i, bpd, js))(ja, jnp.asarray(idx)))
            assert np.array_equal(want, tkeys.digit(
                ta, torch.as_tensor(idx), bpd, ts).numpy())
            want = np.asarray(jkeys.shared_prefix_digits(ja, jb, bpd, js))
            assert np.array_equal(want, tkeys.shared_prefix_digits(
                ta, tb, bpd, ts).numpy())
        want = np.asarray(jkeys.is_between_lr(ja, jb, jnp.flip(ja, 0), js))
        assert np.array_equal(want, tkeys.is_between_lr(
            ta, tb, torch.flip(ta, [0]), ts).numpy())


def test_stat_spec_and_state_layout():
    """The port's Pastry names the same statistics (``route_dropped``
    included) and the same state leaves as the JAX package's."""
    from oversim_tpu.overlay import pastry as jpa
    for name in ("semi", "bamboo_iter", "dht"):
        j, t = _logic("jax", name).stat_spec(), _logic("torch", name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t.stat_spec())
    jfields = [f.name for f in dataclasses.fields(jpa.PastryState)]
    assert jfields == [f.name for f in dataclasses.fields(tpa.PastryState)]
    assert tpa.bamboo_params().num_leaves == jpa.bamboo_params().num_leaves
