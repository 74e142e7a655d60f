"""Kademlia + DHT + DHTTestApp on both packages, leaf-exact.

The verify.ini stack (DHT + DHTTestApp over the overlay, under
LifetimeChurn) cut to 16 slots: ``ChurnParams(model="lifetime",
target_num=8)`` with lifetime mean 8 s and a 1 s graceful leave,
``DhtParams(test_interval=2.0, num_test_keys=64, storage_slots=8)`` and
``EngineParams(window=0.1, inbox_slots=4, pool_factor=4)``, with
``init_deviation = jitter = 0`` (the engine's two normal draws, where
PyTorch's erfinv cannot match XLA's bit for bit):

(a) 120 ticks from a fresh start: every SimState leaf equal (the DHT's
    storage, operations, staged commits and the truth map included),
    with ``inbox_impl="scatter"`` and with ``"pallas"`` (the JAX
    package's Pallas kernels in interpret mode against the port's plain
    kernel versions);
(b) carried state: the JAX state after 100 ticks, truth map and all, is
    loaded into the port and both step 8 more ticks: every leaf equal.
(c) the DHT's u32 leaves: JAX's dtypes in the port's layout, and a round
    trip through ``interop`` with values at and above 2^31.

Each run also shows that the hooks it is there for acted: puts, gets,
replica fan-out, update()-driven maintenance puts and graceful-leave
handover sends (``DhtApp.tally``).  test_torch_dht_chord.py holds Chord
+ DHT and the replica-team variant, test_torch_dht_sparse.py the sparse
tick, test_torch_dht_units.py and test_torch_dht_hooks.py the helpers
and hooks one by one.  Each file's JAX runs happen in one fresh
interpreter (test_torch_engine.py ``fresh_jax_call`` says why), started
(``JaxCall``) before the port's runs so the two overlap.
"""

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop
from oversim_tpu_torch.apps import dht as tdht
from oversim_tpu_torch.common import lookup as tlk
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.overlay.chord import ChordLogic as TChord
from oversim_tpu_torch.overlay.kademlia import KademliaLogic as TKademlia
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import JaxCall, first_difference, own

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

SEED = 3
TICKS = 120
CARRY = 100
CP = dict(model="lifetime", target_num=8, init_interval=0.2,
          init_deviation=0.0, lifetime_mean=8.0, graceful_leave_delay=1.0)
DP = dict(test_interval=2.0, num_test_keys=64, storage_slots=8)
EP = dict(window=0.1, inbox_slots=4, pool_factor=4)
REPEATED = dict(variant="repeated", num_replica_teams=2)
# run name -> (overlay, inbox_impl, tick_impl, active_cap, DhtParams
# extras, ticks at which the JAX leaves are kept)
RUNS = {"scatter": ("kad", "scatter", "dense", 0, {},
                    (0, CARRY, CARRY + 8, TICKS)),
        "pallas": ("kad", "pallas", "dense", 0, {}, (TICKS,)),
        "chord": ("chord", "scatter", "dense", 0, {}, (0, TICKS)),
        "repeated": ("kad", "scatter", "dense", 0, REPEATED, (TICKS,)),
        "sparse": ("kad", "scatter", "sparse", 0, {}, (0, TICKS)),
        "cap2": ("kad", "scatter", "sparse", 2, {}, (TICKS,))}


def _params(name):
    ov, impl, tick_impl, cap, extra, _ = RUNS[name]
    ep = dict(EP, inbox_impl=impl, tick_impl=tick_impl, active_cap=cap)
    return ov, dict(DP, **extra), dict(CP), ep


def port_sim(name, device="cpu"):
    ov, dp, cp, ep = _params(name)
    app = tdht.DhtApp(tdht.DhtParams(**dp))
    app.tally = {}
    if ov == "kad":
        logic = TKademlia(app=app, lcfg=tlk.LookupConfig(slots=8, merge=True))
    else:
        logic = TChord(app=app, lcfg=tlk.LookupConfig(slots=8))
    return tsim.Simulation(logic, tchurn.ChurnParams(**cp),
                           tul.UnderlayParams(jitter=0.0),
                           tsim.EngineParams(**ep), device=device)


def jax_sim(name):
    from oversim_tpu import churn as jchurn
    from oversim_tpu.apps import dht as jdht
    from oversim_tpu.common import lookup as jlk
    from oversim_tpu.engine import sim as jsim
    from oversim_tpu.overlay.chord import ChordLogic as JChord
    from oversim_tpu.overlay.kademlia import KademliaLogic as JKademlia
    from oversim_tpu.underlay import simple as jul
    ov, dp, cp, ep = _params(name)
    app = jdht.DhtApp(jdht.DhtParams(**dp))
    if ov == "kad":
        logic = JKademlia(app=app, lcfg=jlk.LookupConfig(slots=8, merge=True))
    else:
        logic = JChord(app=app, lcfg=jlk.LookupConfig(slots=8))
    return jsim.Simulation(logic, jchurn.ChurnParams(**cp),
                           jul.UnderlayParams(jitter=0.0),
                           jsim.EngineParams(**ep))


def jax_dht_runs(seed, runs):
    """``{run/tick|path: leaf}`` for each run of ``runs`` (names of RUNS)
    stepped one tick at a time."""
    import jax
    out = {}
    for name in runs:
        ticks = RUNS[name][-1]
        sim = jax_sim(name)
        a, t = own(sim.init(seed=seed)), 0
        for want in ticks:
            while t < want:
                a = sim.run_chunk(a, 1)
                t += 1
            for p, v in jax.tree_util.tree_flatten_with_path(a)[0]:
                out[f"{name}/{t}|{jax.tree_util.keystr(p)}"] = np.array(v)
    return out


def at(flat, name, tick):
    head = f"{name}/{tick}|"
    return {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}


def port_runs(names, ref_call):
    """Each run of ``names`` stepped on the port to its last tick, then
    the JAX leaves: ``(ref, {name: (sim, init state, end state)})``."""
    runs = {}
    for name in names:
        sim = port_sim(name)
        s0 = sim.init(SEED)
        runs[name] = (sim, s0, sim.run_chunk(s0, max(RUNS[name][-1])))
    return ref_call.result(), runs


def tally(sim):
    return {k: int(v) for k, v in sim.logic.app.tally.items()}


def assert_hooks_fired(sim, state, *names):
    """The run moved data: puts and gets were issued and fanned out to
    their replicas (the tally counts from the first tick; the ``dht_*``
    statistics only inside the measurement phase), records were stored,
    and each of ``names`` (a tally or ``dht_mnt_puts``) is nonzero."""
    out, t = sim.summary(state), tally(sim)
    assert t.get("put_sends", 0) > 0 and t.get("get_sends", 0) > 0, t
    assert out["dht_stored"] > 0, out
    for name in names:
        if name == "dht_mnt_puts":
            assert out["dht_mnt_puts"] > 0, out
        else:
            assert t.get(name, 0) > 0, (name, t)


@pytest.fixture(scope="module")
def runs():
    call = JaxCall("test_torch_dht", "jax_dht_runs", seed=SEED,
                   runs=["scatter", "pallas"])
    return port_runs(["scatter", "pallas"], call)


def test_fresh_start_leaf_exact(runs):
    ref, port = runs
    sim, s0, b = port["scatter"]
    assert first_difference(at(ref, "scatter", 0), s0) is None
    assert first_difference(at(ref, "scatter", TICKS), b) is None
    assert_hooks_fired(sim, b, "dht_mnt_puts", "update_staged",
                       "handover_sends")
    assert sim.summary(b)["_engine"]["dest_unavailable_lost"] > 0


def test_fresh_start_leaf_exact_pallas(runs):
    ref, port = runs
    sim, _, b = port["pallas"]
    assert first_difference(at(ref, "pallas", TICKS), b) is None
    assert_hooks_fired(sim, b, "dht_mnt_puts", "handover_sends")


def test_carried_state_leaf_exact(runs):
    """The truth map (``app_glob``) and every node's storage come from
    the JAX state; both packages then step 8 ticks."""
    ref, _ = runs
    sim = port_sim("scatter")
    b = interop.state_from_numpy(at(ref, "scatter", CARRY), sim, "cpu")
    assert first_difference(at(ref, "scatter", CARRY), b) is None
    assert int(b.logic.app_glob.cursor) > 0
    assert bool((b.logic.app.s_val >= 0).any())
    b = sim.run_chunk(b, 8)
    assert first_difference(at(ref, "scatter", CARRY + 8), b) is None


def test_interop_round_trip_of_dht_leaves(runs):
    """The DHT's key leaves are uint32 in JAX's layout and survive a
    round trip with values at and above 2^31."""
    ref, _ = runs
    sim = port_sim("scatter")
    flat = interop.state_to_numpy(sim.init(SEED))
    layout = {k: v for k, v in at(ref, "scatter", 0).items()
              if k.startswith(".logic")}
    assert any(k.startswith(".logic.app.") for k in layout)
    for path, v in layout.items():
        assert flat[path].dtype == v.dtype, path
    rng = np.random.default_rng(5)
    u32_paths = [p for p in flat if p.startswith((".logic.app.",
                                                  ".logic.app_glob."))
                 and interop.is_u32(p)]
    assert sorted(p.rsplit(".", 1)[-1] for p in u32_paths) == [
        "commit_key", "keys", "op_key", "s_key", "tr_key"]
    for p in u32_paths:
        flat[p] = rng.integers(2 ** 31 - 4, 2 ** 32, flat[p].shape,
                               dtype=np.int64).astype(np.uint32)
    b = interop.state_from_numpy(flat, sim, "cpu")
    assert int(b.logic.app.s_key.min()) >= 2 ** 31 - 4
    back = interop.state_to_numpy(b)
    for p in u32_paths:
        assert back[p].dtype == np.uint32 and np.array_equal(back[p], flat[p])
