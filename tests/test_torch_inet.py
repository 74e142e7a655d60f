"""The router-topology underlay (InetUnderlay / ReaSE) on both packages.

(a) ``build_topology`` gives the same ``[R, R]`` delay matrix for both
    topologies, several seeds and router counts;
(b) ``init``, ``migrate`` and ``send_batch`` (jitted JAX, in process)
    leaf-exact on random ``[16, 12]`` outbox batches: lossy channels,
    node-type partitions, queue overruns, dead destinations and
    destination words out of range (a disabled lane may carry any
    payload word), with ``jitter = 0`` (the normal draw's erfinv,
    ROADMAP Queue C);
(c) whole runs, every SimState leaf equal, 100 ticks: Kademlia + KBRTest
    over ``"inet"`` (8 routers) under LifetimeChurn at 64-bit keys, and
    Chord + KBRTest over ``"rease"`` (8 routers; the JAX package's
    tests/test_inet.py scenario) under NoChurn at 96-bit keys (Chord's
    coordinate piggyback needs three key lanes);
(d) a reduced KademliaInet stack (verify.ini's modules: InetUnderlay,
    Kademlia + DHT + DHTTestApp under LifetimeChurn; at 16 slots, 64-bit
    keys, 6 access routers) from an ini through both CLIs
    (``--device cpu --json``): integer scalars equal, float scalars
    within 1e-12 relative (``assert_json_close``);
(e) a checkpoint of an inet state round-trips through the port's format.

The sims and the JAX CLI run in one fresh interpreter (test_torch_engine.py
``fresh_jax_call`` says why), started before the port's runs.
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke
from oversim_tpu_torch import checkpoint as ckpt
from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import interop, rng as trng, tree
from oversim_tpu_torch.config import scenario as tsc
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.underlay import inet as tinet
from oversim_tpu_torch.underlay import simple as tsimple
from test_torch_campaign import assert_json_close
from test_torch_engine import JaxCall, first_difference, own
from test_torch_ini_run import normals_off
from test_torch_pastry import LIFETIME, NOCHURN

torch.set_num_threads(1)

SEED = 3
TICKS = 100
EP = dict(window=0.1, inbox_slots=4, pool_factor=4)
# run name -> (overlay, key bits, churn, underlay params)
RUNS = {"kad_inet": ("kademlia", 64, LIFETIME,
                     dict(topology="inet", routers=8, jitter=0.0)),
        "chord_rease": ("chord", 96, dict(NOCHURN, target_num=16),
                        dict(topology="rease", routers=8, jitter=0.0))}
INI = chip_smoke.INET_INI      # a reduced KademliaInet stack, 16 slots
CLI = ["-c", "KademliaInet", "--until", "4.0", "--seed", "5", "--json"]


def _sim(pkg, name):
    ov, bits, cp, up = RUNS[name]
    if pkg == "jax":
        from oversim_tpu import churn as churn_mod
        from oversim_tpu.apps import kbrtest as kb
        from oversim_tpu.core import keys
        from oversim_tpu.engine import sim as sim_mod
        from oversim_tpu.underlay import inet as inet_mod
        kw = {}
    else:
        from oversim_tpu_torch.apps import kbrtest as kb
        from oversim_tpu_torch.core import keys
        churn_mod, sim_mod, inet_mod = tchurn, tsim, tinet
        kw = dict(device="cpu")
    app = kb.KbrTestApp(kb.KbrTestParams(test_interval=1.0, rpc_test=True))
    spec = keys.KeySpec(bits)
    if ov == "kademlia":
        from importlib import import_module
        ka = import_module(("oversim_tpu" if pkg == "jax"
                            else "oversim_tpu_torch") + ".overlay.kademlia")
        lk = import_module(("oversim_tpu" if pkg == "jax"
                            else "oversim_tpu_torch") + ".common.lookup")
        logic = ka.KademliaLogic(spec, app=app, lcfg=lk.LookupConfig(
            slots=4, merge=True))
    else:
        from importlib import import_module
        ch = import_module(("oversim_tpu" if pkg == "jax"
                            else "oversim_tpu_torch") + ".overlay.chord")
        logic = ch.ChordLogic(spec, app=app)
    return sim_mod.Simulation(logic, churn_mod.ChurnParams(**cp),
                              inet_mod.InetUnderlayParams(**up),
                              sim_mod.EngineParams(**EP),
                              underlay_module=inet_mod, **kw)


def jax_side(ini_path):
    """The two runs' leaves at 0 and TICKS ticks, and the JAX CLI's
    output on the KademliaInet ini."""
    import io

    import jax
    from oversim_tpu import __main__ as jmain
    from oversim_tpu.config import scenario as jsc
    out = {}
    for name in RUNS:
        sim = _sim("jax", name)
        a = own(sim.init(seed=SEED))
        for t in (0, TICKS):
            if t:
                a = sim.run_chunk(a, t)
            for p, v in jax.tree_util.tree_flatten_with_path(a)[0]:
                out[f"{name}/{t}|{jax.tree_util.keystr(p)}"] = np.array(v)
    buf = io.StringIO()
    with normals_off(jsc, fresh_t_inf=True), \
            contextlib.redirect_stdout(buf):
        assert jmain.main(["-f", ini_path, *CLI, "--platform", "cpu"]) == 0
    out["cli"] = np.array(buf.getvalue())
    return out


def at(flat, name, tick):
    head = f"{name}/{tick}|"
    return {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}


@pytest.fixture(scope="module")
def ini_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("inet") / "verify.ini"
    path.write_text(INI)
    return str(path)


@pytest.fixture(scope="module")
def runs(ini_path):
    call = JaxCall("test_torch_inet", "jax_side", ini_path=ini_path)
    port = {}
    for name in RUNS:
        sim = _sim("torch", name)
        s0 = sim.init(SEED)
        port[name] = (sim, s0, sim.run_chunk(s0, TICKS))
    return call.result(), port


# -- (a), (b): the module's functions --------------------------------------


def test_build_topology_equal():
    from oversim_tpu.underlay import inet as jinet
    for topo in ("inet", "rease"):
        for routers, transit in ((16, 4), (5, 2), (24, 6)):
            kw = dict(topology=topo, routers=routers, transit=transit)
            for seed in (0, 42, 2 ** 31 - 2):
                want = jinet.build_topology(seed, jinet.InetUnderlayParams(
                    **kw))
                got = tinet.build_topology(seed, tinet.InetUnderlayParams(
                    **kw))
                assert got.dtype == want.dtype == np.float32
                assert np.array_equal(got, want), (kw, seed)
    # the engine's connection_matrix and node_types are simple.py's
    assert tinet.connection_matrix is tsimple.connection_matrix
    assert tinet.node_types is tsimple.node_types


def _leaves_equal(jstate, tstate):
    import jax
    for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        name = jax.tree_util.keystr(p)
        got = getattr(tstate, name.lstrip("."))
        assert np.array_equal(np.asarray(v), got.numpy()), name


def test_init_migrate_send_batch_leaf_exact():
    import jax
    import jax.numpy as jnp
    from oversim_tpu.underlay import inet as jinet
    n, m = 16, 12
    part = dict(num_node_types=2, type_boundaries=(8,),
                partition_events=((0.5, 0, 1, False), (1.0, 1, 0, False)))
    kw = dict(topology="rease", routers=6, jitter=0.0,
              channel_types=("simple_ethernetline", "simple_dsl_lossy"),
              send_queue_bytes=8000, **part)
    jp, tp = jinet.InetUnderlayParams(**kw), tinet.InetUnderlayParams(**kw)
    js = jinet.init(jax.random.PRNGKey(11), n, jp)
    ts = tinet.init(trng.PRNGKey(11), n, tp)
    _leaves_equal(js, ts)
    mig = jax.jit(jinet.migrate, static_argnames=("p",))
    mask = np.arange(n) % 3 == 0
    js = mig(js, jnp.asarray(mask), jax.random.PRNGKey(12), p=jp)
    ts = tinet.migrate(ts, torch.as_tensor(mask), trng.PRNGKey(12), tp)
    _leaves_equal(js, ts)

    rng = np.random.default_rng(5)
    drops = dict.fromkeys(("queue_lost", "bit_error_lost",
                           "dest_unavailable_lost", "partition_lost"), 0)
    for batch in range(4):
        txf = rng.integers(0, 2 * 10 ** 9, n)
        js = dataclasses.replace(js, tx_finished=jnp.asarray(txf))
        ts = dataclasses.replace(ts, tx_finished=torch.as_tensor(txf))
        src = np.repeat(np.arange(n, dtype=np.int32)[:, None], m, 1)
        dst = rng.integers(-n - 3, n + 4, (n, m)).astype(np.int32)
        dst[:, 0] = src[:, 0]                      # a self-send per row
        size = rng.integers(20, 1500, (n, m)).astype(np.int32)
        # the partition schedule is read at the batch's earliest send
        t_send = rng.integers((2 + 4 * batch) * 10 ** 8, 15 * 10 ** 8, (n, m))
        want = rng.random((n, m)) < 0.8
        alive = rng.random(n) < 0.85
        key = jax.random.PRNGKey(100 + batch)
        jout = jinet.send_batch(js, jp, key, jnp.asarray(src),
                                jnp.asarray(dst), jnp.asarray(size),
                                jnp.asarray(t_send), jnp.asarray(want),
                                jnp.asarray(alive))
        tout = tinet.send_batch(ts, tp, trng.PRNGKey(100 + batch),
                                *(torch.as_tensor(x) for x in (
                                    src, dst, size, t_send, want, alive)))
        assert np.array_equal(np.asarray(jout[0]), tout[0].numpy())
        assert np.array_equal(np.asarray(jout[1]), tout[1].numpy())
        _leaves_equal(jout[2], tout[2])
        for k, v in jout[3].items():
            assert int(v) == int(tout[3][k]), k
            drops[k] += int(v)
        js, ts = jout[2], tout[2]
    # every drop kind showed up in some batch
    assert min(drops.values()) > 0, drops


# -- (c), (d): runs against the JAX package --------------------------------


def test_runs_over_both_topologies_leaf_exact(runs):
    ref, port = runs
    for name in RUNS:
        sim, s0, b = port[name]
        assert first_difference(at(ref, name, 0), s0) is None, name
        assert first_difference(at(ref, name, TICKS), b) is None, name
        out = sim.summary(b)
        assert out["kbr_delivered"] > 0, (name, out)
        # the routed delays: at least an access hop each way
        assert out["kbr_latency_s"]["mean"] > 0.002, (name, out)


def test_kademlia_inet_ini_through_both_clis(runs, ini_path, capsys):
    from oversim_tpu_torch.__main__ import main
    ref, _ = runs
    with normals_off(tsc):
        assert main(["-f", ini_path, *CLI, "--device", "cpu"]) == 0
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    want = [json.loads(x) for x in str(ref["cli"]).splitlines()]
    assert len(got) == len(want) == 1
    assert_json_close(got[0], want[0])
    assert got[0]["_t_sim"] >= 4.0 and got[0]["dht_put_attempts"] > 0


# -- (e) ---------------------------------------------------------------------


def test_inet_state_checkpoint_round_trip(runs, tmp_path):
    _, port = runs
    sim, _, b = port["kad_inet"]
    path = str(tmp_path / "inet.npz")
    ckpt.save(path, b)
    back = ckpt.load(path, sim.init(SEED))
    assert isinstance(back.underlay, tinet.InetUnderlayState)
    want = interop.state_to_numpy(b)
    got = interop.state_to_numpy(back)
    assert sorted(want) == sorted(got)
    for k in want:
        assert np.array_equal(want[k], got[k]), k
    assert ".underlay.rr_delay" in got
    assert len(tree.leaves_with_path(back)) == len(want)
