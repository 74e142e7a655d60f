"""Trace-driven simulations: ``trace.py``, the node-type partitions and the
DHT's trace mode, the port against the JAX package.

A ``dht.trace``-format file is generated from a numpy seed (16 nodes
joining over 1.6 s, 40 PUT/GET lines on 8 keys, a split of node types 0
and 1 in both directions from 3.0 to 4.5 s, 3 LEAVEs).  Then:

(a) the native scanner (``native/tracescan.c``, built into
    ``build/native/``) and the Python parser give the same events;
(b) ``churn_from_trace``, ``workload_from_trace`` and
    ``partitions_from_trace`` are array-equal with the JAX package's;
(c) the underlay's node types and connection-matrix replay, and
    ``Ctx.sample_ready`` restricted to connected types (2,000 draws over
    random ready masks, types and matrices) equal the JAX package's;
(d) Kademlia + DHT built from an ini plus the trace (the DHT forced by
    the trace, its command queues, the trace's key pool as truth ring,
    the partition schedule) for 320 ticks, on the dense tick and on the
    sparse tick with the kernels' plain versions: every SimState leaf
    equal, ``partition_lost`` equal and nonzero, trace PUTs and GETs
    issued.

The engine's two normal draws are set to 0 in both packages' built
simulations (test_torch_ini_run.py says why).  The JAX runs happen in one
fresh interpreter (test_torch_engine.py says why).
"""

import dataclasses

import numpy as np
import pytest
import torch

from oversim_tpu_torch import native
from oversim_tpu_torch import rng as R
from oversim_tpu_torch import trace as ttrace
from oversim_tpu_torch.config import ini as tini
from oversim_tpu_torch.config import scenario as tsc
from oversim_tpu_torch.engine import logic as tlogic
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import JaxCall, first_difference
from test_torch_ini_run import zero_normals

torch.set_num_threads(1)

SEED = 3
TICKS = 320
INI = ('**.overlayType = "oversim.overlay.kademlia.KademliaModules"\n'
       '**.tier1Type = "oversim.applications.dht.DHTModules"\n'
       '**.tier2Type = "oversim.tier2.dhttestapp.DHTTestAppModules"\n')
RUNS = {"dense": INI, "sparse": INI + '**.tickImpl = "sparse"\n'
                                      '**.inboxImpl = "pallas"\n'}


def make_trace(n=16, seed=1, ops=40, part=(3.0, 4.5), leaves=3, t_end=8.0):
    """A dht.trace-format text from numpy seed ``seed``."""
    rs = np.random.RandomState(seed)
    lines = [f"{0.1 * i:.3f} {i + 1} JOIN" for i in range(n)]
    for k in range(ops):
        t = 2.0 + (t_end - 2.5) * k / ops
        node = rs.randint(1, n + 1)
        key = f"key{rs.randint(0, 8)}"
        lines.append(f"{t:.3f} {node} PUT {key} val{k}" if k % 2 == 0
                     else f"{t:.3f} {node} GET {key}")
    for a, b in ((0, 1), (1, 0)):
        lines.append(f"{part[0]} 0 DISCONNECT_NODETYPES {a} {b}")
        lines.append(f"{part[1]} 0 CONNECT_NODETYPES {a} {b}")
    for j in range(leaves):
        lines.append(f"{t_end - 2 + 0.5 * j:.3f} {n - j} LEAVE")
    return "\n".join(lines) + "\n"


def sample_cases(seed=21, n=40, types=3, keys=2000):
    rs = np.random.RandomState(seed)
    conn = rs.random_sample((types, types)) < 0.6
    conn[types - 1] = False         # the last type sees no ready peer
    return dict(ready=rs.random_sample(n) < 0.6,
                node_type=rs.randint(0, types, n).astype(np.int32),
                conn=conn, me=rs.randint(0, n, keys).astype(np.int32))


# -- the JAX side (one fresh interpreter) -------------------------------------

def jax_side(path):
    import jax
    import jax.numpy as jnp
    from oversim_tpu import trace as jtrace
    from oversim_tpu.config import ini as jini
    from oversim_tpu.config import scenario as jsc
    from oversim_tpu.engine import logic as jlogic
    from test_torch_engine import own
    out = {}
    for name, text in RUNS.items():
        sim = zero_normals(jsc.build_simulation(
            jini.IniFile.loads(text), trace_events=jtrace.parse_trace(path)))
        a = sim.run_chunk(own(sim.init(seed=SEED)), TICKS)
        for p, v in jax.tree_util.tree_flatten_with_path(a)[0]:
            out[f"{name}|{jax.tree_util.keystr(p)}"] = np.array(v)
    c = sample_cases()
    types = c["conn"].shape[0]
    ready = jnp.asarray(c["ready"])
    cum_t = jnp.cumsum((ready[None, :] & (jnp.asarray(c["node_type"])[None, :]
                        == jnp.arange(types)[:, None])).astype(jnp.int32), 1)
    rc = jnp.cumsum(ready.astype(jnp.int32))
    ctx = jlogic.Ctx(t_start=0, t_end=0, keys=None, alive=ready, ready=ready,
                     ready_cumsum=rc, n_ready=rc[-1], measuring=False,
                     node_type=jnp.asarray(c["node_type"]),
                     conn=jnp.asarray(c["conn"]), ready_cum_t=cum_t)
    keys = jax.random.split(jax.random.PRNGKey(4), len(c["me"]))
    out["picks"] = np.asarray(jax.vmap(ctx.sample_ready)(
        keys, jnp.asarray(c["me"])))
    return out


@pytest.fixture(scope="module")
def trace_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "dht.trace"
    path.write_text(make_trace())
    return str(path)


@pytest.fixture(scope="module")
def ref(trace_file):
    return JaxCall("test_torch_trace", "jax_side", path=trace_file)


@pytest.fixture(scope="module")
def port_runs(trace_file, ref):
    out = {}
    events = ttrace.parse_trace(trace_file)
    for name, text in RUNS.items():
        sim = zero_normals(tsc.build_simulation(
            tini.IniFile.loads(text), trace_events=events, device="cpu"))
        out[name] = (sim, sim.run_chunk(sim.init(seed=SEED), TICKS))
    return out, ref.result()


def test_native_and_python_parsers_agree(trace_file):
    assert native.library("tracescan") is not None
    rows = native.scan_trace(trace_file)
    assert rows is not None and len(rows) == 16 + 40 + 4 + 3
    text = open(trace_file).read()
    assert ttrace.parse_trace(trace_file) == ttrace.parse_text(text)
    assert ttrace.parse_trace(text) == ttrace.parse_text(text)


def test_schedules_match_jax(trace_file):
    from oversim_tpu import trace as jtrace
    from oversim_tpu.core import keys as jkeys
    ev_t = ttrace.parse_trace(trace_file)
    ev_j = jtrace.parse_trace(trace_file)
    assert [dataclasses.astuple(e) for e in ev_t] == \
        [dataclasses.astuple(e) for e in ev_j]
    cp_t, cp_j = ttrace.churn_from_trace(ev_t), jtrace.churn_from_trace(ev_j)
    assert (cp_t.trace_create, cp_t.trace_kill, cp_t.num_slots) == \
        (cp_j.trace_create, cp_j.trace_kill, cp_j.num_slots)
    wl_t = ttrace.workload_from_trace(ev_t, cp_t.num_slots)
    wl_j = jtrace.workload_from_trace(ev_j, cp_j.num_slots)
    for f in ("t", "kind", "key", "value", "key_pool", "g"):
        a, b = getattr(wl_t, f), np.asarray(getattr(wl_j, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    ps_t, ps_j = (ttrace.partitions_from_trace(ev_t),
                  jtrace.partitions_from_trace(ev_j))
    for f in ("t", "a", "b", "connect"):
        a, b = getattr(ps_t, f), getattr(ps_j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(ttrace.K.sha1_key(b"key3"),
                          np.asarray(jkeys.sha1_key(b"key3")))


def test_partition_matrix_and_node_types_match_jax():
    import jax.numpy as jnp
    from oversim_tpu.underlay import simple as jul
    ev = ((1.0, 0, 1, False), (1.0, 2, 0, False), (2.5, 0, 1, True),
          (3.0, 1, 1, False))
    kw = dict(num_node_types=3, type_boundaries=(5, 11),
              partition_events=ev)
    up_t, up_j = tul.UnderlayParams(**kw), jul.UnderlayParams(**kw)
    assert np.array_equal(tul.node_types(17, up_t).numpy(),
                          np.asarray(jul.node_types(17, up_j)))
    for t in (0, 999_999_999, 1_000_000_000, 2_600_000_000, 10 ** 10):
        got = tul.connection_matrix(up_t, torch.tensor(t)).numpy()
        want = np.asarray(jul.connection_matrix(up_j, jnp.int64(t)))
        assert np.array_equal(got, want), t


def test_sample_ready_by_connected_types_matches_jax(port_runs):
    _, ref = port_runs
    c = sample_cases()
    types = c["conn"].shape[0]
    ready = torch.from_numpy(c["ready"])
    nt = torch.from_numpy(c["node_type"])
    cum_t = torch.cumsum((ready[None, :] & (nt[None, :] == torch.arange(
        types, dtype=torch.int32)[:, None])).to(torch.int32), 1,
        dtype=torch.int32)
    rc = torch.cumsum(ready.to(torch.int32), 0, dtype=torch.int32)
    ctx = tlogic.Ctx(t_start=0, t_end=0, keys=None, alive=ready, ready=ready,
                     ready_cumsum=rc, n_ready=rc[-1], measuring=False,
                     node_type=nt, conn=torch.from_numpy(c["conn"]),
                     ready_cum_t=cum_t)
    keys = R.split(R.PRNGKey(4), len(c["me"]))
    got = ctx.sample_ready(keys, torch.from_numpy(c["me"])).numpy()
    assert got.dtype == ref["picks"].dtype
    assert np.array_equal(got, ref["picks"])
    assert (got == -1).any() and (got >= 0).sum() > 1000


@pytest.mark.parametrize("name", list(RUNS))
def test_trace_dht_run_leaf_exact(port_runs, name):
    runs, ref = port_runs
    sim, st = runs[name]
    want = {k[len(name) + 1:]: v for k, v in ref.items()
            if k.startswith(name + "|")}
    assert first_difference(want, st) is None
    out = sim.summary(st)
    assert sim.up.num_node_types == 2 and sim.n == 16
    lost = out["_engine"]["partition_lost"]
    assert lost > 0 and lost == int(want[".counters['partition_lost']"])
    assert out["dht_put_attempts"] > 0 and out["dht_get_attempts"] > 0
    assert out["dht_put_success"] > 0
    assert int(st.logic.app.tr_cur.sum()) >= 12
