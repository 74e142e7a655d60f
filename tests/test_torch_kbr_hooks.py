"""KBRTest's recursive hooks against the JAX functions, for Chord's
semi, full and source modes: the duplicate ring (``_check_seen``,
KBRTestApp::checkSeen) and the deliver hooks on crafted batches, with
repeats inside a batch and against the ring, more fresh entries than the
ring holds, the per-slot hook's direct replies, and ``route_policy``.
Every app-state field and outbox field equal.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from oversim_tpu_torch.apps import kbrtest as tkbr
from oversim_tpu_torch.common import route as trt
from oversim_tpu_torch.engine import logic as tlogic
from test_torch_route_modes import MODES

torch.set_num_threads(1)

N, R, KL = 24, 6, 5
FIELDS = ("valid", "t_deliver", "src", "dst", "kind", "key", "nonce",
          "hops", "a", "b", "c", "d", "nodes", "size_b", "stamp")


def _batch(rng):
    src = rng.integers(0, 4, (N, R)).astype(np.int32)
    seq = rng.integers(0, 3, (N, R)).astype(np.int32) * 2 + 1
    kind = rng.choice(np.array([30, 35, 36], np.int32), (N, R))
    kind[:8] = 30                                  # all one-way: ring wraps
    return dict(
        valid=rng.random((N, R)) < 0.9,
        t_deliver=rng.integers(10**9, 2 * 10**9, (N, R)),
        src=src, dst=np.zeros((N, R), np.int32), kind=kind,
        key=rng.integers(0, 2**32, (N, R, KL), dtype=np.uint64
                         ).astype(np.uint32),
        nonce=np.zeros((N, R), np.int32),
        hops=rng.integers(1, 6, (N, R)).astype(np.int32), a=seq,
        b=np.zeros((N, R), np.int32), c=(seq % 2).astype(np.int32),
        d=np.zeros((N, R), np.int32),
        nodes=rng.integers(-1, N, (N, R, 16)).astype(np.int32),
        size_b=np.full((N, R), 100, np.int32),
        stamp=rng.integers(1, 10**9, (N, R)).astype(np.int64))


def _app_state(rng, app, pkg, buf):
    st = dict(t_test=np.full(N, 2**62, np.int64),
              seq=np.zeros(N, np.int32),
              rpc_dst=rng.choice(np.array([-2, -1, 1, 2], np.int32), N),
              rpc_to=np.full(N, 3 * 10**9, np.int64),
              rpc_t0=np.zeros(N, np.int64),
              rpc_nonce=rng.integers(0, 3, N).astype(np.int32) * 2 + 1,
              seen_src=rng.integers(-1, 4, (N, buf)).astype(np.int32),
              seen_seq=rng.integers(0, 3, (N, buf)).astype(np.int32) * 2 + 1,
              seen_ptr=rng.integers(0, buf, N).astype(np.int32))
    if pkg == "jax":
        from oversim_tpu.apps import kbrtest as jkbr
        return jkbr.KbrTestState(**{k: jnp.asarray(v) for k, v in st.items()})
    return tkbr.KbrTestState(**{k: torch.as_tensor(v) for k, v in st.items()})


def test_duplicate_ring_and_deliver_hooks_against_jax():
    for mode in MODES:
        _ring_and_hooks(mode)


def _ring_and_hooks(mode):
    from oversim_tpu.apps import base as jbase
    from oversim_tpu.apps import kbrtest as jkbr
    from oversim_tpu.common import route as jrt
    from oversim_tpu.engine import logic as jlogic
    from oversim_tpu_torch.apps import base as tbase
    rng = np.random.default_rng(21 + MODES.index(mode))
    keys = rng.integers(0, 2**32, (N, KL), dtype=np.uint64).astype(np.uint32)
    japp = jkbr.KbrTestApp(rcfg=jrt.RouteConfig(mode=mode))
    tapp = tkbr.KbrTestApp(rcfg=trt.RouteConfig(mode=mode))
    assert japp.buf == tapp.buf == 8
    m = _batch(rng)
    sib = rng.random((N, R)) < 0.7
    jst, tst = (_app_state(np.random.default_rng(5), a, pkg, 8)
                for a, pkg in ((japp, "jax"), (tapp, "torch")))
    jmsg = jlogic.Msg(**{k: jnp.asarray(m[k]) for k in FIELDS})
    tmsg = tlogic.Msg(**{k: torch.as_tensor(
        m[k].astype(np.int64) if m[k].dtype == np.uint32 else m[k])
        for k in FIELDS})
    jctx = types.SimpleNamespace(keys=jnp.asarray(keys))
    tctx = types.SimpleNamespace(keys=torch.as_tensor(
        keys.astype(np.int64)))
    nid = np.arange(N, dtype=np.int32)

    def batched(st, mm, sb, me):
        ob, ev = jlogic.Outbox(32, KL, 16), jbase.AppEvents()
        st = japp.on_msgs(st, mm, jctx, ob, ev, sb, node_idx=me)
        return st, ob.finish(), ev.finish({})

    def per_slot(st, mm, sb):
        ob, ev = jlogic.Outbox(32, KL, 16), jbase.AppEvents()
        for r in range(R):
            st = japp.on_msg(st, mm.slot(r), jctx, ob, ev, sb[r])
        return st, ob.finish(), ev.finish({})

    for fn, args in ((batched, (jnp.asarray(nid),)), (per_slot, ())):
        # jitted, as in the JAX tick (the latency's division by NS is
        # a multiply by its float32 reciprocal there)
        want = jax.jit(jax.vmap(fn))(jst, jmsg, jnp.asarray(sib), *args)
        ob, ev = tlogic.Outbox(N, 32, KL, 16, "cpu"), tbase.AppEvents(
            N, "cpu")
        if fn is batched:
            got_st = tapp.on_msgs(tst, tmsg, tctx, ob, ev,
                                  torch.as_tensor(sib),
                                  node_idx=torch.as_tensor(nid))
        else:
            got_st = tst
            for r in range(R):
                got_st = tapp.on_msg(got_st, tmsg.slot(r), tctx, ob, ev,
                                     torch.as_tensor(sib[:, r]))
        got = (got_st, ob.finish(), ev.finish({}))
        for name in ("seen_src", "seen_seq", "seen_ptr", "rpc_dst",
                     "rpc_to"):
            assert np.array_equal(np.asarray(getattr(want[0], name)),
                                  getattr(got[0], name).numpy()), name
        for k, v in want[1][0].items():
            w = np.asarray(v)
            w = w.astype(np.int64) if w.dtype == np.uint32 else w
            assert np.array_equal(w, got[1][0][k].numpy()), k
        assert np.array_equal(np.asarray(want[1][1]), got[1][1].numpy())
        for k, v in want[2].items():
            if isinstance(v, tuple):
                assert np.array_equal(np.asarray(v[0]),
                                      got[2][k][0].numpy()), k
                assert np.array_equal(np.asarray(v[1]),
                                      got[2][k][1].numpy()), k
            else:
                assert np.array_equal(np.asarray(v), got[2][k].numpy()), k
    # the screen caught repeats
    assert int(np.asarray(want[2]["c:kbr_delivered"]).sum()) < int(
        ((m["kind"] == 30) & m["valid"] & sib & (m["c"] != 0)).sum())
    tags = np.arange(0, 64, dtype=np.int32)
    want = jax.vmap(japp.route_policy)(jnp.asarray(tags))
    got = tapp.route_policy(torch.as_tensor(tags))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
