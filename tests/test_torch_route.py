"""``common/route.py`` on both packages, function by function, on the same
numpy inputs made from a seed (the JAX per-node functions vmapped over
the node axis, the port's written over it): every field of the route
state and every outbox field equal.

The inputs cover route-slot reuse (generations at and past the nonce's
22-bit mask, stale ACKs of a reused slot, a wrong sender, nonce 0), full
and empty slot tables, ACK timeouts with retries left and spent
(``give_up``) and visited lists that are full.  Source routes, the reply
transports, the pre-pass, origination, reroute and the lookup hooks are
in test_torch_route_reply.py, which shares the helpers here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from oversim_tpu.common import route as jrt
from oversim_tpu.engine import logic as jlogic
from oversim_tpu_torch.common import route as trt
from oversim_tpu_torch.engine import logic as tlogic

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

N, Q, V, KL, R, RMAX, M = 40, 4, 16, 5, 6, 16, 48
MSG_FIELDS = ("valid", "t_deliver", "src", "dst", "kind", "key", "nonce",
              "hops", "a", "b", "c", "d", "nodes", "size_b", "stamp")


def _same(want, got):
    """Exact equality (u32 lanes held as int64 in the port)."""
    w, g = np.asarray(want), got.detach().numpy()
    if w.dtype == np.uint32:
        w = w.astype(np.int64)
    assert w.shape == g.shape and w.dtype == g.dtype, (w.shape, g.shape,
                                                       w.dtype, g.dtype)
    assert np.array_equal(w, g)


def _nodes(rng, shape, fill=0.3):
    x = rng.integers(0, N, shape).astype(np.int32)
    return np.where(rng.random(shape) < fill, -1, x).astype(np.int32)


def route_state(rng):
    active = rng.random((N, Q)) < 0.5
    active[:4] = True                       # full tables
    active[4:8] = False                     # empty tables
    gen = rng.integers(0, 40, (N, Q)).astype(np.int32)
    gen[8:12] = 0x3FFFFF                    # the next nonce wraps the mask
    gen[12:14] = 0x400005                   # past the mask
    vis = _nodes(rng, (N, Q, V), 0.0)
    n_vis = rng.integers(0, V + 1, (N, Q))
    vis = np.where(np.arange(V) < n_vis[..., None], vis, -1).astype(np.int32)
    return dict(
        active=active, gen=gen, dst=_nodes(rng, (N, Q), 0.1),
        t_to=np.where(active, rng.integers(0, 4 * 10**9, (N, Q)),
                      2**62).astype(np.int64),
        retries=rng.integers(0, 3, (N, Q)).astype(np.int32),
        key=rng.integers(0, 2**32, (N, Q, KL), dtype=np.uint64
                         ).astype(np.uint32),
        inner=rng.integers(0, 40, (N, Q)).astype(np.int32),
        a=rng.integers(-5, 99, (N, Q)).astype(np.int32),
        b=rng.integers(-5, 99, (N, Q)).astype(np.int32),
        c=rng.integers(0, 2, (N, Q)).astype(np.int32),
        hops=rng.integers(0, 40, (N, Q)).astype(np.int32),
        stamp=rng.integers(0, 5 * 10**9, (N, Q)).astype(np.int64),
        size_b=rng.integers(28, 200, (N, Q)).astype(np.int32),
        visited=vis)


def jrs(d):
    return jrt.RouteState(**{k: jnp.asarray(v) for k, v in d.items()})


def trs(d):
    return trt.RouteState(**{k: torch.as_tensor(
        v.astype(np.int64) if v.dtype == np.uint32 else v)
        for k, v in d.items()})


def msgs(rng, r=R, kinds=(7, 8, 9, 30, 35)):
    valid = rng.random((N, r)) < 0.8
    return dict(
        valid=valid, t_deliver=rng.integers(10**9, 2 * 10**9, (N, r)),
        src=_nodes(rng, (N, r), 0.05), dst=_nodes(rng, (N, r), 0.0),
        kind=rng.choice(np.array(kinds, np.int32), (N, r)),
        key=rng.integers(0, 2**32, (N, r, KL), dtype=np.uint64
                         ).astype(np.uint32),
        nonce=rng.integers(-1, 1 + Q * 45, (N, r)).astype(np.int32),
        hops=rng.integers(0, 35, (N, r)).astype(np.int32),
        a=rng.integers(0, 99, (N, r)).astype(np.int32),
        b=rng.integers(-2, RMAX, (N, r)).astype(np.int32),
        c=_nodes(rng, (N, r), 0.0),
        d=rng.choice(np.array([30, 35], np.int32), (N, r)),
        nodes=_nodes(rng, (N, r, RMAX), 0.4),
        size_b=rng.integers(28, 200, (N, r)).astype(np.int32),
        stamp=rng.integers(1, 10**9, (N, r)).astype(np.int64))


def jmsg(d):
    return jlogic.Msg(**{k: jnp.asarray(d[k]) for k in MSG_FIELDS})


def tmsg(d):
    return tlogic.Msg(**{k: torch.as_tensor(
        d[k].astype(np.int64) if d[k].dtype == np.uint32 else d[k])
        for k in MSG_FIELDS})


def same_state(js, ts):
    for f in dataclasses.fields(js):
        _same(getattr(js, f.name), getattr(ts, f.name))


def same_outbox(jout, tob):
    jf, jv, jo = jout
    tf, tv, to = tob.finish()
    for k in jf:
        _same(jf[k], tf[k])
    _same(jv, tv)
    # the overflow count's dtype differs (JAX int64 sum, the port's int32
    # engine counter): compare values
    assert np.array_equal(np.asarray(jo), to.numpy())


def jbox():
    return jlogic.Outbox(M, KL, RMAX)


def tbox():
    return tlogic.Outbox(N, M, KL, RMAX, "cpu")


NID = np.arange(N, dtype=np.int32)


def test_pick_next_hop_and_append_visited():
    rng = np.random.default_rng(1)
    c = 5
    cands = _nodes(rng, (N, R, c), 0.2)
    vis = _nodes(rng, (N, R, V), 0.5)
    last = _nodes(rng, (N, R), 0.1)
    src = _nodes(rng, (N, R), 0.1)
    sib = rng.random((N, R)) < 0.3
    cands[:5, :, 0] = NID[:5, None]                       # self first
    src[5:8] = NID[5:8, None]                             # we are the source
    last[8:10] = cands[8:10, :, 0]                        # came from there
    want = jax.vmap(jax.vmap(jrt.pick_next_hop, (0, 0, 0, 0, None, 0)),
                    (0, 0, 0, 0, 0, 0))(
        jnp.asarray(cands), jnp.asarray(vis), jnp.asarray(last),
        jnp.asarray(src), jnp.asarray(NID), jnp.asarray(sib))
    got = trt.pick_next_hop(*(torch.as_tensor(x) for x in (
        cands, vis, last, src)), torch.as_tensor(NID)[:, None],
        torch.as_tensor(sib))
    _same(want[0], got[0])
    _same(want[1], got[1])
    full = _nodes(rng, (N, R, V), 0.0)                    # full lists too
    for v in (vis, full):
        en = rng.random((N, R)) < 0.6
        want = jax.vmap(jrt.append_visited)(jnp.asarray(v), jnp.asarray(NID),
                                            jnp.asarray(en))
        got = trt.append_visited(torch.as_tensor(v), torch.as_tensor(NID),
                                 torch.as_tensor(en))
        _same(want, got)


def _fields(rng, lanes):
    """Per-node (lanes=None) or per-lane forward() arguments."""
    sh = (N,) if lanes is None else (N, lanes)
    return dict(
        key=rng.integers(0, 2**32, sh + (KL,), dtype=np.uint64
                         ).astype(np.uint32),
        inner=rng.integers(30, 37, sh).astype(np.int32),
        a=rng.integers(0, 99, sh).astype(np.int32),
        b=rng.integers(0, 9, sh).astype(np.int32),
        c=rng.integers(0, 2, sh).astype(np.int32),
        hops=rng.integers(1, 30, sh).astype(np.int32),
        stamp=rng.integers(1, 10**9, sh).astype(np.int64),
        size_b=rng.integers(28, 200, sh).astype(np.int32),
        visited=_nodes(rng, sh + (RMAX,), 0.5))


def _t(v):
    return torch.as_tensor(v.astype(np.int64) if v.dtype == np.uint32
                           else v)


def test_forward_parks_copies_and_reuses_slots():
    for acks in (True, False):
        _forward(acks)


def _forward(acks):
    rng = np.random.default_rng(2)
    cfg_j = jrt.RouteConfig(route_acks=acks)
    cfg_t = trt.RouteConfig(route_acks=acks)
    st = route_state(rng)
    en = rng.random(N) < 0.8
    now = rng.integers(10**9, 2 * 10**9, N).astype(np.int64)
    nxt = _nodes(rng, (N,), 0.0)
    kw = _fields(rng, None)

    def one(rt, en, now, nxt, kw):
        ob = jbox()
        rt = jrt.forward(rt, ob, en, now, nxt, cfg=cfg_j, **kw)
        return rt, ob.finish()

    jst, jout = jax.vmap(one)(jrs(st), jnp.asarray(en), jnp.asarray(now),
                             jnp.asarray(nxt),
                             {k: jnp.asarray(v) for k, v in kw.items()})
    ob = tbox()
    tst = trt.forward(trs(st), ob, _t(en), _t(now), _t(nxt), cfg=cfg_t,
                      **{k: _t(v) for k, v in kw.items()})
    same_state(jst, tst)
    same_outbox(jout, ob)
    # a second hop from the same tables: the freed-and-reused slots give
    # new nonces
    act = np.asarray(jst.active)
    assert acks == bool((act & ~st["active"]).any())


def test_forward_batch_rank_matches_free_slots():
    rng = np.random.default_rng(3)
    cfg_j, cfg_t = jrt.RouteConfig(), trt.RouteConfig()
    st = route_state(rng)
    en = rng.random((N, R)) < 0.6
    now = rng.integers(10**9, 2 * 10**9, (N, R)).astype(np.int64)
    nxt = _nodes(rng, (N, R), 0.0)
    kw = _fields(rng, R)

    def one(rt, en, now, nxt, kw):
        ob = jbox()
        rt = jrt.forward_batch(rt, ob, en, now, nxt, cfg=cfg_j, **kw)
        return rt, ob.finish()

    jst, jout = jax.vmap(one)(jrs(st), jnp.asarray(en), jnp.asarray(now),
                             jnp.asarray(nxt),
                             {k: jnp.asarray(v) for k, v in kw.items()})
    ob = tbox()
    tst = trt.forward_batch(trs(st), ob, _t(en), _t(now), _t(nxt),
                            cfg=cfg_t, **{k: _t(v) for k, v in kw.items()})
    same_state(jst, tst)
    same_outbox(jout, ob)


def test_acks_free_their_slots_and_stale_ones_do_not():
    rng = np.random.default_rng(4)
    st = route_state(rng)
    m = msgs(rng)
    # right (slot, gen, sender) for half the lanes, the rest stale or
    # from another sender
    slot = rng.integers(0, Q, (N, R))
    gen = np.take_along_axis(st["gen"], slot, 1)
    stale = rng.random((N, R)) < 0.3
    m["nonce"] = np.where(rng.random((N, R)) < 0.7, 1 + slot + Q * (
        (gen - stale) & 0x3FFFFF), m["nonce"]).astype(np.int32)
    m["src"] = np.where(rng.random((N, R)) < 0.8,
                        np.take_along_axis(st["dst"], slot, 1),
                        m["src"]).astype(np.int32)
    m["kind"][:] = 8
    jst = jax.vmap(jrt.on_acks)(jrs(st), jmsg(m))
    tst = trt.on_acks(trs(st), tmsg(m))
    same_state(jst, tst)
    assert not np.array_equal(np.asarray(jst.active), st["active"])
    for r in (0, 3):
        jst = jax.vmap(lambda s, mm: jrt.on_ack(s, mm.slot(r)))(
            jrs(st), jmsg(m))
        tst = trt.on_ack(trs(st), tmsg(m).slot(r))
        same_state(jst, tst)


def test_timeouts_reforward_and_drops():
    rng = np.random.default_rng(5)
    cfg_j = jrt.RouteConfig(max_retries=2)
    cfg_t = trt.RouteConfig(max_retries=2)
    st = route_state(rng)
    t_end = np.int64(2 * 10**9)
    jst, jf, jr = jax.vmap(lambda s: jrt.on_timeouts(s, t_end, cfg_j))(
        jrs(st))
    tst, tf, tr = trt.on_timeouts(trs(st), torch.tensor(t_end), cfg_t)
    same_state(jst, tst)
    _same(jf, tf)
    _same(jr, tr)
    assert np.asarray(jr).any() and (np.asarray(jf) >= 0).sum() > \
        np.asarray(jr).sum()                              # some gave up
    nxt = _nodes(rng, (N, Q), 0.2)
    en = rng.random((N, Q)) < 0.7
    now = np.int64(2 * 10**9)

    def per_slot(rt, en, nxt):
        ob = jbox()
        for q in range(Q):
            rt = jrt.reforward(rt, ob, q, en[q], now, nxt[q], cfg_j)
            rt = jrt.drop_slot(rt, q, en[q] & (nxt[q] == -1))
        return rt, ob.finish()

    j2, jout = jax.vmap(per_slot)(jst, jnp.asarray(en), jnp.asarray(nxt))
    ob = tbox()
    t2 = tst
    for q in range(Q):
        t2 = trt.reforward(t2, ob, q, _t(en[:, q]), torch.tensor(now),
                           _t(nxt[:, q]), cfg_t)
        t2 = trt.drop_slot(t2, q, _t(en[:, q] & (nxt[:, q] == -1)))
    same_state(j2, t2)
    same_outbox(jout, ob)

    def batch(rt, en, nxt):
        ob = jbox()
        rt = jrt.reforward_batch(rt, ob, en, now, nxt, cfg_j)
        return jrt.drop_slots(rt, en & (nxt == -1)), ob.finish()

    j3, jout = jax.vmap(batch)(jst, jnp.asarray(en), jnp.asarray(nxt))
    ob = tbox()
    t3 = trt.reforward_batch(tst, ob, _t(en), torch.tensor(now), _t(nxt),
                             cfg_t)
    t3 = trt.drop_slots(t3, _t(en & (nxt == -1)))
    same_state(j3, t3)
    same_outbox(jout, ob)
    _same(jax.vmap(jrt.next_event)(j3), trt.next_event(t3))
