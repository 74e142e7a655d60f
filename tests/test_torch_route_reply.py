"""``common/route.py``'s source routes, replies, pre-pass, origination and
reroute on both packages, and the lookup and neighbour-cache hooks that
Pastry adds, on the same numpy inputs made from a seed (test_torch_
route.py's helpers): every field of the route state and every outbox
field equal.

The inputs cover the three reply transports (semi: direct; full: routed
back to the originator's key; source: along the visited hops), the
inbound pre-pass with and without a routing extension, origination and
the timeout reroute; and ``lookup.on_response``, ``response_rtts``,
``neighborcache.insert_rtts_batch``, ``feed_response_rtts`` and
``set_state``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oversim_tpu.apps import kbrtest as jkbr
from oversim_tpu.common import lookup as jlk
from oversim_tpu.common import neighborcache as jnc
from oversim_tpu.common import route as jrt
from oversim_tpu_torch.apps import base as tbase
from oversim_tpu_torch.apps import kbrtest as tkbr
from oversim_tpu_torch.common import lookup as tlk
from oversim_tpu_torch.common import neighborcache as tnc
from oversim_tpu_torch.common import route as trt
from test_torch_route import (KL, MSG_FIELDS, N, NID, Q, R, RMAX, _nodes,
                              _same, _t, jbox, jmsg, jrs, msgs, route_state,
                              same_outbox, same_state, tbox, tmsg, trs)

torch.set_num_threads(1)


def _ctx(rng):
    keys = rng.integers(0, 2**32, (N, KL), dtype=np.uint64).astype(np.uint32)
    return (types.SimpleNamespace(keys=jnp.asarray(keys)),
            types.SimpleNamespace(keys=torch.as_tensor(keys.astype(np.int64))))


def test_source_routes_and_the_three_reply_transports():
    for ew in (0, 2):
        _source_routes_and_replies(ew)


def _source_routes_and_replies(ew):
    rng = np.random.default_rng(6 + ew)
    m = msgs(rng, kinds=(9, 35, 7))
    m["b"] = rng.integers(-1, 6, (N, R)).astype(np.int32)
    jctx, tctx = _ctx(rng)
    en = rng.random((N, R)) < 0.7

    def sroute(mm):
        ob = jbox()
        dl = jrt.sroute_step(ob, mm)
        jrt.sroute_send(ob, mm.valid, mm.t_deliver, path=mm.nodes,
                        responder=jnp.int32(3), inner=jnp.int32(36),
                        key=mm.key, a=mm.a, hops=0, stamp=mm.stamp,
                        size_b=40)
        return dl, ob.finish()

    jdl, jout = jax.vmap(sroute)(jmsg(m))
    ob = tbox()
    tm = tmsg(m)
    tdl = trt.sroute_step(ob, tm)
    trt.sroute_send(ob, tm.valid, tm.t_deliver, path=tm.nodes,
                    responder=torch.full((N, 1), 3, dtype=torch.int32),
                    inner=36, key=tm.key, a=tm.a, hops=0, stamp=tm.stamp,
                    size_b=40)
    _same(jdl, tdl)
    same_outbox(jout, ob)
    for mode in ("semi", "full", "source"):
        cj = jrt.RouteConfig(mode=mode, ext_words=ew)
        ct = trt.RouteConfig(mode=mode, ext_words=ew)

        def rep(en, mm, me):
            ob = jbox()
            jrt.reply(ob, cj, en, mm.t_deliver, mm, jctx, me, 36,
                      key=mm.key, a=mm.a, stamp=mm.stamp, size_b=32)
            return ob.finish()

        jout = jax.vmap(rep)(jnp.asarray(en), jmsg(m), jnp.asarray(NID))
        ob = tbox()
        trt.reply(ob, ct, _t(en), tm.t_deliver, tm, tctx, _t(NID), 36,
                  key=tm.key, a=tm.a, stamp=tm.stamp, size_b=32)
        same_outbox(jout, ob)


def _kbr_app(pkg, rcfg):
    mod = jkbr if pkg == "jax" else tkbr
    return mod.KbrTestApp(mod.KbrTestParams(rpc_test=True), rcfg=rcfg)


@pytest.mark.parametrize("ew", [0, 2])
def test_prepass_originate_and_reroute(ew):
    rng = np.random.default_rng(8 + ew)
    cj, ct = jrt.RouteConfig(ext_words=ew), trt.RouteConfig(ext_words=ew)
    st = route_state(rng)
    m = msgs(rng, kinds=(7, 8, 9, 30))
    res = _nodes(rng, (N, R, RMAX), 0.3)
    sib = rng.random((N, R)) < 0.3
    ready = rng.random(N) < 0.9

    def pre(rt, mm, res, sib, ready, me):
        ob = jbox()
        rt, mm, drop = jrt.prepass(rt, ob, mm, res, sib, ready, me, cj)
        return rt, mm, drop, ob.finish()

    jst, jm, jdrop, jout = jax.vmap(pre)(
        jrs(st), jmsg(m), jnp.asarray(res), jnp.asarray(sib),
        jnp.asarray(ready), jnp.asarray(NID))
    ob = tbox()
    tst, tm, tdrop = trt.prepass(trs(st), ob, tmsg(m), _t(res), _t(sib),
                                 _t(ready), _t(NID), ct)
    same_state(jst, tst)
    for k in MSG_FIELDS:
        _same(getattr(jm, k), getattr(tm, k))
    # a count: JAX sums the int32 mask to int64
    assert np.array_equal(np.asarray(jdrop), tdrop.numpy())
    same_outbox(jout, ob)

    # origination of the app's routable requests (one-way and RPC tests)
    japp, tapp = _kbr_app("jax", cj), _kbr_app("torch", ct)
    tag = (rng.integers(0, 50, N) * 4 + rng.integers(0, 3, N)) * 2 + 1
    want = rng.random(N) < 0.8
    key = rng.integers(0, 2**32, (N, KL), dtype=np.uint64).astype(np.uint32)
    nxt = _nodes(rng, (N,), 0.2)
    is_sib = rng.random(N) < 0.2
    have = rng.random(N) < 0.8
    now = rng.integers(10**9, 2 * 10**9, N).astype(np.int64)

    def orig(rt, a_st, w, k, t, nx, sb, hv, nw, me):
        ob = jbox()
        req = type("Req", (), {})()
        req.want, req.key, req.tag = w, k, t.astype(jnp.int32)
        out = jrt.originate(rt, ob, japp, a_st, req, nx, sb, hv, nw, me,
                            RMAX, cj, jnp.bool_(True))
        return out, ob.finish()

    (jrr, jas, jfire, jstart), jout = jax.vmap(orig)(
        jst, japp.init(N), jnp.asarray(want), jnp.asarray(key),
        jnp.asarray(tag), jnp.asarray(nxt), jnp.asarray(is_sib),
        jnp.asarray(have), jnp.asarray(now), jnp.asarray(NID))
    ob = tbox()
    req = tbase.LookupReq(want=_t(want), key=_t(key),
                          tag=_t(tag.astype(np.int32)))
    trr, tas, tfire, tstart = trt.originate(
        tst, ob, tapp, tapp.init(N), req, _t(nxt), _t(is_sib), _t(have),
        _t(now), _t(NID), RMAX, ct, torch.tensor(True))
    same_state(jrr, trr)
    same_state(jas, tas)
    _same(jfire, tfire)
    _same(jstart, tstart)
    same_outbox(jout, ob)
    assert np.asarray(jfire).any()

    # timeout reroute around the failed hops
    t_end = np.int64(2 * 10**9)
    jrr, jf, jr = jax.vmap(lambda s: jrt.on_timeouts(s, t_end, cj))(jrr)
    trr, tf, tr = trt.on_timeouts(trr, torch.tensor(t_end), ct)
    res_q = _nodes(rng, (N, Q, 3), 0.3)
    sib_q = rng.random((N, Q)) < 0.2

    def rer(rt, rq, sq, f, r, me):
        ob = jbox()
        rt, g = jrt.reroute(rt, ob, rq, sq, f, r, t_end, me, cj)
        return rt, g, ob.finish()

    jrr, jg, jout = jax.vmap(rer)(jrr, jnp.asarray(res_q),
                                  jnp.asarray(sib_q), jf, jr,
                                  jnp.asarray(NID))
    ob = tbox()
    trr, tg = trt.reroute(trr, ob, _t(res_q), _t(sib_q), tf, tr,
                          torch.tensor(t_end), _t(NID), ct)
    same_state(jrr, trr)
    assert np.array_equal(np.asarray(jg), tg.numpy())
    same_outbox(jout, ob)


def _lookup_state(rng, L=4, F=8, RR=2):
    init = jax.vmap(lambda _: jlk.init(
        jlk.LookupConfig(slots=L, parallel_rpcs=RR), KL))(jnp.arange(N))
    st = {f.name: np.array(getattr(init, f.name))
          for f in dataclasses.fields(init)}
    st["active"] = rng.random((N, L)) < 0.7
    st["gen"] = rng.integers(0, 4, (N, L)).astype(np.int32)
    st["pending_dst"] = _nodes(rng, (N, L, RR), 0.3)
    st["t_sent"] = rng.integers(0, 10**9, (N, L, RR)).astype(np.int64)
    st["t_to"] = np.where(st["pending_dst"] >= 0, 3 * 10**9,
                          2**62).astype(np.int64)
    st["frontier"] = _nodes(rng, (N, L, F), 0.3)
    st["target"] = rng.integers(0, 2**32, (N, L, KL), dtype=np.uint64
                                ).astype(np.uint32)
    return st


def test_lookup_response_and_the_rtt_cache_fold():
    rng = np.random.default_rng(10)
    cfg_j, cfg_t = jlk.LookupConfig(), tlk.LookupConfig()
    lk = _lookup_state(rng)
    m = msgs(rng, kinds=(2,))
    # half the responses answer a pending RPC of theirs
    m["a"] = rng.integers(0, 4, (N, R)).astype(np.int32)
    m["b"] = np.take_along_axis(lk["gen"], m["a"], 1)
    m["src"] = np.where(rng.random((N, R)) < 0.6, np.take_along_axis(
        lk["pending_dst"][..., 0], m["a"], 1), m["src"]).astype(np.int32)
    m["c"] = (rng.random((N, R)) < 0.3).astype(np.int32)
    jl = jlk.LookupState(**{k: jnp.asarray(v) for k, v in lk.items()})
    tl = tlk.LookupState(**{k: _t(v) for k, v in lk.items()})
    # jitted, as inside the JAX tick (XLA turns the division by the
    # constant into a multiply by its float32 reciprocal there)
    want = jax.jit(jax.vmap(jlk.response_rtts))(jl, jmsg(m))
    got = tlk.response_rtts(tl, tmsg(m))
    for w, g in zip(want, got):
        _same(w, g)
    assert np.asarray(want[2]).any()

    def metric_j(c, t):
        return jnp.zeros(c.shape + (KL,), jnp.uint32)

    for r in range(R):
        jl = jax.vmap(lambda s, mm: jlk.on_response(
            s, mm.slot(r), metric_j, cfg_j))(jl, jmsg(m))
        tl = tlk.on_response(tl, tmsg(m).slot(r), None, cfg_t)
    same_state(jl, tl)

    c = 6
    peer = rng.integers(-1, 12, (N, c)).astype(np.int32)
    nc = dict(peer=peer,
              rtt_mean=np.where(rng.random((N, c)) < 0.2, -1.0, rng.uniform(
                  0.01, 0.5, (N, c))).astype(np.float32),
              rtt_var=rng.uniform(0.0, 0.1, (N, c)).astype(np.float32),
              last=rng.integers(0, 10**9, (N, c)).astype(np.int64),
              live=rng.integers(0, 4, (N, c)).astype(np.int32))
    src = rng.integers(-1, 14, (N, R)).astype(np.int32)
    src[:6, 1] = src[:6, 0]                               # repeated peers
    rtt = rng.uniform(-0.1, 0.4, (N, R)).astype(np.float32)
    ok = rng.random((N, R)) < 0.8
    now = rng.integers(10**9, 2 * 10**9, (N, R)).astype(np.int64)
    jst = jax.jit(jax.vmap(jnc.feed_response_rtts))(
        jnc.NcState(**{k: jnp.asarray(v) for k, v in nc.items()}),
        jnp.asarray(src), jnp.asarray(rtt), jnp.asarray(now), jnp.asarray(ok))
    tst = tnc.feed_response_rtts(
        tnc.NcState(**{k: _t(v) for k, v in nc.items()}), _t(src), _t(rtt),
        _t(now), _t(ok))
    same_state(jst, tst)
    j2 = jax.vmap(lambda row, p, e: jnc.set_state(row, p, jnc.S_TIMEOUT, e))(
        {k: jnp.asarray(v) for k, v in nc.items()}, jnp.asarray(src[:, 0]),
        jnp.asarray(ok[:, 0]))
    t2 = tnc.set_state(tnc.NcState(**{k: _t(v) for k, v in nc.items()}),
                       _t(src[:, 0]), tnc.S_TIMEOUT, _t(ok[:, 0]))
    _same(j2["live"], t2.live)
