"""The pieces Koorde and Broose share and their routing units, against the
JAX package at 160-, 100- and 64-bit keys; the ini builders of both.

(a) The key helpers: ``shl_const``/``shr_const`` at every static count up
    to the width, ``shl_dyn``/``shr_dyn`` at per-key counts 0, 1,
    bits - 1, bits, above bits and negative, ``log2_floor`` (a zero key
    gives -1) and ``le``.
(b) The lookup's extension words: ``start`` with and without an ext,
    ``pump``'s FindNode calls (``nodes[:EW]`` and the larger call size)
    and ``on_responses`` taking the first consuming response's tail as
    the new ext, every state field and outbox field equal.
(c) Koorde's ``_walk_pred``, ``_find_start_key`` and ``_db_hop`` on random
    successor and de Bruijn lists (empty entries, the node itself,
    duplicates, equal keys; a zero successor span), at 72 bits in place
    of 64 (Chord's coordinate piggyback needs three key lanes).
(d) Broose's ``_bkt_put``, ``_init_ext`` and ``_eval_find`` on random
    buckets and extension words (unset, left and right, brother steps).
(e) A Koorde and a Broose ini build the same parameters in both
    packages, and the port's ini-built simulation starts from the same
    state as the hand-built one.

The JAX side is the per-node function under ``jax.jit(jax.vmap(...))``
(eager JAX divides by a constant where the jitted tick multiplies by its
reciprocal).  Tolerance 0 for every value.  Nothing here runs a JAX
simulation, so both packages run in this process.
"""

import dataclasses
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from oversim_tpu.common import lookup as jlk
from oversim_tpu.core import keys as jkeys
from oversim_tpu.engine import logic as jlogic
from oversim_tpu_torch.common import lookup as tlk
from oversim_tpu_torch.core import keys as tkeys
from oversim_tpu_torch.engine import logic as tlogic
from oversim_tpu_torch.overlay import broose as tbr
from oversim_tpu_torch.overlay import koorde as tko

torch.set_num_threads(1)

N = 40
BITS = (160, 100, 64)
RMAX = 16


def _t(v):
    v = np.asarray(v)
    return torch.as_tensor(v.astype(np.int64) if v.dtype == np.uint32
                           else v)


def _same(want, got, what=""):
    w, g = np.asarray(want), got.detach().numpy()
    if w.dtype == np.uint32:
        w = w.astype(np.int64)
    assert w.shape == g.shape and w.dtype == g.dtype, (what, w.shape,
                                                       g.shape, w.dtype,
                                                       g.dtype)
    assert np.array_equal(w, g), what


def _keys(rng, spec, shape):
    k = rng.integers(0, 2**32, shape + (spec.lanes,), dtype=np.uint64
                     ).astype(np.uint32)
    k[..., 0] &= np.uint32(spec.top_lane_mask)
    return k


def _slots(rng, shape, fill=0.25, n=N):
    x = rng.integers(0, n, shape).astype(np.int32)
    return np.where(rng.random(shape) < fill, -1, x).astype(np.int32)


def _ring_keys(rng, spec):
    keys = _keys(rng, spec, (N,))
    keys[7] = keys[6]                             # equal keys
    keys[8, :2] = keys[9, :2]                     # shared top 64 bits
    return keys


def test_key_shift_helpers_against_jax():
    rng = np.random.default_rng(21)
    for bits in BITS:
        js, ts = jkeys.KeySpec(bits), tkeys.KeySpec(bits)
        a = _keys(rng, ts, (64,))
        a[0] = 0
        a[1] = np.asarray(jkeys.max_key(js))
        ja, ta = jnp.asarray(a), _t(a)
        _same(jkeys.max_key(js), tkeys.max_key(ts), f"max_key {bits}")
        for c in sorted({0, 1, 2, 4, 31, 32, 33, 63, 64, bits - 1, bits}):
            _same(jax.jit(lambda k, c=c: jkeys.shl_const(k, c, js))(ja),
                  tkeys.shl_const(ta, c, ts), f"shl {bits} {c}")
            _same(jax.jit(lambda k, c=c: jkeys.shr_const(k, c, js))(ja),
                  tkeys.shr_const(ta, c, ts), f"shr {bits} {c}")
        edges = [0, 1, bits - 1, bits, bits + 7, 3 * bits, -1, -bits]
        cnt = np.asarray(edges + list(rng.integers(-2, bits + 3, 64 - 8)),
                         np.int32)
        for name in ("shl_dyn", "shr_dyn"):
            jf, tf = getattr(jkeys, name), getattr(tkeys, name)
            _same(jax.jit(lambda k, n, jf=jf: jf(k, n, js))(
                ja, jnp.asarray(cnt)), tf(ta, _t(cnt), ts), f"{name} {bits}")
        _same(jax.jit(lambda k: jkeys.log2_floor(k, js))(ja),
              tkeys.log2_floor(ta, ts), f"log2 {bits}")
        assert int(tkeys.log2_floor(ta[:1], ts)[0]) == -1
        b = a[::-1].copy()
        b[5] = a[5]
        _same(jkeys.le(ja, jnp.asarray(b)), tkeys.le(ta, _t(b)))


def _msgs(n, r, kl, rmax):
    z32 = np.zeros((n, r), np.int32)
    return dict(valid=np.zeros((n, r), bool), t_deliver=np.zeros((n, r)),
                src=z32, dst=z32, kind=z32,
                key=np.zeros((n, r, kl), np.uint32), nonce=z32, hops=z32,
                a=z32, b=z32, c=z32, d=z32,
                nodes=np.full((n, r, rmax), -1, np.int32), size_b=z32,
                stamp=np.zeros((n, r), np.int64))


def test_lookup_ext_start_call_response():
    rng = np.random.default_rng(22)
    nid = np.arange(N, dtype=np.int32)
    for bits in BITS:
        spec = tkeys.KeySpec(bits)
        kl, ew = spec.lanes, spec.lanes + 1
        jcfg = jlk.LookupConfig(ext_words=ew)
        tcfg = tlk.LookupConfig(ext_words=ew)
        tcfg.check_ported()
        jl = jax.vmap(lambda _: jlk.init(jcfg, kl))(jnp.arange(N))
        tl = tlk.init(tcfg, kl, N)
        f = jcfg.frontier
        now = rng.integers(1, 10**9, N).astype(np.int64)
        for with_ext in (True, False):
            en = rng.random(N) < 0.8
            target = _keys(rng, spec, (N,))
            seed = _slots(rng, (N, f), 0.3)
            ext = rng.integers(-2**31, 2**31, (N, ew)).astype(np.int32)

            def jstart(lk, en, tg, sd, nw, ex):
                slot, have = jlk.free_slot(lk)
                return jlk.start(lk, en & have, slot, 7, 0, tg, sd, nw,
                                 jcfg, ext=ex if with_ext else None)

            jl = jax.jit(jax.vmap(jstart))(
                jl, jnp.asarray(en), jnp.asarray(target), jnp.asarray(seed),
                jnp.asarray(now), jnp.asarray(ext))
            slot, have = tlk.free_slot(tl)
            tl = tlk.start(tl, _t(en) & have, slot, 7, 0, _t(target),
                           _t(seed), _t(now), tcfg,
                           ext=_t(ext) if with_ext else None)

        def jpump(lk, me, nw):
            ob = jlogic.Outbox(8, kl, RMAX)
            lk, _ = jlk.pump(lk, ob, None, me, nw, None, jcfg)
            return lk, ob.finish()

        t_pump = int(now.max())
        jl, (jf, jv, _) = jax.jit(jax.vmap(jpump, (0, 0, None)))(
            jl, jnp.asarray(nid), jnp.int64(t_pump))
        ob = tlogic.Outbox(N, 8, kl, RMAX, "cpu")
        tl = tlk.pump(tl, ob, None, _t(nid), torch.tensor(t_pump), tcfg)
        tf, tv, _ = ob.finish()
        for k in jf:
            _same(jf[k], tf[k], f"outbox {k}")
        _same(jv, tv)
        assert np.asarray(jv).any()
        sent = np.asarray(jf["nodes"])[np.asarray(jv)]
        assert (sent[:, ew:] == -1).all() and (sent[:, :ew] != -1).any()

        # responses from the pending destinations, some sibling-flagged,
        # some empty, duplicates of one responder; the tail carries the
        # responder's ext
        r = 4
        pend = np.asarray(jl.pending_dst)[:, :, 0]
        m = _msgs(N, r, kl, RMAX)
        li = rng.integers(0, jcfg.slots, (N, r))
        m["a"] = li.astype(np.int32)
        m["b"] = np.take_along_axis(np.asarray(jl.gen), li, 1)
        m["src"] = np.take_along_axis(pend, li, 1).astype(np.int32)
        m["valid"] = (rng.random((N, r)) < 0.8) & (m["src"] >= 0)
        m["kind"][:] = 2
        m["c"] = (rng.random((N, r)) < 0.3).astype(np.int32)
        m["t_deliver"] = now[:, None] + rng.integers(1, 10**8, (N, r))
        m["nodes"] = _slots(rng, (N, r, RMAX), 0.3)
        m["nodes"][rng.random((N, r)) < 0.2, :f] = -1
        m["nodes"][..., RMAX - ew:] = rng.integers(-2**31, 2**31,
                                                   (N, r, ew))
        m["src"][:, 1] = m["src"][:, 0]
        m["a"][:, 1] = m["a"][:, 0]
        m["b"][:, 1] = m["b"][:, 0]
        js = jkeys.KeySpec(bits)
        keys = jnp.asarray(_keys(rng, spec, (N,)))

        def metric(c, tg):
            return jkeys.sub(jnp.broadcast_to(tg, keys[c].shape),
                             keys[jnp.maximum(c, 0)], js)

        def jresp(lk, mm):
            return jlk.on_responses(lk, mm, metric, jcfg)

        jmsg = jlogic.Msg(**{k: jnp.asarray(v) for k, v in m.items()})
        jl = jax.jit(jax.vmap(jresp))(jl, jmsg)
        tmsg = tlogic.Msg(**{k: _t(v) for k, v in m.items()})
        tl = tlk.on_responses(tl, tmsg, None, tcfg)
        for fld in dataclasses.fields(jl):
            _same(getattr(jl, fld.name), getattr(tl, fld.name),
                  f"{bits} {fld.name}")
        moved = np.asarray(jl.ext) != 0
        assert moved.any()


def _koorde_inputs(rng, spec):
    keys = _ring_keys(rng, spec)
    succ = _slots(rng, (N, 16), 0.3)
    succ[:, 0] = np.where(rng.random(N) < 0.9, np.abs(succ[:, 0]), -1)
    succ[3, :] = -1                               # an empty list
    succ[4, 2] = 4                                # itself
    succ[5, 3] = succ[5, 4]                       # a duplicate
    db_node = _slots(rng, (N,), 0.3)
    db_list = _slots(rng, (N, 16), 0.4)
    keys[10] = keys[int(max(succ[10, 0], 0))]    # a zero successor span
    return keys, succ, db_node, db_list


def test_koorde_units_against_jax():
    from oversim_tpu.overlay import koorde as jko
    rng = np.random.default_rng(23)
    nid = np.arange(N, dtype=np.int32)
    t = 3
    # Chord's ping carries the coordinates in the key lanes, so Koorde
    # needs three lanes: 72 bits stands in for 64
    for bits in (160, 100, 72):
        js, ts = jkeys.KeySpec(bits), tkeys.KeySpec(bits)
        jl, tl = jko.KoordeLogic(js), tko.KoordeLogic(ts)
        keys, succ, db_node, db_list = _koorde_inputs(rng, ts)
        jctx = types.SimpleNamespace(keys=jnp.asarray(keys))
        tctx = types.SimpleNamespace(keys=_t(keys))
        me = keys
        s0k = keys[np.maximum(succ[:, 0], 0)]
        key = _keys(rng, ts, (N, t))
        key[:, 0] = s0k                           # the successor's key
        key[:6, 1] = me[:6]                       # the own key
        # walk_pred over both lists
        for lst in (succ, db_list):
            want = jax.jit(jax.vmap(jax.vmap(
                lambda l, k: jl._walk_pred(jctx, l, k), (None, 0))))(
                jnp.asarray(lst), jnp.asarray(key))
            _same(want, tl._walk_pred(tctx, _t(lst), _t(key)), "walk")
        # findStartKey
        want = jax.jit(jax.vmap(jax.vmap(jl._find_start_key,
                                         (None, None, 0))))(
            jnp.asarray(me), jnp.asarray(s0k), jnp.asarray(key))
        got = tl._find_start_key(_t(me)[:, None], _t(s0k)[:, None], _t(key))
        _same(want[0], got[0], "start rk")
        _same(want[1], got[1].expand(N, t), "start step")
        # one de Bruijn hop from route keys inside and outside (me, succ]
        rk = _keys(rng, ts, (N, t))
        rk[:, 0] = s0k
        rk[:, 1] = np.asarray(jkeys.add(jnp.asarray(me), jkeys.from_int(
            1, js), js))
        step = rng.integers(1, bits + 1, (N, t)).astype(np.int32)
        step[:, 2] = [1, bits, bits - 1, 2] * (N // 4)
        st = types.SimpleNamespace(succ=_t(succ), db_node=_t(db_node),
                                   db_list=_t(db_list))

        def hop(sc, dn, dli, m, i, k, r, sp):
            s = types.SimpleNamespace(succ=sc, db_node=dn, db_list=dli)
            return jl._db_hop(jctx, s, m, i, k, r, sp)

        want = jax.jit(jax.vmap(jax.vmap(hop, (None,) * 5 + (0, 0, 0))))(
            jnp.asarray(succ), jnp.asarray(db_node), jnp.asarray(db_list),
            jnp.asarray(me), jnp.asarray(nid), jnp.asarray(key),
            jnp.asarray(rk), jnp.asarray(step))
        got = tl._db_hop(tctx, st, _t(me), _t(nid), _t(key), _t(rk),
                         _t(step))
        for w, g, what in zip(want, got, ("hop", "rk", "step")):
            _same(w, g, f"{bits} db_hop {what}")
        assert (np.asarray(want[0]) == np.asarray(db_node)[:, None]).any()


def _broose_state(rng, p, n=N):
    rb = _slots(rng, (n, p.pow_shift, p.r_bucket_size), 0.4, n)
    lb = _slots(rng, (n, p.lb_size), 0.5, n)
    bb = _slots(rng, (n, p.bb_size), 0.6, n)
    bb[:6, p.bucket_size - 1:] = -1               # few brothers
    state = rng.choice(np.array([1, 2, 3, 4, 4, 4], np.int32), n)
    choose = rng.integers(0, 5, n).astype(np.int32)
    return dict(rb=rb, lb=lb, bb=bb, state=state, choose=choose)


def test_broose_units_against_jax():
    from oversim_tpu.overlay import broose as jbr
    rng = np.random.default_rng(24)
    nid = np.arange(N, dtype=np.int32)
    t = 3
    for bits in BITS:
        js, ts = jkeys.KeySpec(bits), tkeys.KeySpec(bits)
        jl, tl = jbr.BrooseLogic(js), tbr.BrooseLogic(ts)
        p = tl.p
        keys = _ring_keys(rng, ts)
        jctx = types.SimpleNamespace(keys=jnp.asarray(keys))
        tctx = types.SimpleNamespace(keys=_t(keys))

        # one bucket put: existing entries, new ones, duplicates, a newer
        # lastSeen for an entry already held
        cap, c = p.r_bucket_size, 6
        arr = _slots(rng, (N, cap), 0.4)
        seen = np.where(arr >= 0, rng.integers(1, 10**9, (N, cap)), 0)
        cands = _slots(rng, (N, c), 0.3)
        cands[:, 1] = cands[:, 2]
        cands[:, 3] = arr[:, 0]
        cseen = np.where(cands >= 0, rng.integers(0, 2 * 10**9, (N, c)), 0)
        bkey = _keys(rng, ts, (N,))
        want = jax.jit(jax.vmap(lambda bk, a, s, cc, cs: jl._bkt_put(
            jctx, bk, a, s, cc, cs)))(*map(jnp.asarray, (
                bkey, arr, seen, cands, cseen)))
        got = tl._bkt_put(tctx.keys[:, :tl._top], _t(bkey), _t(arr),
                          _t(seen), _t(cands), _t(cseen))
        _same(want[0], got[0], "bkt_put")
        _same(want[1], got[1], "bkt_put seen")

        sd = _broose_state(rng, p)
        jst = {k: jnp.asarray(v) for k, v in sd.items()}
        tst = types.SimpleNamespace(**{k: _t(v) for k, v in sd.items()})
        key = _keys(rng, ts, (N, t))
        key[:, 0] = keys
        key[:, 1] = keys[np.maximum(sd["bb"][:, 0], 0)]
        want = jax.jit(jax.vmap(jax.vmap(
            lambda s, m, i, k: jl._init_ext(
                jctx, types.SimpleNamespace(**s), m, i, k),
            (None, None, None, 0))))(jst, jnp.asarray(keys),
                                     jnp.asarray(nid), jnp.asarray(key))
        got = tl._init_ext(tctx, tst, _t(keys), _t(key))
        for w, g in zip(want, got):
            _same(w, g, f"{bits} init_ext")

        # findNode: unset, left and right exts, brother steps
        ext = np.zeros((N, t, ts.lanes + 3), np.int32)
        ext[..., :ts.lanes] = _keys(rng, ts, (N, t)).view(np.int32)
        step = rng.integers(-bits, bits + 1, (N, t)).astype(np.int32)
        step[:, 2] = 0
        ext[..., ts.lanes] = step
        ext[..., ts.lanes + 1] = rng.choice(np.array([0, 1, 3], np.int32),
                                            (N, t))
        ext[..., ts.lanes + 2] = _slots(rng, (N, t), 0.3)
        want = jax.jit(jax.vmap(jax.vmap(
            lambda s, m, i, k, e: jl._eval_find(
                jctx, types.SimpleNamespace(**s), m, i, k, e, RMAX),
            (None, None, None, 0, 0))))(jst, jnp.asarray(keys),
                                        jnp.asarray(nid), jnp.asarray(key),
                                        jnp.asarray(ext))
        got = tl._eval_find(tctx, tst, _t(keys), _t(nid), _t(key), _t(ext),
                            RMAX)
        for w, g, what in zip(want, got, ("res", "sib", "ext", "ok",
                                          "init")):
            _same(w, g, f"{bits} eval_find {what}")
        assert np.asarray(want[1]).any() and not np.asarray(want[1]).all()


KOORDE_INI = textwrap.dedent("""
    [General]
    **.overlayType = "oversim.overlay.koorde.KoordeModules"
    **.targetOverlayTerminalNum = 12
    **.initPhaseCreationInterval = 200ms
    **.overlay*.koorde.stabilizeDelay = 7s
    **.overlay*.koorde.successorListSize = 12
    **.overlay*.koorde.deBruijnDelay = 20s
    **.overlay*.koorde.deBruijnListSize = 10
    **.overlay*.koorde.shiftingBits = 3
    **.tier1Type = "oversim.applications.kbrtestapp.KBRTestAppModules"
    **.tier1*.kbrTestApp.testMsgInterval = 1s

    [Config Broose]
    **.overlayType = "oversim.overlay.broose.BrooseModules"
    **.overlay*.broose.bucketSize = 6
    **.overlay*.broose.rBucketSize = 5
    **.brooseShiftingBits = 3
    **.overlay*.broose.joinDelay = 4s
    **.overlay*.broose.refreshTime = 90s
""")


def test_ini_built_koorde_and_broose():
    from oversim_tpu.config import ini as jini
    from oversim_tpu.config import scenario as jsc
    from oversim_tpu_torch import interop
    from oversim_tpu_torch.apps import kbrtest as tkbr
    from oversim_tpu_torch.config import ini as tini
    from oversim_tpu_torch.config import scenario as tsc
    from oversim_tpu_torch.engine import sim as tsim
    hand = {
        "General": tko.KoordeParams(stabilize_delay=7.0, succ_size=12,
                                    de_bruijn_delay=20.0, de_bruijn_size=10,
                                    shifting_bits=3),
        "Broose": tbr.BrooseParams(bucket_size=6, r_bucket_size=5,
                                   shifting_bits=3, join_delay=4.0,
                                   refresh_time=90.0),
    }
    for config, params in hand.items():
        ja = jsc.build_simulation(jini.IniFile.loads(KOORDE_INI), config)
        tb = tsc.build_simulation(tini.IniFile.loads(KOORDE_INI), config,
                                  device="cpu")
        assert type(tb.logic).__name__ == type(ja.logic).__name__
        assert dataclasses.asdict(ja.logic.p) == dataclasses.asdict(
            tb.logic.p) == dataclasses.asdict(params)
        assert dataclasses.asdict(ja.logic.lcfg) == dataclasses.asdict(
            tb.logic.lcfg)
        assert dataclasses.asdict(ja.logic.app.p) == dataclasses.asdict(
            tb.logic.app.p)
        cls = type(tb.logic)
        app = tkbr.KbrTestApp(tkbr.KbrTestParams(test_interval=1.0))
        logic = cls(tkeys.KeySpec(160), params, app=app)
        sim = tsim.Simulation(logic, tb.cp, tb.up, tb.ep, device="cpu")
        a = interop.state_to_numpy(tb.run_chunk(tb.init(5), 40))
        b = interop.state_to_numpy(sim.run_chunk(sim.init(5), 40))
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in a), config
