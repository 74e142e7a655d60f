"""EpiChord's helpers against the JAX package's, jitted and vmapped.

On random node tables at 160, 64 and 20-bit keys (20 bits: the slice
check's innermost slices collapse, ``max >> k`` reaching 0), every
output equal, tolerance 0:

(a) ``_cache_put``: candidates that refresh, insert, repeat and evict,
    with lastUpdate stamps tied (one stamp per inbox slot), into full
    and part-full caches: the newest C kept, ties in descending index;
(b) ``_ring_sorted`` both ways over candidates holding the node itself,
    duplicates and NO_NODE;
(c) ``_find_node`` for keys that the node is and is not responsible for,
    READY and JOINING nodes, with the source set (remote) and unset
    (local);
(d) the slice check: per slice and side the cache count, the
    deficient flag, the midpoint, and the round-robin pick from a
    cursor, against the JAX step's loop (oversim_tpu/overlay/
    epichord.py:613-648) over caches placed on and beside the slice
    bounds;
(e) ``_handle_failed``: failed nodes dropped from both lists and the
    cache, and a READY node that lost its last successor or predecessor
    rejoining (state, timers, a fresh lookup table, the app stopped).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from oversim_tpu_torch import tree
from oversim_tpu_torch import rng as trng
from oversim_tpu_torch.core import keys as tkeys
from oversim_tpu_torch.overlay import epichord as tep

torch.set_num_threads(1)

BITS = (160, 64, 20)
N = 48           # nodes of the table; the first ROWS are examined
ROWS = 24
NO = -1


def logics(bits, **kw):
    from oversim_tpu.core import keys as jkeys
    from oversim_tpu.overlay import epichord as jep
    return (jep.EpiChordLogic(jkeys.KeySpec(bits), jep.EpiChordParams(**kw)),
            tep.EpiChordLogic(tkeys.KeySpec(bits), tep.EpiChordParams(**kw)))


def key_table(bits, rng, n=N):
    """[n, KL] u32 keys: random, then nodes ROWS.. placed on and beside
    node 0's slice bounds (me +- max >> j, +- 1)."""
    spec = tkeys.KeySpec(bits)
    top = (1 << bits) - 1
    vals = [int(rng.integers(0, 2 ** 62)) << 98 | int(
        rng.integers(0, 2 ** 62)) << 36 | int(rng.integers(0, 2 ** 36))
        for _ in range(n)]
    vals = [v & top for v in vals]
    j = 1
    for i in range(ROWS, n):
        sign = 1 if i % 2 else -1
        delta = (i // 2) % 3 - 1
        vals[i] = (vals[0] + sign * (top >> j) + delta) & top
        j = j % 26 + 1
    lanes = [[(v >> (32 * k)) & 0xFFFFFFFF for k in range(spec.lanes)][::-1]
             for v in vals]
    return np.asarray(lanes, np.uint32)


def tables(bits, seed, s=4, c=64):
    """Random per-node lists: (succ, pred, cache, seen, state) numpy."""
    rng = np.random.default_rng(seed)

    def rows(width, hole):
        out = np.full((N, width), NO, np.int32)
        for i in range(N):
            pick = rng.choice(N, size=min(width, N), replace=False)[:width]
            keep = rng.random(len(pick)) > hole
            out[i, :len(pick)] = np.where(keep, pick, NO)
        return out

    succ, pred = rows(s, 0.2), rows(s, 0.2)
    succ[:3] = NO                          # alone / lost everything
    pred[3:6, 0] = NO
    cache = rows(c, 0.3)
    seen = rng.choice([0, 5, 7, 7, 9], size=(N, c)).astype(np.int64) * 10 ** 8
    seen = np.where(cache == NO, 0, seen)
    state = np.where(rng.random(N) < 0.8, tep.READY, tep.JOINING)
    return succ, pred, cache, seen, state.astype(np.int32)


def states(jl, tl, bits, seed, **tab_kw):
    succ, pred, cache, seen, state = tables(bits, seed, **tab_kw)
    js = jl.init(jax.random.PRNGKey(0), N)
    js = dataclasses.replace(
        js, succ=jnp.asarray(succ), pred=jnp.asarray(pred),
        cache=jnp.asarray(cache), cache_seen=jnp.asarray(seen),
        state=jnp.asarray(state), app_glob=None)
    ts = tl.init(trng.PRNGKey(0, "cpu"), N)
    ts = dataclasses.replace(
        ts, succ=torch.as_tensor(succ), pred=torch.as_tensor(pred),
        cache=torch.as_tensor(cache), cache_seen=torch.as_tensor(seen),
        state=torch.as_tensor(state), app_glob=None)
    return js, ts


def ctxs(keys):
    return (types.SimpleNamespace(keys=jnp.asarray(keys)),
            types.SimpleNamespace(keys=torch.as_tensor(keys.astype(np.int64))))


def eq(j, t):
    j = np.asarray(j)
    t = t.numpy()
    if j.dtype == np.uint32:
        j = j.astype(np.int64)
    return j.shape == t.shape and np.array_equal(j, t)


def test_cache_put_tied_stamps_and_eviction():
    for bits in BITS:
        _cache_put(bits)


def _cache_put(bits):
    jl, tl = logics(bits, cache_size=16)
    rng = np.random.default_rng(bits)
    keys = key_table(bits, rng)
    jctx, tctx = ctxs(keys)
    js, ts = states(jl, tl, bits, bits, c=16)
    # (a) candidates: known (refresh), new, repeated, NO_NODE; stamps tied
    cands = rng.integers(-1, N, (N, 6)).astype(np.int32)
    cands[:, 3] = cands[:, 1]
    cands[::3, 0] = np.asarray(js.cache)[::3, 2]
    now = rng.choice([7, 9, 12], N).astype(np.int64) * 10 ** 8
    put = jax.jit(jax.vmap(lambda st, c, t: jl._cache_put(st, c, t)))
    jout = put(js, jnp.asarray(cands), jnp.asarray(now))
    tc, tsn = tl._cache_put(ts.cache, ts.cache_seen, torch.as_tensor(cands),
                            torch.as_tensor(now))
    assert eq(jout.cache, tc) and eq(jout.cache_seen, tsn)
    # a single candidate (an inbox slot's sender) into full caches
    full = np.asarray(jout.cache)
    assert (full != NO).all(axis=1).any()
    one = cands[:, :1]
    jout2 = put(jout, jnp.asarray(one), jnp.asarray(now))
    tc2, tsn2 = tl._cache_put(tc, tsn, torch.as_tensor(one),
                              torch.as_tensor(now))
    assert eq(jout2.cache, tc2) and eq(jout2.cache_seen, tsn2)


def test_ring_sorted_with_self_duplicates_and_no_node():
    for bits in BITS:
        _ring_sorted(bits)


def _ring_sorted(bits):
    jl, tl = logics(bits)
    rng = np.random.default_rng(50 + bits)
    keys = key_table(bits, rng)
    jctx, tctx = ctxs(keys)
    js, ts = states(jl, tl, bits, 50 + bits)
    me = keys[:N]
    idx = np.arange(N, dtype=np.int32)
    extra = np.stack([idx, np.asarray(js.succ)[:, 0], rng.integers(
        -1, N, N).astype(np.int32)], 1)
    for cw in (True, False):
        c = np.concatenate([np.asarray(js.succ if cw else js.pred), extra], 1)
        want = jax.jit(jax.vmap(lambda k, i, cc: jl._ring_sorted(
            jctx, k, i, cc, cw)))(jnp.asarray(me), jnp.asarray(idx),
                                  jnp.asarray(c))
        got = tl._ring_sorted(tctx, torch.as_tensor(me.astype(np.int64)),
                              torch.as_tensor(idx), torch.as_tensor(c), cw)
        assert eq(want, got), cw


def test_find_node_sibling_and_not_with_source_set_and_unset():
    for bits in BITS:
        _find_node(bits)


def _find_node(bits):
    jl, tl = logics(bits)
    rng = np.random.default_rng(100 + bits)
    keys = key_table(bits, rng)
    jctx, tctx = ctxs(keys)
    js, ts = states(jl, tl, bits, 100 + bits)
    me = keys[:N]
    idx = np.arange(N, dtype=np.int32)
    # responsible keys (own key, just past the predecessor) and others
    pk = keys[np.maximum(np.asarray(js.pred)[:, 0], 0)]
    target = keys[rng.integers(0, N, N)].copy()
    target[::4] = me[::4]
    target[1::4] = pk[1::4]
    target[1::4, -1] += np.uint32(1)
    target[:, 0] &= np.uint32(tkeys.KeySpec(bits).top_lane_mask)
    src = rng.integers(-1, N, N).astype(np.int32)
    rmax = 16
    fn = jax.jit(jax.vmap(lambda st, k, i, key, s: jl._find_node(
        jctx, st, k, i, key, rmax, s)))
    tme = torch.as_tensor(me.astype(np.int64))
    tkey = torch.as_tensor(target.astype(np.int64))[:, None]
    for remote in (True, False):
        s = src if remote else np.full(N, NO, np.int32)
        want, wsib = fn(js, jnp.asarray(me), jnp.asarray(idx),
                        jnp.asarray(target), jnp.asarray(s))
        got, gsib = tl._find_node(tctx, ts, tme, torch.as_tensor(idx), tkey,
                                  rmax, torch.as_tensor(s)[:, None]
                                  if remote else None)
        assert eq(want, got[:, 0]) and eq(wsib, gsib[:, 0]), remote
        assert np.asarray(wsib).any() and not np.asarray(wsib).all()


def jax_slice_check(jl, ctx, st, me_key, cursor):
    """The JAX step's slice-check loop (oversim_tpu/overlay/epichord.py
    :613-648), for one node: its body for slice ``o``, vmapped over the
    slices (one compiled body in place of 24 unrolled ones)."""
    from oversim_tpu.core import keys as K
    p, spec = jl.p, jl.key_spec
    lastsk = ctx.keys[jnp.maximum(st.succ[-1], 0)]
    lastpk = ctx.keys[jnp.maximum(st.pred[-1], 0)]
    cachek = ctx.keys[jnp.maximum(st.cache, 0)]
    cache_ok = st.cache != NO

    def one(o):
        far_s = K.add(me_key, jl._shifted_max[o], spec)
        near_s = K.add(me_key, jl._shifted_max[o + 1], spec)
        act_s = K.is_between(lastsk, me_key, near_s, spec)
        n_in = jnp.sum((cache_ok & K.is_between_r(
            cachek, jnp.broadcast_to(near_s, cachek.shape),
            jnp.broadcast_to(far_s, cachek.shape), spec)).astype(jnp.int32))
        mid_s = K.add(near_s, K.shr_const(
            K.sub(far_s, near_s, spec), 1, spec), spec)
        far_p = K.sub(me_key, jl._shifted_max[o], spec)
        near_p = K.sub(me_key, jl._shifted_max[o + 1], spec)
        act_p = K.is_between(lastpk, near_p, me_key, spec)
        n_in_p = jnp.sum((cache_ok & K.is_between_r(
            cachek, jnp.broadcast_to(far_p, cachek.shape),
            jnp.broadcast_to(near_p, cachek.shape), spec)).astype(jnp.int32))
        mid_p = K.add(far_p, K.shr_const(
            K.sub(near_p, far_p, spec), 1, spec), spec)
        return (jnp.stack([act_s & (n_in < p.nodes_per_slice),
                           act_p & (n_in_p < p.nodes_per_slice)]),
                jnp.stack([mid_s, mid_p]), jnp.stack([n_in, n_in_p]))

    deficient, targets, counts = jax.vmap(one)(jnp.arange(p.max_slices))
    deficient = deficient.reshape(-1)
    nsl = deficient.shape[0]
    rot = (jnp.arange(nsl, dtype=jnp.int32) + cursor) % nsl
    pick = rot[jnp.argmax(deficient[rot]).astype(jnp.int32)]
    return (deficient, pick, targets.reshape(nsl, -1),
            counts.reshape(-1))


def test_slice_check_counts_midpoints_and_pick():
    for bits in BITS:
        _slice_check(bits)


def _slice_check(bits):
    jl, tl = logics(bits, nodes_per_slice=1)
    rng = np.random.default_rng(200 + bits)
    keys = key_table(bits, rng)
    jctx, tctx = ctxs(keys)
    js, ts = states(jl, tl, bits, 200 + bits)
    # the first rows' caches hold the nodes placed on node 0's bounds
    cache = np.asarray(js.cache).copy()
    for i in range(0, ROWS, 3):
        on = rng.choice(np.arange(ROWS, N), size=min(40, N - ROWS),
                        replace=False)
        cache[i, :len(on)] = on
    keys[1:ROWS:3] = keys[0]             # more rows see node 0's bounds
    jctx, tctx = ctxs(keys)
    js = dataclasses.replace(js, cache=jnp.asarray(cache))
    ts = dataclasses.replace(ts, cache=torch.as_tensor(cache))
    me = keys[:N]
    cursor = rng.integers(0, 48, N).astype(np.int32)
    want = jax.jit(jax.vmap(lambda st, k, c: jax_slice_check(
        jl, jctx, st, k, c)))(js, jnp.asarray(me), jnp.asarray(cursor))
    tme = torch.as_tensor(me.astype(np.int64))
    deficient, pick, tgt, counts = tl._slice_check(
        tctx, ts, tme, torch.as_tensor(cursor))
    assert eq(want[0], deficient) and eq(want[1], pick)
    assert eq(want[3], counts)
    assert eq(want[2][np.arange(N), np.asarray(want[1])], tgt)
    mids = tl._slice_table(torch.device("cpu"))[1]
    assert eq(want[2], tkeys.add(tme[:, None], mids[None], tl.key_spec))
    c = np.asarray(want[3])
    assert c.max() >= 2 and (c == 0).any()
    assert np.asarray(want[0]).any() and not np.asarray(want[0]).all()


def flat(state):
    if isinstance(state, torch.Tensor) or not dataclasses.is_dataclass(
            state):
        raise TypeError(type(state))
    return dict(tree.leaves_with_path(state))


def test_handle_failed_with_rejoin():
    for bits in (160, 64):
        _handle_failed(bits)


def _handle_failed(bits):
    jl, tl = logics(bits)
    rng = np.random.default_rng(300 + bits)
    keys = key_table(bits, rng)
    jctx, tctx = ctxs(keys)
    js, ts = states(jl, tl, bits, 300 + bits)
    succ = np.asarray(js.succ)
    # failures: the only successor of some rows, list and cache entries,
    # the node itself, NO_NODE
    failed = rng.integers(-1, N, (N, 5)).astype(np.int32)
    failed[:, 0] = succ[:, 0]
    failed[::5, 1] = np.arange(N, dtype=np.int32)[::5]
    failed[1::7] = NO
    one = np.full_like(succ, NO)
    one[:, 0] = succ[:, 0]
    js = dataclasses.replace(js, succ=jnp.asarray(np.where(
        np.arange(N)[:, None] % 2 == 0, one, succ)))
    ts = dataclasses.replace(ts, succ=torch.as_tensor(np.asarray(js.succ)))
    me = keys[:N]
    idx = np.arange(N, dtype=np.int32)
    now = 123_456_789
    want = jax.jit(jax.vmap(lambda st, k, i, f: jl._handle_failed(
        jctx, st, k, i, f, now)))(js, jnp.asarray(me), jnp.asarray(idx),
                                  jnp.asarray(failed))
    got = tl._handle_failed(tctx, ts, torch.as_tensor(me.astype(np.int64)),
                            torch.as_tensor(idx), torch.as_tensor(failed),
                            torch.tensor(now))
    wl = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_flatten_with_path(want)[0]}
    gl = flat(got)
    assert sorted(wl) == sorted(gl)
    for k in wl:
        assert eq(wl[k], gl[k]), k
    rejoined = (np.asarray(js.state) == tep.READY) & (
        np.asarray(want.state) == tep.JOINING)
    assert rejoined.any() and (np.asarray(want.t_join)[rejoined] == now).all()
