"""The modules under Chord, each against the JAX function on the same
numpy inputs made from a seed (the JAX per-node functions vmapped over
the node axis, the port's written over it):

* ``ncs.update`` (vivaldi and svivaldi) with rtt <= 0, zero distance and
  large errors; ``pack_wire`` / ``unpack_wire`` bit patterns with NaN,
  -0.0, negative and large floats;
* ``neighborcache.insert_rtt`` (hit, miss with LRU eviction, disabled
  rows), ``node_timeout`` and ``adaptive_timeout_fn``;
* ``lookup.on_responses`` in replace mode: two responses for one slot in
  one tick, an empty response, sibling flags;
* Chord's ``_lex_argmin`` on tied inputs and ``_find_node`` on random
  tables with duplicate fingers and edge keys.

Every float is compared bit for bit.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oversim_tpu.common import lookup as jlk
from oversim_tpu.common import ncs as jncs
from oversim_tpu.common import neighborcache as jnc
from oversim_tpu.engine import logic as jlogic
from oversim_tpu.overlay import chord as jchord
from oversim_tpu_torch.common import lookup as tlk
from oversim_tpu_torch.common import ncs as tncs
from oversim_tpu_torch.common import neighborcache as tnc
from oversim_tpu_torch.engine import logic as tlogic
from oversim_tpu_torch.overlay import chord as tchord

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

N = 48


def _same(want, got):
    """Exact equality, float32 compared by bit pattern."""
    w, g = np.asarray(want), got.detach().numpy()
    if w.dtype == np.uint32:
        w = w.astype(np.int64)
    assert w.shape == g.shape and w.dtype == g.dtype, (w.dtype, g.dtype)
    if w.dtype.kind == "f":
        w, g = w.view(np.int32 if w.itemsize == 4 else np.int64), \
            g.view(np.int32 if g.itemsize == 4 else np.int64)
    assert np.array_equal(w, g)


# -- ncs --------------------------------------------------------------------

def _ncs_inputs(rng):
    xi = rng.uniform(-0.3, 0.3, (N, 2)).astype(np.float32)
    xj = rng.uniform(-0.3, 0.3, (N, 2)).astype(np.float32)
    xj[:6] = xi[:6]                                     # zero distance
    rtt = rng.uniform(0.0, 0.4, N).astype(np.float32)
    rtt[6:12] = [0.0, -1.0, -0.0, 1e-12, np.float32(1e-9), 5.0]
    ei = rng.uniform(0.0, 1.0, N).astype(np.float32)
    ej = rng.uniform(0.0, 1.0, N).astype(np.float32)
    ei[12:16], ej[12:16] = 10.0, 1e6                    # large errors
    ei[16:18], ej[16:18] = 0.0, 0.0                     # zero weight sum
    loss = rng.uniform(0.0, 1.0, N).astype(np.float32)
    height = rng.uniform(0.0, 0.01, N).astype(np.float32)
    return xi, xj, rtt, ei, ej, loss, height


@pytest.mark.parametrize("height", [False, True])
@pytest.mark.parametrize("kind", ["vivaldi", "svivaldi"])
def test_ncs_update(kind, height):
    xi, xj, rtt, ei, ej, loss, h = _ncs_inputs(np.random.default_rng(5))
    jp = jncs.NcsParams(ncs_type=kind, enable_height=height)
    tp = tncs.NcsParams(ncs_type=kind, enable_height=height)
    me = dict(coords=xi, height=h, error=ei, loss=loss)
    want = jax.vmap(lambda m, r, x, e: jncs.update(
        m, r, x, e, jnp.float32(0.0), jp))(
        {k: jnp.asarray(v) for k, v in me.items()}, jnp.asarray(rtt),
        jnp.asarray(xj), jnp.asarray(ej))
    got = tncs.update({k: torch.as_tensor(v) for k, v in me.items()},
                      torch.as_tensor(rtt), torch.as_tensor(xj),
                      torch.as_tensor(ej), torch.zeros(()), tp)
    for k in want:
        _same(want[k], got[k])


def test_ncs_init_and_wire_round_trip():
    key = np.array([0, 9], np.uint32)
    jst = jncs.init(jnp.asarray(key), N, jncs.NcsParams())
    from oversim_tpu_torch import rng as trng
    tst = tncs.init(trng.PRNGKey(9), N, tncs.NcsParams())
    for f in dataclasses.fields(jst):
        _same(getattr(jst, f.name), getattr(tst, f.name))
    coords = np.array([[np.nan, -0.0], [-1.5, 3e38], [1e-45, -7.25],
                       [0.0, np.inf]], np.float32)
    err = np.array([-0.0, np.nan, -2.5, 1.0], np.float32)
    want = jax.vmap(lambda c, e: jncs.pack_wire(c, e, 5))(
        jnp.asarray(coords), jnp.asarray(err))
    got = tncs.pack_wire(torch.as_tensor(coords), torch.as_tensor(err), 5)
    _same(want, got)
    xj, ej = tncs.unpack_wire(got, 2)
    _same(coords, xj)
    _same(err, ej)
    wx, we = jax.vmap(lambda k: jncs.unpack_wire(k, 2))(want)
    _same(wx, xj)
    _same(we, ej)


# -- neighborcache ------------------------------------------------------------

def _cache(rng, c=6):
    peer = rng.integers(-1, 20, (N, c)).astype(np.int32)
    mean = np.where(rng.random((N, c)) < 0.2, -1.0,
                    rng.uniform(0.01, 0.5, (N, c))).astype(np.float32)
    var = np.where(rng.random((N, c)) < 0.3, 0.0,
                   rng.uniform(0.0, 0.1, (N, c))).astype(np.float32)
    last = rng.integers(0, 5, (N, c)).astype(np.int64)   # LRU ties
    live = rng.integers(0, 4, (N, c)).astype(np.int32)
    return dict(peer=peer, rtt_mean=mean, rtt_var=var, last=last, live=live)


def test_insert_rtt_hit_miss_and_disabled():
    rng = np.random.default_rng(11)
    row = _cache(rng)
    hit = rng.random(N) < 0.5
    peer = np.where(hit, row["peer"][np.arange(N), rng.integers(0, 6, N)],
                    rng.integers(20, 30, N)).astype(np.int32)
    peer[:4] = -1                                       # disabled: no peer
    rtt = rng.uniform(0.01, 0.5, N).astype(np.float32)
    rtt[4:8] = [0.0, -0.3, -0.0, 0.0]                   # disabled: rtt <= 0
    en = rng.random(N) < 0.85                           # disabled rows
    now = rng.integers(10, 20, N).astype(np.int64)
    want = jax.vmap(jnc.insert_rtt)(
        {k: jnp.asarray(v) for k, v in row.items()}, jnp.asarray(peer),
        jnp.asarray(rtt), jnp.asarray(now), jnp.asarray(en))
    got = tnc.insert_rtt(tnc.NcState(**{k: torch.as_tensor(v)
                                        for k, v in row.items()}),
                         torch.as_tensor(peer), torch.as_tensor(rtt),
                         torch.as_tensor(now), torch.as_tensor(en))
    for k in want:
        _same(want[k], getattr(got, k))
    assert not np.array_equal(np.asarray(want["peer"]), row["peer"])


def test_node_timeout_and_adaptive_timeouts():
    rng = np.random.default_rng(12)
    row = _cache(rng)
    cands = rng.integers(-1, 22, (N, 5)).astype(np.int32)
    jrow = {k: jnp.asarray(v) for k, v in row.items()}
    tst = tnc.NcState(**{k: torch.as_tensor(v) for k, v in row.items()})
    want = jax.vmap(lambda r, c: jax.vmap(
        lambda p: jnc.node_timeout(r, p, 1.5))(c))(jrow, jnp.asarray(cands))
    _same(want, tnc.node_timeout(tst, torch.as_tensor(cands), 1.5))
    for default_ns in (1_500_000_000, 300_000_000):
        want = jax.vmap(lambda r, c: jnc.adaptive_timeout_fn(
            jnc.NcState(**r), default_ns)(c))(jrow, jnp.asarray(cands))
        got = tnc.adaptive_timeout_fn(tst, default_ns)(
            torch.as_tensor(cands))
        _same(want, got)
    rtt, alive = jax.vmap(lambda r, c: jax.vmap(
        lambda p: jnc.get_prox(r, p))(c))(jrow, jnp.asarray(cands))
    trtt, talive = tnc.get_prox(tst, torch.as_tensor(cands))
    _same(rtt, trtt)
    _same(alive, talive)


# -- lookup replace mode ---------------------------------------------------

def _msgs(mod, arrs, as_t):
    kw = {k: as_t(v) for k, v in arrs.items()}
    return mod.Msg(**kw)


def test_on_responses_replace_mode():
    rng = np.random.default_rng(13)
    n, l_dim, f, r_in, kl, rmax = N, 4, 8, 6, 5, 16
    jcfg, tcfg = jlk.LookupConfig(slots=l_dim), tlk.LookupConfig(slots=l_dim)
    lk0 = jax.vmap(lambda _: jlk.init(jcfg, kl))(jnp.arange(n))
    lk = jax.tree_util.tree_map(np.array, lk0)
    lk.active[:] = rng.random((n, l_dim)) < 0.8
    lk.done[:] = rng.random((n, l_dim)) < 0.1
    lk.gen[:] = rng.integers(0, 3, (n, l_dim))
    lk.pending_dst[:] = rng.integers(0, 12, (n, l_dim, 1))
    lk.frontier[:] = rng.integers(-1, 12, (n, l_dim, f))
    lk.fr_src[:] = rng.integers(-1, 12, (n, l_dim, f))
    lk.fr_flags[:] = rng.integers(0, 4, (n, l_dim, f))
    lk.target[:] = rng.integers(0, 2**32, (n, l_dim, kl), dtype=np.uint64)
    # responses: the matching responder for a random slot; every second
    # node gets two responses for one slot (the first with nodes wins),
    # some responses are empty, some carry the sibling flag
    slot = rng.integers(0, l_dim, (n, r_in)).astype(np.int32)
    slot[::2, 1] = slot[::2, 0]
    src = np.take_along_axis(lk.pending_dst[..., 0], slot, 1)
    src[::2, 1] = rng.integers(0, 12, n // 2)
    lk.pending_dst[::2, :, 0] = np.where(
        np.arange(l_dim) == slot[::2, :1], src[::2, 1:2],
        lk.pending_dst[::2, :, 0])
    src[::2, 0] = src[::2, 1]
    nodes = rng.integers(-1, 12, (n, r_in, rmax)).astype(np.int32)
    empty = rng.random((n, r_in)) < 0.25
    nodes[empty] = -1
    nodes[1::4, 0] = -1
    arrs = dict(
        valid=rng.random((n, r_in)) < 0.9,
        t_deliver=rng.integers(0, 100, (n, r_in)).astype(np.int64),
        src=src.astype(np.int32), dst=np.zeros((n, r_in), np.int32),
        kind=np.full((n, r_in), 2, np.int32),
        key=np.zeros((n, r_in, kl), np.uint32),
        nonce=np.zeros((n, r_in), np.int32),
        hops=np.zeros((n, r_in), np.int32), a=slot,
        b=np.take_along_axis(lk.gen, slot, 1).astype(np.int32),
        c=(rng.random((n, r_in)) < 0.3).astype(np.int32),
        d=np.zeros((n, r_in), np.int32), nodes=nodes,
        size_b=np.zeros((n, r_in), np.int32),
        stamp=np.zeros((n, r_in), np.int64))
    jmsgs = _msgs(jlogic, arrs, jnp.asarray)
    want = jax.vmap(lambda s, m: jlk.on_responses(s, m, None, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, lk), jmsgs)
    tlk_state = tlk.LookupState(**{
        fld.name: torch.as_tensor(np.asarray(getattr(lk, fld.name)).astype(
            np.int64) if fld.name == "target" else
            np.asarray(getattr(lk, fld.name)))
        for fld in dataclasses.fields(tlk.LookupState)})
    tmsgs = _msgs(tlogic, {k: v.astype(np.int64) if v.dtype == np.uint32
                           else v for k, v in arrs.items()}, torch.as_tensor)
    got = tlk.on_responses(tlk_state, tmsgs, None, tcfg)
    for fld in dataclasses.fields(tlk.LookupState):
        _same(getattr(want, fld.name), getattr(got, fld.name))
    assert not np.array_equal(np.asarray(want.frontier), lk.frontier)
    assert np.asarray(want.done).sum() > lk.done.sum()


# -- Chord ------------------------------------------------------------------

@pytest.mark.parametrize("trial", range(4))
def test_lex_argmin_ties(trial):
    rng = np.random.default_rng(20 + trial)
    c, kl = 24, 5
    d = rng.integers(0, 4, (N, c, kl), dtype=np.uint64).astype(np.uint32)
    if trial == 1:
        d[:, :, :2] = 0xFFFFFFFF                 # every row ties at UMAX
    if trial == 2:
        d[:, :, 2:] = rng.integers(0, 2**32, (N, c, kl - 2),
                                   dtype=np.uint64)    # low lanes ignored
    if trial == 3:
        d = rng.integers(0, 2**32, (N, c, kl), dtype=np.uint64).astype(
            np.uint32)
        d[:, 5] = d[:, 17]
    want = jax.vmap(jchord._lex_argmin)(jnp.asarray(d))
    _same(want, tchord._lex_argmin(torch.as_tensor(d.astype(np.int64))))


def test_find_node_against_jax():
    """``_find_node`` over every inbox key at once against the JAX
    per-node, per-key function: random successor lists and fingers with
    repeats and holes, keys equal to the node's own, to its candidates
    and to its predecessor, and nodes that are not READY, alone or
    without a predecessor."""
    rng = np.random.default_rng(31)
    n, s, b, t, kl = 20, 8, 160, 12, 5
    keys = rng.integers(0, 2**32, (n, kl), dtype=np.uint64).astype(np.uint32)
    keys[3, :2] = keys[4, :2]                      # a shared top 64 bits
    state = rng.choice([0, 1, 2, 2, 2], n).astype(np.int32)
    pred = rng.integers(-1, n, n).astype(np.int32)
    succ = rng.integers(-1, n, (n, s)).astype(np.int32)
    finger = rng.choice(rng.integers(-1, n, 6), (n, b)).astype(np.int32)
    pred[5], succ[5] = -1, -1                      # alone
    pred[6] = -1
    qk = rng.integers(0, 2**32, (n, t, kl), dtype=np.uint64).astype(
        np.uint32)
    qk[:, 0] = keys                                 # my own key
    qk[:, 1] = keys[np.clip(succ[:, 0], 0, None)]
    qk[:, 2] = keys[np.clip(pred, 0, None)]
    qk[:, 3] = keys[np.clip(finger[:, 7], 0, None)]
    logic_j = jchord.ChordLogic()
    ctx_j = types.SimpleNamespace(keys=jnp.asarray(keys))

    def one(st, idx, kk):
        stn = types.SimpleNamespace(**st)
        return jax.vmap(lambda k: logic_j._find_node(
            ctx_j, stn, ctx_j.keys[idx], idx, k))(kk)

    tbl = dict(state=state, pred=pred, succ=succ, finger=finger)
    want = jax.vmap(one)({k: jnp.asarray(v) for k, v in tbl.items()},
                         jnp.arange(n, dtype=jnp.int32), jnp.asarray(qk))
    tk = torch.as_tensor(keys.astype(np.int64))
    got = tchord.ChordLogic()._find_node(
        types.SimpleNamespace(keys=tk),
        types.SimpleNamespace(**{k: torch.as_tensor(v)
                                 for k, v in tbl.items()}),
        tk, torch.arange(n, dtype=torch.int32),
        torch.as_tensor(qk.astype(np.int64)))
    _same(want[0], got[0])
    _same(want[1], got[1])
    assert np.asarray(want[1]).any() and (np.asarray(want[0]) >= 0).any()


@pytest.mark.parametrize("what", ["rcfg", "merge", "nps", "malicious",
                                  "prox", "retries"])
def test_chord_refuses_what_is_not_ported(what):
    from oversim_tpu_torch.common import malicious as tmal
    from oversim_tpu_torch.common import route as troute
    kw = {"rcfg": dict(rcfg=troute.RouteConfig()),
          "merge": dict(params=tchord.ChordParams(merge_partitions=True)),
          "nps": dict(ncs_params=tncs.NcsParams(ncs_type="nps")),
          "malicious": dict(mparams=tmal.MaliciousParams(probability=0.5)),
          "prox": dict(lcfg=tlk.LookupConfig(prox_aware=True)),
          "retries": dict(lcfg=tlk.LookupConfig(retries=1))}[what]
    if what == "rcfg":
        # recursive routing is ported: Chord takes it and binds it into
        # the app (its reply transport and duplicate ring)
        logic = tchord.ChordLogic(**kw)
        assert logic.app.rcfg is kw["rcfg"] and logic.app.buf == 8
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tchord.ChordLogic(**kw)
