"""EpiChord: reactive Chord with a slice-invariant finger cache (PyTorch).

Counterpart of ``oversim_tpu/overlay/epichord.py`` (reference
EpiChord.{h,cc}, EpiChordNodeList, EpiChordFingerCache; default.ini:
144-164: successorListSize 4, joinDelay 10 s, stabilizeDelay 20 s,
cacheFlushDelay 20 s, cacheCheckMultiplier 3, cacheTTL 120 s,
nodesPerSlice 2, lookupMerge true), after "EpiChord: Parallelizing the
Chord Lookup Algorithm with Reactive Routing State Management".

Per node: symmetric neighbor lists ``succ``/``pred`` [N, S], ring-sorted
clockwise and counter-clockwise from the own key, and a finger cache
[N, C] of every node observed, with lastUpdate stamps, TTL expiry and
oldest-first eviction (the JAX package's bounded-cache deviation).  The
cache is the routing state: every call, response, FindNode payload, join
transfer and stabilize exchange feeds it (receiveNewNode).  Join is an
iterative lookup of the own key and a JoinCall to the responsible node;
stabilize sends one call each way; every cacheFlushDelay expired fingers
go, and every ``cacheCheckMultiplier``-th flush checks the slice
invariant and starts one lookup to a deficient slice's midpoint.
findNode answers with the siblings when responsible, else the
directional head and the cache entries closest at or after the key.

The step runs over the leading ``[N]`` axis with the JAX package's
operations.  The inbox slots are handled one after another, as the JAX
package folds them; folded, because the result is the same: a slot's
three cache puts of different message kinds (a FindNode response's
nodes, a join transfer's cache sample, a stabilize response's lists) are
one put, its neighbor-list updates of different kinds (JoinResponse,
JoinAck, StabilizeCall) one sort per list, and the app's ``on_ready`` of
the node a JoinResponse made READY runs once after the loop (it writes
only the test timer, which no slot reads).  The slice check's 2 x 24
slice bounds are one lane axis: with ring offsets from the own key each
slice is an interval of constants (the table built from ``K.max_key``),
so its counts are integer sums of compares.  The lookup completions
leave as one JoinCall send and the app's completion fold (a JOINING node
has no app lookups, so the two never both send).

``rcfg`` routes the app's payloads recursively (semi, full or source
routing) through ``common/route.py``, with findNode over the inbox's and
the parked messages' keys; app lookups stay iterative.  An app's
Common-API ``forward()`` may veto a hop on that path.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch import stats as stats_mod
from oversim_tpu_torch.apps import base as app_base
from oversim_tpu_torch.apps.kbrtest import KbrTestApp
from oversim_tpu_torch.common import lookup as lk_mod
from oversim_tpu_torch.common import route as rt_mod
from oversim_tpu_torch.common import wire
from oversim_tpu_torch.core import keys as K
from oversim_tpu_torch.engine.logic import (Outbox, bcast, keys_of,
                                           select_tree)
from oversim_tpu_torch.overlay.chord import (_sub_top_key, far_key,
                                             ring_sorted)

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1

DEAD, JOINING, READY = 0, 1, 2
P_JOIN, P_SLICE, P_APP = 1, 2, 3

# stabilize call node types (EpiChordMessage.msg NodeType)
NT_PRED, NT_SUCC = 0, 1

_fit = rt_mod.fit        # [..., k] node lists cut or NO_NODE-padded


@dataclasses.dataclass(frozen=True)
class EpiChordParams:
    """default.ini:144-164 (JAX field names and defaults)."""

    succ_size: int = 4
    join_delay: float = 10.0
    join_retry: int = 2
    stabilize_delay: float = 20.0
    cache_flush_delay: float = 20.0
    cache_check_mult: int = 3
    cache_ttl: float = 120.0
    nodes_per_slice: int = 2
    redundant_nodes: int = 3
    rpc_timeout: float = 1.5
    cache_size: int = 64
    max_slices: int = 24
    additions: int = 4


@dataclasses.dataclass
class EpiChordState:
    state: torch.Tensor         # [N] i32
    succ: torch.Tensor          # [N, S] i32 cw-sorted
    pred: torch.Tensor          # [N, S] i32 ccw-sorted
    cache: torch.Tensor         # [N, C] i32
    cache_seen: torch.Tensor    # [N, C] i64 lastUpdate
    t_join: torch.Tensor        # [N] i64
    join_retry: torch.Tensor    # [N] i32
    t_stab: torch.Tensor        # [N] i64
    t_cache: torch.Tensor       # [N] i64
    check_ctr: torch.Tensor     # [N] i32
    slice_cursor: torch.Tensor  # [N] i32 round-robin deficient slice
    lk: lk_mod.LookupState
    rr: rt_mod.RouteState
    app: object
    app_glob: object


class EpiChordLogic:
    """Engine logic interface (see engine/logic.py)."""

    def __init__(self, spec: K.KeySpec = K.DEFAULT_SPEC,
                 params: EpiChordParams = EpiChordParams(),
                 lcfg: lk_mod.LookupConfig | None = None,
                 app=None, rcfg: rt_mod.RouteConfig | None = None):
        self.key_spec = spec
        self.p = params
        self.lcfg = lcfg or lk_mod.LookupConfig(merge=True)
        self.lcfg.check_ported()
        self.app = app or KbrTestApp()
        self.rcfg = rcfg
        if rcfg is not None and getattr(self.app, "rcfg", "no") is None:
            self.app.rcfg = rcfg
        # responsibility: the clockwise successor of a key holds it
        if getattr(self.app, "dist_fn", "no") is None:
            self.app.dist_fn = (
                lambda nk, rk: K.ring_distance(rk, nk, spec))
        self._tables = {}

    # -- engine interface ---------------------------------------------------

    def stat_spec(self) -> stats_mod.StatSpec:
        app = self.app.stat_spec()
        return stats_mod.StatSpec(
            scalars=tuple(app["scalars"]) + ("lookup_hops",),
            hists=tuple(app["hists"]),
            counters=tuple(app["counters"]) + (
                "epi_joins", "epi_slice_lookups", "lookup_success",
                "lookup_failed", "route_dropped"))

    def split(self, st: EpiChordState):
        return dataclasses.replace(st, app_glob=None), st.app_glob

    def merge(self, node_part: EpiChordState, glob):
        return dataclasses.replace(node_part, app_glob=glob)

    def post_step(self, ctx, st: EpiChordState, events):
        app, glob = self.app.post_step(ctx, st.app, st.app_glob, events)
        return dataclasses.replace(st, app=app, app_glob=glob)

    def init(self, rng, n: int) -> EpiChordState:
        p = self.p
        dev = rng.device

        def full(shape, v, dt):
            return torch.full((n,) + shape, v, dtype=dt, device=dev)

        return EpiChordState(
            state=full((), 0, I32),
            succ=full((p.succ_size,), NO_NODE, I32),
            pred=full((p.succ_size,), NO_NODE, I32),
            cache=full((p.cache_size,), NO_NODE, I32),
            cache_seen=full((p.cache_size,), 0, I64),
            t_join=full((), T_INF, I64),
            join_retry=full((), p.join_retry, I32),
            t_stab=full((), T_INF, I64), t_cache=full((), T_INF, I64),
            check_ctr=full((), 0, I32), slice_cursor=full((), 0, I32),
            lk=lk_mod.init(self.lcfg, self.key_spec.lanes, n, dev),
            rr=rt_mod.init(self.rcfg or rt_mod.RouteConfig(),
                           self.key_spec.lanes, 16, n, dev),
            app=self.app.init(n, dev),
            app_glob=self.app.glob_init(rng))

    def reset(self, st: EpiChordState, clear, join, t_now, rng):
        n = st.state.shape[0]
        glob = st.app_glob
        st = dataclasses.replace(st, app_glob=None)
        fresh = dataclasses.replace(self.init(rng, n), app_glob=None)
        st = select_tree(clear, fresh, st)
        st = dataclasses.replace(st, app_glob=glob)
        # the float64 draw (x64), * 0.1 * NS left to right, truncated
        jitter = (rng_mod.uniform(rng, (n,), F64) * 0.1 * NS).to(I64)
        return dataclasses.replace(
            st, state=torch.where(join, JOINING, st.state),
            t_join=torch.where(join, t_now + jitter, st.t_join))

    def ready_mask(self, st: EpiChordState):
        return st.state == READY

    def next_event(self, st: EpiChordState):
        joining = st.state == JOINING
        ready = st.state == READY
        t = torch.where(joining, st.t_join, T_INF)
        t = torch.minimum(t, torch.where(ready, st.t_stab, T_INF))
        t = torch.minimum(t, torch.where(ready, st.t_cache, T_INF))
        t = torch.minimum(t, torch.where(ready, self.app.next_event(st.app),
                                         T_INF))
        t = torch.minimum(t, lk_mod.next_event(st.lk))
        if self.rcfg is not None:
            t = torch.minimum(t, rt_mod.next_event(st.rr))
        return t

    # -- neighbor lists + cache ---------------------------------------------

    def _ring_sorted(self, ctx, me_key, node_idx, cands, clockwise):
        """Top-S unique candidates [N, S] of ``cands`` [N, K] by cw/ccw
        ring distance from the own key (EpiChordNodeList)."""
        return ring_sorted(ctx, me_key, node_idx, cands, self.p.succ_size,
                           self.key_spec, clockwise)

    def _cache_put(self, cache, cseen, cands, seen):
        """updateFinger for ``cands`` [N, K] stamped ``seen`` [N]: refresh
        the known, insert the new, keep the newest C (a stable ascending
        sort reversed: ties in descending index order)."""
        c = self.p.cache_size
        ok = cands != NO_NODE
        match = (cache[:, :, None] == cands[:, None, :]) & ok[:, None, :]
        cseen = torch.maximum(cseen, torch.max(torch.where(
            match, seen[:, None, None], 0), -1).values)
        fresh = ok & ~torch.any(match, 1) & ~K.dup_mask(cands)
        aug = torch.cat([cache, torch.where(fresh, cands, NO_NODE)], 1)
        aseen = torch.cat([cseen, torch.where(fresh, seen[:, None], 0)], 1)
        order = torch.sort(torch.where(aug == NO_NODE, -1, aseen), dim=1,
                           stable=True).indices.flip(1)[:, :c]
        aug = torch.gather(aug, 1, order)
        return aug, torch.where(aug == NO_NODE, 0,
                                torch.gather(aseen, 1, order))

    def _expire_cache(self, cache, cseen, now):
        dead = (cache != NO_NODE) & (
            cseen + int(self.p.cache_ttl * NS) < now[:, None])
        return (torch.where(dead, NO_NODE, cache),
                torch.where(dead, 0, cseen))

    def _handle_failed(self, ctx, st, me_key, node_idx, failed, now):
        """Remove the failed nodes ``failed`` [N, F] everywhere; losing the
        last successor or predecessor while READY rejoins
        (handleFailedNode, EpiChord.cc:816-846)."""
        n = failed.shape[0]
        failed = torch.where(failed == node_idx[:, None], NO_NODE, failed)
        any_failed = torch.any(failed != NO_NODE, 1)

        def hit(x):
            return torch.any(x[:, :, None] == failed[:, None, :], -1) & (
                x != NO_NODE)

        succ = self._ring_sorted(ctx, me_key, node_idx, torch.where(
            hit(st.succ), NO_NODE, st.succ), True)
        pred = self._ring_sorted(ctx, me_key, node_idx, torch.where(
            hit(st.pred), NO_NODE, st.pred), False)
        chit = hit(st.cache) & any_failed[:, None]
        e = any_failed[:, None]
        st = dataclasses.replace(
            st, succ=torch.where(e, succ, st.succ),
            pred=torch.where(e, pred, st.pred),
            cache=torch.where(chit, NO_NODE, st.cache),
            cache_seen=torch.where(chit, 0, st.cache_seen))
        rejoin = any_failed & (st.state == READY) & (
            (st.succ[:, 0] == NO_NODE) | (st.pred[:, 0] == NO_NODE))
        fresh_lk = lk_mod.init(self.lcfg, self.key_spec.lanes, n,
                               failed.device)
        return dataclasses.replace(
            st,
            state=torch.where(rejoin, JOINING, st.state),
            t_join=torch.where(rejoin, now, st.t_join),
            t_stab=torch.where(rejoin, T_INF, st.t_stab),
            t_cache=torch.where(rejoin, T_INF, st.t_cache),
            lk=select_tree(rejoin, fresh_lk, st.lk),
            app=self.app.on_stop(st.app, rejoin))

    def _become_ready(self, st, en, now):
        """Enter READY (the app's ``on_ready`` is the caller's)."""
        p = self.p
        return dataclasses.replace(
            st,
            state=torch.where(en, READY, st.state),
            t_join=torch.where(en, T_INF, st.t_join),
            t_stab=torch.where(en, now + int(p.stabilize_delay * NS),
                               st.t_stab),
            t_cache=torch.where(en, now + int(p.cache_flush_delay * NS),
                                st.t_cache))

    # -- findNode (EpiChord.cc:517-629) -------------------------------------

    def _is_sibling(self, ctx, st, me_key, key):
        """``key`` [N, T, KL] in (pred, me] (or alone) → [N, T]."""
        pred_ok = (st.pred[:, 0] != NO_NODE)[:, None]
        pk = keys_of(ctx, st.pred[:, 0])[:, None]
        alone = ~pred_ok & (st.succ[:, 0] == NO_NODE)[:, None]
        me = me_key[:, None]
        return (st.state == READY)[:, None] & (
            alone | (~pred_ok & K.eq(key, me))
            | (pred_ok & K.is_between_r(key, pk, me, self.key_spec)))

    def _find_node(self, ctx, st, me_key, node_idx, key, rmax, src=None):
        """findNode for ``key`` [N, T, KL] from ``src`` [N, T] (None: a
        local request): ([N, T, rmax] candidates, [N, T] is_sib).  Not
        responsible: the directional head (the successor side when this
        node lies between the source and the key, else the predecessor
        side; locally the one whose distance to the key is smaller), then
        the ``redundant_nodes`` cache and list entries closest at or after
        the key clockwise."""
        p, spec = self.p, self.key_spec
        n, t = key.shape[0], key.shape[1]
        dev = key.device
        is_sib = self._is_sibling(ctx, st, me_key, key)
        k = min(p.succ_size, rmax - 2)
        sib_set = _fit(torch.cat([node_idx[:, None], st.pred[:, :1],
                                  st.succ[:, :k]], 1), rmax)

        s0, p0 = st.succ[:, 0][:, None], st.pred[:, 0][:, None]
        s0k = keys_of(ctx, st.succ[:, 0])[:, None]
        p0k = keys_of(ctx, st.pred[:, 0])[:, None]
        closer_s = K.lt(K.sub(key, s0k, spec), K.sub(key, p0k, spec))
        if src is None:
            src = torch.full((n, t), NO_NODE, dtype=I32, device=dev)
            head = torch.where(closer_s, s0, p0)
        else:
            fwd = K.is_between(me_key[:, None], keys_of(ctx, src), key,
                               spec)
            head = torch.where(src != NO_NODE, torch.where(fwd, s0, p0),
                               torch.where(closer_s, s0, p0))

        cands = torch.cat([st.cache, st.succ, st.pred], 1)         # [N, C']
        ck = keys_of(ctx, cands)
        bad = ((cands == NO_NODE) | (cands == node_idx[:, None])
               | K.dup_mask(cands))[:, None] | (
            (src != NO_NODE)[..., None] & (cands[:, None] == src[..., None])) \
            | (cands[:, None] == head[..., None])                  # [N, T, C']
        d = _sub_top_key(ck[:, None], key[:, :, None], spec)  # key → cand
        take_n = min(p.redundant_nodes, rmax - 1)
        order = torch.sort(torch.where(bad, far_key(spec), d), dim=-1,
                           stable=True).indices[..., :max(take_n, 1)]
        c_s = torch.gather(cands[:, None].expand(n, t, -1), 2, order)
        first = torch.where(head != NO_NODE, head, c_s[..., 0])
        res = _fit(torch.cat([first[..., None], c_s[..., :take_n]], -1),
                   rmax)
        res = torch.where(bcast(st.state == READY, res), res, NO_NODE)
        return torch.where(is_sib[..., None], sib_set[:, None], res), is_sib

    def _find_node1(self, ctx, st, me_key, node_idx, key, rmax):
        res, sib = self._find_node(ctx, st, me_key, node_idx, key[:, None],
                                   rmax)
        return res[:, 0], sib[:, 0]

    # -- the slice invariant (checkCacheInvariant, EpiChord.cc:416-516) -----

    def _slice_table(self, device):
        """Per device: the thresholds ``max >> k`` (k = 1 .. O + 1) as
        folded words [O + 1, W], and the slice midpoints' offsets from the
        own key [2 O, KL], successor and predecessor side interleaved."""
        key = str(device)
        if key not in self._tables:
            spec, o_n = self.key_spec, self.p.max_slices
            mk = K.max_key(spec, device)
            shm = [K.shr_const(mk, o, spec) for o in range(1, o_n + 3)]
            mids = []
            for o in range(o_n):
                far, near = shm[o], shm[o + 1]
                half = K.shr_const(K.sub(far, near, spec), 1, spec)
                mids.append(K.add(near, half, spec))
                mids.append(K.add(K.neg(far, spec), half, spec))
            thr = torch.stack(shm[:o_n + 1])
            # static, for short keys: the slices whose two bounds
            # coincide, and those whose inner bound is the own key
            top = (1 << spec.bits) - 1
            same = [top >> (o + 1) == top >> (o + 2) for o in range(o_n)]
            a_zero = [top >> (o + 2) == 0 for o in range(o_n)]

            def flags(v):
                if not any(v):
                    return None
                return torch.stack([torch.full((), b, device=device)
                                    for b in v])

            self._tables[key] = (K.fold_lanes(thr), torch.stack(mids),
                                 flags(same), flags(a_zero))
        return self._tables[key]

    def _slice_check(self, ctx, st, me_key, cursor):
        """The slice check's deficient slices [N, 2 O] (successor side
        slice o at 2 o, predecessor side at 2 o + 1), the round-robin pick
        [N] and its midpoint [N, KL].  With offsets from the own key, the
        successor slice o is (A, B] on the clockwise offset and the
        predecessor slice [A, B) on the counter-clockwise one (A = max >>
        (o + 2), B = max >> (o + 1)); each is active when the list's last
        entry lies inside (0, A)."""
        p, spec = self.p, self.key_spec
        o_n = p.max_slices
        thr, mids, same, a_zero = self._slice_table(me_key.device)
        me = me_key[:, None]
        ck = keys_of(ctx, st.cache)
        ok = (st.cache != NO_NODE)[..., None]
        w_cw = K.fold_lanes(K.sub(ck, me, spec))[:, :, None]   # [N, C, 1, W]
        w_ccw = K.fold_lanes(K.sub(me, ck, spec))[:, :, None]
        gt_cw, _ = K.lex_lt_eq(thr, w_cw)                         # [N, C, O+1]
        gt_ccw, eq_ccw = K.lex_lt_eq(thr, w_ccw)
        c_gt = torch.sum(ok & gt_cw, 1, dtype=I32)                # [N, O+1]
        c_ge = torch.sum(ok & (gt_ccw | eq_ccw), 1, dtype=I32)
        c_all = torch.sum(ok[..., 0], 1, dtype=I32)[:, None]
        n_s = c_gt[:, 1:] - c_gt[:, :-1]                          # [N, O]
        n_p = c_ge[:, 1:] - c_ge[:, :-1]
        if same is not None:
            n_s = torch.where(same, c_all, n_s)
            n_p = torch.where(same, c_all, n_p)

        def last_inside(last, cw):
            lk_ = keys_of(ctx, last)[:, None]
            off = K.sub(lk_, me, spec) if cw else K.sub(me, lk_, spec)
            w = K.fold_lanes(off)                                  # [N, 1, W]
            below, _ = K.lex_lt_eq(w, thr[1:])                     # [N, O]
            nz = torch.any(off != 0, -1)
            if a_zero is not None:
                below = below | a_zero
            return below & nz

        act_s = last_inside(st.succ[:, -1], True)
        act_p = last_inside(st.pred[:, -1], False)
        nps = p.nodes_per_slice
        deficient = torch.stack([act_s & (n_s < nps), act_p & (n_p < nps)],
                                -1).reshape(-1, 2 * o_n)
        nsl = 2 * o_n
        rot = torch.remainder(torch.arange(nsl, dtype=I32,
                                           device=me_key.device)
                              + cursor[:, None], nsl)
        pick_rot = torch.argmax(torch.gather(deficient, 1, rot.long())
                                .to(I32), 1)
        pick = torch.gather(rot, 1, pick_rot[:, None])[:, 0]
        tgt = K.add(me_key, mids[pick.long()], spec)
        return deficient, pick, tgt, torch.stack([n_s, n_p], -1).reshape(
            -1, nsl)

    # -- the batched step -----------------------------------------------------

    def step(self, ctx, st, msgs, rng, node_idx, *, outbox_slots, rmax):
        p, lcfg, spec = self.p, self.lcfg, self.key_spec
        n = node_idx.shape[0]
        dev = node_idx.device
        ob = Outbox(n, outbox_slots, spec.lanes, rmax, dev)
        me_key = ctx.keys[node_idx.long()]
        rngs = rng_mod.split(rng, 8)                              # [N, 8, 2]
        t0, t_end = ctx.t_start, ctx.t_end
        f = lcfg.frontier
        s_sz = p.succ_size
        n_all = ctx.keys.shape[0]

        def ready_of(slots):
            return ctx.ready[torch.clamp(slots, 0, n_all - 1).long()]

        def metric_fn(cand, target):
            # how far past the key a candidate sits (successor side)
            ck = keys_of(ctx, cand)
            return K.sub(ck, target[:, :, None, :], spec)

        ev = app_base.AppEvents(n, dev)
        zeros_n = torch.zeros((n,), dtype=I32, device=dev)
        joins_cnt, slice_cnt = zeros_n, zeros_n
        anyfail_cnt, lksucc_cnt, routedrop_cnt = zeros_n, zeros_n, zeros_n

        if self.rcfg is not None:
            # recursive pre-pass: forward or decapsulate KBR_ROUTE
            # wrappers with this overlay's findNode, before the slots
            res_rt, sib_rt = self._find_node(ctx, st, me_key, node_idx,
                                             msgs.key, rmax, msgs.src)
            rr, msgs, drop = rt_mod.prepass(
                st.rr, ob, msgs, res_rt, sib_rt, st.state == READY,
                node_idx, self.rcfg,
                forward_veto=app_base.app_veto(self.app, st.app, ctx))
            st = dataclasses.replace(st, rr=rr)
            routedrop_cnt = routedrop_cnt + drop

        # ------------------------------------------------------- inbox -----
        n_cache = max(0, rmax - 2 * s_sz)
        put_w = max(f, 2 * s_sz, n_cache)
        col_put = torch.arange(put_w, device=dev)
        got_ready = torch.zeros((n,), dtype=torch.bool, device=dev)
        t_ready = torch.zeros((n,), dtype=I64, device=dev)
        for r in range(msgs.valid.shape[1]):
            m = msgs.slot(r)
            now = m.t_deliver
            v = m.valid
            src1 = m.src[:, None]

            # every inbound call/response from a READY sender feeds the
            # cache and both lists (receiveNewNode, direct)
            en = v & ready_of(m.src)
            cache, cseen = self._cache_put(st.cache, st.cache_seen, src1, now)
            succ = self._ring_sorted(ctx, me_key, node_idx,
                                     torch.cat([st.succ, src1], 1), True)
            pred = self._ring_sorted(ctx, me_key, node_idx,
                                     torch.cat([st.pred, src1], 1), False)
            e = en[:, None]
            st = dataclasses.replace(
                st, cache=torch.where(e, cache, st.cache),
                cache_seen=torch.where(e, cseen, st.cache_seen),
                succ=torch.where(e, succ, st.succ),
                pred=torch.where(e, pred, st.pred))

            # FindNodeCall
            en = v & (m.kind == wire.FINDNODE_CALL) & (st.state == READY)
            res, sib = self._find_node(ctx, st, me_key, node_idx,
                                       m.key[:, None], rmax, src1)
            res, sib = res[:, 0], sib[:, 0]
            n_res = torch.sum(res != NO_NODE, 1, dtype=I32)
            ob.send(en, now, m.src, wire.FINDNODE_RES, key=m.key, a=m.a,
                    b=m.b, c=sib.to(I32), nodes=res,
                    size_b=wire.BASE_CALL_B + 1 + wire.NODEHANDLE_B * n_res)

            # FindNodeResponse → the lookup engine
            en_fr = v & (m.kind == wire.FINDNODE_RES)
            st = dataclasses.replace(st, lk=lk_mod.on_response(
                st.lk, dataclasses.replace(m, valid=en_fr), metric_fn, lcfg))

            # JoinCall (rpcJoin): transfer the lists and a cache sample
            en = v & (m.kind == wire.EPI_JOIN_CALL) & (st.state == READY)
            payload = torch.cat([st.pred, st.succ, st.cache[:, :n_cache]], 1)
            ob.send(en, now, m.src, wire.EPI_JOIN_RES, a=s_sz,
                    nodes=_fit(payload, rmax),
                    size_b=wire.BASE_CALL_B + wire.NODEHANDLE_B * rmax)

            # the kind-exclusive list updates: JoinResponse (adopt both
            # lists), JoinAck (the joiner becomes a predecessor),
            # StabilizeCall (the caller and its additions into the list
            # of its side)
            en_jr = v & (m.kind == wire.EPI_JOIN_RES) & (st.state == JOINING)
            en_ja = v & (m.kind == wire.EPI_JOINACK_CALL) & (
                st.state == READY)
            en_sc = v & (m.kind == wire.EPI_STAB_CALL) & (st.state == READY)
            from_pred = m.a == NT_PRED
            w = 2 * s_sz + 1
            adds = _fit(torch.cat([src1, m.nodes[:, :p.additions]], 1), w)
            c_succ = torch.where(en_jr[:, None], _fit(torch.cat(
                [m.nodes[:, s_sz:2 * s_sz], src1], 1), w), adds)
            c_pred = torch.where(en_jr[:, None], _fit(torch.cat(
                [m.nodes[:, :s_sz], src1], 1), w),
                torch.where(en_ja[:, None], _fit(src1, w), adds))
            succ = self._ring_sorted(ctx, me_key, node_idx,
                                     torch.cat([st.succ, c_succ], 1), True)
            pred = self._ring_sorted(ctx, me_key, node_idx,
                                     torch.cat([st.pred, c_pred], 1), False)
            set_succ = en_jr | (en_sc & ~from_pred)
            set_pred = en_jr | en_ja | (en_sc & from_pred)
            first_succ = en_ja & (st.succ[:, 0] == NO_NODE)
            succ = torch.where(
                first_succ[:, None],
                torch.cat([src1, st.succ[:, 1:]], 1), succ)
            st = dataclasses.replace(
                st,
                succ=torch.where((set_succ | first_succ)[:, None], succ,
                                 st.succ),
                pred=torch.where(set_pred[:, None], pred, st.pred))

            # the kind-exclusive cache puts: a FindNode response's nodes,
            # a JoinResponse's cache sample, a StabilizeResponse's lists
            en_sr = v & (m.kind == wire.EPI_STAB_RES) & (st.state == READY)
            learned = _fit(m.nodes[:, :max(f, 2 * s_sz)], put_w)
            l_ok = (learned != NO_NODE) & ready_of(learned) & torch.where(
                en_fr[:, None], col_put < f, col_put < 2 * s_sz)
            cx = _fit(m.nodes[:, 2 * s_sz:], put_w)
            cands = torch.where(en_jr[:, None], cx,
                                torch.where(l_ok, learned, NO_NODE))
            cache, cseen = self._cache_put(st.cache, st.cache_seen, cands,
                                           now)
            e = (en_fr | en_jr | en_sr)[:, None]
            st = dataclasses.replace(
                st, cache=torch.where(e, cache, st.cache),
                cache_seen=torch.where(e, cseen, st.cache_seen))

            # JoinResponse: READY, ack the responder
            joins_cnt = joins_cnt + en_jr.to(I32)
            st = self._become_ready(st, en_jr, now)
            got_ready = got_ready | en_jr
            t_ready = torch.where(en_jr, now, t_ready)
            ob.send(en_jr, now, m.src, wire.EPI_JOINACK_CALL,
                    size_b=wire.BASE_CALL_B)
            # StabilizeCall: respond with pred ++ succ
            ob.send(en_sc, now, m.src, wire.EPI_STAB_RES, a=s_sz,
                    nodes=_fit(torch.cat([st.pred, st.succ], 1), rmax),
                    size_b=wire.BASE_CALL_B + wire.NODEHANDLE_B * 2 * s_sz)

            # the app's kinds
            sib_app = self._is_sibling(ctx, st, me_key, m.key[:, None])[:, 0]
            st = dataclasses.replace(st, app=app_base.on_msg_one(
                self.app, st.app, m, ctx, ob, ev, sib_app))

            # pings
            ob.send(v & (m.kind == wire.PING_CALL), now, m.src,
                    wire.PING_RES, a=m.a, size_b=wire.BASE_CALL_B)
        st = dataclasses.replace(st, app=self.app.on_ready(
            st.app, got_ready, t_ready, rngs[:, 0]))

        # ------------------------------------------------------- timers ----
        # join (a lookup for the own key, then a direct JoinCall)
        en_j = (st.state == JOINING) & (st.t_join < t_end)
        now_j = torch.maximum(st.t_join, t0)
        boot = ctx.sample_ready(rngs[:, 1], node_idx)
        no_join_lk = ~torch.any(st.lk.active & (st.lk.purpose == P_JOIN), 1)
        alone = en_j & (boot == NO_NODE)
        joins_cnt = joins_cnt + alone.to(I32)
        st = self._become_ready(st, alone, now_j)
        st = dataclasses.replace(st, app=self.app.on_ready(
            st.app, alone, now_j, rngs[:, 2]))
        slot, have = lk_mod.free_slot(st.lk)
        start_join = en_j & (boot != NO_NODE) & no_join_lk & have
        st = dataclasses.replace(st, lk=lk_mod.start(
            st.lk, start_join, slot, P_JOIN, 0, me_key, _fit(boot[:, None], f),
            now_j, lcfg))
        st = dataclasses.replace(st, t_join=torch.where(
            en_j & ~alone, now_j + int(p.join_delay * NS), st.t_join))

        # stabilize: one call each way
        en_s = (st.state == READY) & (st.t_stab < t_end)
        now_s = torch.maximum(st.t_stab, t0)
        add_b = wire.BASE_CALL_B + wire.NODEHANDLE_B * p.additions
        ob.send(en_s & (st.pred[:, 0] != NO_NODE), now_s, st.pred[:, 0],
                wire.EPI_STAB_CALL, a=NT_SUCC,
                nodes=_fit(st.succ[:, :p.additions], rmax), size_b=add_b)
        ob.send(en_s & (st.succ[:, 0] != NO_NODE), now_s, st.succ[:, 0],
                wire.EPI_STAB_CALL, a=NT_PRED,
                nodes=_fit(st.pred[:, :p.additions], rmax), size_b=add_b)
        st = dataclasses.replace(st, t_stab=torch.where(
            en_s, now_s + int(p.stabilize_delay * NS), st.t_stab))

        # cache flush + the slice-check counter (the reference's
        # "> multiplier", not ">=")
        en_c = (st.state == READY) & (st.t_cache < t_end)
        now_c = torch.maximum(st.t_cache, t0)
        cache, cseen = self._expire_cache(st.cache, st.cache_seen, now_c)
        ctr = torch.where(en_c, st.check_ctr + 1, st.check_ctr)
        do_check = en_c & (ctr > p.cache_check_mult)
        st = dataclasses.replace(
            st, cache=torch.where(en_c[:, None], cache, st.cache),
            cache_seen=torch.where(en_c[:, None], cseen, st.cache_seen),
            check_ctr=torch.where(do_check, 0, ctr),
            t_cache=torch.where(en_c, now_c + int(p.cache_flush_delay * NS),
                                st.t_cache))

        # slice check: one midpoint lookup per check (round-robin cursor)
        lists_full = (st.succ[:, -1] != NO_NODE) & (st.pred[:, -1] != NO_NODE)
        deficient, pick, tgt, _ = self._slice_check(ctx, st, me_key,
                                                    st.slice_cursor)
        any_def = torch.any(deficient, 1)
        no_slice_lk = ~torch.any(st.lk.active & (st.lk.purpose == P_SLICE),
                                 1)
        seed_s, sib_s = self._find_node1(ctx, st, me_key, node_idx, tgt,
                                         rmax)
        slot, have = lk_mod.free_slot(st.lk)
        start_slice = do_check & lists_full & any_def & no_slice_lk \
            & have & ~sib_s & (seed_s[:, 0] != NO_NODE)
        slice_cnt = slice_cnt + start_slice.to(I32)
        st = dataclasses.replace(
            st,
            slice_cursor=torch.where(do_check, pick + 1, st.slice_cursor),
            lk=lk_mod.start(st.lk, start_slice, slot, P_SLICE, 0, tgt,
                            _fit(seed_s[:, :f], f), now_c, lcfg))

        # app timer (graceful leave first: hand data to the successor)
        st = dataclasses.replace(st, app=app_base.leave_protocol(
            self.app, st.app, ctx, ob, ev, t0, node_idx, st.succ[:, 0],
            st.state == READY))
        t_app = self.app.next_event(st.app)
        en_a = (st.state == READY) & (t_app < t_end)
        now_a = torch.maximum(t_app, t0)
        app, req = self.app.on_timer(st.app, en_a, ctx, now_a, rngs[:, 3],
                                     ev, node_idx)
        st = dataclasses.replace(st, app=app)
        seed_a, sib_a = self._find_node1(ctx, st, me_key, node_idx, req.key,
                                         rmax)
        local = req.want & sib_a
        slot, have = lk_mod.free_slot(st.lk)
        route_fire = torch.zeros_like(req.want)
        if self.rcfg is not None and hasattr(self.app, "route_policy"):
            rr, app, route_fire, start_app = rt_mod.originate(
                st.rr, ob, self.app, st.app, req, seed_a[:, 0], sib_a, have,
                now_a, node_idx, rmax, self.rcfg, ctx.measuring)
            st = dataclasses.replace(st, rr=rr, app=app)
        else:
            start_app = req.want & ~sib_a & have & (seed_a[:, 0] != NO_NODE)
        insta_fail = req.want & ~sib_a & ~start_app & ~route_fire
        st = dataclasses.replace(st, app=self.app.on_lookup_done(
            st.app, app_base.LookupDone(
                en=local | insta_fail, success=local, tag=req.tag,
                target=req.key,
                results=torch.where(local[:, None], _fit(seed_a[:, :f], f),
                                    NO_NODE),
                hops=zeros_n, t0=now_a),
            ctx, ob, ev, now_a, node_idx))
        st = dataclasses.replace(st, lk=lk_mod.start(
            st.lk, start_app, slot, P_APP, req.tag, req.key,
            _fit(seed_a[:, :f], f), now_a, lcfg))

        # ------------------------------------------------ timeouts ---------
        new_lk, failed_nodes, _ = lk_mod.on_timeouts(st.lk, t_end, t0, lcfg)
        st = dataclasses.replace(st, lk=new_lk)
        st = self._handle_failed(ctx, st, me_key, node_idx, failed_nodes, t0)
        if self.rcfg is not None:
            # route-hop ACK timeouts: handleFailedNode, then reroute the
            # parked messages around the failed hop
            rr, rt_failed, rt_retry = rt_mod.on_timeouts(st.rr, t_end,
                                                         self.rcfg)
            st = dataclasses.replace(st, rr=rr)
            st = self._handle_failed(ctx, st, me_key, node_idx, rt_failed, t0)
            res_q, sib_q = self._find_node(ctx, st, me_key, node_idx,
                                           st.rr.key, rmax)
            rr, drop_q = rt_mod.reroute(st.rr, ob, res_q, sib_q, rt_failed,
                                        rt_retry, t0, node_idx, self.rcfg)
            st = dataclasses.replace(st, rr=rr)
            routedrop_cnt = routedrop_cnt + drop_q

        # ------------------------------------------------- completions -----
        new_lk, comp = lk_mod.take_completions(st.lk, t_end)
        st = dataclasses.replace(st, lk=new_lk)
        taken = comp["taken"]
        suc_l = comp["success"] & (comp["result"] != NO_NODE)
        pur_l = comp["purpose"]
        comp_hops_ev = (comp["hops"].to(F32), taken & comp["success"])
        lksucc_cnt = lksucc_cnt + torch.sum(taken & suc_l, 1, dtype=I32)
        anyfail_cnt = anyfail_cnt + torch.sum(taken & ~suc_l, 1, dtype=I32)
        # a join lookup's result gets the JoinCall (a failure retries on
        # the join timer)
        ob.send(taken & suc_l & (pur_l == P_JOIN)
                & (st.state == JOINING)[:, None], t0, comp["result"],
                wire.EPI_JOIN_CALL, size_b=wire.BASE_CALL_B)
        ena_l = taken & (pur_l == P_APP)
        st = dataclasses.replace(st, app=app_base.lookup_done_fold(
            self.app, st.app, app_base.LookupDone(
                en=ena_l, success=ena_l & suc_l, tag=comp["aux"],
                target=comp["target"], results=comp["results"],
                hops=comp["hops"], t0=comp["t0"]),
            ctx, ob, ev, t0, node_idx))

        # ------------------------------------------------------- pump ------
        st = dataclasses.replace(st, lk=lk_mod.pump(
            st.lk, ob, ctx, node_idx, t0, lcfg,
            num_redundant=p.redundant_nodes))

        events = {
            "c:epi_joins": joins_cnt,
            "c:epi_slice_lookups": slice_cnt,
            "c:lookup_success": lksucc_cnt,
            "c:lookup_failed": anyfail_cnt,
            "c:route_dropped": routedrop_cnt,
            "s:lookup_hops": comp_hops_ev,
        }
        ev.finish(events, self.app.hist_map)
        return st, ob, events
