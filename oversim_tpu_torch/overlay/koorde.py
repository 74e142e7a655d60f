"""Koorde: Chord with de Bruijn routing, as batched per-node logic (PyTorch).

Counterpart of ``oversim_tpu/overlay/koorde.py`` (reference Koorde.cc,
``class Koorde : public Chord``; default.ini:268-277: stabilizeDelay 10 s,
successorListSize 16, deBruijnDelay 30 s, deBruijnListSize 16,
shiftingBits 4).  Koorde keeps Chord's ring maintenance (join,
stabilize, notify, predecessor pings) and replaces finger routing by a
de Bruijn walk:

  * each node keeps a de Bruijn pointer, the node responsible for
    ``(own key << shiftingBits)`` nudged back by half a successor span,
    and that node's successors as a backup list; the timer resolves it
    from the own ring position or by an iterative lookup with purpose
    ``P_DEBRUIJN`` (handleDeBruijnTimerExpired, Koorde.cc:163-229);
  * a lookup carries its imaginary route key and bit step with the
    message, in the lookup engine's extension words (``ext_words = key
    lanes + 1``): a call carries them in ``nodes[:EW]``, the response
    hands back the update in its tail;
  * each hop (Koorde::findNode, Koorde.cc:293-358) answers keys in
    (pred, me] itself, keys in (me, succ] with the successor, and
    otherwise shifts ``shiftingBits`` destination bits into the route key
    and forwards to the de Bruijn pointer or the closest predecessor of
    the route key in the de Bruijn and successor lists.

The reference's tail recursion when the hop is the node itself is
unrolled ``SELF_HOPS`` times and then falls back to the successor, as in
the JAX package.  Every function runs over the leading ``[N]`` axis, the
FindNode responder over ``[N, R]`` inbox slots; ``rcfg`` routes the
app's payloads recursively with the extension in the head of the routed
message's node list (``common/route.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch.common import lookup as lk_mod
from oversim_tpu_torch.core import keys as K
from oversim_tpu_torch.engine import pool as pool_mod
from oversim_tpu_torch.engine.logic import keys_of, take
from oversim_tpu_torch.overlay.chord import (I64_MAX, NO_NODE, READY, T_INF,
                                             ChordLogic, ChordParams,
                                             ChordState, _ns, _pad,
                                             _sub_top_key)

I32 = torch.int32
I64 = torch.int64

P_DEBRUIJN = 7          # lookup purpose (Chord's are 1-4)
SELF_HOPS = 3           # unrolled self-recursion bound (module doc)


@dataclasses.dataclass(frozen=True)
class KoordeParams(ChordParams):
    """default.ini:268-277 (JAX field names and defaults)."""

    stabilize_delay: float = 10.0
    succ_size: int = 16
    # the reference stubs out fix-fingers for Koorde: the timer is parked
    fixfingers_delay: float = 1e9
    de_bruijn_delay: float = 30.0
    de_bruijn_size: int = 16
    shifting_bits: int = 4
    use_other_lookup: bool = True
    use_suc_list: bool = True


@dataclasses.dataclass
class KoordeState(ChordState):
    db_node: torch.Tensor   # [N] i32 de Bruijn pointer
    db_list: torch.Tensor   # [N, DL] i32 its successors (backup)
    t_db: torch.Tensor      # [N] i64 de Bruijn timer


class KoordeLogic(ChordLogic):
    """Chord with de Bruijn routing (the engine interface unchanged)."""

    def __init__(self, spec: K.KeySpec = K.DEFAULT_SPEC,
                 params: KoordeParams = KoordeParams(),
                 lcfg: lk_mod.LookupConfig | None = None,
                 app=None, rcfg=None):
        lcfg = lcfg or lk_mod.LookupConfig(ext_words=spec.lanes + 1)
        if lcfg.ext_words != spec.lanes + 1:
            raise ValueError("Koorde needs ext_words == key lanes + 1")
        if rcfg is not None and rcfg.ext_words != lcfg.ext_words:
            # the routeKey/step ext rides the head of the routed
            # message's node list ([ext | visited])
            rcfg = dataclasses.replace(rcfg, ext_words=lcfg.ext_words)
        super().__init__(spec, params, lcfg, app, rcfg=rcfg)
        if (rcfg is not None and getattr(self.app, "rcfg", None) is not None
                and self.app.rcfg.ext_words != rcfg.ext_words):
            self.app.rcfg = rcfg

    def init(self, rng, n: int) -> KoordeState:
        base = super().init(rng, n)
        dev = rng.device
        kw = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(base)}
        return KoordeState(
            **kw,
            db_node=torch.full((n,), NO_NODE, dtype=I32, device=dev),
            db_list=torch.full((n, self.p.de_bruijn_size), NO_NODE,
                               dtype=I32, device=dev),
            t_db=torch.full((n,), T_INF, dtype=I64, device=dev))

    def next_event(self, st: KoordeState):
        t = super().next_event(st)
        return torch.minimum(t, torch.where(st.state == READY, st.t_db,
                                            T_INF))

    def _become_ready(self, ctx, st, en, now, rng):
        st = super()._become_ready(ctx, st, en, now, rng)
        return dataclasses.replace(st, t_db=torch.where(en, now, st.t_db))

    def _handle_failed(self, ctx, st, me_key, node_idx, failed, now):
        """Chord's repair, then the de Bruijn pointer and list
        (Koorde::handleFailedNode, Koorde.cc:129-160): a dead pointer is
        replaced by the first live backup, and the list keeps its order
        without the failed entries (a stable compaction)."""
        st = super()._handle_failed(ctx, st, me_key, node_idx, failed, now)
        any_failed = torch.any(failed != NO_NODE, 1)
        db_hit = torch.any(st.db_node[:, None] == failed, 1) & (
            st.db_node != NO_NODE)
        lhit = torch.any(st.db_list[:, :, None] == failed[:, None, :],
                         -1) & (st.db_list != NO_NODE)
        order = torch.sort(lhit.to(I32), dim=1, stable=True).indices
        compacted = torch.gather(torch.where(lhit, NO_NODE, st.db_list), 1,
                                 order)
        new_db = torch.where(db_hit, compacted[:, 0], st.db_node)
        rolled = torch.cat([compacted[:, 1:], torch.full_like(
            compacted[:, :1], NO_NODE)], 1)
        compacted = torch.where(db_hit[:, None], rolled, compacted)
        return dataclasses.replace(
            st,
            db_node=torch.where(any_failed, new_db, st.db_node),
            db_list=torch.where(any_failed[:, None], compacted, st.db_list))

    # -- de Bruijn timer (handleDeBruijnTimerExpired, Koorde.cc:163) ------

    def _extra_timers(self, ctx, st, me_key, node_idx, t0, t_end, rng):
        p, spec, lcfg = self.p, self.key_spec, self.lcfg
        dl = p.de_bruijn_size

        en = (st.state == READY) & (st.t_db < t_end)
        now = torch.maximum(st.t_db, t0)
        s0 = st.succ[:, 0]
        s0k = keys_of(ctx, s0)
        has_succ = s0 != NO_NODE
        # lookup key = (me << s) - (succ[S/2] - me): a little before the
        # exact de Bruijn key, for failure redundancy (Koorde.cc:165-173)
        lk_key = K.shl_const(me_key, p.shifting_bits, spec)
        n_succ = torch.sum(st.succ != NO_NODE, 1)
        mid = take(st.succ, torch.clamp(n_succ // 2, 0, st.succ.shape[1] - 1))
        lk_key = torch.where(
            has_succ[:, None],
            K.sub(lk_key, K.sub(keys_of(ctx, mid), me_key, spec), spec),
            lk_key)
        pred_ok = st.pred != NO_NODE

        # we are responsible → db = self, list = successors; the
        # predecessor is → db = pred, list = self + successors
        own = en & (~has_succ | K.is_between_r(lk_key, me_key, s0k, spec))
        pre = en & ~own & pred_ok & K.is_between_r(
            lk_key, keys_of(ctx, st.pred), me_key, spec)
        lst1 = _pad(st.succ, dl)
        lst2 = _pad(torch.cat([node_idx[:, None], st.succ], 1), dl)
        st = dataclasses.replace(
            st,
            db_node=torch.where(own, node_idx,
                                torch.where(pre, st.pred, st.db_node)),
            db_list=torch.where(own[:, None], lst1, torch.where(
                pre[:, None], lst2, st.db_list)))

        # otherwise resolve by a lookup (the engine form of the routed
        # DeBruijnCall, Koorde.cc:205-211)
        need_lk = en & ~own & ~pre
        no_db_lk = ~torch.any(st.lk.active & (st.lk.purpose == P_DEBRUIJN),
                              1)
        slot, have = lk_mod.free_slot(st.lk)
        nxt, sib = self._find_node1(ctx, st, me_key, node_idx, lk_key)
        start = need_lk & no_db_lk & have & ~sib & (nxt != NO_NODE)
        st = dataclasses.replace(st, lk=lk_mod.start(
            st.lk, start, slot, P_DEBRUIJN, 0, lk_key,
            _pad(nxt[:, None], lcfg.frontier), now, lcfg))
        return dataclasses.replace(st, t_db=torch.where(
            en, now + _ns(p.de_bruijn_delay), st.t_db))

    def _on_completion(self, ctx, st, comp, taken, suc_l):
        """De Bruijn resolution finished: pointer = the closest sibling,
        backups = the rest of the returned sibling set.  The JAX package
        folds the L slots in order, so the last resolving slot wins."""
        l_dim = taken.shape[1]
        enr = taken & (comp["purpose"] == P_DEBRUIJN) & suc_l      # [N, L]
        any_r = torch.any(enr, 1)
        last = l_dim - 1 - torch.argmax(torch.flip(enr, [1]).to(I32), 1)
        results = take(comp["results"], last)                     # [N, F]
        lst = _pad(results[:, 1:], self.p.de_bruijn_size)
        return dataclasses.replace(
            st,
            db_node=torch.where(any_r, results[:, 0], st.db_node),
            db_list=torch.where(any_r[:, None], lst, st.db_list))

    # -- routing (Koorde::findNode + findDeBruijnHop) ---------------------

    def _walk_pred(self, ctx, lst, key):
        """Closest clockwise predecessor of each key in a node list
        (walkSuccessorList / walkDeBruijnList, Koorde.cc:379-409): ``lst``
        [N, C], ``key`` [N, T, KL] → [N, T], the entry minimizing the
        ring distance key - entry by the top two lanes (element 0 of the
        JAX package's stable approximate sort); NO_NODE for an empty
        list."""
        ek = keys_of(ctx, lst)            # [N, C, KL]
        d = _sub_top_key(key[:, :, None], ek[:, None], self.key_spec)
        d = torch.where((lst == NO_NODE)[:, None], I64_MAX, d)   # [N, T, C]
        best = take(lst, torch.argmin(d, -1))
        return torch.where(torch.any(lst != NO_NODE, 1)[:, None], best,
                           NO_NODE)

    def _find_start_key(self, me_key, s0k, key):
        """findStartKey (Koorde.cc): the imaginary start key within
        (me, succ] aligned to the shifting-bit grid → (route key, step);
        broadcastable ``[..., KL]`` keys."""
        spec, s = self.key_spec, self.p.shifting_bits
        diff = K.sub(s0k, me_key, spec)
        nbits = torch.clamp(K.log2_floor(diff, spec), min=0)
        # the largest nbits' <= nbits with (bits - nbits') % s == 0 (a
        # floor modulo of a negative number)
        nbits = torch.clamp(nbits - torch.remainder(nbits - spec.bits, s),
                            min=0)
        step = nbits + 1
        new_start = K.shl_dyn(K.shr_dyn(me_key, nbits, spec), nbits, spec)
        tmp_dest = K.shr_dyn(key, spec.bits - nbits, spec)
        new_key = K.add(tmp_dest, new_start, spec)
        ok1 = K.is_between_r(new_key, me_key, s0k, spec)
        bump = self.pow2(key.device)[torch.clamp(nbits, 0, spec.bits - 1)
                                     .long()]
        rk = torch.where(ok1[..., None], new_key, K.add(new_key, bump, spec))
        # a degenerate one-node interval: route key = me
        rk = torch.where(torch.all(diff == 0, -1)[..., None],
                         torch.broadcast_to(me_key, rk.shape), rk)
        return rk, step

    def _db_hop(self, ctx, st, me_key, node_idx, key, route_key, step):
        """One findDeBruijnHop evaluation for ``key``/``route_key`` [N, T,
        KL] and ``step`` [N, T] → (hop, route key', step')."""
        p, spec, s = self.p, self.key_spec, self.p.shifting_bits

        me = me_key[:, None]
        s0 = st.succ[:, 0][:, None]
        s0k = keys_of(ctx, s0)
        no_db = (st.db_node == NO_NODE)[:, None]
        db = st.db_node[:, None]
        dbk = keys_of(ctx, db)
        db0 = st.db_list[:, 0][:, None]

        in_resp = K.is_between_r(route_key, me, s0k, spec)
        # shift the next s destination bits into the route key (LSB-indexed
        # positions bits-step, bits-step-1, ...)
        add_val = torch.zeros_like(step, dtype=I64)
        for i in range(s):
            pos = spec.bits - step - i
            bit = torch.where(pos >= 0, K.bit(key, torch.clamp(
                pos, 0, spec.bits - 1), spec), 0)
            add_val = (add_val << 1) | bit
        add_key = torch.cat([torch.zeros_like(key[..., :-1]),
                             add_val[..., None]], -1)
        rk_shift = K.add(K.shl_const(route_key, s, spec), add_key, spec)

        # in our responsibility → advance along the de Bruijn edge
        walk_db = self._walk_pred(ctx, st.db_list, rk_shift)
        db_direct = (db0 != NO_NODE) & K.is_between_r(rk_shift, dbk,
                                                      keys_of(ctx, db0), spec)
        hop_db = torch.where(db_direct | (db0 == NO_NODE), db,
                             torch.where(walk_db != NO_NODE, walk_db, db))
        if p.use_suc_list:
            hop_nodb = self._walk_pred(ctx, st.succ, rk_shift)
            hop_nodb = torch.where(hop_nodb == NO_NODE, s0, hop_nodb)
        else:
            hop_nodb = s0.expand(hop_db.shape)
        hop_in = torch.where(no_db, hop_nodb, hop_db)

        # outside it → ring walk toward the route key, or the de Bruijn
        # pointer when it is closer
        walk_s = self._walk_pred(ctx, st.succ, route_key)
        hop_out = torch.where(walk_s != NO_NODE, walk_s, s0)
        if p.use_suc_list:
            better_db = ~no_db & K.is_between(dbk, keys_of(ctx, hop_out),
                                              route_key, spec)
            hop_out = torch.where(better_db, db, hop_out)

        hop = torch.where(in_resp, hop_in, hop_out)
        rk_out = torch.where(in_resp[..., None], rk_shift, route_key)
        step_out = torch.where(in_resp, step + s, step)
        return hop, rk_out, step_out

    def _respond_find(self, ctx, st, me_key, node_idx, msgs, rmax):
        """Koorde::findNode (Koorde.cc:293-358) for every inbox slot, the
        lookup ext (route key, step) read from ``nodes[:EW]`` and the
        updated ext packed into the tail of a non-sibling answer: ([N, R,
        rmax] result slots, [N, R] sibling flag)."""
        p, spec, lcfg = self.p, self.key_spec, self.lcfg
        ew, kl = lcfg.ext_words, spec.lanes
        key = msgs.key
        n, r_in = key.shape[0], key.shape[1]

        ext_in = msgs.nodes[..., :ew]
        route_key_in = pool_mod.key_from_i32(ext_in[..., :kl])
        step_in = ext_in[..., kl]
        ready = (st.state == READY)[:, None]
        me = me_key[:, None]
        pred_ok = (st.pred != NO_NODE)[:, None]
        s0 = st.succ[:, 0]
        s0k = keys_of(ctx, s0)[:, None]
        has_succ = (s0 != NO_NODE)[:, None]
        alone = ~pred_ok & ~has_succ
        is_sib = ready & (alone | (~pred_ok & K.eq(key, me))
                          | (pred_ok & K.is_between_r(
                              key, keys_of(ctx, st.pred)[:, None], me, spec)))
        succ_case = ready & has_succ & ~is_sib & K.is_between_r(
            key, me, s0k, spec)

        # useOtherLookup (Koorde.cc:299-306): a successor other than the
        # farthest that already precedes the key takes the ring walk
        n_succ = torch.sum(st.succ != NO_NODE, 1)
        far = take(st.succ, torch.clamp(n_succ - 1, 0,
                                        st.succ.shape[1] - 1))[:, None]
        walk = self._walk_pred(ctx, st.succ, key)
        other_ok = (walk != NO_NODE) & (walk != far) & p.use_other_lookup

        # lazy route-key initialization; with no de Bruijn pointer yet the
        # hop is the successor and the ext stays unset (Koorde.cc:296-301)
        need_init = step_in == 0
        no_db = (st.db_node == NO_NODE)[:, None]
        rk0, step0 = self._find_start_key(me, s0k, key)
        rk_cur = torch.where(need_init[..., None], rk0, route_key_in)
        step_cur = torch.where(need_init, step0, step_in)

        # the de Bruijn walk with the self-recursion unrolled
        me_slot = node_idx[:, None]
        hop = s0[:, None].expand(n, r_in)
        rk_fin, step_fin = rk_cur, step_cur
        done = torch.zeros((n, r_in), dtype=torch.bool, device=key.device)
        for _ in range(SELF_HOPS):
            h, rk2, st2 = self._db_hop(ctx, st, me_key, node_idx, key,
                                       rk_cur, step_cur)
            stop_now = ~done & (h != me_slot)
            hop = torch.where(stop_now, h, hop)
            rk_fin = torch.where(stop_now[..., None], rk2, rk_fin)
            step_fin = torch.where(stop_now, st2, step_fin)
            done = done | stop_now
            rk_cur = torch.where(done[..., None], rk_cur, rk2)
            step_cur = torch.where(done, step_cur, st2)
        rk_fin = torch.where(done[..., None], rk_fin, rk_cur)
        step_fin = torch.where(done, step_fin, step_cur)

        init_nodb = need_init & no_db
        db_path = ready & ~is_sib & ~succ_case & ~other_ok & ~init_nodb
        s0b = s0[:, None]
        nxt = torch.where(
            is_sib, me_slot,
            torch.where(succ_case, s0b,
                        torch.where(other_ok, walk,
                                    torch.where(init_nodb, s0b, hop))))
        nxt = torch.where(ready, nxt, NO_NODE)

        # the sibling set when responsible, else the hop with the updated
        # ext in the tail; the ext passes through every other path
        sib_set = _pad(torch.cat([node_idx[:, None], st.succ], 1), rmax)
        ext_key = torch.where(db_path[..., None], rk_fin, route_key_in)
        ext_step = torch.where(db_path, step_fin, step_in)
        ext_out = torch.cat([pool_mod.key_to_i32(ext_key),
                             ext_step[..., None].to(I32)], -1)
        hop_row = torch.cat([nxt[..., None].to(I32), torch.full(
            (n, r_in, rmax - 1 - ew), NO_NODE, dtype=I32, device=key.device),
            ext_out], -1)
        return torch.where(is_sib[..., None], sib_set[:, None],
                           hop_row), is_sib
