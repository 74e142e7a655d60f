"""Broose: XOR buckets and de Bruijn shift routing as batched logic (PyTorch).

Counterpart of ``oversim_tpu/overlay/broose.py`` (reference Broose.cc and
BrooseBucket.cc; default.ini:294-303: bucketSize 8, rBucketSize 8,
shiftingBits 2, joinDelay 10 s, refreshTime 180 s), per "Broose: A
Practical Distributed Hashtable Based on the De-Bruijn Topology".

Per node, every bucket kept XOR-sorted to its bucket key (entry 0 is the
closest; BrooseBucket.cc:70-135):

  * ``rb`` [N, 2^s, k']: right buckets, contacts near (me >> s) + i 2^(B-s);
  * ``lb`` [N, 2^s k']: the left bucket, contacts near (me << s);
  * ``bb`` [N, 7k]: the brother bucket, contacts near me; its k closest
    are the sibling set.

A lookup carries its route key, signed step, direction flags and last
hop in the lookup engine's extension words (``key lanes + 3``): each hop
shifts ``shiftingBits`` bits into or out of the route key and answers
with the contacts closest to it from the left, right or brother bucket
(Broose::findNode, Broose.cc:574-770).  A node joins through INIT (2^s
lookups and brother-bucket calls), RSET and BSET (paced left-bucket pulls
from the right-bucket contacts and the brothers) to READY, with a
per-state deadline that restarts the join.  Stale entries are pinged,
a timeout removes the node from every bucket, and every inbound message
from a READY sender refreshes it.

The inbox is handled one slot at a time over the ``[N]`` axis, as the JAX
package folds it: each slot's bucket updates are seen by the next slot's
findNode.  Folded, because the result is the same: the bucket keys are
computed once per tick (they depend on the own key alone), the paced
calls and the stale-entry pings leave in one send each (lane order is
call order), and a failed join lookup restarts the join once for all
completion slots (every restart of a tick writes the same values).
``rcfg`` routes the app's payloads recursively, with the extension in the
head of the routed message's node list (``common/route.py``).
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
from oversim_tpu_torch.engine import pool as pool_mod
from oversim_tpu_torch.engine.logic import Outbox, bcast, select_tree, take

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1

# lifecycle (Broose States INIT → RSET → BSET → READY, Broose.cc:145-253)
DEAD, INIT, RSET, BSET, READY = 0, 1, 2, 3, 4
P_JOINB, P_APP = 1, 3
# BucketCall proState tags and bucket types
PR_INIT, PR_RSET, PR_BSET, PR_REFRESH = 0, 1, 2, 3
BT_BROTHER, BT_LEFT = 0, 1

SELF_HOPS = 2        # unrolled findNode self-recursion (Broose.cc:766-769)

BUCKETS = ("rb", "rb_seen", "lb", "lb_seen", "bb", "bb_seen")


@dataclasses.dataclass(frozen=True)
class BrooseParams:
    """default.ini:294-303 (JAX field names and defaults)."""

    bucket_size: int = 8
    r_bucket_size: int = 8
    shifting_bits: int = 2
    user_dist: int = 0
    join_delay: float = 10.0
    refresh_time: float = 180.0
    number_retries: int = 0
    rpc_timeout: float = 1.5
    calls_per_tick: int = 4
    pace_delay: float = 0.5
    ping_slots: int = 4
    join_state_timeout: float = 20.0

    @property
    def pow_shift(self) -> int:
        return 1 << self.shifting_bits

    @property
    def lb_size(self) -> int:
        return self.pow_shift * self.r_bucket_size

    @property
    def bb_size(self) -> int:
        return 7 * self.bucket_size


@dataclasses.dataclass
class BrooseState:
    state: torch.Tensor      # [N] i32
    rb: torch.Tensor         # [N, 2^s, k'] i32
    rb_seen: torch.Tensor    # [N, 2^s, k'] i64
    lb: torch.Tensor         # [N, LB] i32
    lb_seen: torch.Tensor    # [N, LB] i64
    bb: torch.Tensor         # [N, BB] i32
    bb_seen: torch.Tensor    # [N, BB] i64
    choose: torch.Tensor     # [N] i32 chooseLookup direction alternator
    t_join: torch.Tensor     # [N] i64 join and RSET/BSET pacing timer
    t_bucket: torch.Tensor   # [N] i64 refresh timer
    state_to: torch.Tensor   # [N] i64 join-state deadline
    jb_recv: torch.Tensor    # [N] i32
    pr_recv: torch.Tensor    # [N] i32
    pr_need: torch.Tensor    # [N] i32
    pr_cursor: torch.Tensor  # [N] i32
    pb_recv: torch.Tensor    # [N] i32
    pb_need: torch.Tensor    # [N] i32
    pb_cursor: torch.Tensor  # [N] i32
    ping_dst: torch.Tensor   # [N, PP] i32
    ping_to: torch.Tensor    # [N, PP] i64
    lk: lk_mod.LookupState
    rr: rt_mod.RouteState
    app: object
    app_glob: object


_fit = rt_mod.fit        # [..., k] node lists cut or NO_NODE-padded


def _fit0(vec, width: int):
    """[..., k] lastSeen rows padded with 0 to ``width``."""
    return torch.cat([vec, torch.zeros(vec.shape[:-1] + (
        width - vec.shape[-1],), dtype=vec.dtype, device=vec.device)], -1)


class BrooseLogic:
    """Engine logic interface (see engine/logic.py)."""

    def __init__(self, spec: K.KeySpec = K.DEFAULT_SPEC,
                 params: BrooseParams = BrooseParams(),
                 lcfg: lk_mod.LookupConfig | None = None,
                 app=None, rcfg: rt_mod.RouteConfig | None = None):
        self.key_spec = spec
        self.p = params
        ew = spec.lanes + 3
        self.lcfg = lcfg or lk_mod.LookupConfig(slots=8, ext_words=ew)
        if self.lcfg.ext_words != ew:
            raise ValueError("Broose needs ext_words == key lanes + 3")
        self.lcfg.check_ported()
        if params.shifting_bits > spec.top_lane_bits:
            raise ValueError("shiftingBits must fit in the top key lane")
        if rcfg is not None and rcfg.ext_words != ew:
            rcfg = dataclasses.replace(rcfg, ext_words=ew)
        self.rcfg = rcfg
        self.app = app or KbrTestApp()
        if rcfg is not None:
            app_rcfg = getattr(self.app, "rcfg", "no")
            if app_rcfg is None or (app_rcfg != "no"
                                    and app_rcfg.ext_words != ew):
                self.app.rcfg = rcfg
        # keyLength rounded down to a multiple of shiftingBits
        self.max_dist = spec.bits - spec.bits % params.shifting_bits
        # the approximate sort reads the top two lanes of a distance
        self._top = min(2, spec.lanes)

    # -- engine interface ---------------------------------------------------

    def stat_spec(self) -> stats_mod.StatSpec:
        app = self.app.stat_spec()
        return stats_mod.StatSpec(
            scalars=tuple(app["scalars"]) + ("lookup_hops",),
            hists=tuple(app["hists"]),
            counters=tuple(app["counters"]) + (
                "broose_joins", "broose_join_retries", "lookup_success",
                "lookup_failed", "route_dropped"))

    def split(self, st: BrooseState):
        return dataclasses.replace(st, app_glob=None), st.app_glob

    def merge(self, node_part: BrooseState, glob):
        return dataclasses.replace(node_part, app_glob=glob)

    def post_step(self, ctx, st: BrooseState, events):
        app, glob = self.app.post_step(ctx, st.app, st.app_glob, events)
        return dataclasses.replace(st, app=app, app_glob=glob)

    def init(self, rng, n: int) -> BrooseState:
        p = self.p
        dev = rng.device

        def full(shape, v, dt):
            return torch.full((n,) + shape, v, dtype=dt, device=dev)

        return BrooseState(
            state=full((), 0, I32),
            rb=full((p.pow_shift, p.r_bucket_size), NO_NODE, I32),
            rb_seen=full((p.pow_shift, p.r_bucket_size), 0, I64),
            lb=full((p.lb_size,), NO_NODE, I32),
            lb_seen=full((p.lb_size,), 0, I64),
            bb=full((p.bb_size,), NO_NODE, I32),
            bb_seen=full((p.bb_size,), 0, I64),
            choose=full((), 0, I32), t_join=full((), T_INF, I64),
            t_bucket=full((), T_INF, I64), state_to=full((), T_INF, I64),
            jb_recv=full((), 0, I32), pr_recv=full((), 0, I32),
            pr_need=full((), 0, I32), pr_cursor=full((), 0, I32),
            pb_recv=full((), 0, I32), pb_need=full((), 0, I32),
            pb_cursor=full((), 0, I32),
            ping_dst=full((p.ping_slots,), NO_NODE, I32),
            ping_to=full((p.ping_slots,), T_INF, I64),
            lk=lk_mod.init(self.lcfg, self.key_spec.lanes, n, dev),
            rr=rt_mod.init(self.rcfg or rt_mod.RouteConfig(),
                           self.key_spec.lanes, 16, n, dev),
            app=self.app.init(n, dev),
            app_glob=self.app.glob_init(rng))

    def reset(self, st: BrooseState, clear, join, t_now, rng) -> BrooseState:
        n = st.state.shape[0]
        glob = st.app_glob
        st = dataclasses.replace(st, app_glob=None)
        fresh = dataclasses.replace(self.init(rng, n), app_glob=None)
        st = select_tree(clear, fresh, st)
        st = dataclasses.replace(st, app_glob=glob)
        jitter = (rng_mod.uniform(rng, (n,), F64) * 0.1 * NS).to(I64)
        return dataclasses.replace(
            st, state=torch.where(join, INIT, st.state),
            t_join=torch.where(join, t_now + jitter, st.t_join))

    def ready_mask(self, st: BrooseState):
        return st.state == READY

    def next_event(self, st: BrooseState):
        joining = (st.state >= INIT) & (st.state < READY)
        ready = st.state == READY
        t = torch.where(joining, st.t_join, T_INF)
        t = torch.minimum(t, st.state_to)
        t = torch.minimum(t, torch.where(ready, st.t_bucket, T_INF))
        t = torch.minimum(t, torch.min(st.ping_to, -1).values)
        t = torch.minimum(t, torch.where(ready, self.app.next_event(st.app),
                                         T_INF))
        t = torch.minimum(t, lk_mod.next_event(st.lk))
        if self.rcfg is not None:
            t = torch.minimum(t, rt_mod.next_event(st.rr))
        return t

    # -- bucket machinery ---------------------------------------------------

    def _bucket_keys(self, me_key):
        """(rb keys [N, 2^s, KL], lb key, bb key) (BrooseBucket::
        initializeBucket, BrooseBucket.cc:49-68)."""
        p, spec = self.p, self.key_spec
        shr = K.shr_const(me_key, p.shifting_bits, spec)
        rb_keys = torch.stack([
            K.add(shr, K.from_int(i << (spec.bits - p.shifting_bits), spec,
                                  me_key.device), spec)
            for i in range(p.pow_shift)], 1)
        return rb_keys, K.shl_const(me_key, p.shifting_bits, spec), me_key

    def _xor_top(self, keys_top, slots, key):
        """The top lanes (those the approximate sort reads) of the XOR
        distance from each entry of ``slots`` [..., A] to ``key``
        [..., KL]: [..., A, top], the all-ones distance for NO_NODE."""
        ck = keys_top[torch.clamp(slots, 0, keys_top.shape[0] - 1).long()]
        x = ck ^ key[..., None, :self._top]
        return torch.where((slots == NO_NODE)[..., None], K.UMAX, x)

    def _bkt_put(self, keys_top, bkey, arr, seen, cands, cseen):
        """Merge candidates into XOR-sorted bucket rows (BrooseBucket::add,
        BrooseBucket.cc:70-135): ``arr``/``seen`` [..., cap], ``cands``/
        ``cseen`` [..., C], ``bkey`` [..., KL].  A duplicated existing entry
        keeps the newer lastSeen."""
        cap = arr.shape[-1]
        aug = torch.cat([arr, cands], -1)
        match = (arr[..., :, None] == cands[..., None, :]) & (
            cands != NO_NODE)[..., None, :]
        upd = torch.max(torch.where(match, cseen[..., None, :], 0), -1).values
        aseen = torch.cat([torch.maximum(seen, upd), cseen], -1)
        dup = K.dup_mask(aug) | (aug == NO_NODE)
        aug = torch.where(dup, NO_NODE, aug)
        _, (aug_s, seen_s) = K.sort_by_distance(
            self._xor_top(keys_top, aug, bkey), (aug, aseen), approx=True)
        aug_s, seen_s = aug_s[..., :cap], seen_s[..., :cap]
        return aug_s, torch.where(aug_s == NO_NODE, 0, seen_s)

    def _put_all(self, kt, bk, rb, rb_seen, lb, lb_seen, bb, bb_seen,
                 cands, cseen):
        """``_bkt_put`` of the same candidates into the 2^s + 2 buckets
        at once: the rows padded with empty entries to the widest bucket
        (empty entries sort last and the rows are cut back, so each row
        is what its own put gives)."""
        bkeys = torch.cat([bk[0], bk[1][:, None], bk[2][:, None]], 1)
        pw, w = rb.shape[1], max(rb.shape[2], lb.shape[1], bb.shape[1])
        arr = torch.cat([_fit(rb, w), _fit(lb, w)[:, None],
                         _fit(bb, w)[:, None]], 1)
        seen = torch.cat([_fit0(rb_seen, w), _fit0(lb_seen, w)[:, None],
                          _fit0(bb_seen, w)[:, None]], 1)
        rows = pw + 2
        out, out_seen = self._bkt_put(
            kt, bkeys, arr, seen, cands[:, None].expand(-1, rows, -1),
            cseen[:, None].expand(-1, rows, -1))
        return dict(rb=out[:, :pw, :rb.shape[2]],
                    rb_seen=out_seen[:, :pw, :rb.shape[2]],
                    lb=out[:, pw, :lb.shape[1]],
                    lb_seen=out_seen[:, pw, :lb.shape[1]],
                    bb=out[:, pw + 1, :bb.shape[1]],
                    bb_seen=out_seen[:, pw + 1, :bb.shape[1]])

    def _routing_add(self, kt, bk, st, node_idx, cands, alive, now, en):
        """routingAdd to every bucket (Broose.cc:1081-1091) where ``en``
        [N]: ``cands`` [N, C] slots, ``alive`` [N, C] or a bool."""
        cands = torch.where(cands == node_idx[:, None], NO_NODE, cands)
        cseen = torch.where(alive & (cands != NO_NODE), now[:, None], 0)
        new = self._put_all(kt, bk, *(getattr(st, f) for f in BUCKETS),
                            cands, cseen)
        return dataclasses.replace(st, **{
            f: torch.where(bcast(en, new[f]), new[f], getattr(st, f))
            for f in BUCKETS})

    def _remove_node(self, kt, bk, st, bad):
        """Drop ``bad`` [N, F] slots from every bucket and re-sort
        (routingTimeout with numberRetries=0, Broose.cc:1070-1079)."""
        n = bad.shape[0]
        any_bad = torch.any(bad != NO_NODE, 1)

        def hit(x):
            xf = x.reshape(n, -1)
            h = torch.any(xf[:, :, None] == bad[:, None, :], -1)
            return h.reshape(x.shape) & (x != NO_NODE)

        cut = {f: torch.where(hit(getattr(st, f)), NO_NODE, getattr(st, f))
               for f in ("rb", "lb", "bb")}
        none = torch.full((n, 1), NO_NODE, dtype=I32, device=bad.device)
        new = self._put_all(kt, bk, cut["rb"], st.rb_seen, cut["lb"],
                            st.lb_seen, cut["bb"], st.bb_seen, none,
                            torch.zeros_like(none, dtype=I64))
        return dataclasses.replace(st, **{
            f: torch.where(bcast(any_bad, new[f]), new[f], getattr(st, f))
            for f in BUCKETS})

    def _longest_prefix(self, ctx, arr):
        """sharedPrefixLength of a bucket's first and last valid entries
        (BrooseBucket::longestPrefix, BrooseBucket.cc:202-209)."""
        n = torch.sum(arr != NO_NODE, -1)
        first = arr[..., 0]
        last = torch.gather(arr, -1, torch.clamp(
            n - 1, 0, arr.shape[-1] - 1)[..., None])[..., 0]
        spl = K.shared_prefix_length(
            ctx.keys[torch.clamp(first, min=0).long()],
            ctx.keys[torch.clamp(last, min=0).long()], self.key_spec)
        return torch.where(n < 2, 0, spl).to(I32)

    def _is_sibling(self, ctx, st, me_key, key):
        """bBucket keyInRange (BrooseBucket.cc:239-258) for ``key`` [N,
        T, KL]: (key ^ me) <= the XOR distance of the k-th closest
        brother, self counted as rank 0 → [N, T]."""
        p = self.p
        nb = torch.sum(st.bb != NO_NODE, 1) + 1
        kth = st.bb[:, min(max(p.bucket_size - 2, 0), p.bb_size - 1)]
        dist = ctx.keys[torch.clamp(kth, min=0).long()] ^ me_key
        close = K.le(key ^ me_key[:, None], dist[:, None])
        return ((st.state == READY) & (nb <= p.bucket_size))[:, None] | (
            (st.state == READY)[:, None] & close)

    # -- findNode (Broose.cc:574-770) ---------------------------------------

    def _unpack_ext(self, ext):
        kl = self.key_spec.lanes
        return (pool_mod.key_from_i32(ext[..., :kl]), ext[..., kl],
                ext[..., kl + 1], ext[..., kl + 2])

    def _pack_ext(self, rk, step, flags, last):
        return torch.cat([pool_mod.key_to_i32(rk), step[..., None].to(I32),
                          flags[..., None].to(I32), last[..., None].to(I32)],
                         -1)

    def _init_ext(self, ctx, st, me_key, key):
        """The first findNode evaluation's ext (Broose.cc:622-668): the hop
        distance from the R buckets' longest shared prefixes, and the
        direction alternating per lookup.  ``key`` [N, T, KL]."""
        p, spec = self.p, self.key_spec
        s = p.shifting_bits
        dist = torch.maximum(self._longest_prefix(ctx, st.rb[:, 0]),
                             self._longest_prefix(ctx, st.rb[:, 1])) \
            + 1 + p.user_dist
        dist = dist + (s - dist % s) % s
        dist = torch.clamp(dist, max=self.max_dist)[:, None]       # [N, 1]
        left = (st.choose % 2 == 0)[:, None]
        me = me_key[:, None]
        me_top = K.shl_dyn(K.shr_dyn(me, spec.bits - dist, spec),
                           spec.bits - dist, spec)
        rk_left = K.add(K.shr_dyn(key, dist, spec), me_top, spec)
        shape = key.shape[:-1]
        rk = torch.where(left[..., None], rk_left, me)
        step = torch.where(left, -dist, dist).expand(shape)
        flags = torch.where(left, 1, 3).to(I32).expand(shape)
        return rk, step.to(I32), flags

    def _eval_once(self, ctx, st, node_idx, key, rk, step, right, rmax):
        """One shifting hop for ``key``/``rk`` [N, T, KL], ``step``/
        ``right`` [N, T]: (res [N, T, rmax] sorted candidates, rk',
        step')."""
        p, spec = self.p, self.key_spec
        s = p.shifting_bits
        n, t = step.shape
        brother = step == 0
        rk_l = K.shl_const(rk, s, spec)
        step_l = step + s
        # right hop: prefix = the key's s bits at MSB digit step/s - 1
        di = torch.clamp(torch.div(step, s, rounding_mode="floor") - 1,
                         min=0)
        pfx = K.digit(key, di, s, spec)
        top = torch.cat([(pfx.to(I64) << (spec.top_lane_bits - s))[..., None],
                         torch.zeros_like(key[..., 1:])], -1)
        rk_r = K.add(K.shr_const(rk, s, spec), top, spec)
        step_r = step - s
        rk2 = torch.where(brother[..., None], rk,
                          torch.where(right[..., None], rk_r, rk_l))
        step2 = torch.where(brother, step, torch.where(right, step_r, step_l))

        pad = max(p.bb_size, p.lb_size, p.r_bucket_size) + 1
        me = node_idx[:, None]
        c_b = _fit(torch.cat([st.bb, me], 1), pad)[:, None]
        c_l = _fit(torch.cat([st.lb, me], 1), pad)[:, None]
        c_r = _fit(torch.cat([take(st.rb, pfx),
                              me[:, None].expand(n, t, 1)], -1), pad)
        cands = torch.where(brother[..., None], c_b,
                            torch.where(right[..., None], c_r, c_l))
        sort_key = torch.where(brother[..., None], key, rk2)
        d = self._xor_top(ctx.keys[:, :self._top], cands, sort_key)
        d = torch.where(K.dup_mask(cands)[..., None], K.UMAX, d)
        (c_s,) = K.sort_by_distance(d, (cands,), approx=True)[1]
        return _fit(c_s[..., :rmax], rmax), rk2, step2

    def _sib_set(self, ctx, st, node_idx, key, rmax):
        """``_eval_once`` at step 0 (a brother hop): the brothers and the
        node itself sorted by XOR to ``key`` (Broose.cc:598-620)."""
        p = self.p
        pad = max(p.bb_size, p.lb_size, p.r_bucket_size) + 1
        c_b = _fit(torch.cat([st.bb, node_idx[:, None]], 1), pad)
        c_b = c_b[:, None].expand(key.shape[:-1] + (pad,))
        d = self._xor_top(ctx.keys[:, :self._top], c_b, key)
        d = torch.where(K.dup_mask(c_b)[..., None], K.UMAX, d)
        (c_s,) = K.sort_by_distance(d, (c_b,), approx=True)[1]
        return _fit(c_s[..., :rmax], rmax)

    def _eval_find(self, ctx, st, me_key, node_idx, key, ext, rmax):
        """The full findNode evaluation for ``key`` [N, T, KL] and ``ext``
        [N, T, EW]: (res [N, T, rmax], is_sib, ext_out, answerable,
        inited).  ``answerable`` is false in INIT/RSET and for left hops
        in BSET (Broose.cc:578-580, 699-701)."""
        rk_in, step_in, flags, _ = self._unpack_ext(ext)
        need_init = (flags & 1) == 0
        rk0, step0, flags0 = self._init_ext(ctx, st, me_key, key)
        rk = torch.where(need_init[..., None], rk0, rk_in)
        step = torch.where(need_init, step0, step_in)
        flags = torch.where(need_init, flags0, flags)
        right = (flags & 2) != 0

        is_sib = self._is_sibling(ctx, st, me_key, key)
        sib_set = self._sib_set(ctx, st, node_idx, key, rmax)
        res, rk_c, step_c = self._eval_once(ctx, st, node_idx, key, rk,
                                            step, right, rmax)
        for _ in range(SELF_HOPS - 1):
            again = res[..., 0] == node_idx[:, None]
            res2, rk2, step2 = self._eval_once(ctx, st, node_idx, key, rk_c,
                                               step_c, right, rmax)
            res = torch.where(again[..., None], res2, res)
            rk_c = torch.where(again[..., None], rk2, rk_c)
            step_c = torch.where(again, step2, step_c)

        left_hop = ~right & (step != 0)
        answerable = ((st.state == READY)[:, None]
                      | ((st.state == BSET)[:, None] & ~left_hop))
        res = torch.where(answerable[..., None], res, NO_NODE)
        ext_out = self._pack_ext(rk_c, step_c, flags,
                                 node_idx[:, None].expand(step_c.shape))
        return (torch.where(is_sib[..., None], sib_set, res), is_sib,
                ext_out, answerable, need_init)

    def _with_ext(self, res, sib, ext_out):
        """A non-sibling answer carries the updated ext in its tail."""
        ew = ext_out.shape[-1]
        tail = torch.cat([res[..., :res.shape[-1] - ew], ext_out], -1)
        return torch.where(sib[..., None], res, tail)

    # -- failure / ready ----------------------------------------------------

    def _restart_join_node(self, st, en, now, rng):
        """Back to INIT: clear the buckets and counters; the join timer
        redraws the bootstrap (changeState(INIT), Broose.cc:148-173)."""
        jitter = (rng_mod.uniform(rng, (), F64) * 0.1 * NS).to(I64)

        def w(new, old):
            return torch.where(bcast(en, old), new, old)

        return dataclasses.replace(
            st, state=w(INIT, st.state), rb=w(NO_NODE, st.rb),
            rb_seen=w(0, st.rb_seen), lb=w(NO_NODE, st.lb),
            lb_seen=w(0, st.lb_seen), bb=w(NO_NODE, st.bb),
            bb_seen=w(0, st.bb_seen), jb_recv=w(0, st.jb_recv),
            pr_recv=w(0, st.pr_recv), pb_recv=w(0, st.pb_recv),
            t_join=w(now + jitter, st.t_join),
            state_to=w(T_INF, st.state_to))

    def _become_ready(self, ctx, st, en, now, rng):
        return dataclasses.replace(
            st,
            state=torch.where(en, READY, st.state),
            t_join=torch.where(en, T_INF, st.t_join),
            state_to=torch.where(en, T_INF, st.state_to),
            t_bucket=torch.where(en, now + int(self.p.refresh_time / 2 * NS),
                                 st.t_bucket),
            app=self.app.on_ready(st.app, en, now, rng))

    def _paced_calls(self, ob, en, now, arr, cursor, pro_state):
        """Up to calls_per_tick BUCKET_CALL(LEFT, pro_state) to the valid
        entries of ``arr`` [N, A] from ``cursor`` on, in one send; returns
        the new cursor."""
        j = self.p.calls_per_tick
        valid = (arr != NO_NODE) & ~K.dup_mask(arr)
        idx = torch.arange(arr.shape[1], dtype=I32, device=arr.device)
        elig = valid & (idx >= cursor[:, None])
        cum = torch.cumsum(elig.to(I32), 1)
        rank = torch.arange(1, j + 1, dtype=I32, device=arr.device)
        pick = elig[:, None, :] & (cum[:, None, :] == rank[:, None])  # [N, J, A]
        hit = torch.any(pick, -1)
        pos = torch.argmax(pick.to(I32), -1)
        ob.send(en[:, None] & hit, now, take(arr, pos),
                wire.BROOSE_BUCKET_CALL, a=BT_LEFT, b=pro_state,
                size_b=wire.BASE_CALL_B + 2)
        sent = en[:, None] & hit
        last = torch.max(torch.where(sent, pos.to(I32) + 1, -1), 1).values
        last_sent = torch.where(torch.any(sent, 1), last, cursor)
        return torch.where(en, last_sent, cursor)

    # -- the batched step -----------------------------------------------------

    def step(self, ctx, st, msgs, rng, node_idx, *, outbox_slots, rmax):
        p, lcfg, spec = self.p, self.lcfg, self.key_spec
        s = p.shifting_bits
        ew = lcfg.ext_words
        n = node_idx.shape[0]
        dev = node_idx.device
        ob = Outbox(n, outbox_slots, spec.lanes, rmax, dev)
        me_key = ctx.keys[node_idx.long()]
        rngs = rng_mod.split(rng, 9)                              # [N, 9, 2]
        t0, t_end = ctx.t_start, ctx.t_end
        f = lcfg.frontier
        pace_ns = int(p.pace_delay * NS)
        state_to_ns = int(p.join_state_timeout * NS)
        kt = ctx.keys[:, :self._top]
        bk = self._bucket_keys(me_key)
        n_all = ctx.keys.shape[0]

        def ready_of(slots):
            return ctx.ready[torch.clamp(slots, 0, n_all - 1).long()]

        def metric_fn(cand, target):
            ck = ctx.keys[torch.clamp(cand, 0, n_all - 1).long()]
            d = ck ^ target[:, :, None, :]
            return torch.where((cand == NO_NODE)[..., None], K.UMAX, d)

        ev = app_base.AppEvents(n, dev)
        zeros_n = torch.zeros((n,), dtype=I32, device=dev)
        joins_cnt, retries_cnt = zeros_n, zeros_n
        anyfail_cnt, lksucc_cnt, routedrop_cnt = zeros_n, zeros_n, zeros_n

        if self.rcfg is not None:
            # recursive pre-pass: each hop runs the shift-routing eval with
            # the ext in the head of the routed message's node list
            res_rt, sib_rt, ext_rt, _, _ = self._eval_find(
                ctx, st, me_key, node_idx, msgs.key, msgs.nodes[..., :ew],
                rmax)
            rr, msgs, drop = rt_mod.prepass(
                st.rr, ob, msgs, self._with_ext(res_rt, sib_rt, ext_rt),
                sib_rt, st.state >= BSET, node_idx, self.rcfg,
                forward_veto=app_base.app_veto(self.app, st.app, ctx))
            st = dataclasses.replace(st, rr=rr)
            routedrop_cnt = routedrop_cnt + drop

        # ------------------------------------------------------- inbox -----
        true_n = torch.ones((n, 1), dtype=torch.bool, device=dev)
        for r in range(msgs.valid.shape[1]):
            m = msgs.slot(r)
            now = m.t_deliver
            v = m.valid

            # a READY sender refreshes its bucket entries (Broose.cc:
            # 840-846, 914-916)
            st = self._routing_add(kt, bk, st, node_idx, m.src[:, None],
                                   true_n, now, v & ready_of(m.src))

            # FindNodeCall → the shift-routing evaluation; BSET and READY
            # answer (handleRpcCall, Broose.cc:878-909)
            en = v & (m.kind == wire.FINDNODE_CALL)
            ext_in = m.nodes[:, None, :ew]
            res, sib, ext_out, ok, _ = self._eval_find(
                ctx, st, me_key, node_idx, m.key[:, None], ext_in, rmax)
            res, sib, ok = res[:, 0], sib[:, 0], ok[:, 0]
            # the previous hop from the ext (Broose.cc:673-680), learned
            # below
            last = m.nodes[:, ew - 1]
            en_last = en & (last != NO_NODE) & ready_of(last)
            res = self._with_ext(res, sib, ext_out[:, 0])
            n_res = torch.sum(res != NO_NODE, 1, dtype=I32)
            ob.send(en & ok, now, m.src, wire.FINDNODE_RES, key=m.key,
                    a=m.a, b=m.b, c=sib.to(I32), nodes=res,
                    size_b=wire.BASE_CALL_B + 1 + wire.NODEHANDLE_B * n_res)

            # FindNodeResponse → the lookup engine, the contents learned
            en = v & (m.kind == wire.FINDNODE_RES)
            st = dataclasses.replace(st, lk=lk_mod.on_response(
                st.lk, dataclasses.replace(m, valid=en), metric_fn, lcfg))
            en_res = en

            # the contacts this slot teaches: the call's previous hop, a
            # FindNode response's or a BucketResponse's nodes (one kind
            # per slot, so one put; the bucket server and the state
            # machine below read the buckets after it, as in the JAX
            # package's order)
            en_bres = v & (m.kind == wire.BROOSE_BUCKET_RES)
            learned = m.nodes[:, :f]
            l_ok = (learned != NO_NODE) & ready_of(learned)
            cands = torch.where(en_last[:, None], _fit(last[:, None], f),
                                torch.where(l_ok, learned, NO_NODE))
            st = self._routing_add(kt, bk, st, node_idx, cands,
                                   cands != NO_NODE, now,
                                   en_last | en_res | en_bres)

            # BucketCall server (handleBucketRequestRpc, Broose.cc:962-1008)
            en = v & (m.kind == wire.BROOSE_BUCKET_CALL) & (
                (st.state == BSET) | (st.state == READY))
            is_left = (m.a == BT_LEFT)[:, None]
            src_bucket = torch.where(is_left, _fit(st.lb, p.bb_size), st.bb)
            nb_src = torch.where(is_left[:, 0],
                                 torch.sum(st.lb != NO_NODE, 1),
                                 torch.sum(st.bb != NO_NODE, 1))
            payload = _fit(src_bucket[:, :min(rmax, p.bb_size)], rmax)
            payload = torch.where(
                torch.arange(rmax, device=dev)[None, :]
                < torch.clamp(nb_src, max=rmax)[:, None], payload, NO_NODE)
            ob.send(en, now, m.src, wire.BROOSE_BUCKET_RES, a=m.a, b=m.b,
                    nodes=payload,
                    size_b=wire.BASE_CALL_B
                    + wire.NODEHANDLE_B * min(rmax, p.bb_size))

            # BucketResponse → the join state machine
            # (handleBucketResponseRpc, Broose.cc:1010-1052)
            en = en_bres
            hit_i = en & (st.state == INIT) & (m.b == PR_INIT)
            jb = st.jb_recv + hit_i.to(I32)
            to_rset = hit_i & (jb >= p.pow_shift)
            hit_r = en & (st.state == RSET) & (m.b == PR_RSET)
            pr = st.pr_recv + hit_r.to(I32)
            to_bset = hit_r & (pr >= st.pr_need)
            hit_b = en & (st.state == BSET) & (m.b == PR_BSET)
            pb = st.pb_recv + hit_b.to(I32)
            to_ready = hit_b & (pb >= st.pb_need)
            rb_flat = st.rb.reshape(n, -1)
            n_rb = torch.sum((rb_flat != NO_NODE) & ~K.dup_mask(rb_flat), 1,
                             dtype=I32)
            n_bb = torch.sum(st.bb != NO_NODE, 1, dtype=I32)
            moved = to_rset | to_bset
            st = dataclasses.replace(
                st,
                jb_recv=jb,
                pr_recv=torch.where(to_rset, 0, pr),
                pb_recv=torch.where(to_bset, 0, pb),
                state=torch.where(to_rset, RSET,
                                  torch.where(to_bset, BSET, st.state)),
                pr_need=torch.where(to_rset, (n_rb + 1) // 2, st.pr_need),
                pr_cursor=torch.where(to_rset, 0, st.pr_cursor),
                pb_need=torch.where(to_bset, (n_bb + 1) // 2, st.pb_need),
                pb_cursor=torch.where(to_bset, 0, st.pb_cursor),
                t_join=torch.where(moved, now, st.t_join),
                state_to=torch.where(moved, now + state_to_ns, st.state_to))
            joins_cnt = joins_cnt + to_ready.to(I32)
            st = self._become_ready(ctx, st, to_ready, now, rngs[:, 0])

            # the app's kinds
            sib_app = self._is_sibling(ctx, st, me_key, m.key[:, None])[:, 0]
            st = dataclasses.replace(st, app=self.app.on_msg(
                st.app, m, ctx, ob, ev, sib_app))

            # pings
            ob.send(v & (m.kind == wire.PING_CALL), now, m.src,
                    wire.PING_RES, a=m.a, size_b=wire.BASE_CALL_B)
            phit = (v & (m.kind == wire.PING_RES))[:, None] & (
                st.ping_dst == m.src[:, None])
            st = dataclasses.replace(
                st, ping_dst=torch.where(phit, NO_NODE, st.ping_dst),
                ping_to=torch.where(phit, T_INF, st.ping_to))

        # ------------------------------------------------------- timers ----
        # join timer in INIT (handleJoinTimerExpired, Broose.cc:268-318):
        # 2^s lookups for i 2^(B-s) + (me >> s), seeded at the bootstrap
        en_j = (st.state == INIT) & (st.t_join < t_end)
        now_j = torch.maximum(st.t_join, t0)
        boot = ctx.sample_ready(rngs[:, 1], node_idx)
        no_jb = ~torch.any(st.lk.active & (st.lk.purpose == P_JOINB), 1)
        alone = en_j & (boot == NO_NODE)
        joins_cnt = joins_cnt + alone.to(I32)
        st = self._become_ready(ctx, st, alone, now_j, rngs[:, 2])
        fire_j = en_j & ~alone & no_jb & (lk_mod.num_free(st.lk)
                                          >= p.pow_shift)
        shr_me = K.shr_const(me_key, s, spec)
        zkey = torch.zeros_like(me_key)
        ext0 = self._pack_ext(zkey, zeros_n, zeros_n, node_idx)
        seed = _fit(boot[:, None], f)
        for i in range(p.pow_shift):
            tgt_key = K.add(shr_me, K.from_int(i << (spec.bits - s), spec,
                                               dev), spec)
            slot, have = lk_mod.free_slot(st.lk)
            st = dataclasses.replace(st, lk=lk_mod.start(
                st.lk, fire_j & have, slot, P_JOINB, i, tgt_key, seed,
                now_j, lcfg, ext=ext0))
        st = dataclasses.replace(
            st,
            t_join=torch.where(en_j & ~alone, now_j + int(p.join_delay * NS),
                               st.t_join),
            state_to=torch.where(fire_j, now_j + state_to_ns, st.state_to),
            jb_recv=torch.where(fire_j, 0, st.jb_recv))

        # pacing timers in RSET / BSET: the next batch of LBucket calls
        for state_v, arr_f, cur_f, pro in (
                (RSET, "rb", "pr_cursor", PR_RSET),
                (BSET, "bb", "pb_cursor", PR_BSET)):
            en_p = (st.state == state_v) & (st.t_join < t_end)
            now_p = torch.maximum(st.t_join, t0)
            cursor = getattr(st, cur_f)
            cur = self._paced_calls(ob, en_p, now_p,
                                    getattr(st, arr_f).reshape(n, -1),
                                    cursor, pro)
            more = cur > cursor
            st = dataclasses.replace(st, **{cur_f: cur}, t_join=torch.where(
                en_p, torch.where(more, now_p + pace_ns, T_INF), st.t_join))

        # join-state deadline → restart from INIT
        en_d = (st.state >= INIT) & (st.state < READY) & (st.state_to < t_end)
        retries_cnt = retries_cnt + en_d.to(I32)
        st = self._restart_join_node(st, en_d,
                                     torch.maximum(st.state_to, t0),
                                     rngs[:, 3])

        # refresh timer (handleBucketTimerExpired, Broose.cc:318-341): ping
        # the stalest entries, a bounded number at a time
        en_b = (st.state == READY) & (st.t_bucket < t_end)
        now_b = torch.maximum(st.t_bucket, t0)
        refresh_ns = int(p.refresh_time * NS)
        all_e = torch.cat([st.rb.reshape(n, -1), st.lb, st.bb], 1)
        all_seen = torch.cat([st.rb_seen.reshape(n, -1), st.lb_seen,
                              st.bb_seen], 1)
        stale = (all_e != NO_NODE) & ~K.dup_mask(all_e) & (
            all_seen + refresh_ns < now_b[:, None])
        order = torch.sort(torch.where(stale, all_seen, T_INF), dim=1,
                           stable=True).indices[:, :p.ping_slots]
        tgt = torch.gather(all_e, 1, order)
        fire = en_b[:, None] & (st.ping_dst == NO_NODE) & torch.gather(
            stale, 1, order)
        ob.send(fire, now_b, tgt, wire.PING_CALL, size_b=wire.BASE_CALL_B)
        st = dataclasses.replace(
            st, ping_dst=torch.where(fire, tgt, st.ping_dst),
            ping_to=torch.where(fire, (now_b + int(p.rpc_timeout * NS))
                                [:, None], st.ping_to))
        # the periodic brother-bucket pull
        nbb = torch.sum(st.bb != NO_NODE, 1, dtype=I32)
        pick = rng_mod.randint(rngs[:, 7], (), 0, torch.clamp(nbb, min=1),
                               dtype=I32)
        btgt = take(st.bb, torch.clamp(pick, 0, p.bb_size - 1))
        ob.send(en_b & (btgt != NO_NODE), now_b, btgt,
                wire.BROOSE_BUCKET_CALL, a=BT_BROTHER, b=PR_REFRESH,
                size_b=wire.BASE_CALL_B + 2)
        st = dataclasses.replace(st, t_bucket=torch.where(
            en_b, now_b + refresh_ns // 2, st.t_bucket))

        # ping timeouts → removal from every bucket
        pto = st.ping_to < t_end
        ping_failed = torch.where(pto, st.ping_dst, NO_NODE)
        st = dataclasses.replace(
            st, ping_dst=torch.where(pto, NO_NODE, st.ping_dst),
            ping_to=torch.where(pto, T_INF, st.ping_to))
        st = self._remove_node(kt, bk, st, ping_failed)

        # app timer
        st = dataclasses.replace(st, app=app_base.leave_protocol(
            self.app, st.app, ctx, ob, ev, t0, node_idx, st.bb[:, 0],
            st.state == READY))
        t_app = self.app.next_event(st.app)
        en_a = (st.state == READY) & (t_app < t_end)
        now_a = torch.maximum(t_app, t0)
        app, req = self.app.on_timer(st.app, en_a, ctx, now_a, rngs[:, 4],
                                     ev, node_idx)
        st = dataclasses.replace(st, app=app)
        ext_a = self._pack_ext(zkey, zeros_n, zeros_n, zeros_n + NO_NODE)
        seed_a, sib_a, ext_a, _, _ = self._eval_find(
            ctx, st, me_key, node_idx, req.key[:, None], ext_a[:, None], rmax)
        seed_a, sib_a, ext_a = seed_a[:, 0], sib_a[:, 0], ext_a[:, 0]
        st = dataclasses.replace(st, choose=st.choose + (
            req.want & ~sib_a).to(I32))
        local = req.want & sib_a
        slot, have = lk_mod.free_slot(st.lk)
        route_fire = torch.zeros_like(req.want)
        if self.rcfg is not None and hasattr(self.app, "route_policy"):
            rr, app, route_fire, start_app = rt_mod.originate(
                st.rr, ob, self.app, st.app, req, seed_a[:, 0], sib_a, have,
                now_a, node_idx, rmax, self.rcfg, ctx.measuring, ext0=ext_a)
            st = dataclasses.replace(st, rr=rr, app=app)
        else:
            start_app = req.want & ~sib_a & have & (seed_a[:, 0] != NO_NODE)
        insta_fail = req.want & ~sib_a & ~start_app & ~route_fire
        st = dataclasses.replace(st, app=self.app.on_lookup_done(
            st.app, app_base.LookupDone(
                en=local | insta_fail, success=local, tag=req.tag,
                target=req.key,
                results=torch.where(local[:, None], seed_a[:, :f], NO_NODE),
                hops=zeros_n, t0=now_a),
            ctx, ob, ev, now_a, node_idx))
        st = dataclasses.replace(st, lk=lk_mod.start(
            st.lk, start_app, slot, P_APP, req.tag, req.key, seed_a[:, :f],
            now_a, lcfg, ext=ext_a))

        # ------------------------------------------------ timeouts ---------
        new_lk, failed_nodes, _ = lk_mod.on_timeouts(st.lk, t_end, t0, lcfg)
        st = dataclasses.replace(st, lk=new_lk)
        st = self._remove_node(kt, bk, st, failed_nodes)
        if self.rcfg is not None:
            # route-hop ACK timeouts → bucket removal and a reroute with
            # the eval over the parked key and ext (the re-sent message
            # keeps the parked ext)
            rr, rt_failed, rt_retry = rt_mod.on_timeouts(st.rr, t_end,
                                                         self.rcfg)
            st = dataclasses.replace(st, rr=rr)
            st = self._remove_node(kt, bk, st, rt_failed)
            res_q, sib_q, _, _, _ = self._eval_find(
                ctx, st, me_key, node_idx, st.rr.key,
                st.rr.visited[..., :ew], rmax)
            rr, drop_q = rt_mod.reroute(st.rr, ob, res_q, sib_q, rt_failed,
                                        rt_retry, t0, node_idx, self.rcfg)
            st = dataclasses.replace(st, rr=rr)
            routedrop_cnt = routedrop_cnt + drop_q

        # ------------------------------------------------- completions -----
        new_lk, comp = lk_mod.take_completions(st.lk, t_end)
        st = dataclasses.replace(st, lk=new_lk)
        taken = comp["taken"]
        comp_hops_ev = (comp["hops"].to(F32), taken & comp["success"])
        suc_l = comp["success"] & (comp["result"] != NO_NODE)
        lksucc_cnt = lksucc_cnt + torch.sum(taken & suc_l, 1, dtype=I32)
        anyfail_cnt = anyfail_cnt + torch.sum(taken & ~suc_l, 1, dtype=I32)
        enj_l = taken & (comp["purpose"] == P_JOINB) & (
            st.state == INIT)[:, None]
        ena_l = taken & (comp["purpose"] == P_APP)
        for li in range(lcfg.slots):
            # join bucket lookup → BBucketCall to the responsible node
            ob.send(enj_l[:, li] & suc_l[:, li], t0, comp["result"][:, li],
                    wire.BROOSE_BUCKET_CALL, a=BT_BROTHER, b=PR_INIT,
                    size_b=wire.BASE_CALL_B + 2)
            st = dataclasses.replace(st, app=self.app.on_lookup_done(
                st.app, app_base.LookupDone(
                    en=ena_l[:, li], success=ena_l[:, li] & suc_l[:, li],
                    tag=comp["aux"][:, li], target=comp["target"][:, li],
                    results=comp["results"][:, li], hops=comp["hops"][:, li],
                    t0=comp["t0"][:, li]),
                ctx, ob, ev, t0, node_idx))
        # a failed join lookup restarts the join (Broose.cc:1055-1062)
        fail_j = enj_l & ~suc_l
        retries_cnt = retries_cnt + torch.sum(fail_j, 1, dtype=I32)
        st = self._restart_join_node(st, torch.any(fail_j, 1), t0,
                                     rngs[:, 5])

        # ------------------------------------------------------- pump ------
        st = dataclasses.replace(st, lk=lk_mod.pump(st.lk, ob, ctx, node_idx,
                                                    t0, lcfg))

        events = {
            "c:broose_joins": joins_cnt,
            "c:broose_join_retries": retries_cnt,
            "c:lookup_success": lksucc_cnt,
            "c:lookup_failed": anyfail_cnt,
            "c:route_dropped": routedrop_cnt,
            "s:lookup_hops": comp_hops_ev,
        }
        ev.finish(events, self.app.hist_map)
        return st, ob, events
