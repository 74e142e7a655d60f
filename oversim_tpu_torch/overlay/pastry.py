"""Pastry / Bamboo prefix routing as batched per-node logic (PyTorch).

Counterpart of ``oversim_tpu/overlay/pastry.py`` (the reference's
BasePastry, Pastry and Bamboo; default.ini:226-267: bitsPerDigit 4,
numberOfLeaves 16, Bamboo 8).  Per node: a leaf set as two ring-sorted
halves ``[N, L/2]`` (clockwise successors, counter-clockwise
predecessors), a prefix routing table ``[N, ROWS, 2^b]`` (row r, column c:
a node sharing r digits with our key whose digit r is c) with the RTT of
each entry for proximity neighbour selection, findNode (the numerically
closest leaf inside the leaf-set span, else the table entry at [shared
digits, next digit], else the closest known node with an at-least-equal
prefix), a join by an iterative lookup of the own key and a state
exchange with the responsible node, Bamboo-style leaf-set push-pull and
global tuning, and reactive leaf repair.

Application payloads route semi-recursively with per-hop ACKs by default
(``common/route.py``; ``routing_mode="iterative"`` switches to lookup
then direct hop); join and maintenance lookups stay iterative.

The JAX package writes ``step`` for one node and vmaps it; here every
operation runs over the leading ``[N]`` axis.  The R inbox slots are
handled one after another, as there, because each slot's sends (ACK,
forward, FindNode answer, state reply) interleave in outbox order and
each slot's learning feeds the next slot's findNode.  Four equivalences
keep the per-slot work down: a slot learns only into the leaf set and
the table, so only those four fields are selected per node (the JAX
package selects the whole state); a slot's FindNode-response and
state-response learnings and the next slot's source learning are one
pass (a slot has one kind, nothing between them reads the tables, and
merging a list into the leaf set at once equals merging its parts in
turn); of a
slot's candidates only the first may carry an RTT, and an unmeasured
one only fills an empty table cell, so the rest fill their cells in one
pass; and the app's ``on_ready`` of the nodes a state response made
ready runs once after the slots, with the same key and each node's own
time (a node becomes ready once, and no app's deliver hook reads or
writes the test timer that ``on_ready`` sets).  findNode's fallback
needs the first ``rec_redundant`` entries of a stable sort of 1 + L +
ROWS 2^b known nodes: they are taken by repeated first-minimum
(``torch.argmin`` returns the first index), which is the stable sort's
head.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch import stats as stats_mod
from oversim_tpu_torch.apps import base as app_base
from oversim_tpu_torch.apps.kbrtest import KbrTestApp
from oversim_tpu_torch.common import lookup as lk_mod
from oversim_tpu_torch.common import neighborcache as nc_mod
from oversim_tpu_torch.common import route as rt_mod
from oversim_tpu_torch.common import wire
from oversim_tpu_torch.core import keys as K
from oversim_tpu_torch.engine.logic import (Outbox, keys_of, put,
                                           select_tree, take)

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1
UMAX = K.UMAX
RTT_INF = 2 ** 30
I64_MAX = 2 ** 63 - 1

DEAD, JOINING, READY = 0, 1, 2
P_JOIN, P_TUNE, P_APP = 1, 2, 3


@dataclasses.dataclass(frozen=True)
class PastryParams:
    """default.ini:226-267 (JAX field names and defaults)."""

    bits_per_digit: int = 4
    num_leaves: int = 16
    rows: int = 16
    join_delay: float = 10.0
    leafset_interval: float = 10.0
    tuning_interval: float = 30.0
    rpc_timeout: float = 1.5
    routing_mode: str = "semi-recursive"
    route_acks: bool = True
    rec_redundant: int = 4
    adaptive_timeouts: bool = False

    @property
    def cols(self) -> int:
        return 1 << self.bits_per_digit

    @property
    def half(self) -> int:
        return self.num_leaves // 2


@dataclasses.dataclass
class PastryState:
    state: torch.Tensor     # [N] i32
    leaf_cw: torch.Tensor   # [N, L/2] i32 clockwise (successor side)
    leaf_ccw: torch.Tensor  # [N, L/2] i32 counter-clockwise
    rt: torch.Tensor        # [N, ROWS, COLS] i32
    rt_rtt: torch.Tensor    # [N, ROWS, COLS] i32 RTT ms of each entry
    t_join: torch.Tensor    # [N] i64
    t_ls: torch.Tensor      # [N] i64 leaf-set maintenance
    t_gt: torch.Tensor      # [N] i64 global tuning
    lk: lk_mod.LookupState
    rr: rt_mod.RouteState
    nc: nc_mod.NcState
    app: object
    app_glob: object


def _prefix_mask(m, spec: K.KeySpec):
    """[...] prefix lengths in bits → [..., KL] lane masks of each key's
    top ``m`` significant bits."""
    out = []
    start = 0
    for i in range(spec.lanes):
        width = spec.top_lane_bits if i == 0 else K.LANE_BITS
        k = torch.clamp(m.to(I64) - start, 0, width)
        out.append(((torch.ones_like(k) << k) - 1) << (width - k))
        start += width
    return torch.stack(out, -1)


class PastryLogic:
    """Engine logic interface; Bamboo is PastryLogic with Bamboo's
    defaults."""

    def __init__(self, spec: K.KeySpec = K.DEFAULT_SPEC,
                 params: PastryParams = PastryParams(),
                 lcfg: lk_mod.LookupConfig | None = None, app=None):
        if params.routing_mode not in ("semi-recursive", "iterative"):
            raise ValueError(f"routing_mode {params.routing_mode!r}")
        self.key_spec = spec
        self.p = params
        self.lcfg = lcfg or lk_mod.LookupConfig()
        self.lcfg.check_ported()
        self.rcfg = rt_mod.RouteConfig(route_acks=params.route_acks)
        self.app = app or KbrTestApp()
        if getattr(self.app, "rcfg", None) is None:
            # Pastry routes semi-recursively by default: the app's reply
            # transport and duplicate ring must know
            self.app.rcfg = self.rcfg
        # responsibility is numeric closeness on the ring (keyDist)
        if getattr(self.app, "dist_fn", "no") is None:
            self.app.dist_fn = (
                lambda nk, rk: K.bidir_ring_distance(nk, rk, spec))

    # -- engine interface ---------------------------------------------------

    def split(self, st: PastryState):
        return dataclasses.replace(st, app_glob=None), st.app_glob

    def merge(self, node_part: PastryState, glob):
        return dataclasses.replace(node_part, app_glob=glob)

    def post_step(self, ctx, st: PastryState, events):
        app, glob = self.app.post_step(ctx, st.app, st.app_glob, events)
        return dataclasses.replace(st, app=app, app_glob=glob)

    def stat_spec(self) -> stats_mod.StatSpec:
        app = self.app.stat_spec()
        return stats_mod.StatSpec(
            scalars=tuple(app["scalars"]) + ("lookup_hops",),
            hists=tuple(app["hists"]),
            counters=tuple(app["counters"]) + (
                "pastry_joins", "lookup_success", "lookup_failed",
                "route_dropped"))

    def init(self, rng, n: int) -> PastryState:
        p = self.p
        dev = rng.device

        def full(shape, v, dt):
            return torch.full((n,) + shape, v, dtype=dt, device=dev)

        return PastryState(
            state=full((), 0, I32),
            leaf_cw=full((p.half,), NO_NODE, I32),
            leaf_ccw=full((p.half,), NO_NODE, I32),
            rt=full((p.rows, p.cols), NO_NODE, I32),
            rt_rtt=full((p.rows, p.cols), RTT_INF, I32),
            t_join=full((), T_INF, I64), t_ls=full((), T_INF, I64),
            t_gt=full((), T_INF, I64),
            lk=lk_mod.init(self.lcfg, self.key_spec.lanes, n, dev),
            rr=rt_mod.init(self.rcfg, self.key_spec.lanes, 16, n, dev),
            nc=nc_mod.init(n, nc_mod.NcParams(
                capacity=16 if p.adaptive_timeouts else 1), dev),
            app=self.app.init(n, dev),
            app_glob=self.app.glob_init(rng))

    def reset(self, st: PastryState, clear, join, t_now, rng):
        n = st.state.shape[0]
        glob = st.app_glob
        st = dataclasses.replace(st, app_glob=None)
        fresh = dataclasses.replace(self.init(rng, n), app_glob=None)
        st = select_tree(clear, fresh, st)
        st = dataclasses.replace(st, app_glob=glob)
        jitter = (rng_mod.uniform(rng, (n,), F64) * 0.1 * NS).to(I64)
        return dataclasses.replace(
            st, state=torch.where(join, JOINING, st.state),
            t_join=torch.where(join, t_now + jitter, st.t_join))

    def ready_mask(self, st: PastryState):
        return st.state == READY

    def next_event(self, st: PastryState):
        ready = st.state == READY
        t = torch.where(st.state == JOINING, st.t_join, T_INF)
        for timer in (st.t_ls, st.t_gt):
            t = torch.minimum(t, torch.where(ready, timer, T_INF))
        t = torch.minimum(t, torch.where(ready, self.app.next_event(st.app),
                                         T_INF))
        t = torch.minimum(t, lk_mod.next_event(st.lk))
        return torch.minimum(t, rt_mod.next_event(st.rr))

    # -- internals ----------------------------------------------------------

    def _halves(self, ctx, me_key, node_idx, cw_cands, ccw_cands):
        """The L/2 ring-closest of ``cw_cands`` clockwise and of
        ``ccw_cands`` counter-clockwise ([N, C] each), sorted by the
        approximate sort: both halves in one pass (the counter-clockwise
        distance is the clockwise one negated)."""
        spec, h = self.key_spec, self.p.half
        cands = torch.stack([cw_cands, ccw_cands], 1)             # [N, 2, C]
        bad = (cands == NO_NODE) | (cands == node_idx[:, None, None]) \
            | K.dup_mask(cands)
        ck = keys_of(ctx, cands)
        d = K.sub_lanes(K.lanes(ck), K.lanes(me_key[:, None, None]), spec)
        nd = K.sub_lanes([None] * spec.lanes, d, spec)
        ccw = torch.arange(2, device=cands.device)[:, None] == 1
        top = K.fold_words([torch.where(ccw, x, y)
                            for x, y in zip(nd[:2], d[:2])])[0]
        key = torch.where(bad, I64_MAX, top)
        order = torch.sort(key, dim=-1, stable=True).indices[..., :h]
        c_s = torch.where(torch.gather(bad, -1, order), NO_NODE,
                          torch.gather(cands, -1, order))
        return c_s[:, 0], c_s[:, 1]

    def _learn(self, ctx, tab, me_key, node_idx, cands, en, rtt=None):
        """Merge candidates ``cands`` [N, K] where ``en`` into the leaf set
        (PastryLeafSet::mergeNode) and the routing table with proximity
        neighbour selection (a measured closer candidate replaces an
        entry, unmeasured ones only fill empty cells), candidate by
        candidate.  ``tab`` and the result are (leaf_cw, leaf_ccw, rt,
        rt_rtt)."""
        p, spec = self.p, self.key_spec
        leaf_cw, leaf_ccw, rt, rt_rtt = tab
        n = node_idx.shape[0]
        c_all = torch.where(en, cands, NO_NODE)
        leaf_cw, leaf_ccw = self._halves(ctx, me_key, node_idx,
                                         torch.cat([leaf_cw, c_all], 1),
                                         torch.cat([leaf_ccw, c_all], 1))
        c_all = torch.where(c_all != node_idx[:, None], c_all, NO_NODE)
        ck = keys_of(ctx, c_all)
        row = torch.clamp(K.shared_prefix_digits(
            me_key[:, None], ck, p.bits_per_digit, spec), max=p.rows - 1)
        col = K.digit(ck, row, p.bits_per_digit, spec)
        cell = (row.to(I64) * p.cols + col.to(I64))               # [N, K]
        rt_f = rt.reshape(n, -1)
        rtt_f = rt_rtt.reshape(n, -1)
        # the first candidate (the only one that may carry a measured RTT)
        # by the rule itself: it takes an empty cell, replaces a farther
        # entry, or refreshes its own
        c = c_all[:, 0]
        c_rtt = RTT_INF if rtt is None else rtt[:, 0]
        ci = cell[:, :1]
        cur = torch.gather(rt_f, 1, ci)[:, 0]
        cur_rtt = torch.gather(rtt_f, 1, ci)[:, 0]
        same = cur == c
        closer = c_rtt < cur_rtt
        do = (c != NO_NODE) & ((cur == NO_NODE) | closer | same)
        rt_f = rt_f.scatter(1, ci, torch.where(do, c, cur)[:, None])
        rtt_f = rtt_f.scatter(1, ci, torch.where(
            do & ~(same & ~closer), c_rtt, cur_rtt).to(I32)[:, None])
        if cands.shape[1] > 1:
            # the unmeasured rest, one after another in the JAX package:
            # such a candidate changes only an empty cell (an empty cell's
            # RTT is RTT_INF), so the fold is "the first candidate for
            # each cell empty now fills it"
            c, cl = c_all[:, 1:], cell[:, 1:]
            k = c.shape[1]
            valid = c != NO_NODE
            earlier = torch.any(
                (cl[:, :, None] == cl[:, None, :]) & valid[:, None, :]
                & torch.tril(torch.ones((k, k), dtype=torch.bool,
                                        device=c.device), diagonal=-1), -1)
            fill = (valid & ~earlier
                    & (torch.gather(rt_f, 1, cl) == NO_NODE))
            rt_f = put(rt_f, cl, c, fill)
            rtt_f = put(rtt_f, cl, RTT_INF, fill)
        return leaf_cw, leaf_ccw, rt_f.reshape(rt.shape), \
            rtt_f.reshape(rt_rtt.shape)

    @staticmethod
    def _tab(st):
        return (st.leaf_cw, st.leaf_ccw, st.rt, st.rt_rtt)

    def _learn_into(self, ctx, st, me_key, node_idx, cands, en, sel,
                    rtt=None):
        """``_learn`` applied to the nodes where ``sel`` [N]."""
        new = self._learn(ctx, self._tab(st), me_key, node_idx, cands, en,
                          rtt)
        s2 = sel[:, None]
        s3 = sel[:, None, None]
        return dataclasses.replace(
            st, leaf_cw=torch.where(s2, new[0], st.leaf_cw),
            leaf_ccw=torch.where(s2, new[1], st.leaf_ccw),
            rt=torch.where(s3, new[2], st.rt),
            rt_rtt=torch.where(s3, new[3], st.rt_rtt))

    def _leafset_nodes(self, st, node_idx):
        """Own state payload: self + both halves (PastryStateMessage)."""
        return torch.cat([node_idx[:, None], st.leaf_cw, st.leaf_ccw], 1)

    def _find_node(self, ctx, st, me_key, node_idx, keys, rmax,
                   keys_t=None):
        """BasePastry::findNode (BasePastry.cc:1100) for T keys per node
        (``keys`` [N, T, KL]): ([N, T, rmax] result slots, [N, T] is
        sibling, [N, T, rec_redundant] next-hop candidates).  Closeness is
        the bidirectional ring distance (PastryStateObject::keyDist).
        ``keys_t`` is ``ctx.keys`` lane-major ([KL, N]).

        One distance pass over the known nodes (self, the leaves, the
        table) serves every comparison: self's distance, the immediate
        neighbours', the leaves' sort and the fallback's; distances are
        compared as ``K.fold_lanes`` words, whose first word is the
        approximate sort's key."""
        p, spec = self.p, self.key_spec
        n = node_idx.shape[0]
        h = p.half
        ready = (st.state == READY)[:, None]
        me = me_key[:, None]
        leafs = self._leafset_nodes(st, node_idx)                 # [N, 1+L]
        nl = leafs.shape[1]
        known = torch.cat([leafs, st.rt.reshape(n, -1)], 1)      # [N, C]
        # the known nodes' keys lane by lane, each [N, 1, C] contiguous
        # (the [N, T, C] work below is the tick's largest)
        keys_t = ctx.keys.t().contiguous() if keys_t is None else keys_t
        kidx = torch.clamp(known, 0, keys_t.shape[1] - 1).long()
        kk = [lane[kidx][:, None] for lane in keys_t]
        kl = [keys[..., i][..., None] for i in range(spec.lanes)]  # [N,T,1]
        dk = K.fold_words(K.bidir_lanes(kk, kl, spec))            # [N,T,C]
        top = dk[0]
        me_d = [w[..., :1] for w in dk]         # known[0] is the node itself
        near = K.lt_words(dk, me_d)                                # [N,T,C]

        def closer(i):
            return near[..., i]

        big, small = st.leaf_cw[:, 0], st.leaf_ccw[:, 0]
        no_nbrs = ((big == NO_NODE) & (small == NO_NODE))[:, None]
        big_closer = (big != NO_NODE)[:, None] & closer(1)
        small_closer = (small != NO_NODE)[:, None] & closer(1 + h)
        is_sib = ready & (K.eq(keys, me) | no_nbrs
                          | (~big_closer & ~small_closer))

        def farthest(half):
            n_valid = torch.sum(half != NO_NODE, 1)
            far = take(half, torch.clamp(n_valid - 1, min=0))
            return torch.where(n_valid > 0, far, NO_NODE)

        cw_far, ccw_far = farthest(st.leaf_cw), farthest(st.leaf_ccw)
        span_ok = ((cw_far != NO_NODE) & (ccw_far != NO_NODE))[:, None]
        lo = keys_of(ctx, ccw_far)[:, None]
        hi = keys_of(ctx, cw_far)[:, None]
        # key in [lo, hi] on the ring (K.is_between_lr)
        k_lo = K.eq(keys, lo)
        between = torch.where(K.eq(lo, hi), ~k_lo, K.lt(
            K.sub(keys, lo, spec), K.sub(hi, lo, spec)) & ~k_lo)
        in_span = span_ok & (between | k_lo | K.eq(keys, hi))
        lkey = torch.where((leafs == NO_NODE)[:, None], I64_MAX,
                           top[..., :nl])
        lorder = torch.sort(lkey, dim=-1, stable=True).indices
        leafs_s = torch.gather(leafs[:, None].expand(lkey.shape), -1, lorder)
        leaf_dest = leafs_s[..., 0]

        # routing-table hop (PastryRoutingTable::lookupNextHop)
        pfx = K.shared_prefix_digits(me, keys, p.bits_per_digit, spec)
        row = torch.clamp(pfx, max=p.rows - 1)
        col = K.digit(keys, row, p.bits_per_digit, spec)
        rt_hop = take(st.rt.reshape(n, -1),
                      row.to(I64) * p.cols + col.to(I64))        # [N, T]
        rt_ok = rt_hop != NO_NODE

        # the rare-case fallback (BasePastry.cc:1132-1165): a known node
        # with at least our shared prefix, strictly closer by keyDist
        mask = _prefix_mask(pfx * p.bits_per_digit, spec)         # [N,T,KL]
        ok = (known != NO_NODE)[:, None] & near
        for i in range(spec.lanes):
            ok = ok & (((kk[i] ^ kl[i]) & mask[..., i:i + 1]) == 0)
        # a keyDist is at most 2^(bits-1), so its sort key stays far
        # below I64_MAX - 1: the entries that are not ok (UMAX in the JAX
        # sort) rank after every ok one, in index order, and a taken
        # head (I64_MAX) after those
        fkey = torch.where(ok, top, I64_MAX - 1)
        heads = []
        for _ in range(max(p.rec_redundant - 1, 1)):
            j = torch.argmin(fkey, -1)
            heads.append(torch.gather(known[:, None].expand(fkey.shape), -1,
                                      j[..., None])[..., 0])
            fkey = fkey.scatter(-1, j[..., None], I64_MAX)
        fb_s = torch.stack(heads, -1)                             # [N, T, h]
        fallback = torch.where(torch.any(ok, -1), fb_s[..., 0], NO_NODE)

        nid = node_idx[:, None]
        nxt = torch.where(in_span & (leaf_dest != nid), leaf_dest,
                          torch.where(rt_ok, rt_hop, fallback))
        res_sib = rt_mod.fit(leafs_s, rmax)
        res_hop = rt_mod.fit(nxt[..., None], rmax)
        res = torch.where(is_sib[..., None], res_sib, res_hop)
        res = torch.where(ready[..., None], res, NO_NODE)
        cands = torch.cat([torch.where(is_sib, nid, nxt)[..., None],
                           fb_s[..., :max(p.rec_redundant - 1, 0)]], -1)
        cands = torch.where(ready[..., None], cands, NO_NODE)
        return res, is_sib, cands

    def _find_node1(self, ctx, st, me_key, node_idx, key, rmax,
                    keys_t=None):
        res, sib, cands = self._find_node(ctx, st, me_key, node_idx,
                                          key[:, None], rmax, keys_t)
        return res[:, 0], sib[:, 0], cands[:, 0]

    def _handle_failed(self, ctx, st, me_key, node_idx, failed, ob, now):
        """BasePastry::handleFailedNode + Pastry's leaf repair: drop the
        failed nodes ``failed`` [N, F] everywhere; a node that lost a leaf
        asks its farthest remaining clockwise leaf for its state."""
        n = node_idx.shape[0]
        any_failed = torch.any(failed != NO_NODE, 1)

        def hit(x):
            xf = x.reshape(n, -1)
            h = torch.any(xf[:, :, None] == failed[:, None, :], -1)
            return h.reshape(x.shape) & (x != NO_NODE)

        h_cw, h_ccw = hit(st.leaf_cw), hit(st.leaf_ccw)
        lost_leaf = torch.any(h_cw, 1) | torch.any(h_ccw, 1)
        leaf_cw = torch.where(h_cw, NO_NODE, st.leaf_cw)
        leaf_ccw = torch.where(h_ccw, NO_NODE, st.leaf_ccw)
        # re-sort each half so survivors of the other half can slide in
        both = torch.cat([leaf_cw, leaf_ccw], 1)
        cw2, ccw2 = self._halves(ctx, me_key, node_idx,
                                 torch.cat([leaf_cw, both], 1),
                                 torch.cat([leaf_ccw, both], 1))
        af = any_failed[:, None]
        h_rt = hit(st.rt)
        st = dataclasses.replace(
            st, leaf_cw=torch.where(af, cw2, st.leaf_cw),
            leaf_ccw=torch.where(af, ccw2, st.leaf_ccw),
            rt=torch.where(h_rt, NO_NODE, st.rt),
            rt_rtt=torch.where(h_rt, RTT_INF, st.rt_rtt))
        repair = torch.where(st.leaf_cw[:, -1] != NO_NODE, st.leaf_cw[:, -1],
                             st.leaf_cw[:, 0])
        fire = any_failed & lost_leaf & (repair != NO_NODE) & (
            st.state == READY)
        ob.send(fire, now, repair, wire.PASTRY_STATE_CALL, stamp=now,
                size_b=wire.BASE_CALL_B)
        return st

    def _become_ready(self, ctx, st, en, now, rng=None):
        """Enter READY; ``rng`` None leaves the app's ``on_ready`` to the
        caller."""
        app = st.app if rng is None else self.app.on_ready(st.app, en, now,
                                                           rng)
        return dataclasses.replace(
            st, state=torch.where(en, READY, st.state),
            t_join=torch.where(en, T_INF, st.t_join),
            t_ls=torch.where(en, now, st.t_ls),
            t_gt=torch.where(en, now + int(self.p.tuning_interval * NS),
                             st.t_gt), app=app)

    # -- the batched step ---------------------------------------------------

    def step(self, ctx, st, msgs, rng, node_idx, *, outbox_slots, rmax):
        p, lcfg, spec = self.p, self.lcfg, self.key_spec
        n = node_idx.shape[0]
        dev = node_idx.device
        ob = Outbox(n, outbox_slots, spec.lanes, rmax, dev)
        me_key = ctx.keys[node_idx.long()]
        keys_t = ctx.keys.t().contiguous()                        # [KL, N]
        rngs = rng_mod.split(rng, 6)                              # [N, 6, 2]
        t0, t_end = ctx.t_start, ctx.t_end
        f = lcfg.frontier
        nid = node_idx

        def metric_fn(cand, target):
            ck = keys_of(ctx, cand)
            d = K.bidir_ring_distance(ck, target[:, :, None, :], spec)
            return torch.where((cand == NO_NODE)[..., None], UMAX, d)

        ev = app_base.AppEvents(n, dev)
        zeros_n = torch.zeros((n,), dtype=I32, device=dev)
        joins_cnt, anyfail_cnt, lksucc_cnt = zeros_n, zeros_n, zeros_n
        routedrop_cnt = zeros_n
        old_leaf = torch.cat([st.leaf_cw, st.leaf_ccw], 1)   # update() base
        ones1 = torch.ones((n, 1), dtype=torch.bool, device=dev)
        rtt_col = torch.arange(rmax, device=dev)[None, :]
        got_ready = torch.zeros((n,), dtype=torch.bool, device=dev)
        t_ready = torch.zeros((n,), dtype=I64, device=dev)
        rtt_inf = torch.full((n, 1), RTT_INF, dtype=I32, device=dev)
        pend = None           # a slot's response learning, not yet applied

        # ------------------------------------------------------- inbox -----
        if p.adaptive_timeouts:
            # FindNode RTT samples into the estimator before the slot
            # handlers clear the pendings
            en_rtt = msgs.valid & (msgs.kind == wire.FINDNODE_RES)
            rtt_src, rtt_s, rtt_ok = lk_mod.response_rtts(
                st.lk, dataclasses.replace(msgs, valid=en_rtt))
            st = dataclasses.replace(st, nc=nc_mod.feed_response_rtts(
                st.nc, rtt_src, rtt_s, msgs.t_deliver, rtt_ok))
        for r in range(msgs.valid.shape[1]):
            m = msgs.slot(r)
            now = m.t_deliver
            v = m.valid

            # learn every READY message source (passive table fill);
            # joining nodes never enter leaf sets.  The previous slot's
            # response learning goes first in the same pass (nothing
            # between the two reads the tables)
            src_ready = ctx.ready[torch.clamp(
                m.src, 0, ctx.ready.shape[0] - 1).long()]
            src_sel = v & src_ready
            if pend is None:
                st = self._learn_into(ctx, st, me_key, nid, m.src[:, None],
                                      ones1, src_sel)
            else:
                p_c, p_sel, p_rtt = pend
                c = torch.cat([torch.where(p_sel[:, None], p_c, NO_NODE),
                               torch.where(src_sel, m.src, NO_NODE)[:, None]],
                              1)
                st = self._learn_into(ctx, st, me_key, nid, c, c != NO_NODE,
                                      p_sel | src_sel,
                                      rtt=torch.cat([p_rtt, rtt_inf], 1))

            # this slot's findNode: the FindNode server, the route
            # pre-pass and the app's sibling check share it
            res, sib, cands = self._find_node1(ctx, st, me_key, nid, m.key,
                                               rmax, keys_t)

            st = dataclasses.replace(st, rr=rt_mod.on_ack(
                st.rr, dataclasses.replace(
                    m, valid=v & (m.kind == wire.KBR_ROUTE_ACK))))

            # recursive route hop: ACK the last hop, then decapsulate
            # (responsible) or forward to the first candidate surviving
            # loop detection; visited hops ride m.nodes
            en_rt = v & (m.kind == wire.KBR_ROUTE) & (st.state == READY)
            ob.send(en_rt & (m.nonce > 0), now, m.src, wire.KBR_ROUTE_ACK,
                    nonce=m.nonce, size_b=wire.BASE_CALL_B)
            deliver = en_rt & sib
            nxt_rt, found_rt = rt_mod.pick_next_hop(
                cands, m.nodes, m.src, m.nodes[:, 0], nid, sib)
            fwd = en_rt & ~sib & found_rt & (m.hops < self.rcfg.hop_max)
            if hasattr(self.app, "forward"):
                # Common API forward() veto (BaseApp.h:214)
                fwd = fwd & ~self.app.forward(st.app, m, ctx)
            vis_n = torch.sum(m.nodes != NO_NODE, 1)
            at_v = fwd[:, None] & (rtt_col == torch.clamp(
                vis_n, max=rmax - 1)[:, None])
            visited2 = torch.where(at_v, nid[:, None].to(I32), m.nodes)
            st = dataclasses.replace(st, rr=rt_mod.forward(
                st.rr, ob, fwd, now, nxt_rt, key=m.key, inner=m.d, a=m.a,
                b=m.b, c=m.c, hops=m.hops + 1, stamp=m.stamp,
                size_b=m.size_b - self.rcfg.overhead_b, visited=visited2,
                cfg=self.rcfg))
            routedrop_cnt = routedrop_cnt + (en_rt & ~sib & ~fwd).to(I32)
            m = dataclasses.replace(
                m, kind=torch.where(deliver, m.d, m.kind),
                src=torch.where(deliver, m.nodes[:, 0], m.src),
                valid=v & (~en_rt | deliver))
            v = m.valid

            # FindNodeCall
            en = v & (m.kind == wire.FINDNODE_CALL)
            n_res = torch.sum(res != NO_NODE, 1, dtype=I32)
            ob.send(en, now, m.src, wire.FINDNODE_RES, key=m.key, a=m.a,
                    b=m.b, c=sib.to(I32), nodes=res,
                    size_b=wire.BASE_CALL_B + 1 + wire.NODEHANDLE_B * n_res)

            # FindNodeResponse → the lookup engine
            en_fr = v & (m.kind == wire.FINDNODE_RES)
            st = dataclasses.replace(st, lk=lk_mod.on_response(
                st.lk, dataclasses.replace(m, valid=en_fr), metric_fn, lcfg))

            # state exchange (leaf-set push-pull; PastryStateMessage)
            en = v & (m.kind == wire.PASTRY_STATE_CALL) & (
                st.state == READY)
            ob.send(en, now, m.src, wire.PASTRY_STATE_RES,
                    nodes=rt_mod.fit(self._leafset_nodes(st, nid), rmax),
                    stamp=m.stamp, size_b=wire.BASE_CALL_B
                    + wire.NODEHANDLE_B * (p.num_leaves + 1))
            en_sr = v & (m.kind == wire.PASTRY_STATE_RES)
            # one learning pass for both responses: the FindNode one's
            # first F nodes unmeasured, the state one's nodes with the
            # responder's RTT first
            rtt_ms = torch.clamp(torch.div(now - m.stamp, 1_000_000,
                                           rounding_mode="floor"),
                                 0, RTT_INF - 1).to(I32)
            rtt0 = torch.where(en_sr & (m.stamp > 0), rtt_ms, RTT_INF)
            rtt_vec = torch.where(rtt_col == 0, rtt0[:, None], RTT_INF)
            learned = torch.where(en_fr[:, None],
                                  rt_mod.fit(m.nodes[:, :f], rmax),
                                  m.nodes[:, :rmax])
            pend = (learned, en_fr | en_sr, rtt_vec)
            # a joining node's first state response completes its join
            # (the app's on_ready after the loop: see the module doc)
            got_state = en_sr & (st.state == JOINING)
            joins_cnt = joins_cnt + got_state.to(I32)
            st = self._become_ready(ctx, st, got_state, now)
            got_ready = got_ready | got_state
            t_ready = torch.where(got_state, now, t_ready)

            # app-owned kinds (this slot's sibling flag)
            st = dataclasses.replace(st, app=app_base.on_msg_one(
                self.app, st.app, m, ctx, ob, ev, sib))

            ob.send(v & (m.kind == wire.PING_CALL), now, m.src,
                    wire.PING_RES, a=m.a, size_b=wire.BASE_CALL_B)
        if pend is not None:
            p_c, p_sel, p_rtt = pend
            st = self._learn_into(ctx, st, me_key, nid, p_c, p_c != NO_NODE,
                                  p_sel, rtt=p_rtt)
        st = dataclasses.replace(st, app=self.app.on_ready(
            st.app, got_ready, t_ready, rngs[:, 0]))

        # ------------------------------------------------------- timers ----
        # join: lookup of the own key, then a state request
        en_j = (st.state == JOINING) & (st.t_join < t_end)
        now_j = torch.maximum(st.t_join, t0)
        boot = ctx.sample_ready(rngs[:, 1], nid)
        no_join_lk = ~torch.any(st.lk.active & (st.lk.purpose == P_JOIN), 1)
        alone_start = en_j & (boot == NO_NODE)
        st = self._become_ready(ctx, st, alone_start, now_j, rngs[:, 2])
        joins_cnt = joins_cnt + alone_start.to(I32)
        slot, have = lk_mod.free_slot(st.lk)
        start_join = en_j & (boot != NO_NODE) & no_join_lk & have
        st = dataclasses.replace(st, lk=lk_mod.start(
            st.lk, start_join, slot, P_JOIN, 0, me_key,
            rt_mod.fit(boot[:, None], f), now_j, lcfg))
        st = dataclasses.replace(st, t_join=torch.where(
            en_j & ~alone_start, now_j + int(p.join_delay * NS), st.t_join))

        # leaf-set maintenance: push-pull with a random leaf
        en_l = (st.state == READY) & (st.t_ls < t_end)
        now_l = torch.maximum(st.t_ls, t0)
        leafs = torch.cat([st.leaf_cw, st.leaf_ccw], 1)
        n_leafs = torch.sum(leafs != NO_NODE, 1, dtype=I32)
        pick = rng_mod.randint(rngs[:, 3], (), 0,
                               torch.clamp(n_leafs, min=1), dtype=I32)
        order = torch.sort((leafs == NO_NODE).to(I32), dim=1,
                           stable=True).indices
        tgt = take(leafs, take(order, torch.clamp(pick, max=leafs.shape[1]
                                                  - 1)))
        ob.send(en_l & (tgt != NO_NODE), now_l, tgt, wire.PASTRY_STATE_CALL,
                stamp=now_l, size_b=wire.BASE_CALL_B)
        st = dataclasses.replace(st, t_ls=torch.where(
            en_l, now_l + int(p.leafset_interval * NS), st.t_ls))

        # global tuning: a random-key lookup fills routing rows
        en_g = (st.state == READY) & (st.t_gt < t_end)
        now_g = torch.maximum(st.t_gt, t0)
        no_tune = ~torch.any(st.lk.active & (st.lk.purpose == P_TUNE), 1)
        target = K.random_keys(rngs[:, 4], (), spec)
        seed_g, sib_g, _ = self._find_node1(ctx, st, me_key, nid, target,
                                            rmax, keys_t)
        slot, have = lk_mod.free_slot(st.lk)
        start_g = en_g & no_tune & have & ~sib_g & (seed_g[:, 0] != NO_NODE)
        st = dataclasses.replace(
            st, lk=lk_mod.start(st.lk, start_g, slot, P_TUNE, 0, target,
                                seed_g[:, :f], now_g, lcfg),
            t_gt=torch.where(en_g, now_g + int(p.tuning_interval * NS),
                             st.t_gt))

        # app timer (graceful leave hands over to the clockwise leaf)
        st = dataclasses.replace(st, app=app_base.leave_protocol(
            self.app, st.app, ctx, ob, ev, t0, nid, st.leaf_cw[:, 0],
            st.state == READY))
        t_app = self.app.next_event(st.app)
        en_a = (st.state == READY) & (t_app < t_end)
        now_a = torch.maximum(t_app, t0)
        app, req = self.app.on_timer(st.app, en_a, ctx, now_a, rngs[:, 5],
                                     ev, nid)
        st = dataclasses.replace(st, app=app)
        seed_a, sib_a, cands_a = self._find_node1(ctx, st, me_key, nid,
                                                  req.key, rmax, keys_t)
        local = req.want & sib_a
        st = dataclasses.replace(st, app=self.app.on_lookup_done(
            st.app, app_base.LookupDone(
                en=local, success=local, tag=req.tag, target=req.key,
                results=torch.where(local[:, None], seed_a[:, :f], NO_NODE),
                hops=zeros_n, t0=now_a),
            ctx, ob, ev, now_a, nid))
        # only the payloads the app declares routable take the recursive
        # path; DHT lookups and the lookup test need a sibling set and
        # go through the iterative engine, as in the reference
        fire0 = torch.zeros_like(req.want)
        routable = torch.zeros_like(req.want)
        if (p.routing_mode == "semi-recursive"
                and hasattr(self.app, "route_policy")):
            routable, inner_a, is_rpc = self.app.route_policy(req.tag)
            vis0 = rt_mod.fit(nid[:, None].to(I32), rmax)
            nxt0, found0 = rt_mod.pick_next_hop(
                cands_a, torch.full((n, rmax), NO_NODE, dtype=I32,
                                    device=dev),
                torch.full_like(nid, NO_NODE), nid, nid, sib_a)
            fire0 = req.want & ~sib_a & routable & found0
            st = dataclasses.replace(st, rr=rt_mod.forward(
                st.rr, ob, fire0, now_a, nxt0, key=req.key, inner=inner_a,
                a=req.tag, b=zeros_n, c=torch.broadcast_to(
                    ctx.measuring.to(I32), (n,)), hops=zeros_n + 1,
                stamp=now_a, size_b=zeros_n + 100, visited=vis0,
                cfg=self.rcfg))
            if hasattr(self.app, "on_route_fired"):
                st = dataclasses.replace(st, app=self.app.on_route_fired(
                    st.app, fire0 & is_rpc, now_a, req.tag))
            routedrop_cnt = routedrop_cnt + (
                req.want & ~sib_a & routable & ~found0).to(I32)
        slot, have = lk_mod.free_slot(st.lk)
        start_app = (req.want & ~sib_a & ~routable & have
                     & (seed_a[:, 0] != NO_NODE))
        # a routable request with no next hop fails its operation too
        insta_fail = req.want & ~sib_a & ~start_app & ~fire0
        st = dataclasses.replace(st, app=self.app.on_lookup_done(
            st.app, app_base.LookupDone(
                en=insta_fail, success=torch.zeros_like(insta_fail),
                tag=req.tag, target=req.key,
                results=torch.full((n, f), NO_NODE, dtype=I32, device=dev),
                hops=zeros_n, t0=now_a),
            ctx, ob, ev, now_a, nid))
        st = dataclasses.replace(st, lk=lk_mod.start(
            st.lk, start_app, slot, P_APP, req.tag, req.key, seed_a[:, :f],
            now_a, lcfg))

        # ------------------------------------------------ lookup timeouts --
        new_lk, failed_nodes, _ = lk_mod.on_timeouts(st.lk, t_end, t0, lcfg)
        st = dataclasses.replace(st, lk=new_lk)
        # route-hop ACK timeouts: unresponsive next hops failed too
        new_rr, rt_failed, rt_retry = rt_mod.on_timeouts(st.rr, t_end,
                                                         self.rcfg)
        st = dataclasses.replace(st, rr=new_rr)
        st = self._handle_failed(ctx, st, me_key, nid,
                                 torch.cat([failed_nodes, rt_failed], 1),
                                 ob, t0)

        # reroute the parked messages around their failed hops (they are
        # out of the tables now); a node that became responsible
        # self-forwards and delivers next tick.  The per-slot reforwards
        # of the JAX package are one send of the Q slots in slot order.
        _, sib_q, cands_q = self._find_node(ctx, st, me_key, nid,
                                            st.rr.key, rmax, keys_t)
        nxt_q, found_q = rt_mod.pick_next_hop(
            cands_q, st.rr.visited, torch.full_like(rt_retry, NO_NODE,
                                                    dtype=I32),
            st.rr.visited[..., 0], nid[:, None], sib_q)
        st = dataclasses.replace(st, rr=rt_mod.reforward_batch(
            st.rr, ob, rt_retry & found_q, t0, nxt_q, self.rcfg))
        give_up = rt_retry & ~found_q
        st = dataclasses.replace(st, rr=rt_mod.drop_slots(st.rr, give_up))
        routedrop_cnt = routedrop_cnt + torch.sum(give_up, 1, dtype=I32)

        # ------------------------------------------------- completions -----
        new_lk, comp = lk_mod.take_completions(st.lk, t_end)
        st = dataclasses.replace(st, lk=new_lk)
        comp_hops_ev = (comp["hops"].to(torch.float32),
                        comp["taken"] & comp["success"])
        for li in range(lcfg.slots):
            en = comp["taken"][:, li]
            res_l = comp["result"][:, li]
            suc = comp["success"][:, li] & (res_l != NO_NODE)
            pur = comp["purpose"][:, li]
            lksucc_cnt = lksucc_cnt + (en & suc).to(I32)
            anyfail_cnt = anyfail_cnt + (en & ~suc).to(I32)
            # join lookup done → state request to the responsible node;
            # failed → retry after the join delay
            enj = en & (pur == P_JOIN)
            ob.send(enj & suc, t0, res_l, wire.PASTRY_STATE_CALL, stamp=t0,
                    size_b=wire.BASE_CALL_B)
            st = dataclasses.replace(st, t_join=torch.where(
                enj & ~suc, t0 + int(p.join_delay * NS), st.t_join))
            ena = en & (pur == P_APP)
            st = dataclasses.replace(st, app=self.app.on_lookup_done(
                st.app, app_base.LookupDone(
                    en=ena, success=ena & suc, tag=comp["aux"][:, li],
                    target=comp["target"][:, li],
                    results=comp["results"][:, li],
                    hops=comp["hops"][:, li], t0=comp["t0"][:, li]),
                ctx, ob, ev, t0, nid))

        # ------------------------------------------------------- pump ------
        timeout_fn = (nc_mod.adaptive_timeout_fn(st.nc, lcfg.rpc_timeout_ns)
                      if p.adaptive_timeouts else None)
        st = dataclasses.replace(st, lk=lk_mod.pump(
            st.lk, ob, ctx, nid, t0, lcfg, timeout_fn=timeout_fn))

        # Common API update(): nodes that entered the leaf set (Pastry's
        # replica set) trigger the app's re-replication
        if hasattr(self.app, "on_update"):
            new_leaf = torch.cat([st.leaf_cw, st.leaf_ccw], 1)
            new_in = torch.where(
                (new_leaf != NO_NODE) & ~torch.any(
                    new_leaf[:, :, None] == old_leaf[:, None, :], -1),
                new_leaf, NO_NODE)
            st = dataclasses.replace(st, app=self.app.on_update(
                st.app, st.state == READY, ctx, ob, ev, t0, nid, new_in,
                sib_keys=keys_of(ctx, new_leaf),
                sib_valid=new_leaf != NO_NODE))

        events = {"c:pastry_joins": joins_cnt,
                  "c:lookup_success": lksucc_cnt,
                  "c:lookup_failed": anyfail_cnt,
                  "c:route_dropped": routedrop_cnt,
                  "s:lookup_hops": comp_hops_ev}
        ev.finish(events, self.app.hist_map)
        return st, ob, events


def bamboo_params() -> PastryParams:
    """Bamboo's defaults (default.ini:251-267): a leaf set of 8."""
    return PastryParams(num_leaves=8)


class BambooLogic(PastryLogic):
    """Bamboo: Pastry with periodic push-pull maintenance, which is this
    implementation's own style, and Bamboo's smaller leaf set."""

    def __init__(self, spec: K.KeySpec = K.DEFAULT_SPEC,
                 params: PastryParams | None = None,
                 lcfg: lk_mod.LookupConfig | None = None, app=None):
        super().__init__(spec, params or bamboo_params(), lcfg, app)
