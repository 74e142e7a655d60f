"""Kademlia XOR-metric DHT as batched per-node logic (PyTorch).

Counterpart of ``oversim_tpu/overlay/kademlia.py`` (reference
Kademlia.{h,cc}, default configuration: k=8, s=8, b=1, maxStaleCount=0,
lookupMerge, iterative routing).  State is structure of arrays over the
node axis: the sibling table ``[N, S]`` sorted by XOR distance from the
own key, k-buckets ``[N, B, K]`` with last-seen times and stale counts,
bounded maintenance-ping slots, the iterative lookup engine
(common/lookup.py) and the tier app (apps/kbrtest.py or apps/dht.py, fed
by the Common API update() hook and the per-slot completion fold).

The JAX package writes ``step`` for one node and vmaps it; here it is
written out over the leading ``[N]`` axis, operation for operation, so
the two packages stay leaf-exact.  Ported: the default configuration
(routingAdd with sibling merge and the batched bucket pass, findNode and
isSiblingFor, join, bucket and sibling refresh, failure handling,
maintenance-ping bookkeeping).  Still to be ported, and refused in
``__init__``: the replacement cache and its pings, bucket pings,
downlists, adaptive timeouts, R/Kademlia recursive routing and the
malicious-node attacks.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch import stats as stats_mod
from oversim_tpu_torch.apps import base as app_base
from oversim_tpu_torch.apps.kbrtest import KbrTestApp
from oversim_tpu_torch.common import lookup as lk_mod
from oversim_tpu_torch.common import malicious as mal_mod
from oversim_tpu_torch.common import neighborcache as nc_mod
from oversim_tpu_torch.common import route as rt_mod
from oversim_tpu_torch.common import wire
from oversim_tpu_torch.core import keys as K
from oversim_tpu_torch.engine.logic import (Outbox, put, put2, select_tree,
                                            take)

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1
UMAX = K.UMAX

DEAD, JOINING, READY = 0, 1, 2
P_JOIN, P_REFRESH, P_APP, P_SIB = 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class KademliaParams:
    """default.ini:185-200 + Kademlia.ned (JAX field names and defaults)."""

    k: int = 8
    s: int = 8
    num_buckets: int = 32
    max_stale: int = 0
    join_delay: float = 10.0
    sibling_refresh: float = 1000.0
    bucket_refresh: float = 1000.0
    redundant_nodes: int = 8
    rpc_timeout: float = 1.5
    replacement_cands: int = 0
    replacement_cache_ping: bool = False
    bucket_ping_interval: float = 0.0
    enable_downlists: bool = False
    ping_slots: int = 4
    adaptive_timeouts: bool = False


@dataclasses.dataclass
class KademliaState:
    state: torch.Tensor          # [N] i32
    sib: torch.Tensor            # [N, S] i32
    buckets: torch.Tensor        # [N, B, K] i32
    b_seen: torch.Tensor         # [N, B, K] i64
    b_stale: torch.Tensor        # [N, B, K] i32
    b_used: torch.Tensor         # [N, B] i64
    refresh_dirty: torch.Tensor  # [N, B] bool
    t_join: torch.Tensor         # [N] i64
    t_refresh: torch.Tensor      # [N] i64
    sib_used: torch.Tensor       # [N] i64
    rc_nodes: torch.Tensor       # [N, B, RC] i32
    rc_pos: torch.Tensor         # [N, B] i32
    ping_dst: torch.Tensor       # [N, Pp] i32
    ping_to: torch.Tensor        # [N, Pp] i64
    t_bping: torch.Tensor        # [N] i64
    rr: object
    nc: object
    lk: lk_mod.LookupState
    app: object
    app_glob: object


def _ns(seconds: float) -> int:
    return int(seconds * NS)


class KademliaLogic:
    """Engine logic interface (see engine/logic.py)."""

    def __init__(self, spec: K.KeySpec = K.DEFAULT_SPEC,
                 params: KademliaParams = KademliaParams(),
                 lcfg: lk_mod.LookupConfig | None = None,
                 app=None,
                 mparams: mal_mod.MaliciousParams = mal_mod.MaliciousParams(),
                 rcfg: rt_mod.RouteConfig | None = None):
        p = params
        if (p.replacement_cands or p.replacement_cache_ping
                or p.bucket_ping_interval > 0 or p.enable_downlists
                or p.adaptive_timeouts or mparams.active
                or rcfg is not None):
            raise NotImplementedError(
                "Kademlia options beyond the default configuration "
                "(replacement cache, bucket pings, downlists, adaptive "
                "timeouts, malicious nodes, R/Kademlia) are not ported yet "
                "(ROADMAP Queue A)")
        self.key_spec = spec
        self.p = params
        self.lcfg = lcfg or lk_mod.LookupConfig(merge=True)
        self.lcfg.check_ported()
        self.app = app or KbrTestApp()
        self.mp = mparams
        self.rcfg = rcfg
        self._pow2 = {}

    def pow2(self, device):
        key = str(device)
        if key not in self._pow2:
            self._pow2[key] = K.pow2_table(self.key_spec, device)
        return self._pow2[key]

    # -- engine interface ---------------------------------------------------

    def split(self, st: KademliaState):
        return dataclasses.replace(st, app_glob=None), st.app_glob

    def merge(self, node_part: KademliaState, glob):
        return dataclasses.replace(node_part, app_glob=glob)

    def post_step(self, ctx, st: KademliaState, events):
        app, glob = self.app.post_step(ctx, st.app, st.app_glob, events)
        return dataclasses.replace(st, app=app, app_glob=glob)

    def stat_spec(self) -> stats_mod.StatSpec:
        app = self.app.stat_spec()
        return stats_mod.StatSpec(
            scalars=tuple(app["scalars"]) + ("lookup_hops",),
            hists=tuple(app["hists"]),
            counters=tuple(app["counters"]) + (
                "kad_joins", "lookup_success", "lookup_failed",
                "route_dropped"))

    def init(self, rng, n: int) -> KademliaState:
        p = self.p
        dev = rng.device

        def full(shape, v, dt):
            return torch.full((n,) + shape, v, dtype=dt, device=dev)

        b, kk = p.num_buckets, p.k
        return KademliaState(
            state=full((), 0, I32), sib=full((p.s,), NO_NODE, I32),
            buckets=full((b, kk), NO_NODE, I32),
            b_seen=full((b, kk), 0, I64), b_stale=full((b, kk), 0, I32),
            b_used=full((b,), 0, I64),
            refresh_dirty=full((b,), False, torch.bool),
            t_join=full((), T_INF, I64), t_refresh=full((), T_INF, I64),
            sib_used=full((), 0, I64),
            rc_nodes=full((b, p.replacement_cands), NO_NODE, I32),
            rc_pos=full((b,), 0, I32),
            ping_dst=full((p.ping_slots,), NO_NODE, I32),
            ping_to=full((p.ping_slots,), T_INF, I64),
            t_bping=full((), T_INF, I64),
            rr=rt_mod.init(self.rcfg or rt_mod.RouteConfig(),
                           self.key_spec.lanes, 16, n, dev),
            nc=nc_mod.init(n, nc_mod.NcParams(
                capacity=16 if p.adaptive_timeouts else 1), dev),
            lk=lk_mod.init(self.lcfg, self.key_spec.lanes, n, dev),
            app=self.app.init(n, dev),
            app_glob=self.app.glob_init(rng))

    def reset(self, st: KademliaState, clear, join, t_now, rng):
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

    def ready_mask(self, st: KademliaState):
        return st.state == READY

    def next_event(self, st: KademliaState):
        joining = st.state == JOINING
        ready = st.state == READY
        t = torch.where(joining, st.t_join, T_INF)
        t = torch.minimum(t, torch.where(ready, st.t_refresh, T_INF))
        t = torch.minimum(t, torch.where(ready, self.app.next_event(st.app),
                                         T_INF))
        t = torch.minimum(t, lk_mod.next_event(st.lk))
        return torch.minimum(t, torch.min(st.ping_to, 1).values)

    # -- key-space helpers --------------------------------------------------

    def _xor_to(self, ctx, slots, key):
        """slots [N, ...] → [N, ..., KL] XOR distance of the slot keys to
        ``key`` (broadcastable to [N, ..., KL]); NO_NODE → max distance."""
        ck = ctx.keys[torch.clamp(slots, min=0).long()]
        return torch.where((slots == NO_NODE)[..., None], UMAX, ck ^ key)

    def _bucket_index(self, me_key, other_key):
        pl = K.shared_prefix_length(me_key, other_key, self.key_spec)
        return torch.clamp(pl, 0, self.p.num_buckets - 1)

    def _sib_merge(self, ctx, me_key, node_idx, sib, cands, cand_ok):
        s = self.p.s
        c = torch.cat([sib, torch.where(cand_ok, cands, NO_NODE)], 1)
        bad = (c == NO_NODE) | (c == node_idx[:, None]) | K.dup_mask(c)
        c = torch.where(bad, NO_NODE, c)
        d = self._xor_to(ctx, c, me_key[:, None, :])
        (c_s,) = K.sort_by_distance(d, (c,), approx=True)[1]
        new_sib = c_s[:, :s]
        still = torch.any(sib[:, :, None] == new_sib[:, None, :], -1)
        disp = torch.where((sib != NO_NODE) & ~still, sib, NO_NODE)
        return new_sib, disp

    def _bucket_update_batch(self, ctx, st, me_key, cands, alive, now):
        """Batched bucket half of routingAdd for every candidate at once
        (``cands`` deduplicated, NO_NODE = disabled)."""
        p = self.p
        num_b, kk = p.num_buckets, p.k
        n, c_dim = cands.shape
        dev = cands.device
        en = cands != NO_NODE
        ck = ctx.keys[torch.clamp(cands, min=0).long()]
        bi = torch.where(en, self._bucket_index(me_key[:, None, :], ck),
                         num_b)

        acand = torch.where(en & alive, cands, NO_NODE)
        hit = torch.any(st.buckets[..., None] == acand[:, None, None, :],
                        -1) & (st.buckets != NO_NODE)
        b_seen = torch.where(hit, now[:, None, None], st.b_seen)
        b_stale = torch.where(hit, 0, st.b_stale)
        buckets = st.buckets

        row_c = take(buckets, torch.clamp(bi, max=num_b - 1))     # [N, C, K]
        present = torch.any(row_c == cands[..., None], -1)
        need = en & ~present
        k1 = torch.where(need, bi, num_b).to(I64)
        k2 = (~alive).to(I64)
        order_c = torch.sort(k1 * 2 + k2, dim=1, stable=True).indices
        b_s = torch.gather(k1, 1, order_c)
        a_s = torch.gather(k2, 1, order_c)
        k3 = torch.arange(c_dim, device=dev).expand(n, c_dim)
        rank = k3 - torch.searchsorted(b_s.contiguous(), b_s.contiguous(),
                                       side="left")
        free = buckets == NO_NODE
        evictable = ~free & (b_stale > p.max_stale)
        cls = torch.where(free, 0, torch.where(evictable, 1, 2))
        colkey = cls * (1 << 20) - torch.where(
            evictable, torch.clamp(b_stale, max=(1 << 19) - 1), 0)
        order = torch.sort(colkey, dim=-1, stable=True).indices  # [N, B, K]
        free_cnt = torch.sum(free, -1, dtype=I32)
        avail_cnt = free_cnt + torch.sum(evictable, -1, dtype=I32)

        bi_c = torch.clamp(b_s, max=num_b - 1)
        limit = torch.where(a_s == 0, take(avail_cnt, bi_c),
                            take(free_cnt, bi_c))
        okc = (b_s < num_b) & (rank < limit) & (rank < kk)
        col = take(order.reshape(n, num_b * kk),
                   bi_c * kk + torch.clamp(rank, 0, kk - 1))
        vals = torch.gather(cands, 1, order_c)
        al_v = a_s == 0
        st = dataclasses.replace(
            st,
            buckets=put2(buckets, bi_c, col, vals, okc),
            b_seen=put2(b_seen, bi_c, col,
                        torch.where(al_v, now[:, None], 0), okc),
            b_stale=put2(b_stale, bi_c, col, 0, okc))
        return st, torch.full((n,), NO_NODE, dtype=I32, device=dev)

    def _routing_add_batch(self, ctx, st, me_key, node_idx, cands, alive,
                           now):
        en = (cands != NO_NODE) & (cands != node_idx[:, None])
        cands = torch.where(en, cands, NO_NODE)
        eq = cands[:, :, None] == cands[:, None, :]
        alive = torch.any(eq & (alive & en)[:, None, :], -1) & en
        en = en & ~K.dup_mask(cands)
        cands = torch.where(en, cands, NO_NODE)

        new_sib, disp_vec = self._sib_merge(ctx, me_key, node_idx, st.sib,
                                            cands, en)
        st = dataclasses.replace(st, sib=new_sib)
        became_sib = torch.any(cands[:, :, None] == new_sib[:, None, :],
                               -1) & en
        in_disp = torch.any(cands[:, :, None] == disp_vec[:, None, :],
                            -1) & en
        disp_vec = torch.where(torch.any(
            disp_vec[:, :, None] == torch.where(en, cands, NO_NODE)[:, None],
            -1), NO_NODE, disp_vec)
        bc = torch.cat([disp_vec, torch.where(became_sib, NO_NODE, cands)],
                       1)
        ba = torch.cat([torch.ones_like(disp_vec, dtype=torch.bool),
                        alive | in_disp], 1)
        return self._bucket_update_batch(ctx, st, me_key, bc, ba, now)

    def _find_node_batch(self, ctx, st, me_key, node_idx, keys, rmax):
        """Batched findNode + isSiblingFor for T target keys per node:
        ``keys`` [N, T, KL] → ([N, T, rmax] slots, [N, T] is_sibling)."""
        p = self.p
        n, t_dim = keys.shape[0], keys.shape[1]
        flat = st.buckets.reshape(n, -1)
        in_sib = torch.any(flat[:, :, None] == st.sib[:, None, :], -1)
        flat = torch.where(in_sib, NO_NODE, flat)
        cands = torch.cat([node_idx[:, None], st.sib, flat], 1)    # [N, C]
        # the approximate sort reads only the top two distance lanes
        ck = ctx.keys[torch.clamp(cands, min=0).long()][..., :2]
        d = ck[:, None] ^ keys[:, :, None, :2]                    # [N,T,C,2]
        d = torch.where((cands == NO_NODE)[:, None, :, None], UMAX, d)
        (c_s,) = K.sort_by_distance(
            d, (cands[:, None, :].expand(n, t_dim, cands.shape[1]),),
            approx=True)[1]
        ready = st.state == READY
        out = torch.where(ready[:, None, None], c_s[..., :rmax], NO_NODE)
        if p.redundant_nodes < rmax:
            out = torch.cat([out[..., :p.redundant_nodes], torch.full(
                out.shape[:-1] + (rmax - p.redundant_nodes,), NO_NODE,
                dtype=out.dtype, device=out.device)], -1)

        n_sib = torch.sum(st.sib != NO_NODE, 1)
        full = n_sib >= p.s
        d_me = me_key[:, None, :] ^ keys                           # [N,T,KL]
        d_far = self._xor_to(ctx, st.sib[:, -1:], me_key[:, None, :])
        not_ours = full[:, None] & K.gt(d_me, d_far.expand_as(d_me))
        sk = ctx.keys[torch.clamp(st.sib, min=0).long()]           # [N,S,KL]
        d_sib_key = sk[:, None] ^ keys[:, :, None, :]              # [N,T,S,KL]
        d_sib_key = torch.where((st.sib == NO_NODE)[:, None, :, None], UMAX,
                                d_sib_key)
        closer_sib = torch.any(K.lt(d_sib_key, d_me[:, :, None, :].expand_as(
            d_sib_key)), -1)
        r1 = ready[:, None]
        is_sib = (r1 & (n_sib < 1)[:, None]) | (r1 & ~not_ours & ~closer_sib)
        return out, is_sib

    def _handle_failed(self, ctx, st, me_key, node_idx, failed):
        """handleFailedNode for the tick's failure list ``failed`` [N, F]."""
        en = torch.any(failed != NO_NODE, 1)
        hit = torch.any(st.sib[:, :, None] == failed[:, None, :], -1) & (
            st.sib != NO_NODE)
        sib_masked = torch.where(hit, NO_NODE, st.sib)
        d = self._xor_to(ctx, sib_masked, me_key[:, None, :])
        (sib_s,) = K.sort_by_distance(d, (sib_masked,), approx=True)[1]
        st = dataclasses.replace(st, sib=torch.where(en[:, None], sib_s,
                                                     st.sib))
        strikes = torch.sum(st.buckets[..., None] == failed[:, None, None, :],
                            -1, dtype=I32)
        strikes = torch.where(st.buckets != NO_NODE, strikes, 0)
        stale = st.b_stale + strikes
        evict = (strikes > 0) & (stale > self.p.max_stale)
        return dataclasses.replace(
            st, buckets=torch.where(evict, NO_NODE, st.buckets),
            b_stale=torch.where(evict, 0, stale),
            b_seen=torch.where(evict, 0, st.b_seen))

    def _become_ready(self, ctx, st, en, now, rng):
        p = self.p
        return dataclasses.replace(
            st,
            state=torch.where(en, READY, st.state),
            t_join=torch.where(en, T_INF, st.t_join),
            t_refresh=torch.where(en, now, st.t_refresh),
            sib_used=torch.where(en, now - _ns(p.sibling_refresh) - 1,
                                 st.sib_used),
            app=self.app.on_ready(st.app, en, now, rng))

    # -- the batched step ---------------------------------------------------

    def step(self, ctx, st, msgs, rng, node_idx, *, outbox_slots, rmax):
        p, lcfg, spec = self.p, self.lcfg, self.key_spec
        n = node_idx.shape[0]
        dev = node_idx.device
        ob = Outbox(n, outbox_slots, spec.lanes, rmax, dev)
        me_key = ctx.keys[node_idx.long()]
        rngs = rng_mod.split(rng, 8)                              # [N, 8, 2]
        t0, t_end = ctx.t_start, ctx.t_end
        r_in = msgs.valid.shape[1]
        f = lcfg.frontier

        def metric_fn(cand, target):
            return self._xor_to(ctx, cand, target[:, :, None, :])

        ev = app_base.AppEvents(n, dev)
        zeros_n = torch.zeros((n,), dtype=I32, device=dev)
        joins_cnt, anyfail_cnt, lksucc_cnt = zeros_n, zeros_n, zeros_n
        v_r, t_del_r = msgs.valid, msgs.t_deliver
        old_sib = st.sib                     # update() delta base

        # FindNodeResponses → lookup engine
        en_res = v_r & (msgs.kind == wire.FINDNODE_RES)
        st = dataclasses.replace(st, lk=lk_mod.on_responses(
            st.lk, dataclasses.replace(msgs, valid=en_res), metric_fn, lcfg))

        # batched routingAdd: sources verified, response payloads learned
        learned = torch.where(en_res[..., None], msgs.nodes[:, :, :f],
                              NO_NODE)
        add_cands = torch.cat([torch.where(v_r, msgs.src, NO_NODE),
                               learned.reshape(n, -1)], 1)
        add_alive = torch.cat([
            torch.ones((n, r_in), dtype=torch.bool, device=dev),
            torch.zeros((n, learned.shape[1] * f), dtype=torch.bool,
                        device=dev)], 1)
        now_add = torch.max(torch.where(v_r, t_del_r, 0), 1).values
        st, rc_ping = self._routing_add_batch(ctx, st, me_key, node_idx,
                                              add_cands, add_alive, now_add)

        res_b, sib_b = self._find_node_batch(ctx, st, me_key, node_idx,
                                             msgs.key, rmax)
        routedrop_cnt = zeros_n

        # FindNodeCalls → responder
        en_call = v_r & (msgs.kind == wire.FINDNODE_CALL)
        ob.send(en_call, t_del_r, msgs.src, wire.FINDNODE_RES,
                key=msgs.key, a=msgs.a, b=msgs.b, c=sib_b.to(I32),
                nodes=res_b, size_b=wire.findnode_res_b(p.redundant_nodes))
        ob.send(v_r & (msgs.kind == wire.PING_CALL), t_del_r, msgs.src,
                wire.PING_RES, a=msgs.a, b=msgs.b, size_b=wire.BASE_CALL_B)
        ob.send(v_r & (msgs.kind == wire.KAD_PING_CALL), t_del_r, msgs.src,
                wire.KAD_PING_RES, a=msgs.a, size_b=wire.BASE_CALL_B)
        en_kpr = v_r & (msgs.kind == wire.KAD_PING_RES)
        pong_hit = torch.any(st.ping_dst[:, :, None] == torch.where(
            en_kpr, msgs.src, NO_NODE)[:, None, :], -1)
        st = dataclasses.replace(
            st, ping_dst=torch.where(pong_hit, NO_NODE, st.ping_dst),
            ping_to=torch.where(pong_hit, T_INF, st.ping_to))
        dl_cands = torch.where(v_r & (msgs.kind == wire.KAD_DOWNLIST),
                               msgs.a, NO_NODE)

        st = dataclasses.replace(st, app=app_base.on_msgs_fold(
            self.app, st.app, msgs, ctx, ob, ev, sib_b))

        # ------------------------------------------------------- timers ----
        en_j = (st.state == JOINING) & (st.t_join < t_end)
        now_j = torch.maximum(st.t_join, t0)
        boot = ctx.sample_ready(rngs[:, 1], node_idx)
        no_join_lk = ~torch.any(st.lk.active & (st.lk.purpose == P_JOIN), 1)
        alone_start = en_j & (boot == NO_NODE)
        st = self._become_ready(ctx, st, alone_start, now_j, rngs[:, 2])
        joins_cnt = joins_cnt + alone_start.to(I32)
        slot, have = lk_mod.free_slot(st.lk)
        start_join = en_j & (boot != NO_NODE) & no_join_lk & have
        seed = torch.full((n, f), NO_NODE, dtype=I32, device=dev)
        seed[:, 0] = boot
        st = dataclasses.replace(st, lk=lk_mod.start(
            st.lk, start_join, slot, P_JOIN, 0, me_key, seed, now_j, lcfg))
        st = dataclasses.replace(st, t_join=torch.where(
            en_j & ~alone_start, now_j + _ns(p.join_delay), st.t_join))

        en_r = (st.state == READY) & (st.t_refresh < t_end)
        now_r = torch.maximum(st.t_refresh, t0)
        refresh_ns = _ns(p.bucket_refresh)
        far_sib = st.sib[:, -1]
        max_bi = torch.where(far_sib != NO_NODE, self._bucket_index(
            me_key, ctx.keys[torch.clamp(far_sib, min=0).long()]), -1)
        bi_range = torch.arange(p.num_buckets, device=dev)
        stale_bucket = st.b_used + refresh_ns < now_r[:, None]
        mark = en_r[:, None] & (bi_range <= max_bi[:, None]) & stale_bucket
        st = dataclasses.replace(
            st, refresh_dirty=st.refresh_dirty | mark,
            t_refresh=torch.where(en_r, now_r + refresh_ns, st.t_refresh))
        sib_stale = en_r & (st.sib_used + _ns(p.sibling_refresh) < now_r)

        # ----------------------------------------- maintenance pings ----
        ping_exp = (st.ping_dst != NO_NODE) & (st.ping_to < t_end)
        ping_failed = torch.where(ping_exp, st.ping_dst, NO_NODE)
        st = dataclasses.replace(
            st, ping_dst=torch.where(ping_exp, NO_NODE, st.ping_dst),
            ping_to=torch.where(ping_exp, T_INF, st.ping_to))
        bp_cand = torch.full((n,), NO_NODE, dtype=I32, device=dev)
        ping_cands = torch.cat([dl_cands, rc_ping[:, None],
                                bp_cand[:, None]], 1)
        dup_p = torch.any(ping_cands[:, :, None] == st.ping_dst[:, None, :],
                          -1)
        ping_cands = torch.where(dup_p | K.dup_mask(ping_cands), NO_NODE,
                                 ping_cands)
        en_p = ping_cands != NO_NODE
        lane_rank = torch.cumsum(en_p.to(I32), 1) - 1
        free_p = st.ping_dst == NO_NODE
        slot_rank = torch.cumsum(free_p.to(I32), 1) - 1
        n_free_p = torch.sum(free_p.to(I32), 1)
        pp = p.ping_slots
        slot_of_rank = put(
            torch.full((n, pp), pp, dtype=I64, device=dev), slot_rank,
            torch.arange(pp, device=dev).expand(n, pp), free_p)
        lane_slot = torch.where(
            en_p & (lane_rank < n_free_p[:, None]),
            take(slot_of_rank, torch.clamp(lane_rank, 0, pp - 1)), pp)
        sent_p = lane_slot < pp
        ob.send(sent_p, t0, ping_cands, wire.KAD_PING_CALL,
                size_b=wire.BASE_CALL_B)
        st = dataclasses.replace(
            st, ping_dst=put(st.ping_dst, lane_slot, ping_cands, sent_p),
            ping_to=put(st.ping_to, lane_slot, t0 + _ns(p.rpc_timeout),
                        sent_p))

        # app timer (graceful leavers stop testing first)
        ready = st.state == READY
        st = dataclasses.replace(st, app=app_base.leave_protocol(
            self.app, st.app, ctx, ob, ev, t0, node_idx, st.sib[:, 0],
            ready))
        t_app = self.app.next_event(st.app)
        en_a = ready & (t_app < t_end)
        now_a = torch.maximum(t_app, t0)
        app, req = self.app.on_timer(st.app, en_a, ctx, now_a, rngs[:, 3],
                                     ev, node_idx)
        st = dataclasses.replace(st, app=app)

        # bucket-refresh target: random key at shared prefix length bi
        bi_ref = torch.argmax(st.refresh_dirty.to(I32), 1)
        jbit = torch.clamp(spec.bits - 1 - bi_ref, 0, spec.bits - 1)
        top = self.pow2(dev)[jbit]
        mask = K.sub(top, K.from_int(1, spec, dev), spec)
        rnd = K.random_keys(rngs[:, 5], (), spec)
        target_ref = me_key ^ (top | (rnd & mask))

        seeds3, sib3 = self._find_node_batch(
            ctx, st, me_key, node_idx,
            torch.stack([me_key, req.key, target_ref], 1), rmax)
        res0, seed_a, seed_r = seeds3[:, 0], seeds3[:, 1], seeds3[:, 2]
        sib_a = sib3[:, 1]

        no_sib_lk = ~torch.any(st.lk.active & (st.lk.purpose == P_SIB), 1)
        slot, have = lk_mod.free_slot(st.lk)
        start_sib = sib_stale & no_sib_lk & have & (res0[:, 0] != NO_NODE)
        st = dataclasses.replace(st, lk=lk_mod.start(
            st.lk, start_sib, slot, P_SIB, 0, me_key, res0[:, :f], now_r,
            lcfg))
        st = dataclasses.replace(
            st, sib_used=torch.where(start_sib, now_r, st.sib_used))
        local = req.want & sib_a
        loc_cands = torch.cat([node_idx[:, None], st.sib], 1)
        loc_d = self._xor_to(ctx, loc_cands, req.key[:, None, :])
        (loc_s,) = K.sort_by_distance(loc_d, (loc_cands,), approx=True)[1]
        res_local = loc_s[:, :f]
        if res_local.shape[1] < f:
            res_local = torch.cat([res_local, torch.full(
                (n, f - res_local.shape[1]), NO_NODE, dtype=I32,
                device=dev)], 1)
        slot, have = lk_mod.free_slot(st.lk)
        start_app = req.want & ~sib_a & have & (seed_a[:, 0] != NO_NODE)
        insta_fail = req.want & ~sib_a & ~start_app
        st = dataclasses.replace(st, app=self.app.on_lookup_done(
            st.app, app_base.LookupDone(
                en=local | insta_fail, success=local, tag=req.tag,
                target=req.key,
                results=torch.where(local[:, None], res_local, NO_NODE),
                hops=zeros_n, t0=now_a),
            ctx, ob, ev, now_a, node_idx))
        st = dataclasses.replace(st, lk=lk_mod.start(
            st.lk, start_app, slot, P_APP, req.tag, req.key, seed_a[:, :f],
            now_a, lcfg))

        # ------------------------------------------------ lookup timeouts --
        new_lk, failed_nodes, _failed_prov = lk_mod.on_timeouts(
            st.lk, t_end, t0, lcfg)
        st = dataclasses.replace(st, lk=new_lk)
        st = self._handle_failed(ctx, st, me_key, node_idx,
                                 torch.cat([failed_nodes, ping_failed], 1))

        # ------------------------------------------------- completions -----
        new_lk, comp = lk_mod.take_completions(st.lk, t_end)
        st = dataclasses.replace(st, lk=new_lk)
        taken = comp["taken"]
        suc_l = comp["success"] & (comp["result"] != NO_NODE)
        pur_l = comp["purpose"]
        comp_hops_ev = (comp["hops"].to(torch.float32),
                        taken & comp["success"])
        lksucc_cnt = lksucc_cnt + torch.sum((taken & suc_l).to(I32), 1,
                                            dtype=I32)
        anyfail_cnt = anyfail_cnt + torch.sum((taken & ~suc_l).to(I32), 1,
                                              dtype=I32)
        enj = taken & (pur_l == P_JOIN)
        any_j = torch.any(enj, 1)
        n_sib_j = torch.sum(st.sib != NO_NODE, 1)
        got = any_j & (torch.any(enj & suc_l, 1) | (n_sib_j >= min(p.s, 4)))
        joins_cnt = joins_cnt + got.to(I32)
        st = self._become_ready(ctx, st, got, t0, rngs[:, 4])
        st = dataclasses.replace(st, t_join=torch.where(
            any_j & ~got, t0 + _ns(p.join_delay), st.t_join))

        enr_l = taken & (pur_l == P_REFRESH)
        rows_r = torch.clamp(comp["aux"], 0, p.num_buckets - 1)
        st = dataclasses.replace(
            st, refresh_dirty=put(st.refresh_dirty, rows_r, False, enr_l),
            b_used=put(st.b_used, rows_r, t0, enr_l))

        ena_l = taken & (pur_l == P_APP)
        st = dataclasses.replace(st, app=app_base.lookup_done_fold(
            self.app, st.app, app_base.LookupDone(
                en=ena_l, success=ena_l & suc_l, tag=comp["aux"],
                target=comp["target"], results=comp["results"],
                hops=comp["hops"], t0=comp["t0"]),
            ctx, ob, ev, t0, node_idx))

        # ------------------------------------------- bucket refresh pump ---
        dirty_now = take(st.refresh_dirty,
                         torch.clamp(bi_ref, max=p.num_buckets - 1))
        dirty_any = (st.state == READY) & dirty_now
        no_ref_lk = ~torch.any(st.lk.active & (st.lk.purpose == P_REFRESH),
                               1)
        slot, have = lk_mod.free_slot(st.lk)
        start_ref = dirty_any & no_ref_lk & have & (seed_r[:, 0] != NO_NODE)
        clear_only = dirty_any & no_ref_lk & (seed_r[:, 0] == NO_NODE)
        at_ref = clear_only[:, None] & (bi_range == bi_ref[:, None])
        st = dataclasses.replace(
            st, refresh_dirty=st.refresh_dirty & ~at_ref,
            lk=lk_mod.start(st.lk, start_ref, slot, P_REFRESH, bi_ref,
                            target_ref, seed_r[:, :f], t0, lcfg))

        st = dataclasses.replace(st, lk=lk_mod.pump(
            st.lk, ob, ctx, node_idx, t0, lcfg,
            num_redundant=p.redundant_nodes))

        # Common API update() (BaseOverlay::callUpdate → BaseApp::update,
        # BaseApp.h:223): the nodes that entered the sibling set this
        # tick, for the app's re-replication (the DHT's maintenance puts)
        if hasattr(self.app, "on_update"):
            new_in = torch.where(
                (st.sib != NO_NODE) & ~torch.any(
                    st.sib[:, :, None] == old_sib[:, None, :], -1),
                st.sib, NO_NODE)
            st = dataclasses.replace(st, app=self.app.on_update(
                st.app, st.state == READY, ctx, ob, ev, t0, node_idx,
                new_in, sib_keys=ctx.keys[torch.clamp(st.sib, min=0).long()],
                sib_valid=st.sib != NO_NODE))

        events = {
            "c:kad_joins": joins_cnt,
            "c:lookup_success": lksucc_cnt,
            "c:lookup_failed": anyfail_cnt,
            "c:route_dropped": routedrop_cnt,
            "s:lookup_hops": comp_hops_ev,
        }
        ev.finish(events, self.app.hist_map)
        return st, ob, events
