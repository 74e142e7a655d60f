"""GIA: capacity-aware unstructured overlay + search workload (PyTorch).

Counterpart of ``oversim_tpu/overlay/gia.py`` (reference Gia.{h,cc},
GiaNeighbors, GiaTokenFactory, GiaKeyList and the GIASearchApp workload;
default.ini's gia section: minNeighbors/maxNeighbors,
maxTopAdaptionInterval, tokenWaitTime, maxResponses).  GIA is not a KBR
overlay: there is no lookup engine, no key responsibility and no app
object; searches are capacity-biased random walks over token edges.

Per node: a capacity class, a neighbor set ``nbr`` [N, D] with the
neighbors' advertised capacities and the forwarding tokens held from
each, the join/adaptation/token/search timers and one outstanding
search.  Acceptance follows the subset rule (room, or a candidate
strictly stronger than the weakest neighbor, which gets a disconnect
notice); a query is answered where its key is the node's own or a
neighbor's (one-hop replication), else forwarded along a token edge,
parked on the node for ``token_wait`` when no token edge exists, and
dropped after ``token_wait_max`` parks.

The step runs over the leading ``[N]`` axis with the JAX package's
operations, its inbox slots one after another:

* a slot holds one message kind, so the NEIGHBOR_CALL and NEIGHBOR_RES
  inserts are one ``_nbr_add`` with the two kinds' operands merged (the
  state after it is the same as after JAX's two calls);
* slots ``r`` and ``r + 4`` draw their forwarding Gumbel values from the
  same key (``rngs[1 + r % 4]``), as does the search's first hop
  (``rngs[3]``): the four draws are made once a tick and reused;
* the pick score ``log(nbr_cap + 1e-3)`` only ever sees the capacity
  classes (they cross the wire as ``int32(cap * 16) / 16``, exactly), so
  its float32 ``log`` is ``LOG_CAP``'s table of XLA-CPU's values, which
  differ from ``torch.log``'s in the last ulp at 1.001 and 10.001;
* the satisfaction's float32 sum over D is explicit adds, left to right;
  latencies are ``x * float32(1e-9)`` as XLA compiles ``x / NS``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch import stats as stats_mod
from oversim_tpu_torch.apps.base import seconds
from oversim_tpu_torch.common import wire
from oversim_tpu_torch.core import keys as K
from oversim_tpu_torch.engine.logic import Outbox, keys_of, select_tree

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1

DEAD, JOINING, READY = 0, 1, 2

CAP_CLASSES = (1.0, 10.0, 100.0, 1000.0)
CAP_PROBS = (0.5, 0.3, 0.15, 0.05)
# XLA-CPU's float32 log(cap + 1e-3) for each capacity class (and for
# an empty slot's 0), as float32 bit patterns; tests/test_torch_game_
# units.py holds each to the jitted jnp.log
LOG_CAP = {0.0: 0xC0DD0C55, 1.0: 0x3A83033C, 10.0: 0x40135F32,
           100.0: 0x40935DA3, 1000.0: 0x40DD0C57}


def log_cap(cap):
    """float32 ``log(cap + 1e-3)`` as XLA-CPU computes it, for ``cap`` a
    capacity class (other values take ``torch.log``)."""
    out = torch.log(cap + torch.full((), 1e-3, dtype=F32, device=cap.device))
    for c, b in LOG_CAP.items():
        v = torch.full((), b, dtype=torch.int64, device=cap.device).to(
            I32).view(F32)
        out = torch.where(cap == c, v, out)
    return out


@dataclasses.dataclass(frozen=True)
class GiaParams:
    """default.ini gia namespace (JAX field names and defaults)."""

    min_neighbors: int = 3
    max_neighbors: int = 10
    adapt_interval: float = 10.0
    token_interval: float = 2.0
    max_tokens: int = 10
    search_interval: float = 60.0
    search_ttl: int = 20
    max_responses: int = 1
    search_timeout: float = 15.0
    join_delay: float = 5.0
    token_wait: float = 1.0
    token_wait_max: int = 5


@dataclasses.dataclass
class GiaState:
    state: torch.Tensor      # [N] i32
    capacity: torch.Tensor   # [N] f32
    nbr: torch.Tensor        # [N, D] i32
    nbr_cap: torch.Tensor    # [N, D] f32 neighbor's advertised capacity
    tokens: torch.Tensor     # [N, D] i32 tokens held FROM neighbor d
    t_join: torch.Tensor     # [N] i64
    t_adapt: torch.Tensor    # [N] i64
    t_token: torch.Tensor    # [N] i64
    t_search: torch.Tensor   # [N] i64
    s_active: torch.Tensor   # [N] bool
    s_seq: torch.Tensor      # [N] i32
    s_t0: torch.Tensor       # [N] i64
    s_to: torch.Tensor       # [N] i64


class GiaLogic:
    """Engine logic interface (see engine/logic.py)."""

    def __init__(self, spec: K.KeySpec = K.DEFAULT_SPEC,
                 params: GiaParams = GiaParams()):
        self.key_spec = spec
        self.p = params

    def stat_spec(self) -> stats_mod.StatSpec:
        return stats_mod.StatSpec(
            scalars=("gia_search_hops", "gia_search_latency_s",
                     "gia_satisfaction"),
            hists=(),
            counters=("gia_joins", "gia_searches", "gia_search_success",
                      "gia_search_failed", "gia_query_drops"))

    def init(self, rng, n: int) -> GiaState:
        d = self.p.max_neighbors
        dev = rng.device
        # the class table and its logits by fills, not host copies (a
        # reset runs this every tick); math.log is the C library's, as
        # XLA's constant folding of jnp.log is
        logits = torch.stack([torch.full((), math.log(q), dtype=F64,
                                         device=dev) for q in CAP_PROBS])
        cls = rng_mod.categorical(rng, logits, shape=(n,))
        capacity = torch.full((n,), CAP_CLASSES[-1], dtype=F32, device=dev)
        for k in range(len(CAP_CLASSES) - 2, -1, -1):
            capacity = torch.where(cls == k, CAP_CLASSES[k], capacity)

        def full(shape, v, dt):
            return torch.full((n,) + shape, v, dtype=dt, device=dev)

        return GiaState(
            state=full((), DEAD, I32), capacity=capacity,
            nbr=full((d,), NO_NODE, I32), nbr_cap=full((d,), 0.0, F32),
            tokens=full((d,), 0, I32),
            t_join=full((), T_INF, I64), t_adapt=full((), T_INF, I64),
            t_token=full((), T_INF, I64), t_search=full((), T_INF, I64),
            s_active=full((), False, torch.bool), s_seq=full((), 0, I32),
            s_t0=full((), 0, I64), s_to=full((), T_INF, I64))

    def split(self, st):
        return st, None

    def merge(self, node_part, glob):
        return node_part

    def post_step(self, ctx, st, events):
        return st

    def reset(self, st: GiaState, clear, join, t_now, rng):
        n = st.state.shape[0]
        r_init, r_j = rng_mod.split(rng).unbind(-2)
        fresh = self.init(r_init, n)
        # capacities stay with the surviving slots
        fresh = dataclasses.replace(fresh, capacity=torch.where(
            clear, fresh.capacity, st.capacity))
        st = select_tree(clear, fresh, st)
        jitter = (rng_mod.uniform(r_j, (n,), F64) * 0.1 * NS).to(I64)
        return dataclasses.replace(
            st, state=torch.where(join, JOINING, st.state),
            t_join=torch.where(join, t_now + jitter, st.t_join))

    def ready_mask(self, st: GiaState):
        return st.state == READY

    def next_event(self, st: GiaState):
        ready = st.state == READY
        t = torch.where(st.state == JOINING, st.t_join, T_INF)
        for timer in (st.t_adapt, st.t_token, st.t_search):
            t = torch.minimum(t, torch.where(ready, timer, T_INF))
        return torch.minimum(t, torch.where(st.s_active, st.s_to, T_INF))

    # -- per-node helpers -----------------------------------------------------

    @staticmethod
    def _deg(st):
        return torch.sum((st.nbr != NO_NODE).to(I32), 1, dtype=I32)

    def _satisfaction(self, st):
        """Gia::calculateLevelOfSatisfaction: the mean neighbor capacity
        over the own, 0 below minNeighbors, 1 when above 1 or at
        maxNeighbors (float32 adds over D, left to right)."""
        deg = self._deg(st)
        caps = torch.where(st.nbr != NO_NODE, st.nbr_cap, 0.0)
        total = torch.zeros_like(st.capacity)
        for j in range(caps.shape[1]):
            total = total + caps[:, j]
        los = total / (st.capacity * torch.clamp(deg, min=1).to(F32))
        los = torch.where(deg < self.p.min_neighbors, 0.0, los)
        return torch.where((los > 1.0) | (deg >= self.p.max_neighbors), 1.0,
                           los)

    def _nbr_add(self, st, peer, cap, en):
        """Insert ``peer`` into the first free slot, or in place of the
        first weakest neighbor when ``cap`` is strictly above its;
        returns (st, accepted, the dropped neighbor or NO_NODE)."""
        d = st.nbr.shape[1]
        cols = torch.arange(d, device=st.nbr.device)
        used = st.nbr != NO_NODE
        has_free = ~torch.all(used, 1)
        already = torch.any(st.nbr == peer[:, None], 1)
        col_free = torch.argmax((~used).to(I32), 1)
        weakest = torch.argmin(torch.where(used, st.nbr_cap, torch.inf), 1)
        w_cap = st.nbr_cap.gather(1, weakest[:, None])[:, 0]
        w_node = st.nbr.gather(1, weakest[:, None])[:, 0]
        can_replace = ~has_free & (cap > w_cap)
        col = torch.where(has_free, col_free, weakest)
        accept = en & ~already & (has_free | can_replace)
        dropped = torch.where(accept & ~has_free, w_node, NO_NODE)
        hit = (cols[None, :] == col[:, None]) & accept[:, None]
        st = dataclasses.replace(
            st, nbr=torch.where(hit, peer[:, None], st.nbr),
            nbr_cap=torch.where(hit, cap[:, None], st.nbr_cap),
            tokens=torch.where(hit, 0, st.tokens))
        return st, accept, dropped

    @staticmethod
    def _nbr_drop(st, peer, en):
        hit = (st.nbr == peer[:, None]) & en[:, None]
        return dataclasses.replace(
            st, nbr=torch.where(hit, NO_NODE, st.nbr),
            nbr_cap=torch.where(hit, 0.0, st.nbr_cap),
            tokens=torch.where(hit, 0, st.tokens))

    @staticmethod
    def _pick(ok, cap_log, g):
        """First argmax of ``log(cap + 1e-3) + g`` over the ``ok`` slots
        (float64 sums, as JAX promotes the float32 log)."""
        score = torch.where(ok, cap_log.to(F64) + g, -torch.inf)
        return torch.argmax(score, 1)

    def _forward_target(self, st, cap_log, g, exclude):
        """The capacity-biased pick among the neighbors we hold a token
        from, ``exclude`` left out (Gia::forwardSearchMessage):
        (target or NO_NODE, slot, any)."""
        ok = (st.nbr != NO_NODE) & (st.tokens > 0) & (
            st.nbr != exclude[:, None])
        pick = self._pick(ok, cap_log, g)
        has = torch.any(ok, 1)
        tgt = st.nbr.gather(1, pick[:, None])[:, 0]
        return torch.where(has, tgt, NO_NODE), pick, has

    def _spend_token(self, st, col, en):
        d = st.nbr.shape[1]
        hit = (torch.arange(d, device=col.device)[None, :] == col[:, None]) \
            & en[:, None]
        return dataclasses.replace(st, tokens=st.tokens - hit.to(I32))

    # -- the batched step -----------------------------------------------------

    def step(self, ctx, st, msgs, rng, node_idx, *, outbox_slots, rmax):
        p, spec = self.p, self.key_spec
        n = st.state.shape[0]
        dev = st.state.device
        d = p.max_neighbors
        ob = Outbox(n, outbox_slots, spec.lanes, rmax, dev)
        me_key = ctx.keys[node_idx.long()]
        rngs = rng_mod.split(rng, 8)                              # [N, 8, 2]
        t0 = ctx.t_start
        t_end = ctx.t_end
        cols = torch.arange(d, device=dev)

        zero = torch.zeros((n,), dtype=I32, device=dev)
        joins_cnt, searches, succ_cnt, fail_cnt, drop_cnt = (zero,) * 5
        hops_vals, hops_mask, lat_vals, lat_mask = [], [], [], []

        # the draws that repeat across slots: one float64 uniform (the
        # search timer of a node made READY) and the four forwarding
        # Gumbel vectors (slots r and r + 4 share rngs[1 + r % 4])
        u_search = rng_mod.uniform(rngs[:, 0], (), F64)
        g_fwd = rng_mod.gumbel(rngs[:, 1:5], (d,), F64)          # [N, 4, D]
        wait_ns = int(p.token_wait * NS)

        # ------------------------------------------------------- inbox -----
        for r in range(msgs.valid.shape[1]):
            m = msgs.slot(r)
            now = m.t_deliver
            v = m.valid
            ready = st.state == READY
            cap = m.a.to(F32) / 16.0

            # neighbor connect request and response: one insert (a slot
            # holds one kind)
            en_call = v & (m.kind == wire.GIA_NEIGHBOR_CALL) & ready
            en_res = v & (m.kind == wire.GIA_NEIGHBOR_RES) & (m.c != 0)
            st, accept, dropped = self._nbr_add(st, m.src, cap,
                                                en_call | en_res)
            ob.send(dropped != NO_NODE, now, dropped, wire.GIA_DISCONNECT,
                    size_b=wire.BASE_CALL_B)
            ob.send(en_call, now, m.src, wire.GIA_NEIGHBOR_RES,
                    a=(st.capacity * 16.0).to(I32), c=accept.to(I32),
                    size_b=wire.BASE_CALL_B + 8)
            # the first accepted neighbor while joining → READY
            got = en_res & (st.state == JOINING)
            joins_cnt = joins_cnt + got.to(I32)
            st = dataclasses.replace(
                st, state=torch.where(got, READY, st.state),
                t_join=torch.where(got, T_INF, st.t_join),
                t_adapt=torch.where(got, now, st.t_adapt),
                t_token=torch.where(got, now, st.t_token),
                t_search=torch.where(
                    got, now + (u_search * p.search_interval * NS).to(I64),
                    st.t_search))

            # disconnect notice
            st = self._nbr_drop(st, m.src, v & (m.kind == wire.GIA_DISCONNECT))

            # token grant (GiaTokenFactory::sendToken)
            en = v & (m.kind == wire.GIA_TOKEN)
            is_src = st.nbr == m.src[:, None]
            col = torch.argmax(is_src.to(I32), 1)
            hit = (cols[None, :] == col[:, None]) & (
                en & torch.any(is_src, 1))[:, None]
            st = dataclasses.replace(st, tokens=torch.where(
                hit, torch.clamp(st.tokens + 1, max=p.max_tokens), st.tokens))

            # search query walk (Gia::processSearchMessage): answer if
            # the key is ours or a neighbor's, else forward along a token
            # edge; no token → park on ourselves for token_wait (wire: a
            # originator, b seq, c prev-hop + 1, d park count)
            ready = st.state == READY
            en = v & (m.kind == wire.GIA_QUERY) & ready
            nbr_keys = keys_of(ctx, torch.clamp(st.nbr, min=0))
            hit_nbr = torch.any((st.nbr != NO_NODE) & K.eq(
                m.key[:, None, :], nbr_keys), 1)
            hit = K.eq(m.key, me_key) | hit_nbr
            ob.send(en & hit, now, m.a, wire.GIA_QUERY_RES, key=m.key,
                    b=m.b, hops=m.hops, stamp=m.stamp,
                    size_b=wire.BASE_CALL_B + 20)
            prev_hop = torch.where(m.c > 0, m.c - 1, m.src)
            fwd = en & ~hit & (m.hops < p.search_ttl)
            tgt, col, has = self._forward_target(
                st, log_cap(st.nbr_cap), g_fwd[:, r % 4], prev_hop)
            ob.send(fwd & has, now, tgt, wire.GIA_QUERY, key=m.key, a=m.a,
                    b=m.b, hops=m.hops + 1, stamp=m.stamp,
                    size_b=wire.BASE_CALL_B + 20 + 8)
            st = self._spend_token(st, col, fwd & has)
            requeue = fwd & ~has & (m.d < p.token_wait_max)
            ob.send(requeue, now + wait_ns, node_idx, wire.GIA_QUERY,
                    key=m.key, a=m.a, b=m.b, c=prev_hop + 1, d=m.d + 1,
                    hops=m.hops, stamp=m.stamp,
                    size_b=wire.BASE_CALL_B + 20 + 8)
            drop_cnt = drop_cnt + (en & ~hit & ~(fwd & has) & ~requeue).to(I32)

            # search response at the originator
            en = v & (m.kind == wire.GIA_QUERY_RES) & st.s_active & (
                m.b == st.s_seq)
            succ_cnt = succ_cnt + en.to(I32)
            hops_vals.append((m.hops + 1).to(F32))
            hops_mask.append(en & ctx.measuring)
            lat_vals.append(seconds(now - m.stamp))
            lat_mask.append(en & ctx.measuring)
            st = dataclasses.replace(
                st, s_active=torch.where(en, False, st.s_active),
                s_to=torch.where(en, T_INF, st.s_to))

        # ------------------------------------------------------- timers ----
        # join: connect to a random ready node (the bootstrap oracle)
        en_j = (st.state == JOINING) & (st.t_join < t_end)
        now_j = torch.maximum(st.t_join, t0)
        boot = ctx.sample_ready(rngs[:, 5], node_idx)
        alone = en_j & (boot == NO_NODE)
        joins_cnt = joins_cnt + alone.to(I32)
        st = dataclasses.replace(
            st, state=torch.where(alone, READY, st.state),
            t_join=torch.where(alone, T_INF, torch.where(
                en_j, now_j + int(p.join_delay * NS), st.t_join)),
            t_adapt=torch.where(alone, now_j, st.t_adapt),
            t_token=torch.where(alone, now_j, st.t_token),
            t_search=torch.where(alone, T_INF, st.t_search))
        ob.send(en_j & (boot != NO_NODE), now_j, boot,
                wire.GIA_NEIGHBOR_CALL, a=(st.capacity * 16.0).to(I32),
                size_b=wire.BASE_CALL_B + 8)

        # topology adaptation
        ready = st.state == READY
        en_t = ready & (st.t_adapt < t_end)
        now_t = torch.maximum(st.t_adapt, t0)
        sat = self._satisfaction(st)
        deg = self._deg(st)
        want_more = en_t & ((sat < 1.0) | (deg < p.min_neighbors)) & (
            deg < p.max_neighbors)
        cand = ctx.sample_ready(rngs[:, 6], node_idx)
        ob.send(want_more & (cand != NO_NODE) & (cand != node_idx), now_t,
                cand, wire.GIA_NEIGHBOR_CALL,
                a=(st.capacity * 16.0).to(I32), size_b=wire.BASE_CALL_B + 8)
        st = dataclasses.replace(st, t_adapt=torch.where(
            en_t, now_t + int(p.adapt_interval * NS), st.t_adapt))

        # token generation: grant to a capacity-biased neighbor
        en_k = ready & (st.t_token < t_end)
        now_k = torch.maximum(st.t_token, t0)
        okn = st.nbr != NO_NODE
        cap_log = log_cap(st.nbr_cap)
        pick = self._pick(okn, cap_log, rng_mod.gumbel(rngs[:, 7], (d,), F64))
        ob.send(en_k & torch.any(okn, 1), now_k,
                st.nbr.gather(1, pick[:, None])[:, 0], wire.GIA_TOKEN,
                size_b=wire.BASE_CALL_B)
        st = dataclasses.replace(st, t_token=torch.where(
            en_k, now_k + int(p.token_interval * NS), st.t_token))

        # search timeout
        en_to = st.s_active & (st.s_to < t_end)
        fail_cnt = fail_cnt + en_to.to(I32)
        st = dataclasses.replace(
            st, s_active=torch.where(en_to, False, st.s_active),
            s_to=torch.where(en_to, T_INF, st.s_to))

        # periodic search (GIASearchApp); a leaving node parks its timer
        st = dataclasses.replace(st, t_search=torch.where(
            ctx.leaving[node_idx.long()], T_INF, st.t_search))
        due_s = ready & (st.t_search < t_end)
        en_s = due_s & ~st.s_active
        now_s = torch.maximum(st.t_search, t0)
        victim = ctx.sample_ready(rngs[:, 2])
        key = keys_of(ctx, torch.clamp(victim, min=0))
        no_ex = torch.full((n,), NO_NODE, dtype=I32, device=dev)
        tgt, col, has = self._forward_target(st, cap_log, g_fwd[:, 2], no_ex)
        fire = en_s & (victim != NO_NODE) & (victim != node_idx) & has
        searches = searches + fire.to(I32)
        seq = st.s_seq + 1
        ob.send(fire, now_s, tgt, wire.GIA_QUERY, key=key, a=node_idx,
                b=seq, hops=0, stamp=now_s, size_b=wire.BASE_CALL_B + 20 + 8)
        st = self._spend_token(st, col, fire)
        st = dataclasses.replace(
            st, s_active=torch.where(fire, True, st.s_active),
            s_seq=torch.where(fire, seq, st.s_seq),
            s_t0=torch.where(fire, now_s, st.s_t0),
            s_to=torch.where(fire, now_s + int(p.search_timeout * NS),
                             st.s_to),
            t_search=torch.where(
                due_s, now_s + int(p.search_interval * NS), st.t_search))

        # ------------------------------------------------------ events -----
        events = {
            "c:gia_joins": joins_cnt,
            "c:gia_searches": searches,
            "c:gia_search_success": succ_cnt,
            "c:gia_search_failed": fail_cnt,
            "c:gia_query_drops": drop_cnt,
            "s:gia_search_hops": (torch.stack(hops_vals, 1),
                                  torch.stack(hops_mask, 1)),
            "s:gia_search_latency_s": (torch.stack(lat_vals, 1),
                                       torch.stack(lat_mask, 1)),
            "s:gia_satisfaction": (
                torch.clamp(self._satisfaction(st), max=10.0)[:, None],
                ((st.state == READY) & ctx.measuring)[:, None]),
        }
        return st, ob, events
