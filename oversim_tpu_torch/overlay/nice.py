"""NICE — hierarchical cluster-based application-layer multicast (PyTorch).

Counterpart of ``oversim_tpu/overlay/nice.py`` (reference
src/overlay/nice/ Nice.{h,cc}, the SIGCOMM'02 protocol): nodes form
layered clusters of size k..3k-1; every cluster's leader is also a
member of the next layer up, so layer membership is a prefix 0..h, and
data sent into a cluster is re-forwarded by each receiver into every
other cluster it belongs to.

* Membership is a dense ``[N, L, C]`` member table with an ``[N, L]``
  in-layer mask; the rendezvous point is the glob part ``rp`` (a 0-d
  int32), kept by ``post_step``: the lowest-slot READY node when the
  old one is gone.
* The join descent QUERY → QUERY_RES → PROBE round → QUERY one layer
  down → JOIN at the target layer's leader; heartbeats (member HBs and
  authoritative LEADER_HB member lists), eviction after
  ``peer_timeout_hbs`` intervals, the leader's split past 3k-1 members
  (a balanced bipartition in slot order) and merge under k.
* The ALMTest workload is folded in: every READY node publishes into all
  its clusters every ``pub_interval`` while measuring; a receiver
  delivers once (a ring of ``seen`` hashes) and queues one re-forward
  per tick.

The step runs over the leading ``[N]`` axis with the JAX package's
operations: its inbox slots one after another, each handler in the JAX
order; the layer loops of the maintenance timer stay in layer order,
their member loops are lanes.  A ``.at[row].set(..., mode="drop")``
with ``row = L`` as "no write" is a masked write.  A MERGE's members go
into the free slots first to last, each one not already there, which is
the JAX package's insertion loop as one rank match.  The heartbeat's
per-member LEADER_HB and HB sends are one send (a member is one or the
other in a layer), in the JAX package's lane order.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch import stats as stats_mod
from oversim_tpu_torch.apps import base as app_base
from oversim_tpu_torch.core import keys as K
from oversim_tpu_torch.engine.logic import (Outbox, first_true, one_hot,
                                          select_tree, take)

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1
BIG = 2 ** 30

DEAD, JOINING, READY = 0, 1, 2

# join-descent stages
J_IDLE, J_QUERY, J_PROBE, J_JOIN = 0, 1, 2, 3

NICE_QUERY = 110       # a=layer (-1 = your top layer)
NICE_QUERY_RES = 111   # a=layer, b=cluster leader, nodes=members
NICE_PROBE = 112       # RTT probe (stamp echoed back)
NICE_PROBE_RES = 113
NICE_JOIN = 114        # a=layer: admit me to your layer-a cluster
NICE_JOIN_ACK = 115    # a=layer, nodes=members
NICE_HB = 116          # a=layer: member liveness heartbeat
NICE_LEADER_HB = 117   # a=layer, nodes=authoritative member list
NICE_SPLIT = 118       # a=layer, b=new leader, c=upper anchor, nodes=half
NICE_MERGE = 119       # a=layer, nodes=members to absorb
NICE_MCAST = 120       # a=cluster layer, b=seq, c=origin


@dataclasses.dataclass(frozen=True)
class NiceParams:
    """JAX field names and defaults (default.ini:357-366)."""

    k: int = 3                      # cluster parameter
    layers: int = 4                 # maxLayers
    hb_interval: float = 5.0        # heartbeatInterval
    maint_interval: float = 3.3     # maintenanceInterval
    query_interval: float = 2.0     # queryInterval (join retry)
    probe_wait: float = 1.0         # RTT-eval window
    peer_timeout_hbs: float = 3.0   # peerTimeoutHeartbeats
    join_delay: float = 1.0
    pub_interval: float = 20.0      # ALMTest sender period
    seen: int = 16                  # duplicate-suppression ring size

    @property
    def cmax(self) -> int:
        return 3 * self.k + 2       # split fires at >3k-1; +2 admit slack


@dataclasses.dataclass
class NiceState:
    state: torch.Tensor       # [N] i32 DEAD/JOINING/READY
    in_layer: torch.Tensor    # [N, L] bool (prefix mask)
    leader: torch.Tensor      # [N, L] i32 my cluster's leader
    member: torch.Tensor      # [N, L, C] i32 my cluster view (incl. self)
    hb_seen: torch.Tensor     # [N, L, C] i64 last HB per member
    t_hb: torch.Tensor        # [N] i64
    t_maint: torch.Tensor     # [N] i64
    t_pub: torch.Tensor       # [N] i64 ALM workload sender
    jn_stage: torch.Tensor    # [N] i32 J_*
    jn_layer: torch.Tensor    # [N] i32 layer of the cluster being probed
    jn_target: torch.Tensor   # [N] i32 layer we want to join
    jn_cands: torch.Tensor    # [N, C] i32
    jn_rtt: torch.Tensor      # [N, C] i64
    jn_sent: torch.Tensor     # [N] bool probes fired for this round
    jn_deadline: torch.Tensor  # [N] i64
    seq: torch.Tensor         # [N] i32 publish counter
    seen: torch.Tensor        # [N, S] i64 (origin<<32 | seq) dup ring
    seen_n: torch.Tensor      # [N] i32
    fw_h: torch.Tensor        # [N] i64 pending forward (hash; 0 = none)
    fw_src: torch.Tensor      # [N] i32
    fw_origin: torch.Tensor   # [N] i32
    fw_seq: torch.Tensor      # [N] i32
    fw_layer: torch.Tensor    # [N] i32 arrival layer (-1 = own publish)
    fw_hops: torch.Tensor     # [N] i32
    rp: object                # glob: 0-d i32, the rendezvous point


def _set_row(x, row, val, en):
    """``x.at[row].set(val)`` per node where ``en`` ([N]): ``x`` [N, L,
    ...], ``row`` [N], ``val`` broadcastable to ``x``'s row [N, ...]."""
    at = one_hot(row, x.shape[1]) & en[:, None]
    while at.dim() < x.dim():
        at = at.unsqueeze(-1)
    val = rng_mod.device_scalar(val, x.dtype, x.device)
    if val.dim():
        val = val.unsqueeze(1)
    return torch.where(at, val, x)


def _with_col(x, li: int, val):
    """A copy of ``x`` [N, L, ...] with layer ``li`` replaced by ``val``."""
    y = x.clone()
    y[:, li] = val
    return y


class NiceLogic:
    """Engine logic interface (see engine/logic.py)."""

    def __init__(self, spec: K.KeySpec = K.DEFAULT_SPEC,
                 params: NiceParams = NiceParams()):
        self.key_spec = spec
        self.p = params

    def stat_spec(self):
        return stats_mod.StatSpec(
            scalars=("nice_hops", "nice_layers"), hists=(),
            counters=("nice_joins", "nice_pub", "nice_recv", "nice_dup",
                      "nice_splits", "nice_merges", "nice_evicts",
                      "nice_fwd_drop"))

    def split(self, st):
        return dataclasses.replace(st, rp=None), st.rp

    def merge(self, node_part, glob):
        return dataclasses.replace(node_part, rp=glob)

    def post_step(self, ctx, st, events):
        """Keep the rendezvous point while it is READY, else elect the
        lowest-slot READY node."""
        ready = (st.state == READY) & ctx.alive
        rp = st.rp
        # a gather, not ``ready[rp]``: a 0-d index reads back to the host
        ok = (rp != NO_NODE) & ready.gather(
            0, torch.clamp(rp, min=0).long().reshape(1)).reshape(())
        fallback = torch.where(torch.any(ready), first_true(ready).to(I32),
                               NO_NODE)
        return dataclasses.replace(st, rp=torch.where(ok, rp, fallback))

    def init(self, rng, n: int) -> NiceState:
        p = self.p
        l, c = p.layers, p.cmax
        dev = rng.device

        def full(shape, v, dt):
            return torch.full((n,) + shape, v, dtype=dt, device=dev)

        return NiceState(
            state=full((), DEAD, I32), in_layer=full((l,), False, torch.bool),
            leader=full((l,), NO_NODE, I32),
            member=full((l, c), NO_NODE, I32), hb_seen=full((l, c), 0, I64),
            t_hb=full((), T_INF, I64), t_maint=full((), T_INF, I64),
            t_pub=full((), T_INF, I64), jn_stage=full((), J_IDLE, I32),
            jn_layer=full((), 0, I32), jn_target=full((), 0, I32),
            jn_cands=full((c,), NO_NODE, I32), jn_rtt=full((c,), T_INF, I64),
            jn_sent=full((), False, torch.bool),
            jn_deadline=full((), T_INF, I64), seq=full((), 0, I32),
            seen=full((p.seen,), 0, I64), seen_n=full((), 0, I32),
            fw_h=full((), 0, I64), fw_src=full((), NO_NODE, I32),
            fw_origin=full((), NO_NODE, I32), fw_seq=full((), 0, I32),
            fw_layer=full((), 0, I32), fw_hops=full((), 0, I32),
            rp=torch.full((), NO_NODE, dtype=I32, device=dev))

    def reset(self, st, clear, join, t_now, rng):
        n = st.state.shape[0]
        glob = st.rp
        st = dataclasses.replace(st, rp=None)
        fresh = dataclasses.replace(self.init(rng, n), rp=None)
        st = select_tree(clear, fresh, st)
        st = dataclasses.replace(st, rp=glob)
        jitter = (rng_mod.uniform(rng, (n,), F64) * self.p.join_delay
                  * NS).to(I64)
        return dataclasses.replace(
            st, state=torch.where(join, JOINING, st.state),
            jn_stage=torch.where(join, J_IDLE, st.jn_stage),
            jn_target=torch.where(join, 0, st.jn_target),
            jn_deadline=torch.where(join, t_now + jitter, st.jn_deadline))

    def ready_mask(self, st):
        return st.state == READY

    def next_event(self, st):
        ready = st.state == READY
        t = torch.where(st.state == JOINING, st.jn_deadline, T_INF)
        t = torch.minimum(t, torch.where(ready, st.jn_deadline, T_INF))
        t = torch.minimum(t, torch.where(ready, st.t_hb, T_INF))
        t = torch.minimum(t, torch.where(ready, st.t_maint, T_INF))
        t = torch.minimum(t, torch.where(ready, st.t_pub, T_INF))
        # a pending forward / unsent probe round must run this tick
        return torch.where((st.fw_h != 0) | ((st.jn_stage == J_PROBE)
                                             & ~st.jn_sent), 0, t)

    # -- helpers --------------------------------------------------------------

    def _become_root(self, st, en, now, node_idx):
        """First node (or healed partition head): a one-member layer 0."""
        p = self.p
        mem0 = torch.where(one_hot(torch.zeros_like(node_idx), p.cmax),
                           node_idx[:, None], NO_NODE)
        row = torch.zeros_like(node_idx)
        return dataclasses.replace(
            st, state=torch.where(en, READY, st.state),
            in_layer=_set_row(st.in_layer, row, True, en),
            leader=_set_row(st.leader, row, node_idx, en),
            member=_set_row(st.member, row, mem0, en),
            jn_stage=torch.where(en, J_IDLE, st.jn_stage),
            jn_deadline=torch.where(en, T_INF, st.jn_deadline),
            t_hb=torch.where(en, now + int(p.hb_interval * NS), st.t_hb),
            t_maint=torch.where(en, now + int(p.maint_interval * NS),
                                st.t_maint),
            t_pub=torch.where(en, now + int(p.pub_interval * NS), st.t_pub))

    @staticmethod
    def _seen_push(st, en, h):
        s = st.seen.shape[-1]
        at = one_hot(st.seen_n % s, s) & en[:, None]
        return dataclasses.replace(
            st, seen=torch.where(at, h[:, None], st.seen),
            seen_n=st.seen_n + en.to(I32))

    @staticmethod
    def _merge_into(mem, nodes):
        """``nodes`` [N, C] absorbed into ``mem`` [N, C]: each node not
        yet there takes the first free slot, in list order, while free
        slots last (the JAX package's per-member insertion loop)."""
        c = mem.shape[1]
        new = ((nodes != NO_NODE)
               & ~torch.any(mem[:, None, :] == nodes[:, :, None], -1)
               & ~K.dup_mask(nodes))
        rank = torch.cumsum(new.to(I32), 1) - 1
        free = mem == NO_NODE
        frank = torch.cumsum(free.to(I32), 1) - 1
        match = (free[:, :, None] & new[:, None, :]
                 & (frank[:, :, None] == rank[:, None, :]))      # [N, C, C]
        val = torch.amax(torch.where(match, nodes[:, None, :], NO_NODE), -1)
        return torch.where(torch.any(match, -1), val, mem) if c else mem

    # -- the batched step -----------------------------------------------------

    def step(self, ctx, st, msgs, rng, node_idx, *, outbox_slots, rmax):
        p, spec = self.p, self.key_spec
        lmax, cmax = p.layers, p.cmax
        n = st.state.shape[0]
        dev = st.state.device
        ob = Outbox(n, outbox_slots, spec.lanes, rmax, dev)
        t0, t_end = ctx.t_start, ctx.t_end
        ev = app_base.AppEvents(n, dev)
        layer_idx = torch.arange(lmax, dtype=I32, device=dev)
        zero = torch.zeros((n,), dtype=I32, device=dev)
        c_joins = c_pub = c_recv = c_dup = zero
        c_splits = c_merges = c_evicts = c_fwdrop = zero
        hb_ns = int(p.hb_interval * NS)
        list_b = 16 + 25 * cmax   # NODEHANDLE_B * cmax payload

        # ------------------------------------------------------- inbox -----
        # A slot holds one message, so of the handlers below one at most
        # is enabled for a node: each reads the slot's starting state,
        # which the others leave alone for that node, and their writes
        # to a layer's row merge into one write per field.
        ar_c = torch.arange(cmax, device=dev)
        me = node_idx[:, None]
        for r in range(msgs.valid.shape[1]):
            m = msgs.slot(r)
            now = m.t_deliver
            kind = torch.where(m.valid, m.kind, -1)
            is_ready = st.state == READY
            l = torch.clamp(m.a, 0, lmax - 1)
            at_l = layer_idx[None, :] == l[:, None]                  # [N, L]
            nodes = m.nodes[:, :cmax]
            in_l = take(st.in_layer, l)
            lead_l = take(st.leader, l)
            mem_l = take(st.member, l)                               # [N, C]
            i_lead = in_l & (lead_l == node_idx)
            is_src = mem_l == m.src[:, None]
            have = torch.any(is_src, 1)
            free = mem_l == NO_NODE

            # QUERY: return my layer-a cluster (a = -1: my top layer)
            h = torch.amax(torch.where(st.in_layer, layer_idx, -1), 1)
            l_eff = torch.clamp(torch.where(m.a < 0, h, torch.minimum(m.a, h)),
                                0, lmax - 1)
            ob.send((kind == NICE_QUERY) & is_ready & (h >= 0), now, m.src,
                    NICE_QUERY_RES, a=l_eff, b=take(st.leader, l_eff),
                    nodes=take(st.member, l_eff), size_b=list_b)

            # QUERY_RES: descend, or ask the target layer's leader to
            # admit us
            en = (kind == NICE_QUERY_RES) & (st.jn_stage == J_QUERY)
            at_target = en & (m.a <= st.jn_target) & (m.b != NO_NODE)
            ob.send(at_target, now, torch.clamp(m.b, min=0), NICE_JOIN,
                    a=st.jn_target, size_b=16)
            descend = en & ~at_target

            # PROBE: echo for the RTT measurement; PROBE_RES: record it
            ob.send(kind == NICE_PROBE, now, m.src, NICE_PROBE_RES,
                    stamp=m.stamp, size_b=8)
            cand = st.jn_cands == m.src[:, None]
            rtt_at = (ar_c == first_true(cand)[:, None]) & (
                (kind == NICE_PROBE_RES) & (st.jn_stage == J_PROBE)
                & torch.any(cand, 1))[:, None]

            # JOIN: the leader admits a member (refresh or a free slot)
            join = (kind == NICE_JOIN) & is_ready & i_lead
            slot = torch.where(have, first_true(is_src), first_true(free))
            adm = join & (have | torch.any(free, 1))
            join_row = torch.where(ar_c == slot[:, None], m.src[:, None],
                                   mem_l)
            ob.send(adm, now, m.src, NICE_JOIN_ACK, a=l, nodes=join_row,
                    size_b=list_b)

            # JOIN_ACK: we are in
            ack = (kind == NICE_JOIN_ACK) & (st.jn_stage == J_JOIN)
            c_joins = c_joins + (ack & (st.state == JOINING)).to(I32)

            # HB: member liveness
            hb = (kind == NICE_HB) & is_ready & in_l & have

            # LEADER_HB: authoritative membership; evicted by my own
            # leader → drop the layer and those above (layer 0 rejoins)
            lhb = (kind == NICE_LEADER_HB) & is_ready
            inlist = torch.any(nodes == me, 1)
            lhb_in = lhb & inlist
            evict = lhb & ~inlist & in_l & (lead_l == m.src)
            rejoin0 = evict & (l == 0)

            # SPLIT: my cluster was bipartitioned; its new leader joins
            # the upper anchor's cluster at l+1
            split = (kind == NICE_SPLIT) & is_ready & inlist
            promo = (split & (m.b == node_idx) & (m.c != NO_NODE)
                     & (m.c != node_idx) & (l + 1 < lmax))
            ob.send(promo, now, torch.clamp(m.c, min=0), NICE_JOIN,
                    a=torch.clamp(l + 1, max=lmax - 1), size_b=16)

            # MERGE: absorb a dissolving sibling cluster
            merge = (kind == NICE_MERGE) & is_ready & i_lead
            c_merges = c_merges + merge.to(I32)

            # the slot's writes to layer l: member and heartbeat rows,
            # the in-layer bit and the leader
            adopt = ack | lhb_in | split
            w_mem = adm | adopt | merge
            mem_row = torch.where(adm[:, None], join_row, torch.where(
                merge[:, None], self._merge_into(mem_l, nodes), nodes))
            cell = torch.where(join, slot, first_true(is_src))
            hb_row = torch.where(
                (adm | hb)[:, None] & (ar_c != cell[:, None]),
                take(st.hb_seen, l), now[:, None])
            w_hb = adm | hb | adopt | merge
            at_in = at_l & (ack | lhb_in)[:, None]
            st = dataclasses.replace(
                st,
                member=torch.where((at_l & w_mem[:, None])[:, :, None],
                                   mem_row[:, None, :], st.member),
                hb_seen=torch.where((at_l & w_hb[:, None])[:, :, None],
                                    hb_row[:, None, :], st.hb_seen),
                in_layer=(st.in_layer | at_in) & ~(
                    evict[:, None] & (layer_idx[None, :] >= l[:, None])),
                leader=torch.where(at_l & adopt[:, None], torch.where(
                    split, m.b, m.src)[:, None], st.leader),
                jn_stage=torch.where(at_target, J_JOIN, torch.where(
                    descend, J_PROBE, torch.where(ack | rejoin0, J_IDLE,
                                                  st.jn_stage))),
                jn_layer=torch.where(descend, m.a, st.jn_layer),
                jn_target=torch.where(ack | rejoin0, 0, st.jn_target),
                jn_cands=torch.where(descend[:, None], nodes, st.jn_cands),
                jn_rtt=torch.where(descend[:, None], T_INF, torch.where(
                    rtt_at, (now - m.stamp)[:, None], st.jn_rtt)),
                jn_sent=st.jn_sent & ~descend,
                jn_deadline=torch.where(
                    at_target, now + int(p.query_interval * NS),
                    torch.where(ack, T_INF, torch.where(
                        rejoin0, now, st.jn_deadline))),
                state=torch.where(ack, READY, st.state),
                t_hb=torch.where(ack & (st.t_hb == T_INF), now + hb_ns,
                                 st.t_hb),
                t_maint=torch.where(
                    ack & (st.t_maint == T_INF),
                    now + int(p.maint_interval * NS), st.t_maint),
                t_pub=torch.where(ack & (st.t_pub == T_INF),
                                  now + int(p.pub_interval * NS), st.t_pub))

            # MCAST: deliver once, queue the re-forward
            en = (kind == NICE_MCAST) & is_ready
            h = torch.bitwise_left_shift(m.c.to(I64), 32) | m.b.to(I64)
            dup = torch.any(st.seen == h[:, None], 1)
            fresh = en & ~dup
            c_recv = c_recv + fresh.to(I32)
            c_dup = c_dup + (en & dup).to(I32)
            ev.value("nice_hops", m.hops.to(F32), fresh)
            st = self._seen_push(st, fresh, h)
            # one re-forward queued per tick (further distinct arrivals
            # in the window are counted, not re-forwarded)
            c_fwdrop = c_fwdrop + (fresh & (st.fw_h != 0)).to(I32)
            tk = fresh & (st.fw_h == 0)
            st = dataclasses.replace(
                st, fw_h=torch.where(tk, h, st.fw_h),
                fw_src=torch.where(tk, m.src, st.fw_src),
                fw_origin=torch.where(tk, m.c, st.fw_origin),
                fw_seq=torch.where(tk, m.b, st.fw_seq),
                fw_layer=torch.where(tk, m.a, st.fw_layer),
                fw_hops=torch.where(tk, m.hops + 1, st.fw_hops))

        # ------------------------------------------------------- timers ----
        rp = (ctx.glob if ctx.glob is not None
              else torch.full((), NO_NODE, dtype=I32, device=dev))
        is_ready = st.state == READY

        # join / rejoin descent driver
        want = (st.state == JOINING) | (is_ready & (
            (st.jn_stage != J_IDLE) | (st.jn_deadline < T_INF)))
        due = want & (st.jn_deadline < t_end)
        now_j = torch.maximum(st.jn_deadline, t0)
        alone = due & ((rp == NO_NODE) | (rp == node_idx)) & (
            st.state == JOINING)
        st = self._become_root(st, alone, now_j, node_idx)
        c_joins = c_joins + alone.to(I32)

        # probe-round evaluation: the deadline passed while PROBING
        eval_p = due & (st.jn_stage == J_PROBE) & st.jn_sent
        got = torch.any(st.jn_rtt < T_INF, 1)
        best_node = st.jn_cands.gather(
            1, torch.argmin(st.jn_rtt, 1, keepdim=True))[:, 0]
        go_down = eval_p & got & (best_node != NO_NODE)
        ob.send(go_down, now_j, torch.clamp(best_node, min=0), NICE_QUERY,
                a=torch.maximum(st.jn_layer - 1, st.jn_target), size_b=16)
        # a deadline expiring in QUERY or JOIN: the counterpart never
        # answered; back to IDLE so the restart below re-enters through
        # the RP this same tick
        stuck = due & ~alone & ((st.jn_stage == J_QUERY)
                                | (st.jn_stage == J_JOIN))
        st = dataclasses.replace(
            st,
            jn_stage=torch.where(go_down, J_QUERY, torch.where(
                (eval_p & ~got) | stuck, J_IDLE, st.jn_stage)),
            jn_deadline=torch.where(due & ~alone,
                                    now_j + int(p.query_interval * NS),
                                    st.jn_deadline))

        # (re)start of the descent: IDLE but wanting a layer → query RP
        restart = (due & ~alone & (st.jn_stage == J_IDLE)
                   & ((st.state == JOINING) | ~st.in_layer[:, 0]
                      | (st.jn_target > 0)))
        ob.send(restart & (rp != NO_NODE), now_j, torch.clamp(rp, min=0),
                NICE_QUERY, a=-1, size_b=16)
        st = dataclasses.replace(
            st, jn_stage=torch.where(restart, J_QUERY, st.jn_stage))

        # a fresh probe round: fire the probes
        fire_p = (st.jn_stage == J_PROBE) & ~st.jn_sent & (st.state != DEAD)
        nd = st.jn_cands
        ob.send(fire_p[:, None] & (nd != NO_NODE) & (nd != node_idx[:, None]),
                t0, torch.clamp(nd, min=0), NICE_PROBE, stamp=t0, size_b=8)
        st = dataclasses.replace(
            st, jn_sent=st.jn_sent | fire_p,
            jn_deadline=torch.where(fire_p, t0 + int(p.probe_wait * NS),
                                    st.jn_deadline))

        # heartbeats: a leader's LEADER_HB with its member list, a
        # member's HB, to every other member of each of its layers
        is_ready = st.state == READY
        en_hb = is_ready & (st.t_hb < t_end)
        now_h = torch.maximum(st.t_hb, t0)
        lead = st.in_layer & (st.leader == node_idx[:, None])    # [N, L]
        nd = st.member                                            # [N, L, C]
        okd = (nd != NO_NODE) & (nd != node_idx[:, None, None])
        lead_c = lead[:, :, None].expand(-1, -1, cmax)
        ob.send((en_hb[:, None, None] & st.in_layer[:, :, None]
                 & okd).reshape(n, -1), now_h,
                torch.clamp(nd, min=0).reshape(n, -1),
                torch.where(lead_c, NICE_LEADER_HB, NICE_HB).reshape(n, -1),
                a=layer_idx[None, :, None].expand(n, -1, cmax).reshape(n, -1),
                nodes=torch.where(lead_c[..., None], nd[:, :, None, :],
                                  NO_NODE).reshape(n, lmax * cmax, cmax),
                size_b=torch.where(lead_c, list_b, 16).reshape(n, -1))
        st = dataclasses.replace(
            st, t_hb=torch.where(en_hb, now_h + hb_ns, st.t_hb))

        # maintenance: evict / split / merge, layer by layer
        en_mt = is_ready & (st.t_maint < t_end)
        now_m = torch.maximum(st.t_maint, t0)
        timeout = int(p.peer_timeout_hbs * p.hb_interval * NS)
        pos = torch.arange(cmax, dtype=I32, device=dev)
        me = node_idx[:, None]
        for li in range(lmax):
            act = en_mt & st.in_layer[:, li]
            lead = act & (st.leader[:, li] == node_idx)
            mem = st.member[:, li]
            stale = ((mem != NO_NODE) & (mem != me)
                     & (now_m[:, None] - st.hb_seen[:, li] > timeout))
            # the leader loses members → clear their slots
            c_evicts = c_evicts + torch.sum((stale & lead[:, None]).to(I32),
                                            1, dtype=I32)
            st = dataclasses.replace(st, member=_with_col(
                st.member, li, torch.where(stale & lead[:, None], NO_NODE,
                                           mem)))
            # a member loses its leader → rejoin this layer through the RP
            is_l = mem == st.leader[:, li:li + 1]
            seen_l = st.hb_seen[:, li].gather(
                1, first_true(is_l)[:, None])[:, 0]
            lost = (act & ~lead & torch.any(is_l, 1)
                    & (now_m - seen_l > timeout))
            st = dataclasses.replace(
                st, in_layer=_with_col(st.in_layer, li,
                                       st.in_layer[:, li] & ~lost),
                jn_stage=torch.where(lost, J_IDLE, st.jn_stage),
                jn_target=torch.where(lost, li, st.jn_target),
                jn_deadline=torch.where(lost, now_m, st.jn_deadline))

            # split past 3k-1 members (ClusterSplit): me and the lowest
            # slots stay, the rest form the new cluster
            mem = st.member[:, li]
            size = torch.sum((mem != NO_NODE).to(I32), 1, dtype=I32)
            do_split = lead & (size > 3 * p.k - 1)
            c_splits = c_splits + do_split.to(I32)
            others = torch.sort(torch.where(
                (mem == NO_NODE) | (mem == me), BIG, mem), 1).values
            others = torch.where(others == BIG, NO_NODE, others)
            n_oth = torch.sum((others != NO_NODE).to(I32), 1, dtype=I32)
            keep = torch.div(size, 2, rounding_mode="floor") - 1
            h1 = others.gather(1, torch.clamp(pos - 1, 0, cmax - 1)
                               .expand(n, -1).long())
            half1 = torch.where(pos == 0, me, torch.where(
                pos[None, :] - 1 < keep[:, None], h1, NO_NODE))
            h2 = others.gather(1, torch.clamp(pos[None, :] + keep[:, None],
                                              0, cmax - 1).long())
            half2 = torch.where(pos[None, :] < (n_oth - keep)[:, None], h2,
                                NO_NODE)
            up = li + 1 < lmax
            lup = min(li + 1, lmax - 1)
            has_up = st.in_layer[:, lup] if up else torch.zeros_like(lead)
            anchor = torch.where(has_up, st.leader[:, lup], node_idx)
            ob.send(do_split[:, None] & (half2 != NO_NODE), now_m,
                    torch.clamp(half2, min=0), NICE_SPLIT, a=li,
                    b=half2[:, 0], c=anchor, nodes=half2, size_b=list_b)
            st = dataclasses.replace(st, member=_with_col(
                st.member, li, torch.where(do_split[:, None], half1, mem)))
            if up:
                # I was the top leader: a fresh upper cluster forms
                # around me
                mkup = do_split & ~has_up
                st = dataclasses.replace(
                    st, in_layer=_with_col(st.in_layer, lup,
                                           st.in_layer[:, lup] | mkup),
                    leader=_with_col(st.leader, lup, torch.where(
                        mkup, node_idx, st.leader[:, lup])),
                    member=_with_col(st.member, lup, torch.where(
                        mkup[:, None], torch.where(pos == 0, me, NO_NODE),
                        st.member[:, lup])),
                    hb_seen=_with_col(st.hb_seen, lup, torch.where(
                        mkup[:, None], now_m[:, None], st.hb_seen[:, lup])))

            # merge under k members (ClusterMerge) into a sibling
            # leader's cluster
            mem = st.member[:, li]
            up_mem = st.member[:, lup]
            peer_ok = (up_mem != NO_NODE) & (up_mem != me)
            peer = up_mem.gather(1, first_true(peer_ok)[:, None])[:, 0]
            do_merge = (lead & (torch.sum((mem != NO_NODE).to(I32), 1) < p.k)
                        & st.in_layer[:, lup] & torch.any(peer_ok, 1)
                        & up)
            ob.send(do_merge, now_m, torch.clamp(peer, min=0), NICE_MERGE,
                    a=li, nodes=mem, size_b=list_b)
            # demote: the absorbing peer owns the merged cluster; we stay
            # a plain member of layer li and leave the layers above
            st = dataclasses.replace(
                st, leader=_with_col(st.leader, li, torch.where(
                    do_merge, peer, st.leader[:, li])),
                in_layer=st.in_layer & ~(do_merge[:, None]
                                         & (layer_idx[None, :] > li)))
        st = dataclasses.replace(
            st, t_maint=torch.where(en_mt, now_m + int(p.maint_interval * NS),
                                    st.t_maint))

        # ALM workload: publish into all own clusters
        is_ready = st.state == READY
        fw = st.fw_h != 0
        pub_due = is_ready & (st.t_pub < t_end)
        en_pub = pub_due & ctx.measuring & ~fw
        now_pb = torch.maximum(st.t_pub, t0)
        seq = st.seq + en_pub.to(I32)
        h = torch.bitwise_left_shift(node_idx.to(I64), 32) | seq.to(I64)
        c_pub = c_pub + en_pub.to(I32)
        st = self._seen_push(st, en_pub, h)
        st = dataclasses.replace(
            st, seq=seq, t_pub=torch.where(
                pub_due, now_pb + int(p.pub_interval * NS), st.t_pub))
        nlayers = torch.sum(st.in_layer.to(I32), 1, dtype=I32)
        ev.value("nice_layers", nlayers.to(F32), en_pub)

        # one dissemination fan-out per tick: my own publish (arrival
        # layer -1) or the re-forward queued by the inbox sweep
        go = fw | en_pub
        g_src = torch.where(fw, st.fw_src, node_idx)
        g_layer = torch.where(fw, st.fw_layer, -1)
        into = (go[:, None] & st.in_layer
                & (layer_idx[None, :] != g_layer[:, None]))      # [N, L]
        nd = st.member
        ob.send((into[:, :, None] & (nd != NO_NODE) & (nd != me[:, :, None])
                 & (nd != g_src[:, None, None])).reshape(n, -1),
                torch.where(fw, t0, now_pb), torch.clamp(nd, min=0)
                .reshape(n, -1), NICE_MCAST,
                a=layer_idx[None, :, None].expand(n, -1, cmax).reshape(n, -1),
                b=torch.where(fw, st.fw_seq, seq),
                c=torch.where(fw, st.fw_origin, node_idx),
                hops=torch.where(fw, st.fw_hops, 0), size_b=60)
        st = dataclasses.replace(
            st, fw_h=torch.where(fw, 0, st.fw_h),
            fw_src=torch.where(fw, NO_NODE, st.fw_src))

        events = {"c:nice_joins": c_joins, "c:nice_pub": c_pub,
                  "c:nice_recv": c_recv, "c:nice_dup": c_dup,
                  "c:nice_splits": c_splits, "c:nice_merges": c_merges,
                  "c:nice_evicts": c_evicts, "c:nice_fwd_drop": c_fwdrop}
        ev.finish(events, {})
        return st, ob, events
