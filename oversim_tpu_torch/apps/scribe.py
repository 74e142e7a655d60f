"""Scribe application-level multicast with the ALMTest workload (PyTorch).

Counterpart of ``oversim_tpu/apps/scribe.py`` (reference
src/applications/scribe/Scribe.{h,cc} with the ALMTest driver of
src/applications/almtest folded in).  Scribe is a tier app over any KBR
overlay:

  * on READY each node joins one of ``num_groups`` groups (ALMTest's
    groupNum draw) and subscribes: a lookup resolves the group key to
    its rendezvous root, then ScribeSubscribe goes there directly;
  * a node accepts up to ``children`` subscribers per group; a full
    table redirects the subscriber to its least recently refreshed
    child, which grows a bounded-degree tree (interior nodes are group
    members here, as in the JAX package);
  * publishes route to the root and flood down the child tables,
    TTL-bounded; subscriptions refresh, and silent children are pruned
    after ``child_timeout``.

Every hook runs over the whole node axis.  The app has only the
one-slot ``on_msg``, as the JAX package's: an overlay hands it its inbox
slot by slot (``apps/base.py on_msgs_fold``), so its sends enter the
outbox in slot order, and a slot's four multicast forwards leave as one
four-lane send in child order.  Bool ``argmax`` goes through int32
(first index); the JAX ``mode="drop"`` writes are masked writes.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch.apps import base
from oversim_tpu_torch.common import wire
from oversim_tpu_torch.core import keys as keys_mod
from oversim_tpu_torch.engine.logic import bcast, first_true, one_hot, take

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1

M_SUB, M_PUB = 0, 1     # lookup tag modes


@dataclasses.dataclass(frozen=True)
class ScribeParams:
    """JAX field names and defaults."""

    num_groups: int = 4
    children: int = 4             # child-table capacity per node
    subscribe_refresh: float = 30.0   # parent/subscription refresh
    child_timeout: float = 90.0   # prune silent children (childTimeout)
    publish_interval: float = 30.0    # ALMTest multicast interval
    mcast_ttl: int = 12
    payload_bytes: int = 100


@dataclasses.dataclass
class ScribeState:
    group: torch.Tensor      # [N] i32 joined group (-1 until READY)
    parent: torch.Tensor     # [N] i32 tree parent (NO_NODE: root/unjoined)
    is_root: torch.Tensor    # [N] bool responsible for the group key
    children: torch.Tensor   # [N, G, CH] i32 per-group child tables
    child_seen: torch.Tensor  # [N, G, CH] i64
    t_sub: torch.Tensor      # [N] i64 subscribe/refresh timer
    t_pub: torch.Tensor      # [N] i64 publish timer
    seq: torch.Tensor        # [N] i32


@dataclasses.dataclass
class ScribeGlobal:
    keys: torch.Tensor       # [G, KL] u32 group rendezvous keys


class ScribeApp:
    """Tier app (interface: apps/base.py docstring)."""

    def __init__(self, params: ScribeParams = ScribeParams(),
                 spec: keys_mod.KeySpec = keys_mod.DEFAULT_SPEC):
        self.p = params
        self.spec = spec

    def stat_spec(self):
        return dict(
            scalars=("alm_hops", "alm_latency_s"),
            hists=(),
            counters=("alm_joins", "alm_published", "alm_received",
                      "alm_sub_redirects", "alm_lookup_failed"))

    def _base_fields(self, n, device):
        ch, g = self.p.children, self.p.num_groups

        def full(shape, v, dt):
            return torch.full((n,) + shape, v, dtype=dt, device=device)

        return dict(
            group=full((), -1, I32), parent=full((), NO_NODE, I32),
            is_root=full((), False, torch.bool),
            children=full((g, ch), NO_NODE, I32),
            child_seen=full((g, ch), 0, I64), t_sub=full((), T_INF, I64),
            t_pub=full((), T_INF, I64), seq=full((), 0, I32))

    def init(self, n: int, device="cpu") -> ScribeState:
        return ScribeState(**self._base_fields(n, device))

    def glob_init(self, rng) -> ScribeGlobal:
        return ScribeGlobal(keys=keys_mod.random_keys(
            rng, (self.p.num_groups,), self.spec))

    def post_step(self, ctx, state, glob, events):
        return state, glob

    def on_ready(self, app, en, now, rng):
        """Join a random group and schedule subscribe and publish
        (ALMTest::initializeApp); ``rng`` is one key per node ([N, 2])."""
        r = rng_mod.split(rng)
        g = rng_mod.randint(r[:, 0], (), 0, self.p.num_groups, dtype=I32)
        off = (rng_mod.uniform(r[:, 1], (), F64) * self.p.publish_interval
               * NS).to(I64)
        return dataclasses.replace(
            app, group=torch.where(en, g, app.group),
            t_sub=torch.where(en, now, app.t_sub),
            t_pub=torch.where(en, now + off, app.t_pub))

    def on_stop(self, app, en):
        return dataclasses.replace(
            app, t_sub=torch.where(en, T_INF, app.t_sub),
            t_pub=torch.where(en, T_INF, app.t_pub))

    def on_leave(self, app, en, ctx, ob, ev, now, node_idx, handover):
        return app    # soft state, rebuilt by the refreshes

    def next_event(self, app):
        return torch.minimum(app.t_sub, app.t_pub)

    def on_timer(self, app, en, ctx, now, rng, ev, node_idx):
        """Fire the subscribe refresh or the publish; each resolves the
        group key with an overlay lookup first."""
        p = self.p
        glob: ScribeGlobal = ctx.glob
        # prune silent children (childTimeout)
        stale = (app.children != NO_NODE) & (
            app.child_seen + int(p.child_timeout * NS)
            < bcast(now, app.child_seen))
        app = dataclasses.replace(
            app, children=torch.where(stale, NO_NODE, app.children),
            child_seen=torch.where(stale, 0, app.child_seen))

        sub_due = en & (app.t_sub < ctx.t_end)
        pub_due = en & ~sub_due & (app.t_pub < ctx.t_end)
        mode = torch.where(sub_due, M_SUB, M_PUB).to(I32)
        fire = (sub_due | pub_due) & (app.group >= 0)
        key = glob.keys[torch.clamp(app.group, min=0).long()]
        ev.count("alm_published", fire & pub_due & ctx.measuring)
        app = dataclasses.replace(
            app,
            t_sub=torch.where(sub_due, now + int(p.subscribe_refresh * NS),
                              app.t_sub),
            t_pub=torch.where(pub_due, now + int(p.publish_interval * NS),
                              app.t_pub),
            seq=app.seq + (fire & pub_due).to(I32))
        return app, base.LookupReq(want=fire, key=key,
                                   tag=(app.seq * 4 + mode).to(I32))

    def on_lookup_done(self, app, done: base.LookupDone, ctx, ob, ev, now,
                       node_idx):
        en = done.en
        mode = done.tag % 4
        root = done.results[:, 0]
        suc = done.success & (root != NO_NODE)
        ev.count("alm_lookup_failed", en & ~suc)

        # subscribe: we are the root when the lookup resolves to self
        en_s = en & suc & (mode == M_SUB)
        self_root = en_s & (root == node_idx)
        ev.count("alm_joins", self_root & ~app.is_root)
        app = dataclasses.replace(
            app, is_root=torch.where(en_s, self_root, app.is_root),
            parent=torch.where(self_root, NO_NODE, app.parent))
        ob.send(en_s & ~self_root, now, root, wire.SCRIBE_SUB, a=app.group,
                size_b=wire.BASE_CALL_B + 4)

        # publish: hand the payload to the root (a root floods through
        # its child table when its own send loops back)
        en_p = en & suc & (mode == M_PUB)
        ob.send(en_p, now, root, wire.SCRIBE_MCAST, a=app.group,
                b=torch.div(done.tag, 4, rounding_mode="floor"),
                c=self.p.mcast_ttl, stamp=now, hops=0,
                size_b=self.p.payload_bytes)
        return app

    def _child_add(self, app, en, g, child, now):
        """Add or refresh ``child`` in group row ``g`` (all [N]); returns
        (app, accepted)."""
        p = self.p
        g = torch.clamp(g, 0, p.num_groups - 1)
        row = take(app.children, g)
        match = (row == child[:, None]) & (child != NO_NODE)[:, None]
        have = torch.any(match, 1)
        free = row == NO_NODE
        col = torch.where(have, first_true(match), first_true(free))
        ok = en & (have | torch.any(free, 1))
        at = (one_hot(g, p.num_groups)[:, :, None]
              & one_hot(col, p.children)[:, None, :]
              & bcast(ok, app.children))
        return dataclasses.replace(
            app, children=torch.where(at, bcast(child, at), app.children),
            child_seen=torch.where(at, bcast(now, at), app.child_seen)), ok

    def on_msg(self, app, m, ctx, ob, ev, is_sib):
        """One inbox slot (fields [N])."""
        p = self.p
        now = m.t_deliver

        # ScribeSubscribe: accept as a child, or redirect to a child
        en = m.valid & (m.kind == wire.SCRIBE_SUB)
        mg = torch.clamp(m.a, 0, p.num_groups - 1)
        app, ok = self._child_add(app, en, mg, m.src, now)
        # the least recently refreshed child is the redirect target
        tgt = take(take(app.children, mg),
                   torch.argmin(take(app.child_seen, mg), 1))
        redirect = en & ~ok & (tgt != NO_NODE) & (tgt != m.src)
        ev.count("alm_sub_redirects", redirect)
        col = torch.arange(p.children, device=now.device)
        nodes = torch.where((col == 0) & redirect[:, None], tgt[:, None],
                            NO_NODE).to(I32)
        ob.send(en & (ok | redirect), now, m.src, wire.SCRIBE_SUB_ACK,
                a=m.a, b=redirect.to(I32), nodes=nodes,
                size_b=wire.BASE_CALL_B + 4)

        # SubscribeAck: adopt the parent, or chase the redirect
        en = m.valid & (m.kind == wire.SCRIBE_SUB_ACK) & (m.a == app.group)
        direct = en & (m.b == 0)
        app = dataclasses.replace(
            app, parent=torch.where(direct, m.src, app.parent),
            is_root=torch.where(direct, False, app.is_root))
        red_tgt = m.nodes[:, 0]
        ob.send(en & (m.b != 0) & (red_tgt != NO_NODE), now,
                torch.clamp(red_tgt, min=0), wire.SCRIBE_SUB, a=app.group,
                size_b=wire.BASE_CALL_B + 4)

        # multicast data: deliver to members, forward down the group's
        # child table (forwarders need not be members)
        en = m.valid & (m.kind == wire.SCRIBE_MCAST) & (m.c > 0)
        member = en & (m.a == app.group)
        ev.count("alm_received", member & ctx.measuring)
        ev.value("alm_hops", m.hops.to(F32), member & ctx.measuring)
        ev.value("alm_latency_s", base.seconds(now - m.stamp),
                 member & ctx.measuring)
        kids = take(app.children, mg)
        fwd = en[:, None] & (kids != NO_NODE) & (kids != m.src[:, None])
        ob.send(fwd, now, kids, wire.SCRIBE_MCAST, a=m.a, b=m.b, c=m.c - 1,
                hops=m.hops + 1, stamp=m.stamp, size_b=p.payload_bytes)
        return app

    @property
    def hist_map(self):
        return {}
