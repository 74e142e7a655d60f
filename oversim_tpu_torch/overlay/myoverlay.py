"""MyOverlay — the tutorial overlay skeleton (PyTorch, batched).

Counterpart of ``oversim_tpu/overlay/myoverlay.py`` (a rebuild of
src/overlay/myoverlay/, the website tutorial's minimal example): ring
routing with one successor pointer.

  * join: draw a bootstrap peer and greedy-walk RING_JOIN messages
    clockwise until the responsible node adopts the joiner;
  * routing: a key in (pred, me] is mine, else it goes to the successor
    (O(N) hops, deliberately naive);
  * maintenance: a periodic HELLO to the successor.

The step runs over the leading ``[N]`` axis with the JAX package's
operations, its inbox slots one after another, and hands each slot to
the app through ``apps/base.py on_msg_one`` (the app's one-slot hook).
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch import stats as stats_mod
from oversim_tpu_torch.apps import base as app_base
from oversim_tpu_torch.apps.dummy import MyApp
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

RING_JOIN = 140      # a=joiner
RING_JOIN_ACK = 141  # a=your new successor
RING_HELLO = 142


@dataclasses.dataclass(frozen=True)
class MyOverlayParams:
    join_delay: float = 10.0
    hello_interval: float = 20.0


@dataclasses.dataclass
class MyOverlayState:
    state: torch.Tensor    # [N] i32
    succ: torch.Tensor     # [N] i32, the one routing pointer
    pred: torch.Tensor     # [N] i32
    t_join: torch.Tensor   # [N] i64
    t_hello: torch.Tensor  # [N] i64
    app: object
    app_glob: object


class MyOverlayLogic:
    """Engine logic interface (see engine/logic.py)."""

    def __init__(self, spec: K.KeySpec = K.DEFAULT_SPEC,
                 params: MyOverlayParams = MyOverlayParams(), app=None):
        self.key_spec = spec
        self.p = params
        self.app = app or MyApp()

    def stat_spec(self):
        a = self.app.stat_spec()
        return stats_mod.StatSpec(
            scalars=tuple(a["scalars"]) + ("ring_hops",),
            hists=tuple(a["hists"]),
            counters=tuple(a["counters"]) + ("ring_joins",))

    def split(self, st):
        return dataclasses.replace(st, app_glob=None), st.app_glob

    def merge(self, node_part, glob):
        return dataclasses.replace(node_part, app_glob=glob)

    def post_step(self, ctx, st, events):
        app, glob = self.app.post_step(ctx, st.app, st.app_glob, events)
        return dataclasses.replace(st, app=app, app_glob=glob)

    def init(self, rng, n: int) -> MyOverlayState:
        dev = rng.device

        def full(v, dt):
            return torch.full((n,), v, dtype=dt, device=dev)

        return MyOverlayState(
            state=full(DEAD, I32), succ=full(NO_NODE, I32),
            pred=full(NO_NODE, I32), t_join=full(T_INF, I64),
            t_hello=full(T_INF, I64), app=self.app.init(n, dev),
            app_glob=self.app.glob_init(rng))

    def reset(self, st, clear, join, t_now, rng):
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

    def ready_mask(self, st):
        return st.state == READY

    def next_event(self, st):
        ready = st.state == READY
        t = torch.where(st.state == JOINING, st.t_join, T_INF)
        t = torch.minimum(t, torch.where(ready, st.t_hello, T_INF))
        return torch.minimum(t, torch.where(
            ready, self.app.next_event(st.app), T_INF))

    def _is_mine(self, ctx, st, me_key, key):
        pk = keys_of(ctx, torch.clamp(st.pred, min=0))
        return (st.state == READY) & ((st.pred == NO_NODE) | K.is_between_r(
            key, pk, me_key, self.key_spec))

    def step(self, ctx, st, msgs, rng, node_idx, *, outbox_slots, rmax):
        p, spec = self.p, self.key_spec
        n = st.state.shape[0]
        dev = st.state.device
        ob = Outbox(n, outbox_slots, spec.lanes, rmax, dev)
        me_key = ctx.keys[node_idx.long()]
        rngs = rng_mod.split(rng, 4)                              # [N, 4, 2]
        t0, t_end = ctx.t_start, ctx.t_end
        ev = app_base.AppEvents(n, dev)
        joins = torch.zeros((n,), dtype=I32, device=dev)

        for r in range(msgs.valid.shape[1]):
            m = msgs.slot(r)
            now = m.t_deliver
            v = m.valid

            # RING_JOIN: adopt the joiner as predecessor if its key is
            # ours to cover, else pass it clockwise
            en = v & (m.kind == RING_JOIN) & (st.state == READY)
            mine = self._is_mine(ctx, st, me_key,
                                 keys_of(ctx, torch.clamp(m.a, min=0)))
            adopt = en & mine
            ob.send(adopt, now, m.a, RING_JOIN_ACK, a=node_idx, b=st.pred,
                    size_b=16)
            ob.send(en & ~mine & (st.succ != NO_NODE), now,
                    torch.clamp(st.succ, min=0), RING_JOIN, a=m.a,
                    hops=m.hops + 1, size_b=16)
            st = dataclasses.replace(st, pred=torch.where(adopt, m.a,
                                                          st.pred))

            # RING_JOIN_ACK: my successor is the adopter
            en = v & (m.kind == RING_JOIN_ACK) & (st.state == JOINING)
            joins = joins + en.to(I32)
            st = dataclasses.replace(
                st, succ=torch.where(en, m.src, st.succ),
                pred=torch.where(en & (m.b != NO_NODE), m.b, st.pred),
                state=torch.where(en, READY, st.state),
                t_join=torch.where(en, T_INF, st.t_join),
                t_hello=torch.where(en, now, st.t_hello),
                app=self.app.on_ready(st.app, en, now, rngs[:, 0]))
            # tell the old predecessor its successor changed
            ob.send(en & (m.b != NO_NODE), now, torch.clamp(m.b, min=0),
                    RING_HELLO, a=node_idx, size_b=16)

            # RING_HELLO: adopt a closer successor
            en = v & (m.kind == RING_HELLO) & (st.state == READY)
            closer = en & (m.a != NO_NODE) & (
                (st.succ == NO_NODE) | K.is_between(
                    keys_of(ctx, torch.clamp(m.a, min=0)), me_key,
                    keys_of(ctx, torch.clamp(st.succ, min=0)), spec))
            st = dataclasses.replace(st, succ=torch.where(closer, m.a,
                                                          st.succ))

            # routed payload: deliver when responsible (the app checks
            # the is_sib flag), else forward clockwise
            en = v & (m.kind == wire.APP_ONEWAY) & (st.state == READY)
            mine = self._is_mine(ctx, st, me_key, m.key)
            ev.value("ring_hops", m.hops.to(F32), en & mine)
            ob.send(en & ~mine & (st.succ != NO_NODE), now,
                    torch.clamp(st.succ, min=0), wire.APP_ONEWAY, key=m.key,
                    c=m.c, stamp=m.stamp, hops=m.hops + 1, size_b=m.size_b)
            st = dataclasses.replace(st, app=app_base.on_msg_one(
                self.app, st.app, m, ctx, ob, ev, mine))

        # join timer
        en_j = (st.state == JOINING) & (st.t_join < t_end)
        now_j = torch.maximum(st.t_join, t0)
        boot = ctx.sample_ready(rngs[:, 1], node_idx)
        alone = en_j & (boot == NO_NODE)
        joins = joins + alone.to(I32)
        st = dataclasses.replace(
            st, state=torch.where(alone, READY, st.state),
            t_hello=torch.where(alone, now_j, st.t_hello),
            app=self.app.on_ready(st.app, alone, now_j, rngs[:, 2]),
            t_join=torch.where(en_j & ~alone, now_j + int(p.join_delay * NS),
                               st.t_join))
        ob.send(en_j & ~alone, now_j, torch.clamp(boot, min=0), RING_JOIN,
                a=node_idx, hops=0, size_b=16)

        # hello timer
        en_h = (st.state == READY) & (st.t_hello < t_end)
        now_h = torch.maximum(st.t_hello, t0)
        ob.send(en_h & (st.succ != NO_NODE), now_h,
                torch.clamp(st.succ, min=0), RING_HELLO, a=node_idx,
                size_b=16)
        st = dataclasses.replace(st, t_hello=torch.where(
            en_h, now_h + int(p.hello_interval * NS), st.t_hello))

        # app timer: route the payload clockwise from here
        st = dataclasses.replace(st, app=app_base.leave_protocol(
            self.app, st.app, ctx, ob, ev, t0, node_idx, st.succ,
            st.state == READY))
        t_app = self.app.next_event(st.app)
        en_a = (st.state == READY) & (t_app < t_end)
        now_a = torch.maximum(t_app, t0)
        app, req = self.app.on_timer(st.app, en_a, ctx, now_a, rngs[:, 3],
                                     ev, node_idx)
        st = dataclasses.replace(st, app=app)
        mine = self._is_mine(ctx, st, me_key, req.key)
        # local: complete through the app hook; remote: ship clockwise
        res = torch.full((n, 4), NO_NODE, dtype=I32, device=dev)
        res[:, 0] = node_idx
        st = dataclasses.replace(st, app=self.app.on_lookup_done(
            st.app, app_base.LookupDone(
                en=req.want & mine, success=req.want & mine, tag=req.tag,
                target=req.key, results=res,
                hops=torch.zeros((n,), dtype=I32, device=dev), t0=now_a),
            ctx, ob, ev, now_a, node_idx))
        ob.send(req.want & ~mine & (st.succ != NO_NODE), now_a,
                torch.clamp(st.succ, min=0), wire.APP_ONEWAY, key=req.key,
                c=ctx.measuring.to(I32), stamp=now_a, hops=1, size_b=100)

        events = {"c:ring_joins": joins}
        ev.finish(events, self.app.hist_map)
        return st, ob, events
