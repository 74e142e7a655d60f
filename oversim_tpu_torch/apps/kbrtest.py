"""KBRTestApp — the reference's benchmark workload (PyTorch, batched).

Counterpart of ``oversim_tpu/apps/kbrtest.py``: periodic tests route a
payload to the key of a random live node; the receiver checks that it is
responsible and records delivery, hop count and latency.  The delivery
ratio delivered/sent is the headline KPI.  One timer round-robins the
enabled modes (one-way, routed RPC, lookup).  Every hook runs over the
whole node axis.

``rcfg`` is set by a recursive-routing overlay (``common/route.py``
RouteConfig): one-way and RPC test payloads then travel as routed data
(``route_policy``), a circular (src, seq) ring of ``msg_handle_buf``
entries screens the duplicates the ACK/reroute path can deliver
(KBRTestApp::checkSeen) and RPC replies take the routing mode's
transport (``route.reply``).  ``on_msg`` is the one-slot deliver hook of
the overlays that dispatch slot by slot (Pastry): it replies direct and
matches a response by its sender, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch.apps import base
from oversim_tpu_torch.common import route as rt_mod
from oversim_tpu_torch.common import wire
from oversim_tpu_torch.engine.logic import put, take

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1
ANY_NODE = -2

M_ONEWAY, M_RPC, M_LOOKUP = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class KbrTestParams:
    test_interval: float = 60.0
    test_msg_bytes: int = 100
    hop_hist_bins: int = 16
    oneway_test: bool = True
    rpc_test: bool = False
    lookup_test: bool = False
    rpc_timeout: float = 10.0
    msg_handle_buf: int = 8

    @property
    def modes(self) -> tuple:
        out = []
        if self.oneway_test:
            out.append(M_ONEWAY)
        if self.rpc_test:
            out.append(M_RPC)
        if self.lookup_test:
            out.append(M_LOOKUP)
        return tuple(out) or (M_ONEWAY,)


@dataclasses.dataclass
class KbrTestState:
    t_test: torch.Tensor     # [N] i64
    seq: torch.Tensor        # [N] i32
    rpc_dst: torch.Tensor    # [N] i32
    rpc_to: torch.Tensor     # [N] i64
    rpc_t0: torch.Tensor     # [N] i64
    rpc_nonce: torch.Tensor  # [N] i32
    seen_src: torch.Tensor   # [N, B] i32
    seen_seq: torch.Tensor   # [N, B] i32
    seen_ptr: torch.Tensor   # [N] i32


class KbrTestApp:
    def __init__(self, params: KbrTestParams = KbrTestParams(), rcfg=None):
        self.p = params
        self.rcfg = rcfg

    @property
    def buf(self) -> int:
        """Width of the duplicate ring: ``msg_handle_buf`` under recursive
        routing, else 0 (the iterative path delivers once).  Read at
        ``init``, after an overlay has bound ``rcfg``."""
        return self.p.msg_handle_buf if self.rcfg is not None else 0

    def route_policy(self, tag):
        """(routable, inner kind, is_rpc) of the requests ``tag`` [N]: the
        one-way and RPC test payloads route as data; the lookup test
        needs a sibling resolution and stays on the lookup engine."""
        mode = torch.div(tag, 2, rounding_mode="floor") % 4
        routable = (mode == M_ONEWAY) | (mode == M_RPC)
        inner = torch.where(mode == M_ONEWAY, wire.APP_ONEWAY,
                            wire.APP_RPC_CALL).to(I32)
        return routable, inner, mode == M_RPC

    def on_route_fired(self, app, fired, now, tag):
        """A recursive overlay routed our APP_RPC_CALL: arm the one
        outstanding call with the ANY_NODE responder wildcard."""
        return dataclasses.replace(
            app, rpc_dst=torch.where(fired, ANY_NODE, app.rpc_dst),
            rpc_to=torch.where(fired, now + int(self.p.rpc_timeout * NS),
                               app.rpc_to),
            rpc_t0=torch.where(fired, now, app.rpc_t0),
            rpc_nonce=torch.where(fired, tag, app.rpc_nonce))

    def _check_seen(self, app, src, seq, cand):
        """Circular (src, seq) duplicate filter (KBRTestApp.cc:458-476)
        over ``cand`` [N, R]: returns (app', dup [N, R]).  Fresh lanes
        enter the ring oldest-first; past ``buf`` fresh lanes in one batch
        the rest are screened but not inserted."""
        b = self.buf
        r = src.shape[1]
        dup_buf = torch.any((app.seen_src[:, None, :] == src[..., None])
                            & (app.seen_seq[:, None, :] == seq[..., None]), -1)
        same = ((src[:, :, None] == src[:, None, :])
                & (seq[:, :, None] == seq[:, None, :]))
        lower = torch.tril(torch.ones((r, r), dtype=torch.bool,
                                      device=src.device), diagonal=-1)
        earlier = torch.any(same & lower & cand[:, None, :], -1)
        dup = cand & (dup_buf | earlier)
        fresh = cand & ~dup
        fi = fresh.to(I32)
        rank = torch.cumsum(fi, 1) - fi
        ins = fresh & (rank < b)
        pos = torch.remainder(app.seen_ptr[:, None] + rank, b)
        app = dataclasses.replace(
            app, seen_src=put(app.seen_src, pos, src, ins),
            seen_seq=put(app.seen_seq, pos, seq, ins),
            seen_ptr=torch.remainder(
                app.seen_ptr + torch.sum(ins, 1, dtype=I32), b))
        return app, dup

    def kpi_spec(self):
        """Telemetry taps (``telemetry.resolve_taps``): the hop count and
        its histogram, the one-way latency and the counters of the
        derived delivery ratio."""
        return ("kbr_hopcount", "kbr_latency_s", "kbr_hop_hist",
                "kbr_sent", "kbr_delivered", "kbr_wrong_node",
                "kbr_lookup_failed")

    def stat_spec(self):
        return dict(
            scalars=("kbr_hopcount", "kbr_latency_s", "kbr_rpc_rtt_s",
                     "kbr_lookup_latency_s"),
            hists=(("kbr_hop_hist", self.p.hop_hist_bins),),
            counters=("kbr_sent", "kbr_delivered", "kbr_wrong_node",
                      "kbr_lookup_failed", "kbr_rpc_sent",
                      "kbr_rpc_success", "kbr_rpc_failed",
                      "kbr_lookups_sent", "kbr_lookup_success",
                      "kbr_lookup_wrong"))

    def init(self, n: int, device="cpu") -> KbrTestState:
        b = self.buf

        def full(shape, v, dt):
            return torch.full(shape, v, dtype=dt, device=device)

        return KbrTestState(
            t_test=full((n,), T_INF, I64), seq=full((n,), 0, I32),
            rpc_dst=full((n,), NO_NODE, I32), rpc_to=full((n,), T_INF, I64),
            rpc_t0=full((n,), 0, I64), rpc_nonce=full((n,), -1, I32),
            seen_src=full((n, b), NO_NODE, I32),
            seen_seq=full((n, b), 0, I32), seen_ptr=full((n,), 0, I32))

    def glob_init(self, rng):
        return None

    def post_step(self, ctx, state, glob, events):
        return state, glob

    def on_ready(self, app, en, now, rng):
        """First test after a uniform offset in [0, interval); ``rng`` is
        one key per node ([N, 2])."""
        off = rng_mod.uniform(rng, (), F64, 0.0, self.p.test_interval)
        t = now + (off * NS).to(I64)
        return dataclasses.replace(app, t_test=torch.where(en, t, app.t_test))

    def on_stop(self, app, en):
        return dataclasses.replace(
            app, t_test=torch.where(en, T_INF, app.t_test),
            rpc_dst=torch.where(en, NO_NODE, app.rpc_dst),
            rpc_to=torch.where(en, T_INF, app.rpc_to))

    def next_event(self, app):
        return torch.minimum(app.t_test, app.rpc_to)

    def on_timer(self, app, en, ctx, now, rng, ev, node_idx):
        modes = self.p.modes
        dev = en.device
        rpc_dead = en & (app.rpc_to < ctx.t_end)
        ev.count("kbr_rpc_failed", rpc_dead & ((app.rpc_nonce % 2) != 0))
        app = dataclasses.replace(
            app, rpc_dst=torch.where(rpc_dead, NO_NODE, app.rpc_dst),
            rpc_to=torch.where(rpc_dead, T_INF, app.rpc_to))
        en = en & (app.t_test < ctx.t_end)
        phase = app.seq % len(modes)
        mode = torch.full_like(app.seq, modes[0])
        for i, m in enumerate(modes[1:], 1):
            mode = torch.where(phase == i, m, mode)
        dest = ctx.sample_ready(rng)
        dest_key = ctx.keys[torch.clamp(dest, min=0).long()]
        want = en & (dest != NO_NODE)
        ev.count("kbr_sent", want & (mode == M_ONEWAY))
        ev.count("kbr_rpc_sent", want & (mode == M_RPC))
        ev.count("kbr_lookups_sent", want & (mode == M_LOOKUP))
        # campaign sweep hook: "app.testMsgInterval" (a float64 tensor)
        # overrides the re-arm interval; the first test's offset
        # (``on_ready``) keeps the static one, as in the JAX package.
        # The JAX tick keeps the traced division a true division
        iv = ctx.ov_get("app.testMsgInterval")
        if iv is None:
            interval_ns = int(self.p.test_interval / len(modes) * NS)
        else:
            interval_ns = (iv / len(modes) * NS).to(I64)
        app2 = dataclasses.replace(
            app, t_test=torch.where(en, now + interval_ns, app.t_test),
            seq=app.seq + en.to(I32))
        return app2, base.LookupReq(
            want=want, key=dest_key,
            tag=(app.seq * 4 + mode) * 2 + ctx.measuring.to(I32))

    def _done(self, app, done, ctx, ob, ev, now, node_idx, batched):
        """Shared body of ``on_lookup_done`` ([N] lanes) and the batched
        hook ([N, L] lanes)."""
        en = done.en
        mode = torch.div(done.tag, 2, rounding_mode="floor") % 4
        meas = (done.tag % 2) != 0
        res = done.results[..., 0]
        suc = done.success & (res != NO_NODE)
        me = node_idx[:, None] if batched else node_idx

        en_1 = en & (mode == M_ONEWAY)
        ev.count("kbr_lookup_failed", en_1 & ~suc)
        ob.send(en_1 & suc & (res != me), now, res, wire.APP_ONEWAY,
                key=done.target, hops=done.hops + 1, a=done.tag,
                c=meas.to(I32), stamp=done.t0, size_b=self.p.test_msg_bytes)
        self_del = en_1 & suc & (res == me)
        ev.count("kbr_delivered", self_del & meas)
        ev.value("kbr_hopcount", done.hops, self_del & meas)
        ev.value("kbr_latency_s", base.seconds(now - done.t0),
                 self_del & meas)

        en_r = en & (mode == M_RPC)
        ev.count("kbr_rpc_failed", en_r & ~suc & meas)
        fire_r = en_r & suc & (res != me)
        ob.send(fire_r, now, res, wire.APP_RPC_CALL, key=done.target,
                a=done.tag, stamp=done.t0, size_b=self.p.test_msg_bytes)
        self_r = en_r & suc & (res == me)
        ev.count("kbr_rpc_success", self_r & meas)
        rpc_to_ns = int(self.p.rpc_timeout * NS)
        if batched:
            l_dim = en.shape[1]
            any_f = torch.any(fire_r, 1)
            last = l_dim - 1 - torch.argmax(
                torch.flip(fire_r, [1]).to(I32), 1)
            sel = torch.clamp(last, 0, l_dim - 1)
            app = dataclasses.replace(
                app,
                rpc_dst=torch.where(any_f, take(res, sel), app.rpc_dst),
                rpc_to=torch.where(any_f, now + rpc_to_ns, app.rpc_to),
                rpc_t0=torch.where(any_f, take(done.t0, sel), app.rpc_t0),
                rpc_nonce=torch.where(any_f, take(done.tag, sel),
                                      app.rpc_nonce))
        else:
            app = dataclasses.replace(
                app,
                rpc_dst=torch.where(fire_r, res, app.rpc_dst),
                rpc_to=torch.where(fire_r, now + rpc_to_ns, app.rpc_to),
                rpc_t0=torch.where(fire_r, done.t0, app.rpc_t0),
                rpc_nonce=torch.where(fire_r, done.tag, app.rpc_nonce))

        en_l = en & (mode == M_LOOKUP)
        rc = torch.clamp(res, min=0).long()
        right = suc & torch.all(ctx.keys[rc] == done.target, -1) \
            & ctx.alive[rc]
        ev.count("kbr_lookup_success", en_l & right & meas)
        ev.count("kbr_lookup_wrong", en_l & suc & ~right & meas)
        ev.count("kbr_lookup_failed", en_l & ~suc & meas)
        ev.value("kbr_lookup_latency_s", base.seconds(now - done.t0),
                 en_l & right & meas)
        return app

    def on_lookup_done(self, app, done: base.LookupDone, ctx, ob, ev, now,
                       node_idx):
        """One completion per node (``done`` fields [N, ...])."""
        return self._done(app, done, ctx, ob, ev, now, node_idx, False)

    def on_lookup_done_batch(self, app, done: base.LookupDone, ctx, ob, ev,
                             now, node_idx):
        """L completions per node (``done`` fields [N, L, ...]); the last
        fired routed RPC wins, like the JAX fold."""
        return self._done(app, done, ctx, ob, ev, now, node_idx, True)

    def on_msgs(self, app, msgs, ctx, ob, ev, is_sib, node_idx=None):
        """Deliver hook over the [N, R] inbox."""
        v = msgs.valid
        en = v & (msgs.kind == wire.APP_ONEWAY)
        if self.buf:
            # screen duplicates before any accounting (checkSeen)
            app, dup = self._check_seen(app, msgs.src, msgs.a, en)
            en = en & ~dup
        good = en & is_sib & (msgs.c != 0)
        ev.count("kbr_delivered", good)
        ev.count("kbr_wrong_node", en & ~is_sib & (msgs.c != 0))
        ev.value("kbr_hopcount", msgs.hops, good)
        ev.value("kbr_latency_s", base.seconds(msgs.t_deliver - msgs.stamp),
                 good)

        en = v & (msgs.kind == wire.APP_RPC_CALL)
        if (self.rcfg is not None and self.rcfg.mode in ("full", "source")
                and node_idx is not None):
            rt_mod.reply(ob, self.rcfg, en, msgs.t_deliver, msgs, ctx,
                         node_idx, wire.APP_RPC_RES, key=msgs.key, a=msgs.a,
                         stamp=msgs.stamp, size_b=wire.BASE_CALL_B)
        else:
            ob.send(en, msgs.t_deliver, msgs.src, wire.APP_RPC_RES,
                    key=msgs.key, a=msgs.a, stamp=msgs.stamp,
                    size_b=wire.BASE_CALL_B)

        en = v & (msgs.kind == wire.APP_RPC_RES) & (
            (msgs.src == app.rpc_dst[:, None])
            | (app.rpc_dst == ANY_NODE)[:, None]) & (
            msgs.a == app.rpc_nonce[:, None])
        en = en & (torch.cumsum(en.to(I32), 1) == 1)
        hit = torch.any(en, 1)
        meas_r = ((app.rpc_nonce % 2) != 0)[:, None]
        ev.count("kbr_rpc_success", en & meas_r)
        ev.value("kbr_rpc_rtt_s", base.seconds(msgs.t_deliver - msgs.stamp),
                 en & meas_r)
        return dataclasses.replace(
            app, rpc_dst=torch.where(hit, NO_NODE, app.rpc_dst),
            rpc_to=torch.where(hit, T_INF, app.rpc_to))

    def on_msg(self, app, m, ctx, ob, ev, is_sib):
        """Deliver hook for one inbox slot per node (``m`` fields [N]):
        the duplicate screen, a direct RPC reply, and an RPC response
        accepted from the recorded responder only."""
        en = m.valid & (m.kind == wire.APP_ONEWAY)
        if self.buf:
            app, dup = self._check_seen(app, m.src[:, None], m.a[:, None],
                                        en[:, None])
            en = en & ~dup[:, 0]
        good = en & is_sib & (m.c != 0)
        ev.count("kbr_delivered", good)
        ev.count("kbr_wrong_node", en & ~is_sib & (m.c != 0))
        ev.value("kbr_hopcount", m.hops, good)
        ev.value("kbr_latency_s", base.seconds(m.t_deliver - m.stamp), good)

        en = m.valid & (m.kind == wire.APP_RPC_CALL)
        ob.send(en, m.t_deliver, m.src, wire.APP_RPC_RES, key=m.key, a=m.a,
                stamp=m.stamp, size_b=wire.BASE_CALL_B)

        en = m.valid & (m.kind == wire.APP_RPC_RES) & (
            m.src == app.rpc_dst) & (m.a == app.rpc_nonce)
        meas_r = (app.rpc_nonce % 2) != 0
        ev.count("kbr_rpc_success", en & meas_r)
        ev.value("kbr_rpc_rtt_s", base.seconds(m.t_deliver - m.stamp),
                 en & meas_r)
        return dataclasses.replace(
            app, rpc_dst=torch.where(en, NO_NODE, app.rpc_dst),
            rpc_to=torch.where(en, T_INF, app.rpc_to))

    def on_leave(self, app, en, ctx, ob, ev, now, node_idx, handover):
        return app

    @property
    def hist_map(self):
        return {"kbr_hopcount": "kbr_hop_hist"}
