"""P2PNS: a P2P name service, register and resolve with a cache (PyTorch).

Counterpart of ``oversim_tpu/apps/p2pns.py`` (reference
src/tier2/p2pns/P2pns.{h,cc}: a SIP/DNS-style name service over KBR,
P2pns.h:45-99), a tier app over any KBR overlay:

  * every node owns one name, its slot's entry in the global name table
    (``P2pnsGlobal.name_keys``);
  * register: on READY and every ``keepalive`` seconds, resolve the
    name's key and store the binding (name id -> own slot) at the
    responsible node with ``record_ttl``;
  * resolve: every ``resolve_interval``, pick a random READY node and
    resolve its name, from the local cache when it holds a live entry,
    else by a lookup and a ResolveCall to the responsible node; an
    answer equal to the true owner succeeds and fills the cache for
    ``cache_ttl``;
  * a graceful leave hands the first stored binding to the successor.

Every hook runs over the whole node axis; the app has only the one-slot
``on_msg`` (an overlay folds its inbox slot by slot).  Bool ``argmax``
goes through int32 and an int64 ``argmin`` takes the first index on
ties, as JAX's; the JAX ``mode="drop"`` writes are masked writes.  The
XML-RPC surface (``xmlrpcif.py``) is not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch.apps import base
from oversim_tpu_torch.common import wire
from oversim_tpu_torch.core import keys as keys_mod
from oversim_tpu_torch.engine.logic import first_true, one_hot, take

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1
NO_VAL = -1

M_REG, M_RESOLVE = 0, 1
OP_NONE, OP_REG, OP_RESOLVE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class P2pnsParams:
    """JAX field names and defaults."""

    keepalive: float = 120.0      # re-register interval
    resolve_interval: float = 30.0
    record_ttl: float = 300.0     # stored binding TTL
    cache_ttl: float = 60.0       # resolved-binding cache TTL
    cache_size: int = 8
    storage_slots: int = 16
    op_timeout: float = 10.0


@dataclasses.dataclass
class P2pnsState:
    # stored bindings at the responsible node
    r_name: torch.Tensor    # [N, D] i32 name id (-1 empty)
    r_val: torch.Tensor     # [N, D] i32
    r_expire: torch.Tensor  # [N, D] i64
    # local resolution cache
    c_name: torch.Tensor    # [N, C] i32
    c_val: torch.Tensor     # [N, C] i32
    c_expire: torch.Tensor  # [N, C] i64
    # timers and the one outstanding operation
    t_reg: torch.Tensor     # [N] i64
    t_res: torch.Tensor     # [N] i64
    op: torch.Tensor        # [N] i32
    op_seq: torch.Tensor    # [N] i32
    op_name: torch.Tensor   # [N] i32 name id being registered/resolved
    op_expect: torch.Tensor  # [N] i32 true owner of a pending resolve
    op_to: torch.Tensor     # [N] i64
    op_t0: torch.Tensor     # [N] i64
    seq: torch.Tensor       # [N] i32


@dataclasses.dataclass
class P2pnsGlobal:
    name_keys: torch.Tensor   # [N, KL] u32: slot i owns name i


class P2pnsApp:
    """Tier-2 app (interface: apps/base.py docstring)."""

    def __init__(self, params: P2pnsParams = P2pnsParams(),
                 spec: keys_mod.KeySpec = keys_mod.DEFAULT_SPEC,
                 num_slots: int = 0):
        if num_slots <= 0:
            raise ValueError("P2pnsApp needs num_slots (= engine slots) "
                             "for the global name table")
        self.p = params
        self.spec = spec
        self.n = num_slots

    def stat_spec(self):
        return dict(
            scalars=("p2pns_resolve_latency_s",),
            hists=(),
            counters=("p2pns_registers", "p2pns_resolves",
                      "p2pns_cache_hits", "p2pns_resolve_success",
                      "p2pns_resolve_failed", "p2pns_stored"))

    def init(self, n: int, device="cpu") -> P2pnsState:
        p = self.p

        def full(shape, v, dt):
            return torch.full((n,) + shape, v, dtype=dt, device=device)

        d, c = (p.storage_slots,), (p.cache_size,)
        return P2pnsState(
            r_name=full(d, -1, I32), r_val=full(d, NO_VAL, I32),
            r_expire=full(d, 0, I64), c_name=full(c, -1, I32),
            c_val=full(c, NO_VAL, I32), c_expire=full(c, 0, I64),
            t_reg=full((), T_INF, I64), t_res=full((), T_INF, I64),
            op=full((), OP_NONE, I32), op_seq=full((), 0, I32),
            op_name=full((), -1, I32), op_expect=full((), NO_VAL, I32),
            op_to=full((), T_INF, I64), op_t0=full((), 0, I64),
            seq=full((), 0, I32))

    def glob_init(self, rng) -> P2pnsGlobal:
        return P2pnsGlobal(name_keys=keys_mod.random_keys(
            rng, (self.n,), self.spec))

    def post_step(self, ctx, state, glob, events):
        return state, glob

    def on_ready(self, app, en, now, rng):
        """``rng`` is one key per node ([N, 2])."""
        off = (rng_mod.uniform(rng, (), F64) * self.p.resolve_interval
               * NS).to(I64)
        return dataclasses.replace(
            app, t_reg=torch.where(en, now, app.t_reg),
            t_res=torch.where(en, now + off, app.t_res))

    def on_stop(self, app, en):
        return dataclasses.replace(
            app, t_reg=torch.where(en, T_INF, app.t_reg),
            t_res=torch.where(en, T_INF, app.t_res),
            op=torch.where(en, OP_NONE, app.op),
            op_to=torch.where(en, T_INF, app.op_to))

    def on_leave(self, app, en, ctx, ob, ev, now, node_idx, handover):
        """Hand the first stored binding to the successor, as the DHT
        hands its records over."""
        en = en & (handover != NO_NODE) & (handover != node_idx)
        valid = app.r_name >= 0
        has = en & torch.any(valid, 1)
        col = first_true(valid)
        ob.send(has, now, handover, wire.P2PNS_REG_CALL,
                a=take(app.r_name, col), b=take(app.r_val, col),
                stamp=take(app.r_expire, col),
                size_b=wire.BASE_CALL_B + 12)
        drop = one_hot(col, self.p.storage_slots) & has[:, None]
        return dataclasses.replace(
            app, r_name=torch.where(drop, -1, app.r_name))

    def next_event(self, app):
        return torch.minimum(torch.minimum(app.t_reg, app.t_res), app.op_to)

    def on_timer(self, app, en, ctx, now, rng, ev, node_idx):
        p = self.p
        glob: P2pnsGlobal = ctx.glob

        to = en & (app.op != OP_NONE) & (app.op_to < ctx.t_end)
        ev.count("p2pns_resolve_failed", to & (app.op == OP_RESOLVE))
        app = dataclasses.replace(
            app, op=torch.where(to, OP_NONE, app.op),
            op_to=torch.where(to, T_INF, app.op_to))

        idle = app.op == OP_NONE
        # a due timer always advances, even with an operation in flight
        # (a stale timer would pin the event horizon); the action waits
        # for the next period
        reg_hit = en & (app.t_reg < ctx.t_end)
        res_hit = en & (app.t_res < ctx.t_end)
        reg_due = reg_hit & idle
        res_due = res_hit & ~reg_due & idle

        # resolve target: a random READY node's name; the cache first
        tgt = ctx.sample_ready(rng)
        tgt_ok = tgt != NO_NODE
        chit_mask = ((app.c_name == tgt[:, None])
                     & (app.c_expire > now[:, None]) & tgt_ok[:, None])
        chit = res_due & torch.any(chit_mask, 1)
        cval = take(app.c_val, first_true(chit_mask))
        ev.count("p2pns_resolves", res_due & tgt_ok)
        ev.count("p2pns_cache_hits", chit)
        ev.count("p2pns_resolve_success",
                 chit & (cval == tgt) & ctx.measuring)
        ev.count("p2pns_registers", reg_due)

        fire_reg = reg_due
        fire_res = res_due & tgt_ok & ~chit
        fire = fire_reg | fire_res
        name_id = torch.where(fire_reg, node_idx, tgt)
        # a slot past the name table clamps, as JAX's gather does
        lk_key = glob.name_keys[torch.clamp(name_id, 0, self.n - 1).long()]
        app = dataclasses.replace(
            app,
            t_reg=torch.where(reg_hit, now + int(p.keepalive * NS),
                              app.t_reg),
            t_res=torch.where(res_hit, now + int(p.resolve_interval * NS),
                              app.t_res),
            op=torch.where(fire_reg, OP_REG, torch.where(
                fire_res, OP_RESOLVE, app.op)).to(I32),
            op_seq=torch.where(fire, app.seq, app.op_seq),
            op_name=torch.where(fire, name_id, app.op_name),
            op_expect=torch.where(fire_res, tgt, app.op_expect),
            op_to=torch.where(fire, now + int(p.op_timeout * NS), app.op_to),
            op_t0=torch.where(fire, now, app.op_t0),
            seq=app.seq + fire.to(I32))
        mode = torch.where(fire_reg, M_REG, M_RESOLVE)
        return app, base.LookupReq(want=fire, key=lk_key,
                                   tag=(app.op_seq * 4 + mode).to(I32))

    def on_lookup_done(self, app, done: base.LookupDone, ctx, ob, ev, now,
                       node_idx):
        p = self.p
        resp = done.results[:, 0]
        en = done.en & (app.op != OP_NONE) & (
            torch.div(done.tag, 4, rounding_mode="floor") == app.op_seq)
        suc = done.success & (resp != NO_NODE)
        fail = en & ~suc
        ev.count("p2pns_resolve_failed", fail & (app.op == OP_RESOLVE))
        app = dataclasses.replace(
            app, op=torch.where(fail, OP_NONE, app.op),
            op_to=torch.where(fail, T_INF, app.op_to))

        # register: store the binding at the responsible node
        en_r = en & suc & (app.op == OP_REG)
        ob.send(en_r, now, resp, wire.P2PNS_REG_CALL, a=node_idx,
                b=node_idx, stamp=now + int(p.record_ttl * NS),
                size_b=wire.BASE_CALL_B + 12)
        app = dataclasses.replace(
            app, op=torch.where(en_r, OP_NONE, app.op),
            op_to=torch.where(en_r, T_INF, app.op_to))

        # resolve: query the responsible node
        en_v = en & suc & (app.op == OP_RESOLVE)
        ob.send(en_v, now, resp, wire.P2PNS_RES_CALL, a=app.op_name,
                b=app.op_seq, size_b=wire.BASE_CALL_B + 8)
        return app

    def _cache_put(self, app, en, name, val, now):
        match = (app.c_name == name[:, None]) & (name >= 0)[:, None]
        have = torch.any(match, 1)
        oldest = torch.argmin(app.c_expire, 1)       # oldest or empty
        col = torch.where(have, first_true(match), oldest)
        at = one_hot(col, self.p.cache_size) & en[:, None]
        return dataclasses.replace(
            app, c_name=torch.where(at, name[:, None], app.c_name),
            c_val=torch.where(at, val[:, None], app.c_val),
            c_expire=torch.where(
                at, (now + int(self.p.cache_ttl * NS))[:, None],
                app.c_expire))

    def on_msg(self, app, m, ctx, ob, ev, is_sib):
        """One inbox slot (fields [N])."""
        now = m.t_deliver

        # RegisterCall: store the binding (the same name, else a free
        # slot, else the earliest expiry)
        en = m.valid & (m.kind == wire.P2PNS_REG_CALL)
        same = (app.r_name == m.a[:, None]) & (m.a >= 0)[:, None]
        free = app.r_name < 0
        col = torch.where(torch.any(same, 1), first_true(same), torch.where(
            torch.any(free, 1), first_true(free),
            torch.argmin(app.r_expire, 1)))
        at = one_hot(col, self.p.storage_slots) & en[:, None]
        app = dataclasses.replace(
            app, r_name=torch.where(at, m.a[:, None], app.r_name),
            r_val=torch.where(at, m.b[:, None], app.r_val),
            r_expire=torch.where(at, m.stamp[:, None], app.r_expire))
        ev.count("p2pns_stored", en)
        # b echoes the caller's nonce (an external register matches its
        # answer on it)
        ob.send(en, now, m.src, wire.P2PNS_REG_RES, a=m.a, b=m.b,
                size_b=wire.BASE_CALL_B)

        # ResolveCall: probe the storage
        en = m.valid & (m.kind == wire.P2PNS_RES_CALL)
        hit = ((app.r_name == m.a[:, None]) & (m.a >= 0)[:, None]
               & (app.r_expire > now[:, None]))
        val = torch.where(torch.any(hit, 1),
                          take(app.r_val, first_true(hit)), NO_VAL)
        ob.send(en, now, m.src, wire.P2PNS_RES_RES, a=m.a, b=m.b, c=val,
                size_b=wire.BASE_CALL_B + 4)

        # ResolveResponse: hold it to the true owner, fill the cache
        en = (m.valid & (m.kind == wire.P2PNS_RES_RES)
              & (app.op == OP_RESOLVE) & (m.b == app.op_seq))
        good = en & (m.c == app.op_expect) & (m.c != NO_VAL)
        ev.count("p2pns_resolve_success", good & ctx.measuring)
        ev.count("p2pns_resolve_failed", en & ~good)
        ev.value("p2pns_resolve_latency_s", base.seconds(now - app.op_t0),
                 good & ctx.measuring)
        app = self._cache_put(app, good, m.a, m.c, now)
        return dataclasses.replace(
            app, op=torch.where(en, OP_NONE, app.op),
            op_to=torch.where(en, T_INF, app.op_to))

    @property
    def hist_map(self):
        return {}
