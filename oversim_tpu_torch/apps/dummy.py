"""TierDummy and MyApplication — the no-op tier app and the tutorial app
(PyTorch, batched).

Counterpart of ``oversim_tpu/apps/dummy.py`` (rebuilds of
src/applications/tierdummy/ and src/applications/myapplication/).
``TierDummyApp`` satisfies the tier-app interface (``apps/base.py``)
with no timers and no messages, and is the base of the gateway's echo
apps (``apps/realworld.py``).  ``MyApp`` is the tutorial shape that
MyOverlay (``overlay/myoverlay.py``) drives: one timer, one routed
message to a random key, one delivery counter.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch.apps import base
from oversim_tpu_torch.common import wire
from oversim_tpu_torch.core import keys as keys_mod

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62
NO_NODE = -1


@dataclasses.dataclass
class _Empty:
    zero: torch.Tensor    # [N] placeholder (a state needs one leaf)


class TierDummyApp:
    """No-op tier filler (src/applications/tierdummy)."""

    def stat_spec(self):
        return dict(scalars=(), hists=(), counters=())

    def init(self, n: int, device="cpu") -> _Empty:
        return _Empty(zero=torch.zeros((n,), dtype=I32, device=device))

    def glob_init(self, rng):
        return None

    def post_step(self, ctx, state, glob, events):
        return state, glob

    def on_ready(self, app, en, now, rng):
        return app

    def on_stop(self, app, en):
        return app

    def on_leave(self, app, en, ctx, ob, ev, now, node_idx, handover):
        return app

    def next_event(self, app):
        return torch.full(app.zero.shape, T_INF, dtype=I64,
                          device=app.zero.device)

    def on_timer(self, app, en, ctx, now, rng, ev, node_idx):
        n, dev = app.zero.shape[0], app.zero.device
        return app, base.LookupReq(
            want=torch.zeros((n,), dtype=torch.bool, device=dev),
            key=torch.zeros((n, ctx.keys.shape[1]), dtype=I64, device=dev),
            tag=torch.zeros((n,), dtype=I32, device=dev))

    def on_lookup_done(self, app, done, ctx, ob, ev, now, node_idx):
        return app

    def on_msgs(self, app, msgs, ctx, ob, ev, is_sib, node_idx=None):
        return app

    @property
    def hist_map(self):
        return {}


@dataclasses.dataclass(frozen=True)
class MyAppParams:
    interval: float = 60.0       # sendPeriod (tutorial)
    msg_bytes: int = 100


@dataclasses.dataclass
class MyAppState:
    t_send: torch.Tensor   # [N] i64


class MyApp(TierDummyApp):
    """The tutorial application (src/applications/myapplication): send a
    message to a random key every ``interval``; count deliveries."""

    def __init__(self, params: MyAppParams = MyAppParams(),
                 spec: keys_mod.KeySpec = keys_mod.DEFAULT_SPEC):
        self.p = params
        self.spec = spec

    def stat_spec(self):
        return dict(scalars=(), hists=(),
                    counters=("myapp_sent", "myapp_delivered"))

    def init(self, n: int, device="cpu") -> MyAppState:
        return MyAppState(t_send=torch.full((n,), T_INF, dtype=I64,
                                            device=device))

    def on_ready(self, app, en, now, rng):
        """The first send after a uniform offset in [0, interval); ``rng``
        is one key per node ([N, 2])."""
        off = (rng_mod.uniform(rng, (), F64) * self.p.interval * NS).to(I64)
        return dataclasses.replace(
            app, t_send=torch.where(en, now + off, app.t_send))

    def on_stop(self, app, en):
        return dataclasses.replace(
            app, t_send=torch.where(en, T_INF, app.t_send))

    def next_event(self, app):
        return app.t_send

    def on_timer(self, app, en, ctx, now, rng, ev, node_idx):
        fire = en & (app.t_send < ctx.t_end)
        key = keys_mod.random_keys(rng, (), self.spec)
        ev.count("myapp_sent", fire & ctx.measuring)
        app = dataclasses.replace(app, t_send=torch.where(
            fire, now + int(self.p.interval * NS), app.t_send))
        return app, base.LookupReq(
            want=fire, key=key,
            tag=torch.zeros(fire.shape, dtype=I32, device=fire.device))

    def on_lookup_done(self, app, done, ctx, ob, ev, now, node_idx):
        res0 = done.results[:, 0]
        suc = done.en & done.success & (res0 != NO_NODE)
        ob.send(suc & (res0 != node_idx), now, res0, wire.APP_ONEWAY,
                key=done.target, hops=done.hops + 1,
                c=ctx.measuring.to(I32), stamp=done.t0,
                size_b=self.p.msg_bytes)
        ev.count("myapp_delivered", suc & (res0 == node_idx) & ctx.measuring)
        return app

    def on_msg(self, app, m, ctx, ob, ev, is_sib):
        """One inbox slot (fields [N]): a delivered payload counts."""
        ev.count("myapp_delivered", m.valid & (m.kind == wire.APP_ONEWAY)
                 & (m.c != 0) & is_sib)
        return app

    def on_msgs(self, app, msgs, ctx, ob, ev, is_sib, node_idx=None):
        """Every inbox slot at once (``on_msg`` sends nothing, so the
        count over the ``[N, R]`` slots is the per-slot fold's)."""
        return self.on_msg(app, msgs, ctx, ob, ev, is_sib)
