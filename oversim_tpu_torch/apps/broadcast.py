"""BroadcastTestApp: exercises the KBR broadcast API (PyTorch).

Counterpart of ``oversim_tpu/apps/broadcast.py`` (reference
src/tier2/broadcasttestapp: a keyspace-partitioned broadcast through
BaseOverlay::forwardBroadcast, BaseOverlay.h:817-818, measuring how many
nodes each one reaches).

Each node periodically looks up its own key.  That lookup completes at
once (a node is its own sibling), and the completion sends the first
BROADCAST to the node itself with the full circle as its limit; it
loops back through the pool at zero delay and the overlay's BROADCAST
handler (Chord's ``_broadcast``) splits the range over its routing
entries hop by hop.  Every copy received counts ``bcast_received``, the
initiator ``bcast_started``: received / started is the reference's
coverage KPI.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch.apps import base
from oversim_tpu_torch.common import wire

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
NS = 1_000_000_000
T_INF = 2 ** 62


@dataclasses.dataclass(frozen=True)
class BroadcastTestParams:
    """JAX field names and defaults."""

    interval: float = 60.0        # broadcast period per node
    payload_bytes: int = 100


@dataclasses.dataclass
class BroadcastTestState:
    t_test: torch.Tensor   # [N] i64
    seq: torch.Tensor      # [N] i32


class BroadcastTestApp:
    """Tier app (interface: apps/base.py docstring)."""

    def __init__(self, params: BroadcastTestParams = BroadcastTestParams()):
        self.p = params

    def stat_spec(self):
        return dict(scalars=("bcast_hops",), hists=(),
                    counters=("bcast_started", "bcast_received"))

    def init(self, n: int, device="cpu") -> BroadcastTestState:
        return BroadcastTestState(
            t_test=torch.full((n,), T_INF, dtype=I64, device=device),
            seq=torch.zeros((n,), dtype=I32, device=device))

    def glob_init(self, rng):
        return None

    def post_step(self, ctx, state, glob, events):
        return state, glob

    def on_ready(self, app, en, now, rng):
        """``rng`` is one key per node ([N, 2])."""
        off = (rng_mod.uniform(rng, (), F64) * self.p.interval * NS).to(I64)
        return dataclasses.replace(
            app, t_test=torch.where(en, now + off, app.t_test))

    def on_stop(self, app, en):
        return dataclasses.replace(
            app, t_test=torch.where(en, T_INF, app.t_test))

    def on_leave(self, app, en, ctx, ob, ev, now, node_idx, handover):
        return app

    def next_event(self, app):
        return app.t_test

    def on_timer(self, app, en, ctx, now, rng, ev, node_idx):
        """Kick a broadcast: a lookup of the own key, whose completion
        sends the first BROADCAST (the completion hook owns an outbox)."""
        fire = en & (app.t_test < ctx.t_end)
        ev.count("bcast_started", fire & ctx.measuring)
        app = dataclasses.replace(
            app, t_test=torch.where(fire, now + int(self.p.interval * NS),
                                    app.t_test),
            seq=app.seq + fire.to(I32))
        return app, base.LookupReq(want=fire, key=ctx.keys[node_idx.long()],
                                   tag=app.seq)

    def on_lookup_done(self, app, done, ctx, ob, ev, now, node_idx):
        # an own-key lookup resolves locally; the self-send loops back
        # through the pool and the overlay fans it out
        fire = done.en & done.success & (done.results[:, 0] == node_idx)
        ob.send(fire, now, node_idx, wire.BROADCAST,
                key=ctx.keys[node_idx.long()], a=done.tag, b=node_idx,
                hops=0, size_b=self.p.payload_bytes)
        return app

    def on_msg(self, app, m, ctx, ob, ev, is_sib):
        """One inbox slot (fields [N])."""
        en = m.valid & (m.kind == wire.BROADCAST)
        ev.count("bcast_received", en & ctx.measuring)
        ev.value("bcast_hops", m.hops.to(F32), en & ctx.measuring)
        return app

    @property
    def hist_map(self):
        return {}
