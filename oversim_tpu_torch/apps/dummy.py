"""TierDummy — the no-op tier app (PyTorch, batched).

Counterpart of ``oversim_tpu/apps/dummy.py`` (a rebuild of
src/applications/tierdummy/): it satisfies the tier-app interface
(``apps/base.py``) with no timers and no messages, and is the base of
the gateway's echo apps (``apps/realworld.py``).  Its ``MyApp`` (the
tutorial application) waits for MyOverlay (ROADMAP Queue A item 14(f)).
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch.apps import base

I32 = torch.int32
I64 = torch.int64
T_INF = 2 ** 62


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
