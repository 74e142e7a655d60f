"""Tier-app interface: the Common API between overlays and apps (PyTorch).

Counterpart of ``oversim_tpu/apps/base.py``.  An app is a strategy object
the overlay drives from its step; in the port every hook sees the whole
node axis (``[N, ...]`` state, ``[N]`` masks), where the JAX package's
per-node hooks saw one node's slice.  See the JAX module for the hook
list; the port's main path app is ``apps/kbrtest.py``.
"""

from __future__ import annotations

import dataclasses

import torch

I32 = torch.int32


@dataclasses.dataclass
class LookupReq:
    """The app asks the overlay to resolve ``key`` ([N] batched)."""

    want: torch.Tensor       # [N] bool
    key: torch.Tensor        # [N, KL]
    tag: torch.Tensor        # [N] i32


@dataclasses.dataclass
class LookupDone:
    """Completion of app lookups; ``[N]`` or ``[N, L]`` batched."""

    en: torch.Tensor
    success: torch.Tensor
    tag: torch.Tensor
    target: torch.Tensor     # [..., KL]
    results: torch.Tensor    # [..., R] i32
    hops: torch.Tensor
    t0: torch.Tensor


def leave_protocol(app_obj, app_state, ctx, ob, ev, t0, node_idx,
                   handover, ready):
    """Per-tick app housekeeping shared by every overlay step."""
    if hasattr(app_obj, "on_tick"):
        app_state = app_obj.on_tick(app_state, ctx, ob, ev, node_idx)
    ni = node_idx.long()
    app_state = app_obj.on_leave(app_state, ctx.graceful[ni] & ready, ctx,
                                 ob, ev, t0, node_idx, handover)
    return app_obj.on_stop(app_state, ctx.leaving[ni] & ready)


class AppEvents:
    """Accumulates per-node stat events over an overlay step.

    ``count`` folds a ``[N]`` or ``[N, B]`` increment into an ``[N]``
    counter; ``value`` appends ``[N, B]`` (value, mask) columns in call
    order, so the finished events are ``[N, V]`` exactly like the JAX
    package's vmapped ``[V]`` per-node events."""

    def __init__(self, n: int, device):
        self.n = n
        self.device = device
        self._counts: dict = {}
        self._vals: dict = {}

    def count(self, name: str, inc):
        inc = inc.to(I32)
        if inc.dim() > 1:
            inc = torch.sum(inc, dim=tuple(range(1, inc.dim())), dtype=I32)
        prev = self._counts.get(name)
        self._counts[name] = inc if prev is None else prev + inc

    def value(self, name: str, val, mask):
        val = val.to(torch.float32).reshape(self.n, -1)
        mask = torch.broadcast_to(mask.reshape(self.n, -1), val.shape)
        self._vals.setdefault(name, []).append((val, mask))

    def finish(self, events: dict, hist_bins: dict | None = None):
        for name, v in self._counts.items():
            prev = events.get("c:" + name)
            events["c:" + name] = v if prev is None else prev + v
        for name, pairs in self._vals.items():
            vals = torch.cat([p[0] for p in pairs], dim=1)
            mask = torch.cat([p[1] for p in pairs], dim=1)
            events["s:" + name] = (vals, mask)
            if hist_bins and name in hist_bins:
                events["h:" + hist_bins[name]] = (vals.to(I32), mask)
        return events
