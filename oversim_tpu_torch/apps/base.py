"""Tier-app interface: the Common API between overlays and apps (PyTorch).

Counterpart of ``oversim_tpu/apps/base.py``.  An app is a strategy object
the overlay drives from its step; in the port every hook sees the whole
node axis (``[N, ...]`` state, ``[N]`` masks), where the JAX package's
per-node hooks saw one node's slice.  The hooks:

  stat_spec() -> dict(scalars=(), hists=(), counters=())
  init(n, device) -> state of [N, ...] tensors
  glob_init(rng) -> simulation-global state (or None)   # oracle maps
  post_step(ctx, app_state, glob, events) -> (app_state, glob)
      # after the node sweep: fold per-node staging fields into the
      # global part, clear the staging
  on_ready(state, en, now, rng) -> state    # overlay became READY
  on_stop(state, en) -> state               # node left / lost READY
  next_event(state) -> [N] i64              # earliest app timer
  on_timer(state, en, ctx, now, rng, ev, node_idx) -> (state, LookupReq)
      # fire app timers due in the window; at most one lookup per node
  on_lookup_done(state, done, ctx, ob, ev, now, node_idx) -> state
      # one completion per node (``done`` fields [N, ...])
  on_msgs(state, msgs, ctx, ob, ev, is_sib, node_idx=None) -> state
      # the [N, R] inbox's app-owned kinds (wire.py kind >= 30); an app
      # with only the one-slot ``on_msg(state, m, ctx, ob, ev, is_sib)``
      # gets it slot by slot (``on_msgs_fold``)
  on_leave(state, en, ctx, ob, ev, now, node_idx, handover) -> state
      # graceful-leave grace window: hand state to ``handover``

Optional hooks (overlays probe with ``hasattr``):

  on_lookup_done_batch(state, done, ctx, ob, ev, now, node_idx) -> state
      # every completion slot at once (``done`` fields [N, L, ...]);
      # without it the overlay folds the L slots in slot order through
      # ``on_lookup_done`` (``lookup_done_fold``)
  on_update(state, en, ctx, ob, ev, now, node_idx, added, sib_keys=None,
            sib_valid=None, urgent=None) -> state
      # Common API update() (BaseApp.h:223): ``added`` [N, A] lists the
      # nodes that ENTERED each node's sibling/replica set this tick
      # (NO_NODE padded); ``sib_keys`` [N, S, KL] / ``sib_valid`` [N, S]
      # carry the overlay's current sibling view; ``urgent`` [N] marks a
      # delta that must preempt (Chord's new predecessor)
  on_tick(state, ctx, ob, ev, node_idx) -> state
      # every-tick outbox access (paced pumps), from ``leave_protocol``
  timer_event(state) -> [N] i64
      # the events that need an ``on_timer`` dispatch (``next_event``
      # without the every-tick pump sentinel)
  forward(state, msgs, ctx) -> bool of ``msgs.valid``'s shape
      # Common API forward() (BaseApp.h:214): True vetoes the recursive
      # hop of a message routed THROUGH the node (the hop is dropped);
      # ``msgs`` is the [N, R] inbox or one [N] slot (Pastry)

The apps are in this directory; ``apps/stack.py`` composes several.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import tree

I32 = torch.int32
NS = 1_000_000_000


def seconds(dt):
    """ns interval → float32 seconds.  XLA compiles the JAX package's
    ``x.astype(f32) / NS`` as a multiply by the float32 reciprocal, so
    the port multiplies too (a true division differs in the last ulp)."""
    return dt.to(torch.float32) * torch.full(
        (), 1.0 / NS, dtype=torch.float32, device=dt.device)


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


def app_veto(app_obj, app_state, ctx):
    """The app's ``forward()`` veto as ``route.prepass``'s
    ``forward_veto`` (None when the app has no such hook)."""
    if not hasattr(app_obj, "forward"):
        return None
    return lambda msgs: app_obj.forward(app_state, msgs, ctx)


def on_msg_one(app_obj, app_state, m, ctx, ob, ev, sib):
    """One inbox slot (``m`` fields [N, ...], ``sib`` [N]) into the app:
    its one-slot hook when it has one, else ``on_msgs`` on a one-slot
    inbox (as the JAX package's one-slot fallbacks do)."""
    if hasattr(app_obj, "on_msg"):
        return app_obj.on_msg(app_state, m, ctx, ob, ev, sib)
    one = dataclasses.replace(
        m, **{fd.name: getattr(m, fd.name)[:, None]
              for fd in dataclasses.fields(m)})
    return app_obj.on_msgs(app_state, one, ctx, ob, ev, sib[:, None])


def on_msgs_fold(app_obj, app_state, msgs, ctx, ob, ev, is_sib,
                 node_idx=None):
    """The whole ``[N, R]`` inbox (``is_sib`` [N, R]) into the app: its
    batched hook when it has one, else ``on_msg`` on each inbox slot in
    slot order (the JAX overlays' per-slot fold)."""
    if hasattr(app_obj, "on_msgs"):
        return app_obj.on_msgs(app_state, msgs, ctx, ob, ev, is_sib,
                               node_idx=node_idx)
    for r in range(msgs.valid.shape[1]):
        app_state = app_obj.on_msg(app_state, msgs.slot(r), ctx, ob, ev,
                                   is_sib[:, r])
    return app_state


def lookup_done_fold(app_obj, app_state, done: LookupDone, ctx, ob, ev,
                     now, node_idx):
    """The tick's ``[N, L]`` app-lookup completions into the app: its
    batched hook when it has one, else ``on_lookup_done`` on each ``[N]``
    completion column in slot order (the JAX overlays' per-slot fold)."""
    if hasattr(app_obj, "on_lookup_done_batch"):
        return app_obj.on_lookup_done_batch(app_state, done, ctx, ob, ev,
                                            now, node_idx)
    for li in range(done.en.shape[1]):
        app_state = app_obj.on_lookup_done(
            app_state, tree.tree_map(lambda x: x[:, li], done), ctx, ob, ev,
            now, node_idx)
    return app_state


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
