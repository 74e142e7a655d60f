"""TierStack — several tier apps over one overlay (PyTorch).

Counterpart of ``oversim_tpu/apps/stack.py`` (the reference's ITier
plugins, SimpleOverlayHost.ned:14-100, tier1Type/tier2Type/tier3Type in
default.ini:622-628).  A :class:`TierStack` is itself an app
(``apps/base.py``) that delegates to an ordered tuple of member apps, so
any overlay hosts any combination:

  * state and glob are tuples of the members' states and globs;
  * inbound messages go to every member in order (apps filter their own
    wire kinds); a member with the batched ``on_msgs`` gets the whole
    ``[N, R]`` inbox, one with only ``on_msg`` gets it slot by slot;
  * lookups multiplex on the tag, ``tag * T + tier``: a completion, a
    route policy and a fired route go back to the owning tier;
  * one lookup per node per window: when several tiers' timers are due,
    the earliest (``timer_event`` where a member has it, else
    ``next_event``; the first tier on ties) fires and the others keep
    their timers for the next tick;
  * the optional hooks (``forward``, ``on_update``, ``on_tick``,
    ``on_msgs``, ``route_policy``/``on_route_fired``) exist on the stack
    only when a member has them, since the overlays probe with
    ``hasattr``; the stack adds no hook the JAX stack lacks.

Stat names must be disjoint across members.  Every hook runs over the
whole node axis; ``glob_init``, ``on_ready`` and ``on_timer`` split
their key into one subkey per member, as the JAX stack does.
"""

from __future__ import annotations

import dataclasses
import inspect

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch.apps import base

I32 = torch.int32


class TierStack:
    """Composite tier app (interface: apps/base.py docstring)."""

    def __init__(self, apps):
        if not apps:
            raise ValueError("TierStack needs at least one app")
        self.apps = tuple(apps)
        # optional hooks mirror the members (hasattr probing)
        if any(hasattr(a, "on_msgs") for a in self.apps):
            self.on_msgs = self._on_msgs
        if any(hasattr(a, "forward") for a in self.apps):
            self.forward = self._forward
        if any(hasattr(a, "on_update") for a in self.apps):
            self.on_update = self._on_update
        if any(hasattr(a, "on_tick") for a in self.apps):
            self.on_tick = self._on_tick
        if any(hasattr(a, "route_policy") for a in self.apps):
            self.route_policy = self._route_policy
            self.on_route_fired = self._on_route_fired
        names = [n for a in self.apps for n in a.stat_spec()["counters"]]
        if len(names) != len(set(names)):
            raise ValueError("stacked apps must have disjoint stat names")

    # overlays bind ``app.rcfg``: fan it out
    @property
    def rcfg(self):
        return getattr(self.apps[0], "rcfg", None)

    @rcfg.setter
    def rcfg(self, value):
        for a in self.apps:
            if hasattr(a, "rcfg"):
                a.rcfg = value

    # ring overlays bind ``app.dist_fn`` (their responsibility metric):
    # None while any member still waits for it, so the overlay's probe
    # fires and the setter fans out
    @property
    def dist_fn(self):
        if any(getattr(a, "dist_fn", "set") is None for a in self.apps):
            return None
        return getattr(self.apps[0], "dist_fn", None)

    @dist_fn.setter
    def dist_fn(self, value):
        for a in self.apps:
            if getattr(a, "dist_fn", "set") is None:
                a.dist_fn = value

    def stat_spec(self):
        out = dict(scalars=(), hists=(), counters=())
        for a in self.apps:
            s = a.stat_spec()
            for k in out:
                out[k] += tuple(s[k])
        return out

    @property
    def hist_map(self):
        out = {}
        for a in self.apps:
            out.update(a.hist_map)
        return out

    def _ctx(self, ctx, i):
        """Member ``i``'s view of the tick context: its own glob."""
        if isinstance(ctx.glob, tuple):
            return dataclasses.replace(ctx, glob=ctx.glob[i])
        return ctx

    def _members(self, states):
        return enumerate(zip(self.apps, states))

    def init(self, n: int, device="cpu"):
        return tuple(a.init(n, device) for a in self.apps)

    def glob_init(self, rng):
        rngs = rng_mod.split(rng, len(self.apps))
        return tuple(a.glob_init(rngs[i]) for i, a in enumerate(self.apps))

    def post_step(self, ctx, states, globs, events):
        outs = [a.post_step(self._ctx(ctx, i), s, g, events)
                for i, (a, s, g) in enumerate(zip(self.apps, states, globs))]
        return tuple(o[0] for o in outs), tuple(o[1] for o in outs)

    def on_ready(self, states, en, now, rng):
        """``rng`` is one key per node ([N, 2])."""
        rngs = rng_mod.split(rng, len(self.apps))
        return tuple(a.on_ready(s, en, now, rngs[:, i])
                     for i, (a, s) in self._members(states))

    def on_stop(self, states, en):
        return tuple(a.on_stop(s, en) for a, s in zip(self.apps, states))

    def on_leave(self, states, en, ctx, ob, ev, now, node_idx, handover):
        return tuple(a.on_leave(s, en, self._ctx(ctx, i), ob, ev, now,
                                node_idx, handover)
                     for i, (a, s) in self._members(states))

    def next_event(self, states):
        t = self.apps[0].next_event(states[0])
        for a, s in zip(self.apps[1:], states[1:]):
            t = torch.minimum(t, a.next_event(s))
        return t

    # -- timers: the earliest-due tier fires this window ------------------

    def on_timer(self, states, en, ctx, now, rng, ev, node_idx):
        t = len(self.apps)
        rngs = rng_mod.split(rng, t)
        # each tier's on_timer clock (timer_event where defined: the DHT
        # pump holds next_event at 0 and would take every window)
        nevs = torch.stack([getattr(a, "timer_event", a.next_event)(s)
                            for a, s in zip(self.apps, states)], 1)
        pick = torch.argmin(nevs, 1).to(I32)
        new_states = []
        want = torch.zeros_like(en)
        key = None
        tag = torch.zeros(en.shape, dtype=I32, device=en.device)
        for i, (a, s) in self._members(states):
            en_i = en & (pick == i)
            s2, req = a.on_timer(s, en_i, self._ctx(ctx, i), now,
                                 rngs[:, i], ev, node_idx)
            new_states.append(s2)
            fire_i = req.want & en_i
            key = req.key if key is None else torch.where(
                fire_i[:, None], req.key, key)
            tag = torch.where(fire_i, (req.tag * t + i).to(I32), tag)
            want = want | fire_i
        return tuple(new_states), base.LookupReq(want=want, key=key, tag=tag)

    def on_lookup_done(self, states, done, ctx, ob, ev, now, node_idx):
        t = len(self.apps)
        tier = done.tag % t
        inner = dataclasses.replace(
            done, tag=torch.div(done.tag, t, rounding_mode="floor"))
        return tuple(
            a.on_lookup_done(
                s, dataclasses.replace(inner, en=done.en & (tier == i)),
                self._ctx(ctx, i), ob, ev, now, node_idx)
            for i, (a, s) in self._members(states))

    # -- messages ---------------------------------------------------------

    def on_msg(self, states, m, ctx, ob, ev, is_sib):
        return tuple(a.on_msg(s, m, self._ctx(ctx, i), ob, ev, is_sib)
                     for i, (a, s) in self._members(states))

    def _on_msgs(self, states, msgs, ctx, ob, ev, is_sib, node_idx=None):
        out = []
        for i, (a, s) in self._members(states):
            ctx_i = self._ctx(ctx, i)
            if hasattr(a, "on_msgs"):
                # probe the signature for the optional node_idx (a
                # try/except around the call would replay its sends)
                if "node_idx" in inspect.signature(a.on_msgs).parameters:
                    s = a.on_msgs(s, msgs, ctx_i, ob, ev, is_sib,
                                  node_idx=node_idx)
                else:
                    s = a.on_msgs(s, msgs, ctx_i, ob, ev, is_sib)
            else:
                for r in range(msgs.valid.shape[1]):
                    s = a.on_msg(s, msgs.slot(r), ctx_i, ob, ev,
                                 is_sib[:, r])
            out.append(s)
        return tuple(out)

    # -- optional hooks (installed in __init__ when a member has them) ----

    def _forward(self, states, msgs, ctx):
        veto = torch.zeros_like(msgs.valid)
        for i, (a, s) in self._members(states):
            if hasattr(a, "forward"):
                veto = veto | a.forward(s, msgs, self._ctx(ctx, i))
        return veto

    def _on_update(self, states, en, ctx, ob, ev, now, node_idx, added,
                   sib_keys=None, sib_valid=None, urgent=None):
        return tuple(
            a.on_update(s, en, self._ctx(ctx, i), ob, ev, now, node_idx,
                        added, sib_keys=sib_keys, sib_valid=sib_valid,
                        urgent=urgent)
            if hasattr(a, "on_update") else s
            for i, (a, s) in self._members(states))

    def _on_tick(self, states, ctx, ob, ev, node_idx):
        return tuple(a.on_tick(s, self._ctx(ctx, i), ob, ev, node_idx)
                     if hasattr(a, "on_tick") else s
                     for i, (a, s) in self._members(states))

    def _route_policy(self, tag):
        t = len(self.apps)
        tier = tag % t
        routable = torch.zeros(tag.shape, dtype=torch.bool, device=tag.device)
        inner = torch.zeros(tag.shape, dtype=I32, device=tag.device)
        is_rpc = routable
        for i, a in enumerate(self.apps):
            if not hasattr(a, "route_policy"):
                continue
            r_i, k_i, rpc_i = a.route_policy(
                torch.div(tag, t, rounding_mode="floor"))
            hit = tier == i
            routable = torch.where(hit, r_i, routable)
            inner = torch.where(hit, k_i, inner)
            is_rpc = torch.where(hit, rpc_i, is_rpc)
        return routable, inner, is_rpc

    def _on_route_fired(self, states, fired, now, tag):
        t = len(self.apps)
        tier = tag % t
        inner = torch.div(tag, t, rounding_mode="floor")
        return tuple(a.on_route_fired(s, fired & (tier == i), now, inner)
                     if hasattr(a, "on_route_fired") else s
                     for i, (a, s) in self._members(states))
