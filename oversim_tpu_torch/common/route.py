"""Recursive KBR routing: the per-hop forwarding state machine (PyTorch).

Counterpart of ``oversim_tpu/common/route.py`` (the reference's
BaseOverlay::sendToKey recursive branch, BaseOverlay.cc:1441-1581, and
sendRouteMessage :1107), batched over the node axis: every ``RouteState``
field is ``[N, Q, ...]`` (Q pending-ACK route slots per node) and every
function takes the whole node axis at once.

A routed message (``wire.KBR_ROUTE``) carries the destination key in
``key``, the encapsulated payload kind in ``d``, the payload scalars in
``a/b/c/stamp/size_b``, the hop count in ``hops``, the visited hops in
``nodes`` and the per-hop ACK nonce in ``nonce`` (0: no ACK asked).  Each
hop forwards to the first candidate of the overlay's findNode that
survives loop detection (``pick_next_hop``); with ``route_acks`` the
forwarding node parks a copy in a free slot until the next hop ACKs it,
and on an ACK timeout reports the hop failed and reroutes the copy
(``on_timeouts``, ``reforward``, ``reroute``) up to ``max_retries``
times.  At the responsible node the payload is decapsulated (kind := d,
src := the originator).  Replies travel direct (semi), routed back to the
originator's key (full) or source-routed along the reversed visited list
(``wire.KBR_SROUTE``, source): ``reply``.

Where the JAX package scatters with ``mode="drop"`` at an out-of-range
index, the port masks the write; the slots one batch writes are distinct.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch.common import wire
from oversim_tpu_torch.engine.logic import put, take
from oversim_tpu_torch.rng import device_scalar

I32 = torch.int32
I64 = torch.int64
NO_NODE = -1
T_INF = 2 ** 62
GEN_MASK = 0x003FFFFF


@dataclasses.dataclass(frozen=True)
class RouteConfig:
    """Static knobs (the reference's BaseOverlay parameters; JAX field
    names and defaults).  ``mode``: "semi", "full" or "source"."""

    slots: int = 4
    max_retries: int = 2
    hop_max: int = 32
    ack_timeout_ns: int = 1_500_000_000
    route_acks: bool = True
    overhead_b: int = 28
    mode: str = "semi"
    record_route: bool = False
    ext_words: int = 0


@dataclasses.dataclass
class RouteState:
    """``[N, Q, ...]`` pending-ACK route slots."""

    active: torch.Tensor
    gen: torch.Tensor
    dst: torch.Tensor
    t_to: torch.Tensor
    retries: torch.Tensor
    key: torch.Tensor        # [N, Q, KL] u32 lanes in int64
    inner: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    hops: torch.Tensor
    stamp: torch.Tensor
    size_b: torch.Tensor
    visited: torch.Tensor    # [N, Q, V]


def init(cfg: RouteConfig, kl: int, visited_cap: int, n: int,
         device="cpu") -> RouteState:
    q = cfg.slots

    def full(shape, v, dt):
        return torch.full((n,) + shape, v, dtype=dt, device=device)

    return RouteState(
        active=full((q,), False, torch.bool), gen=full((q,), 0, I32),
        dst=full((q,), NO_NODE, I32), t_to=full((q,), T_INF, I64),
        retries=full((q,), 0, I32), key=full((q, kl), 0, I64),
        inner=full((q,), 0, I32), a=full((q,), 0, I32),
        b=full((q,), 0, I32), c=full((q,), 0, I32),
        hops=full((q,), 0, I32), stamp=full((q,), 0, I64),
        size_b=full((q,), 0, I32),
        visited=full((q, visited_cap), NO_NODE, I32))


def _first(mask):
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(I32), -1)


def fit(vec, width: int):
    """[..., k] node lists → [..., width]: cut, or padded with NO_NODE."""
    k = vec.shape[-1]
    if k >= width:
        return vec[..., :width]
    return torch.cat([vec, torch.full(vec.shape[:-1] + (width - k,), NO_NODE,
                                      dtype=vec.dtype, device=vec.device)], -1)


def pick_next_hop(cands, visited, last_hop, src_node, self_idx, is_sib):
    """Loop-detection candidate scan (BaseOverlay.cc:1500-1521):
    ``cands`` [..., C] in preference order, ``visited`` [..., V],
    ``last_hop``/``src_node``/``is_sib`` [...], ``self_idx``
    broadcastable to [...].  A candidate is rejected if it is the last
    hop (and not us), already visited, the source node (and we are not)
    or ourselves while not a sibling.  Returns (next hop, found)."""
    self_idx = torch.broadcast_to(self_idx, last_hop.shape)
    in_visited = torch.any(cands[..., :, None] == visited[..., None, :], -1)
    bad = ((cands == NO_NODE)
           | ((cands == last_hop[..., None]) & (cands != self_idx[..., None]))
           | in_visited
           | ((cands == src_node[..., None])
              & (self_idx != src_node)[..., None])
           | ((cands == self_idx[..., None]) & ~is_sib[..., None]))
    ok = ~bad
    found = torch.any(ok, -1)
    nxt = torch.gather(cands, -1, _first(ok)[..., None])[..., 0]
    return torch.where(found, nxt, NO_NODE), found


def _route_nonce(slot, gen, q: int):
    """Nonzero ACK nonce encoding (slot, gen)."""
    return 1 + slot + q * (gen & GEN_MASK)


def _send_route(ob, en, now, next_hop, *, key, nonce, hops, a, b, c, inner,
                visited, stamp, size_b, cfg: RouteConfig):
    ob.send(en, now, next_hop, wire.KBR_ROUTE, key=key, nonce=nonce,
            hops=hops, a=a, b=b, c=c, d=inner, nodes=visited, stamp=stamp,
            size_b=size_b + cfg.overhead_b)


def forward(rt: RouteState, ob, en, now, next_hop, *, key, inner, a, b, c,
            hops, stamp, size_b, visited, cfg: RouteConfig):
    """Send one route hop per node (``en``/``next_hop`` [N], ``key`` [N,
    KL], ``visited`` [N, V'] including ourselves); with ACKs on, park a
    copy in the first free slot (sendRouteMessage + the NextHopCall
    wrap).  With no free slot the message leaves un-ACKed."""
    if not cfg.route_acks:
        _send_route(ob, en, now, next_hop, key=key, nonce=0, hops=hops, a=a,
                    b=b, c=c, inner=inner, visited=visited, stamp=stamp,
                    size_b=size_b, cfg=cfg)
        return rt
    q = rt.active.shape[1]
    free = ~rt.active
    slot = _first(free)                                          # [N]
    use = en & torch.any(free, 1)
    gen = take(rt.gen, slot) + 1
    nonce = torch.where(use, _route_nonce(slot.to(I32), gen, q), 0)
    _send_route(ob, en, now, next_hop, key=key, nonce=nonce, hops=hops, a=a,
                b=b, c=c, inner=inner, visited=visited, stamp=stamp,
                size_b=size_b, cfg=cfg)
    row = use[:, None] & (torch.arange(q, device=use.device)[None, :]
                          == slot[:, None])                      # [N, Q]

    def at(x, v, dt):
        v = device_scalar(v, dt, x.device)
        if v.dim() == 1:
            v = v[:, None]
        return torch.where(row, v, x)

    vis = fit(visited, rt.visited.shape[2])
    return dataclasses.replace(
        rt, active=rt.active | row, gen=torch.where(row, gen[:, None], rt.gen),
        dst=at(rt.dst, next_hop, I32),
        t_to=at(rt.t_to, now + cfg.ack_timeout_ns, I64),
        retries=torch.where(row, 0, rt.retries),
        key=torch.where(row[..., None], key[:, None, :], rt.key),
        inner=at(rt.inner, inner, I32), a=at(rt.a, a, I32),
        b=at(rt.b, b, I32), c=at(rt.c, c, I32), hops=at(rt.hops, hops, I32),
        stamp=at(rt.stamp, stamp, I64), size_b=at(rt.size_b, size_b, I32),
        visited=torch.where(row[..., None], vis[:, None, :], rt.visited))


def forward_batch(rt: RouteState, ob, en, now, next_hop, *, key, inner, a,
                  b, c, hops, stamp, size_b, visited, cfg: RouteConfig):
    """``forward`` for R lanes per node (``en``/``next_hop`` and the
    fields [N, R], ``key`` [N, R, KL], ``visited`` [N, R, V']): one
    send; the j-th enabled lane takes the j-th free slot, lanes past the
    free supply leave un-ACKed."""
    if not cfg.route_acks:
        _send_route(ob, en, now, next_hop, key=key, nonce=0, hops=hops, a=a,
                    b=b, c=c, inner=inner, visited=visited, stamp=stamp,
                    size_b=size_b, cfg=cfg)
        return rt
    n, q = rt.active.shape
    dev = en.device
    lane_rank = torch.cumsum(en.to(I32), 1) - 1                   # [N, R]
    free = ~rt.active
    slot_rank = torch.cumsum(free.to(I32), 1) - 1                 # [N, Q]
    n_free = torch.sum(free, 1, dtype=I32)
    slot_of_rank = torch.full((n, q + 1), q, dtype=I64, device=dev).scatter_(
        1, torch.where(free, slot_rank, q).long(),
        torch.arange(q, device=dev).expand(n, q))[:, :q]          # rank→slot
    lane_slot = torch.where(en & (lane_rank < n_free[:, None]),
                            take(slot_of_rank, torch.clamp(lane_rank, 0,
                                                           q - 1)), q)
    parked = lane_slot < q                                        # [N, R]
    ls = torch.clamp(lane_slot, 0, q - 1)
    gen = take(rt.gen, ls) + 1
    nonce = torch.where(parked, _route_nonce(ls.to(I32), gen, q), 0)
    _send_route(ob, en, now, next_hop, key=key, nonce=nonce, hops=hops, a=a,
                b=b, c=c, inner=inner, visited=visited, stamp=stamp,
                size_b=size_b, cfg=cfg)

    def at(x, v):
        return put(x, ls, v, parked)

    return dataclasses.replace(
        rt, active=at(rt.active, True), gen=at(rt.gen, gen),
        dst=at(rt.dst, next_hop), t_to=at(rt.t_to, now + cfg.ack_timeout_ns),
        retries=at(rt.retries, 0), key=at(rt.key, key),
        inner=at(rt.inner, inner), a=at(rt.a, a), b=at(rt.b, b),
        c=at(rt.c, c), hops=at(rt.hops, hops), stamp=at(rt.stamp, stamp),
        size_b=at(rt.size_b, size_b),
        visited=at(rt.visited, fit(visited, rt.visited.shape[2])))


def on_acks(rt: RouteState, m):
    """Consume the KBR_ROUTE_ACKs of an [N, R] inbox (``m.valid``
    pre-masked to the ACK kind): free each slot whose (slot, generation)
    nonce and next hop match."""
    q = rt.active.shape[1]
    slot = torch.remainder(m.nonce - 1, q)
    gen = torch.div(m.nonce - 1, q, rounding_mode="floor")
    ok = (m.valid & (m.nonce > 0) & take(rt.active, slot)
          & ((take(rt.gen, slot) & GEN_MASK) == gen)
          & (take(rt.dst, slot) == m.src))
    return dataclasses.replace(rt, active=put(rt.active, slot, False, ok),
                               t_to=put(rt.t_to, slot, T_INF, ok))


def on_ack(rt: RouteState, m):
    """``on_acks`` for one inbox slot per node (``m`` fields [N])."""
    one = dataclasses.replace(m, valid=m.valid[:, None],
                              nonce=m.nonce[:, None], src=m.src[:, None])
    return on_acks(rt, one)


def append_visited(visited, self_idx, en):
    """recordRoute (BaseOverlay.cc:893-898): append ``self_idx`` [N] at the
    first NO_NODE of each enabled lane's ``visited`` [N, R, V] (a full
    list overwrites its last entry)."""
    vcap = visited.shape[-1]
    n_vis = torch.sum(visited != NO_NODE, -1)
    pos = torch.clamp(n_vis, max=vcap - 1)
    at = en[..., None] & (torch.arange(vcap, device=visited.device)
                          == pos[..., None])
    return torch.where(at, self_idx[:, None, None].to(visited.dtype), visited)


def sroute_send(ob, en, now, *, path, responder, inner, key, a, hops,
                stamp, size_b, overhead_b=28):
    """Emit source-routed replies along the reversed ``path`` [N, R, V]
    (path[0] is the originator): the first hop goes to path[last] with
    cursor b = last."""
    n_path = torch.sum(path != NO_NODE, -1, dtype=I32)
    last = torch.clamp(n_path - 1, min=0)
    first_dst = torch.gather(path, -1, last[..., None].long())[..., 0]
    en = en & (n_path > 0)
    ob.send(en, now, first_dst, wire.KBR_SROUTE, key=key, a=a, b=last,
            c=responder, d=inner, nodes=path, hops=hops, stamp=stamp,
            size_b=size_b + overhead_b)


def sroute_step(ob, msgs, overhead_b=28):
    """One source-route hop over an [N, R] inbox: lanes at cursor 0 are at
    the originator and deliver (returned mask; the caller sets kind := d,
    src := c); the others are forwarded to nodes[b - 1] here."""
    en = msgs.valid & (msgs.kind == wire.KBR_SROUTE)
    j = msgs.b
    deliver = en & (j <= 0)
    fwd = en & (j > 0)
    jc = torch.clamp(j - 1, 0, msgs.nodes.shape[-1] - 1)
    nxt = torch.gather(msgs.nodes, -1, jc[..., None].long())[..., 0]
    ob.send(fwd & (nxt != NO_NODE), msgs.t_deliver, nxt, wire.KBR_SROUTE,
            key=msgs.key, a=msgs.a, b=jc, c=msgs.c, d=msgs.d,
            nodes=msgs.nodes, hops=msgs.hops + 1, stamp=msgs.stamp,
            size_b=msgs.size_b)
    return deliver


def reply(ob, cfg: RouteConfig, en, now, msgs, ctx, node_idx, inner_kind,
          *, key=None, a=0, stamp=0, size_b=40):
    """RPC replies to decapsulated routed calls ``msgs`` [N, R] in the
    routing mode's transport (BaseOverlay.cc:1790-1825): direct (semi),
    a KBR_ROUTE to the originator's key entering the overlay by a
    self-send (full), or KBR_SROUTE along the request's visited list
    (source)."""
    if key is None:
        key = msgs.key
    ew = cfg.ext_words
    if cfg.mode == "full":
        width = msgs.nodes.shape[-1]
        col = torch.arange(width, device=msgs.nodes.device)
        vis0 = torch.where(col == ew, node_idx[:, None, None].to(I32),
                           NO_NODE).expand(msgs.nodes.shape)
        if ew:
            vis0 = torch.where(col < ew, 0, vis0)
        src_k = ctx.keys[torch.clamp(msgs.src, min=0).long()]
        ob.send(en, now, node_idx, wire.KBR_ROUTE, key=src_k, nonce=0,
                hops=0, a=a, d=inner_kind, nodes=vis0, stamp=stamp,
                size_b=size_b + cfg.overhead_b)
    elif cfg.mode == "source":
        sroute_send(ob, en, now, path=msgs.nodes[..., ew:],
                    responder=node_idx, inner=inner_kind, key=key, a=a,
                    hops=0, stamp=stamp, size_b=size_b,
                    overhead_b=cfg.overhead_b)
    else:
        ob.send(en, now, msgs.src, inner_kind, key=key, a=a, stamp=stamp,
                size_b=size_b)


def on_timeouts(rt: RouteState, t_end, cfg: RouteConfig):
    """Expire the ACKs due before ``t_end``.  Returns (rt', failed [N, Q]
    next hops to report, retry [N, Q] slots to reroute or drop)."""
    expired = rt.active & (rt.t_to < t_end)
    failed = torch.where(expired, rt.dst, NO_NODE)
    can_retry = expired & (rt.retries < cfg.max_retries)
    give_up = expired & ~can_retry
    return dataclasses.replace(
        rt, active=rt.active & ~give_up,
        t_to=torch.where(expired, T_INF, rt.t_to),
        dst=torch.where(expired, NO_NODE, rt.dst),
        retries=rt.retries + expired.to(I32)), failed, can_retry


def reforward_batch(rt: RouteState, ob, en, now, next_hop, cfg: RouteConfig):
    """Re-send the parked messages of the slots marked in ``en`` [N, Q] to
    ``next_hop`` [N, Q] (reroute after a hop failure): one send."""
    q = rt.active.shape[1]
    en = en & (next_hop != NO_NODE)
    gen = rt.gen + 1
    slots = torch.arange(q, dtype=I32, device=en.device)
    nonce = torch.where(en, _route_nonce(slots, gen, q), 0)
    _send_route(ob, en, now, next_hop, key=rt.key, nonce=nonce, hops=rt.hops,
                a=rt.a, b=rt.b, c=rt.c, inner=rt.inner, visited=rt.visited,
                stamp=rt.stamp, size_b=rt.size_b, cfg=cfg)
    return dataclasses.replace(
        rt, gen=torch.where(en, gen, rt.gen),
        dst=torch.where(en, next_hop, rt.dst),
        t_to=torch.where(en, now + cfg.ack_timeout_ns, rt.t_to))


def _col(v):
    """[N] → [N, 1]; scalars stay as they are."""
    return v[:, None] if isinstance(v, torch.Tensor) and v.dim() == 1 else v


def reforward(rt: RouteState, ob, slot: int, en, now, next_hop,
              cfg: RouteConfig):
    """Re-send slot ``slot``'s parked message to ``next_hop`` [N] where
    ``en`` [N] (a per-slot reroute)."""
    q = rt.active.shape[1]
    en = en & (next_hop != NO_NODE)
    gen = rt.gen[:, slot] + 1
    nonce = torch.where(en, _route_nonce(slot, gen, q), 0)
    _send_route(ob, en, now, next_hop, key=rt.key[:, slot], nonce=nonce,
                hops=rt.hops[:, slot], a=rt.a[:, slot], b=rt.b[:, slot],
                c=rt.c[:, slot], inner=rt.inner[:, slot],
                visited=rt.visited[:, slot], stamp=rt.stamp[:, slot],
                size_b=rt.size_b[:, slot], cfg=cfg)
    at = en[:, None] & (torch.arange(q, device=en.device) == slot)
    return dataclasses.replace(
        rt, gen=torch.where(at, gen[:, None], rt.gen),
        dst=torch.where(at, next_hop[:, None], rt.dst),
        t_to=torch.where(at, _col(now + cfg.ack_timeout_ns), rt.t_to))


def drop_slots(rt: RouteState, en):
    """Free every slot marked in ``en`` [N, Q]."""
    return dataclasses.replace(rt, active=rt.active & ~en,
                               t_to=torch.where(en, T_INF, rt.t_to))


def drop_slot(rt: RouteState, slot: int, en):
    q = rt.active.shape[1]
    return drop_slots(rt, en[:, None] & (torch.arange(q, device=en.device)
                                         == slot))


def next_event(rt: RouteState):
    """[N] earliest ACK timeout."""
    return torch.min(torch.where(rt.active, rt.t_to, T_INF), 1).values


# -- the three blocks every recursive overlay wires -------------------------


def prepass(rt: RouteState, ob, msgs, res_b, sib_b, ready, node_idx,
            cfg: RouteConfig, forward_veto=None):
    """Inbound recursive-route pre-pass over an [N, R] inbox
    (BaseOverlay.cc:1441-1581): consume ACKs, pop source-routed replies,
    ACK and forward or decapsulate KBR_ROUTE messages with the overlay's
    findNode results ``res_b`` [N, R, RMAX] / ``sib_b`` [N, R].
    ``forward_veto(msgs)`` -> [N, R] bool is the app's Common API
    ``forward()``: a vetoed hop is dropped (BaseApp.h:214).  Returns
    (rt', msgs' with routed payloads decapsulated and consumed wrapper
    lanes invalid, [N] drop count)."""
    v_r = msgs.valid
    now_r = msgs.t_deliver
    rmax = msgs.nodes.shape[-1]
    ew = cfg.ext_words

    rt = on_acks(rt, dataclasses.replace(
        msgs, valid=v_r & (msgs.kind == wire.KBR_ROUTE_ACK)))

    en_sro = v_r & (msgs.kind == wire.KBR_SROUTE)
    deliver_sr = sroute_step(ob, msgs)
    msgs = dataclasses.replace(
        msgs, kind=torch.where(deliver_sr, msgs.d, msgs.kind),
        src=torch.where(deliver_sr, msgs.c, msgs.src),
        valid=v_r & (~en_sro | deliver_sr))
    v_r = msgs.valid

    en_rt = v_r & (msgs.kind == wire.KBR_ROUTE) & ready[:, None]
    ob.send(en_rt & (msgs.nonce > 0), now_r, msgs.src, wire.KBR_ROUTE_ACK,
            nonce=msgs.nonce, size_b=wire.BASE_CALL_B)
    deliver_rt = en_rt & sib_b
    if ew:
        vis_in = msgs.nodes[..., ew:]
        cands = torch.cat([res_b[..., :rmax - ew], torch.full_like(
            res_b[..., rmax - ew:], NO_NODE)], -1)
    else:
        vis_in = msgs.nodes
        cands = res_b
    nxt_v, found_v = pick_next_hop(cands, vis_in, msgs.src, vis_in[..., 0],
                                   node_idx[:, None], sib_b)
    fwd = en_rt & ~sib_b & found_v & (msgs.hops < cfg.hop_max)
    if forward_veto is not None:
        fwd = fwd & ~forward_veto(msgs)
    visited2 = append_visited(vis_in, node_idx, fwd)
    nodes_out = (torch.cat([res_b[..., rmax - ew:], visited2], -1) if ew
                 else visited2)
    rt = forward_batch(
        rt, ob, fwd, now_r, nxt_v, key=msgs.key, inner=msgs.d, a=msgs.a,
        b=msgs.b, c=msgs.c, hops=msgs.hops + 1, stamp=msgs.stamp,
        size_b=msgs.size_b - cfg.overhead_b, visited=nodes_out, cfg=cfg)
    drop = torch.sum(en_rt & ~sib_b & ~fwd, 1, dtype=I32)
    msgs = dataclasses.replace(
        msgs, kind=torch.where(deliver_rt, msgs.d, msgs.kind),
        src=torch.where(deliver_rt, msgs.nodes[..., ew], msgs.src),
        valid=v_r & (~en_rt | deliver_rt))
    return rt, msgs, drop


def originate(rt: RouteState, ob, app_obj, app_state, req, next_hop,
              is_sib, have_slot, now, node_idx, rmax: int,
              cfg: RouteConfig, measuring, ext0=None):
    """Originator side of the recursive data path for an app LookupReq
    ([N] lanes): the payloads the app declares routable leave as
    KBR_ROUTE to ``next_hop``; the rest stays with the iterative engine.
    Returns (rt', app_state', route_fire, start_iterative)."""
    routable, inner_a, is_rpc = app_obj.route_policy(req.tag)
    route_fire = req.want & ~is_sib & routable & (next_hop != NO_NODE)
    ew = cfg.ext_words
    n = node_idx.shape[0]
    col = torch.arange(rmax, device=node_idx.device)
    vis0 = torch.where(col == ew, node_idx[:, None], NO_NODE).to(I32)
    if ew:
        head = (torch.zeros((n, ew), dtype=I32, device=node_idx.device)
                if ext0 is None else ext0.to(I32))
        vis0 = torch.cat([head, vis0[:, ew:]], 1)
    zeros = torch.zeros((n,), dtype=I32, device=node_idx.device)
    rt = forward(rt, ob, route_fire, now, next_hop, key=req.key,
                 inner=inner_a, a=req.tag, b=zeros,
                 c=torch.broadcast_to(measuring.to(I32), (n,)),
                 hops=zeros + 1, stamp=now, size_b=zeros + 100,
                 visited=vis0, cfg=cfg)
    if hasattr(app_obj, "on_route_fired"):
        app_state = app_obj.on_route_fired(app_state, route_fire & is_rpc,
                                           now, req.tag)
    start_iter = (req.want & ~is_sib & ~routable & have_slot
                  & (next_hop != NO_NODE))
    return rt, app_state, route_fire, start_iter


def reroute(rt: RouteState, ob, res_q, sib_q, rt_failed, rt_retry, now,
            node_idx, cfg: RouteConfig):
    """Timeout reroute (internalHandleRpcTimeout, BaseOverlay.cc:1697-1729):
    re-send the parked messages around their failed hops with fresh
    findNode results ``res_q`` [N, Q, C] (or [N, Q]) / ``sib_q`` [N, Q]
    over the parked keys; a node that became responsible self-forwards.
    Returns (rt', [N] give-up count)."""
    ew = cfg.ext_words
    if res_q.dim() == 2:
        res_q = res_q[..., None]
    nxt_q, found_q = pick_next_hop(res_q, rt.visited[..., ew:], rt_failed,
                                   rt.visited[..., ew], node_idx[:, None],
                                   sib_q)
    nxt_fin = torch.where(sib_q, node_idx[:, None], nxt_q)
    ok_q = rt_retry & (sib_q | found_q)
    rt = reforward_batch(rt, ob, ok_q, now, nxt_fin, cfg)
    give_up = rt_retry & ~ok_q
    rt = drop_slots(rt, give_up)
    return rt, torch.sum(give_up, 1, dtype=I32)
