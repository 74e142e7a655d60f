"""Iterative KBR lookup engine as per-node state machines (PyTorch).

Counterpart of ``oversim_tpu/common/lookup.py``, batched over the node
axis: every ``LookupState`` field is ``[N, L, ...]`` (L lookup slots per
node).  A lookup keeps a frontier of candidate next hops sorted by the
overlay's metric and fires FindNode RPCs at the closest unvisited ones
until a sibling-flagged response completes it (IterativeLookup.cc).

Ported: ``merge=True`` (Kademlia's sorted frontier), replace mode
(``merge=False``, Chord's: the first consuming response with nodes
replaces the frontier), parallel RPCs, the visited ring, RPC timeouts
(static, or per destination through ``pump``'s ``timeout_fn``), the
whole-lookup deadline and the per-lookup extension words (``ext_words``:
Koorde's and Broose's routing state riding with the lookup; a FindNode
call carries ``ext`` in ``nodes[:EW]``, and the first consuming response
of a slot hands back the responder's update in ``nodes[-EW:]``).
Retries, exhaustive routing, S/Kademlia sibling verification and
proximity-aware routing are still to be ported (ROADMAP Queue A) and
raise.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch.common import wire
from oversim_tpu_torch.core import keys as keys_mod
from oversim_tpu_torch.engine.logic import put, take

I32 = torch.int32
I64 = torch.int64
NO_NODE = -1
T_INF = 2 ** 62
UMAX = keys_mod.UMAX

F_NEW, F_PENDING, F_RESPONDED, F_FAILED = 0, 1, 2, 3

LOOKUP_TIMEOUT_NS = 10 * 1_000_000_000
RPC_TIMEOUT_NS = 1_500_000_000
MAX_HOPS = 32


@dataclasses.dataclass(frozen=True)
class LookupConfig:
    """JAX field names and defaults (IterativeLookupConfiguration)."""

    slots: int = 4
    frontier: int = 8
    visited: int = 16
    merge: bool = False
    parallel_rpcs: int = 1
    retries: int = 0
    exhaustive: bool = False
    verify_siblings: bool = False
    rpc_timeout_ns: int = RPC_TIMEOUT_NS
    deadline_ns: int = LOOKUP_TIMEOUT_NS
    prox_aware: bool = False
    prox_window: int = 3
    ext_words: int = 0

    def check_ported(self):
        if (self.retries or self.exhaustive or self.verify_siblings
                or self.prox_aware):
            raise NotImplementedError(
                "lookup retries, exhaustive routing, sibling verification "
                "and proximity routing are not ported yet (ROADMAP Queue A)")


@dataclasses.dataclass
class LookupState:
    active: torch.Tensor       # [N, L] bool
    purpose: torch.Tensor      # [N, L] i32
    aux: torch.Tensor          # [N, L] i32
    target: torch.Tensor       # [N, L, KL] u32 lanes in int64
    gen: torch.Tensor          # [N, L] i32
    frontier: torch.Tensor     # [N, L, F] i32
    fr_flags: torch.Tensor     # [N, L, F] i32
    fr_src: torch.Tensor       # [N, L, F] i32
    visited: torch.Tensor      # [N, L, V] i32
    vis_n: torch.Tensor        # [N, L] i32
    pending_dst: torch.Tensor  # [N, L, Rr] i32
    pend_prov: torch.Tensor    # [N, L, Rr] i32
    t_sent: torch.Tensor       # [N, L, Rr] i64
    t_to: torch.Tensor         # [N, L, Rr] i64
    retry: torch.Tensor        # [N, L, Rr] i32
    refire: torch.Tensor       # [N, L, Rr] bool
    deadline: torch.Tensor     # [N, L] i64
    hops: torch.Tensor         # [N, L] i32
    t0: torch.Tensor           # [N, L] i64
    done: torch.Tensor         # [N, L] bool
    success: torch.Tensor      # [N, L] bool
    result: torch.Tensor       # [N, L] i32
    results: torch.Tensor      # [N, L, F] i32
    res_n: torch.Tensor        # [N, L] i32
    t_done: torch.Tensor       # [N, L] i64
    ext: torch.Tensor          # [N, L, EW] i32
    ver_dst: torch.Tensor      # [N, L] i32
    ver_to: torch.Tensor       # [N, L] i64


def init(cfg: LookupConfig, kl: int, n: int, device="cpu") -> LookupState:
    l, f, v, r = cfg.slots, cfg.frontier, cfg.visited, cfg.parallel_rpcs

    def full(shape, val, dt):
        return torch.full((n,) + shape, val, dtype=dt, device=device)

    return LookupState(
        active=full((l,), False, torch.bool), purpose=full((l,), 0, I32),
        aux=full((l,), 0, I32), target=full((l, kl), 0, I64),
        gen=full((l,), 0, I32), frontier=full((l, f), NO_NODE, I32),
        fr_flags=full((l, f), 0, I32), fr_src=full((l, f), NO_NODE, I32),
        visited=full((l, v), NO_NODE, I32), vis_n=full((l,), 0, I32),
        pending_dst=full((l, r), NO_NODE, I32),
        pend_prov=full((l, r), NO_NODE, I32), t_sent=full((l, r), 0, I64),
        t_to=full((l, r), T_INF, I64), retry=full((l, r), 0, I32),
        refire=full((l, r), False, torch.bool),
        deadline=full((l,), T_INF, I64), hops=full((l,), 0, I32),
        t0=full((l,), 0, I64), done=full((l,), False, torch.bool),
        success=full((l,), False, torch.bool),
        result=full((l,), NO_NODE, I32),
        results=full((l, f), NO_NODE, I32), res_n=full((l,), 0, I32),
        t_done=full((l,), T_INF, I64), ext=full((l, cfg.ext_words), 0, I32),
        ver_dst=full((l,), NO_NODE, I32), ver_to=full((l,), T_INF, I64))


def free_slot(lk: LookupState):
    """([N] index of the first free slot, [N] any free)."""
    free = ~lk.active
    return torch.argmax(free.to(I32), 1).to(I32), torch.any(free, 1)


def num_free(lk: LookupState):
    """[N] count of free slots."""
    return torch.sum(~lk.active, 1, dtype=I32)


def start(lk: LookupState, en, slot, purpose, aux, target, seed_nodes,
          now, cfg: LookupConfig, ext=None) -> LookupState:
    """Occupy ``slot`` [N] with a new lookup where ``en`` [N] (no RPC yet:
    ``pump`` fires).  ``target`` [N, KL], ``seed_nodes`` [N, >=F], ``ext``
    [N, EW] i32 (zeros when None)."""
    l_dim, f = lk.frontier.shape[1], lk.frontier.shape[2]
    dev = en.device
    row = en[:, None] & (torch.arange(l_dim, device=dev)[None, :]
                         == slot.long()[:, None])                # [N, L]
    r2 = row[:, :, None]

    def per(v, dt):
        v = rng_mod.device_scalar(v, dt, dev)
        return v[:, None] if v.dim() == 1 else v

    return dataclasses.replace(
        lk,
        active=lk.active | row,
        purpose=torch.where(row, per(purpose, I32), lk.purpose),
        aux=torch.where(row, per(aux, I32), lk.aux),
        target=torch.where(r2, target[:, None, :], lk.target),
        gen=lk.gen + row.to(I32),
        frontier=torch.where(r2, seed_nodes[:, None, :f].to(I32),
                             lk.frontier),
        fr_flags=torch.where(r2, F_NEW, lk.fr_flags),
        fr_src=torch.where(r2, NO_NODE, lk.fr_src),
        visited=torch.where(r2, NO_NODE, lk.visited),
        vis_n=torch.where(row, 0, lk.vis_n),
        pending_dst=torch.where(r2, NO_NODE, lk.pending_dst),
        pend_prov=torch.where(r2, NO_NODE, lk.pend_prov),
        t_sent=torch.where(r2, 0, lk.t_sent),
        t_to=torch.where(r2, T_INF, lk.t_to),
        retry=torch.where(r2, 0, lk.retry),
        refire=lk.refire & ~r2,
        deadline=torch.where(row, per(now, I64) + cfg.deadline_ns,
                             lk.deadline),
        hops=torch.where(row, 0, lk.hops),
        t0=torch.where(row, per(now, I64), lk.t0),
        done=lk.done & ~row,
        success=lk.success & ~row,
        result=torch.where(row, NO_NODE, lk.result),
        results=torch.where(r2, NO_NODE, lk.results),
        res_n=torch.where(row, 0, lk.res_n),
        t_done=torch.where(row, T_INF, lk.t_done),
        ext=torch.where(r2, 0 if ext is None else ext[:, None, :].to(I32),
                        lk.ext),
        ver_dst=torch.where(row, NO_NODE, lk.ver_dst),
        ver_to=torch.where(row, T_INF, lk.ver_to))


def _visited_mask(visited, frontier):
    """[N, L, F] bool: frontier entry already in its slot's visited ring."""
    return torch.any(visited[:, :, None, :] == frontier[:, :, :, None],
                     -1) & (frontier != NO_NODE)


def on_responses(lk: LookupState, msgs, metric_fn, cfg: LookupConfig):
    """Consume every node's FINDNODE_RES inbox messages in one pass
    (``msgs.valid`` pre-masked to the response kind; a = lookup slot,
    b = generation, c = sibling flag, nodes = closest-node payload).
    ``metric_fn(cand [N, L, C], target [N, L, KL]) -> [N, L, C, KL]``."""
    cfg.check_ported()
    n, r_in = msgs.valid.shape
    l_dim, f = lk.frontier.shape[1], lk.frontier.shape[2]
    dev = msgs.valid.device
    lixs = torch.arange(l_dim, device=dev)

    l_r = torch.clamp(msgs.a, 0, l_dim - 1)                       # [N, R]
    match = (take(lk.pending_dst, l_r) == msgs.src[:, :, None]) & (
        msgs.src != NO_NODE)[:, :, None]                          # [N, R, Rr]
    ok = (msgs.valid & take(lk.active, l_r) & (take(lk.gen, l_r) == msgs.b)
          & torch.any(match, -1) & ~take(lk.done, l_r))
    same = (l_r[:, None, :] == l_r[:, :, None]) & (
        msgs.src[:, None, :] == msgs.src[:, :, None])
    earlier = torch.tril(torch.ones((r_in, r_in), dtype=torch.bool,
                                    device=dev), diagonal=-1)
    ok = ok & ~torch.any(same & earlier & ok[:, None, :], -1)
    j = torch.argmax(match.to(I32), -1)                           # [N, R]

    rr = lk.pending_dst.shape[2]
    cell = l_r.long() * rr + j                                   # [N, R]

    def clear(x, val):
        flat = x.reshape(n, l_dim * rr)
        return put(flat, cell, val, ok).reshape(x.shape)

    hop_add = torch.sum((ok[:, :, None] & (l_r[:, :, None] == lixs)).to(I32),
                        1, dtype=I32)
    lk = dataclasses.replace(
        lk,
        pending_dst=clear(lk.pending_dst, NO_NODE),
        t_to=clear(lk.t_to, T_INF), retry=clear(lk.retry, 0),
        refire=clear(lk.refire, False), hops=lk.hops + hop_add)

    resp_nodes = msgs.nodes[:, :, :f]                             # [N, R, F]
    has_nodes = torch.any(resp_nodes != NO_NODE, -1)
    is_sib = (msgs.c != 0) & has_nodes

    def per_slot(pred):
        m_rl = pred[:, :, None] & (l_r[:, :, None] == lixs)       # [N, R, L]
        return (torch.any(m_rl, 1), torch.argmax(m_rl.to(I32), 1), m_rl)

    fin, win, _ = per_slot(ok & is_sib)
    wnodes = take(resp_nodes, win)                                # [N, L, F]
    lk = dataclasses.replace(
        lk,
        done=lk.done | fin, success=lk.success | fin,
        result=torch.where(fin, wnodes[..., 0], lk.result),
        results=torch.where(fin[..., None], wnodes, lk.results),
        t_done=torch.where(fin, take(msgs.t_deliver, win), lk.t_done))
    upd = ok & ~is_sib

    if cfg.merge:
        any_upd, _, m_upd = per_slot(upd)
        m_lr = m_upd.transpose(1, 2)                          # [N, L, R]
        contrib = torch.where(m_lr[..., None], resp_nodes[:, None],
                              NO_NODE).reshape(n, l_dim, r_in * f)
        c_src = torch.where(m_lr, msgs.src[:, None, :], NO_NODE)
        c_src = c_src[..., None].expand(n, l_dim, r_in, f).reshape(
            n, l_dim, r_in * f)
        cand = torch.cat([lk.frontier, contrib], -1)
        flags = torch.cat([lk.fr_flags, torch.full(
            (n, l_dim, r_in * f), F_NEW, dtype=I32, device=dev)], -1)
        srcs = torch.cat([lk.fr_src, c_src], -1)
        dup = keys_mod.dup_mask(cand) | (cand == NO_NODE)
        cand = torch.where(dup, NO_NODE, cand)
        dist = metric_fn(cand, lk.target)
        dist = torch.where(dup[..., None], UMAX, dist)
        _, (cand_s, flags_s, src_s) = keys_mod.sort_by_distance(
            dist, (cand, flags, srcs), approx=True)
        new_frontier = cand_s[..., :f]
        new_flags = torch.where(new_frontier == NO_NODE, F_NEW,
                                flags_s[..., :f])
        new_src = src_s[..., :f]
    else:
        # replace mode: the first consuming response with nodes replaces
        # the frontier (IterativeLookup.cc:839-841); empty ones keep it
        any_upd, win_u, _ = per_slot(upd & has_nodes)
        new_frontier = take(resp_nodes, win_u)                    # [N, L, F]
        new_flags = torch.full_like(new_frontier, F_NEW)
        new_src = take(msgs.src, win_u)[..., None].expand(n, l_dim, f)

    au = any_upd[..., None]
    lk = dataclasses.replace(
        lk,
        frontier=torch.where(au, new_frontier, lk.frontier),
        fr_flags=torch.where(au, new_flags, lk.fr_flags),
        fr_src=torch.where(au, new_src, lk.fr_src))
    ew = cfg.ext_words
    if ew:
        # the responder's updated extension rides the response tail
        any_e, win_e, _ = per_slot(upd)
        lk = dataclasses.replace(lk, ext=torch.where(
            any_e[..., None], take(msgs.nodes[..., -ew:], win_e), lk.ext))
    return lk


def on_response(lk: LookupState, msg, metric_fn, cfg: LookupConfig):
    """One FINDNODE_RES per node (``msg`` fields [N], a one-slot view):
    ``on_responses`` of a one-message inbox, which is the JAX package's
    ``on_response`` (with one message nothing is merged across
    responses).  Overlays that interleave responses with their own
    table updates slot by slot (Pastry) call this."""
    one = dataclasses.replace(
        msg, **{f.name: getattr(msg, f.name)[:, None]
                for f in dataclasses.fields(msg)})
    return on_responses(lk, one, metric_fn, cfg)


def response_rtts(lk: LookupState, msgs):
    """RTT samples of an [N, R] FINDNODE_RES batch (``msgs.valid``
    pre-masked) against the matched pending RPC's send time
    (NeighborCache::updateNode on every RPC response); call before
    ``on_responses`` clears the pendings.  Returns (src, float32 seconds
    as XLA computes ``x / 1e9``, ok), each [N, R]."""
    l_dim, rr = lk.pending_dst.shape[1], lk.pending_dst.shape[2]
    l_r = torch.clamp(msgs.a, 0, l_dim - 1)
    match = (take(lk.pending_dst, l_r) == msgs.src[..., None]) & (
        msgs.src != NO_NODE)[..., None]                           # [N, R, Rr]
    ok = (msgs.valid & take(lk.active, l_r) & (take(lk.gen, l_r) == msgs.b)
          & torch.any(match, -1))
    j = torch.argmax(match.to(I32), -1)
    n = msgs.valid.shape[0]
    sent = take(lk.t_sent.reshape(n, l_dim * rr), l_r.long() * rr + j)
    rtt_s = (msgs.t_deliver - sent).to(torch.float32) * torch.full(
        (), 1.0 / 1e9, dtype=torch.float32, device=sent.device)
    return torch.where(ok, msgs.src, NO_NODE), rtt_s, ok


def on_timeouts(lk: LookupState, t_end, now, cfg: LookupConfig):
    """Expire pending RPCs / deadlines due before ``t_end``.  Returns
    (lk', failed_nodes [N, L*Rr], failed_prov [N, L*Rr])."""
    cfg.check_ported()
    n = lk.active.shape[0]
    act = lk.active[:, :, None]
    exp = act & (lk.pending_dst != NO_NODE) & (lk.t_to < t_end)
    can_retry = exp & (lk.retry < cfg.retries)
    final = exp & ~can_retry
    failed_nodes = torch.where(final, lk.pending_dst, NO_NODE).reshape(n, -1)
    failed_prov = torch.where(final, lk.pend_prov, NO_NODE).reshape(n, -1)
    fmask = torch.any(final[:, :, None, :] & (
        lk.frontier[:, :, :, None] == lk.pending_dst[:, :, None, :]), -1)
    dead = lk.active & ~lk.done & (lk.deadline < t_end)
    return dataclasses.replace(
        lk,
        fr_flags=torch.where(fmask, F_FAILED, lk.fr_flags),
        pending_dst=torch.where(final, NO_NODE, lk.pending_dst),
        pend_prov=torch.where(final, NO_NODE, lk.pend_prov),
        t_to=torch.where(exp, T_INF, lk.t_to),
        retry=lk.retry + can_retry.to(I32),
        refire=lk.refire | can_retry,
        hops=lk.hops + torch.sum(final.to(I32), -1, dtype=I32),
        done=lk.done | dead,
        t_done=torch.where(dead, now, lk.t_done)), failed_nodes, failed_prov


def pump(lk: LookupState, outbox, ctx, node_idx, now, cfg: LookupConfig, *,
         num_siblings: int = 1, num_redundant: int = 1, timeout_fn=None):
    """Fire FindNodeCalls for every active slot with free RPC capacity;
    slots with nothing left to query and nothing in flight fail.
    ``timeout_fn(dsts [N, L]) -> [N, L]`` ns is a per-destination RPC
    timeout (NeighborCache adaptive timeouts) in place of
    ``cfg.rpc_timeout_ns``."""
    cfg.check_ported()
    n, l_dim, f = lk.frontier.shape
    dev = lk.active.device
    call_size = wire.findnode_call_b() + 4 * cfg.ext_words
    lix = torch.arange(l_dim, device=dev)
    me = node_idx[:, None, None]
    frontier, fr_flags = lk.frontier, lk.fr_flags
    visited, vis_n = lk.visited, lk.vis_n
    pending_dst, t_to = lk.pending_dst, lk.t_to
    pend_prov, t_sent, retry = lk.pend_prov, lk.t_sent, lk.retry
    v_dim, r_dim = visited.shape[2], pending_dst.shape[2]
    fcol = torch.arange(f, device=dev)
    vcol_ar = torch.arange(v_dim, device=dev)
    rcol = torch.arange(r_dim, device=dev)
    for _ in range(r_dim):
        cand_ok = ((frontier != NO_NODE) & (fr_flags == F_NEW)
                   & ~_visited_mask(visited, frontier) & (frontier != me))
        has_cand = torch.any(cand_ok, -1)
        first = torch.argmax(cand_ok.to(I32), -1)                # [N, L]
        cand = torch.gather(frontier, 2, first[..., None])[..., 0]
        prov = torch.gather(lk.fr_src, 2, first[..., None])[..., 0]
        free_col_ok = pending_dst == NO_NODE
        has_free = torch.any(free_col_ok, -1)
        col = torch.argmax(free_col_ok.to(I32), -1)
        fire = (lk.active & ~lk.done & has_cand & has_free
                & (lk.hops < MAX_HOPS))
        vcol = (vis_n % v_dim).long()
        at_v = fire[..., None] & (vcol_ar == vcol[..., None])
        visited = torch.where(at_v, cand[..., None], visited)
        vis_n = vis_n + fire.to(I32)
        at_f = fire[..., None] & (fcol == first[..., None])
        fr_flags = torch.where(at_f, F_PENDING, fr_flags)
        at_c = fire[..., None] & (rcol == col[..., None])
        pending_dst = torch.where(at_c, cand[..., None], pending_dst)
        pend_prov = torch.where(at_c, prov[..., None], pend_prov)
        t_sent = torch.where(at_c, now, t_sent)
        to_ns = (cfg.rpc_timeout_ns if timeout_fn is None
                 else timeout_fn(cand)[..., None])
        t_to = torch.where(at_c, now + to_ns, t_to)
        retry = torch.where(at_c, 0, retry)
        outbox.send(fire, now, cand, wire.FINDNODE_CALL, key=lk.target,
                    a=lix[None, :].expand(n, l_dim), b=lk.gen,
                    c=num_siblings, d=num_redundant,
                    nodes=lk.ext if cfg.ext_words else None,
                    size_b=call_size)

    cand_ok = ((frontier != NO_NODE) & (fr_flags == F_NEW)
               & ~_visited_mask(visited, frontier) & (frontier != me))
    has_cand = torch.any(cand_ok, -1)
    inflight = torch.any(pending_dst != NO_NODE, -1)
    fail = (lk.active & ~lk.done & ~inflight
            & (~has_cand | (lk.hops >= MAX_HOPS)))
    return dataclasses.replace(
        lk, frontier=frontier, fr_flags=fr_flags, visited=visited,
        vis_n=vis_n, pending_dst=pending_dst, pend_prov=pend_prov,
        t_sent=t_sent, t_to=t_to, retry=retry,
        done=lk.done | fail, t_done=torch.where(fail, now, lk.t_done))


def take_completions(lk: LookupState, t_end):
    """Harvest slots whose completion is due; taken slots are freed."""
    taken = lk.done & (lk.t_done < t_end)
    comp = dict(taken=taken, success=lk.success & taken, result=lk.result,
                results=lk.results, purpose=lk.purpose, aux=lk.aux,
                hops=lk.hops, t0=lk.t0, target=lk.target)
    t2 = taken[..., None]
    lk = dataclasses.replace(
        lk,
        active=lk.active & ~taken, done=lk.done & ~taken,
        pending_dst=torch.where(t2, NO_NODE, lk.pending_dst),
        pend_prov=torch.where(t2, NO_NODE, lk.pend_prov),
        ver_dst=torch.where(taken, NO_NODE, lk.ver_dst),
        ver_to=torch.where(taken, T_INF, lk.ver_to),
        t_to=torch.where(t2, T_INF, lk.t_to),
        retry=torch.where(t2, 0, lk.retry),
        refire=lk.refire & ~t2,
        deadline=torch.where(taken, T_INF, lk.deadline),
        t_done=torch.where(taken, T_INF, lk.t_done))
    return lk, comp


def next_event(lk: LookupState):
    """[N] earliest timeout/completion wake-up over each node's slots."""
    act = lk.active[..., None]
    t = torch.min(torch.where(act, lk.t_to, T_INF), -1).values
    t = torch.minimum(t, torch.where(lk.active & ~lk.done, lk.deadline,
                                     T_INF))
    t = torch.minimum(t, torch.where(lk.done, lk.t_done, T_INF))
    staged = lk.active & ~lk.done & (lk.ver_dst != NO_NODE)
    t = torch.where(staged & (lk.ver_to >= T_INF), 0, torch.minimum(
        t, torch.where(staged, lk.ver_to, T_INF)))
    t = torch.where(torch.any(lk.refire & act, -1), 0, t)
    return torch.min(t, -1).values
