"""Per-node RTT cache (NeighborCache) with adaptive timeouts, PyTorch.

Counterpart of ``oversim_tpu/common/neighborcache.py``: every node keeps
a bounded cache of peers with an exponential (mean, var) RTT estimate
and a liveness state.  ``insert_rtt`` records one sample per node
(evicting the least recently updated entry when full), ``get_prox``
answers the last-known RTT, and ``node_timeout`` /
``adaptive_timeout_fn`` give the TCP-style per-destination RPC timeout
(NeighborCache.cc:802-838) that Chord's and Pastry's lookups use;
``insert_rtts_batch`` / ``feed_response_rtts`` fold a tick's RPC-response
samples in one pass and ``set_state`` marks an entry's liveness.  Every
function runs over the whole node axis: a "row" is the ``[N, C]`` cache
and a peer is one ``[N]`` slot (or ``[N, L]`` slots) per node.  Float
work is float32 in the JAX package's order.  ``prox_fn`` (proximity-aware
lookups) is still to be ported (ROADMAP Queue A).
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch.engine.logic import put, take

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
NO_NODE = -1

RTT_TIMEOUT_ADJUSTMENT = 1.3   # NeighborCache.cc RTT_TIMEOUT_ADJUSTMENT
ALPHA = 0.125                  # EWMA weights (TCP RFC 6298 style)
BETA = 0.25

# entry liveness (NeighborCache.h:152-164 RttState)
S_UNKNOWN, S_ALIVE, S_WAITING, S_TIMEOUT = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class NcParams:
    capacity: int = 16


@dataclasses.dataclass
class NcState:
    peer: torch.Tensor       # [N, C] i32
    rtt_mean: torch.Tensor   # [N, C] f32 seconds (-1 = no sample)
    rtt_var: torch.Tensor    # [N, C] f32
    last: torch.Tensor       # [N, C] i64
    live: torch.Tensor       # [N, C] i32 S_*


def init(n: int, p: NcParams, device="cpu") -> NcState:
    c = p.capacity
    return NcState(
        peer=torch.full((n, c), NO_NODE, dtype=I32, device=device),
        rtt_mean=torch.full((n, c), -1.0, dtype=F32, device=device),
        rtt_var=torch.zeros((n, c), dtype=F32, device=device),
        last=torch.zeros((n, c), dtype=I64, device=device),
        live=torch.zeros((n, c), dtype=I32, device=device))


def _find(row_peer, peer):
    """``row_peer`` [N, C], ``peer`` [N, *P] → (found, first column),
    both [N, *P]."""
    ps = peer.shape[1:]
    flat = peer.reshape(peer.shape[0], -1)
    hit = row_peer[:, None, :] == flat[:, :, None]               # [N, P, C]
    return (torch.any(hit, -1).reshape(peer.shape),
            torch.argmax(hit.to(I32), -1).to(I32).reshape((-1,) + ps))


def insert_rtt(nc: NcState, peer, rtt_s, now, en=True) -> NcState:
    """Record one RTT sample per node (``peer``, ``rtt_s`` and ``en`` [N];
    ``now`` [N] or a scalar): updateNode / insertNodeRtt."""
    en = torch.as_tensor(en, device=peer.device) & (peer != NO_NODE) & (
        rtt_s > 0)
    found, col_hit = _find(nc.peer, peer)
    col_new = torch.argmin(nc.last, 1).to(I32)           # LRU / free slot
    col = torch.where(found, col_hit, col_new)
    old_mean = torch.where(found, take(nc.rtt_mean, col), -1.0)
    has_hist = found & (old_mean >= 0)
    mean = torch.where(has_hist, (1 - ALPHA) * old_mean + ALPHA * rtt_s,
                       rtt_s)
    var = torch.where(has_hist, (1 - BETA) * take(nc.rtt_var, col)
                      + BETA * torch.abs(rtt_s - old_mean), 0.0)
    col = col[:, None]
    en = en[:, None]
    now = torch.broadcast_to(torch.as_tensor(now, device=peer.device),
                             peer.shape)
    return NcState(
        peer=put(nc.peer, col, peer[:, None], en),
        rtt_mean=put(nc.rtt_mean, col, mean[:, None], en),
        rtt_var=put(nc.rtt_var, col, var[:, None], en),
        last=put(nc.last, col, now[:, None], en),
        live=put(nc.live, col, S_ALIVE, en))


def set_state(nc: NcState, peer, state, en=True) -> NcState:
    """Mark the liveness of ``peer`` [N]'s entry (WAITING at send,
    TIMEOUT on a miss) where it is cached and ``en``."""
    en = torch.as_tensor(en, device=peer.device) & (peer != NO_NODE)
    found, col = _find(nc.peer, peer)
    return dataclasses.replace(nc, live=put(nc.live, col[:, None], state,
                                            (en & found)[:, None]))


def insert_rtts_batch(nc: NcState, peers, rtt_s, now, en) -> NcState:
    """``insert_rtt`` of a tick's R samples per node in one pass
    (``peers``, ``rtt_s``, ``en`` [N, R]; ``now`` [N, R] or a scalar), as
    the JAX package folds them: several samples of one peer collapse to
    the last lane, new peers take distinct least recently updated
    columns (columns hit this batch ordered last), and where two lanes
    write one column the later wins."""
    n, c = nc.peer.shape
    r = peers.shape[1]
    dev = peers.device
    en = en & (peers != NO_NODE) & (rtt_s > 0)
    later = torch.triu(torch.ones((r, r), dtype=torch.bool, device=dev),
                       diagonal=1)
    later_dup = torch.any((peers[:, None, :] == peers[:, :, None])
                          & en[:, None, :] & later, -1)
    en = en & ~later_dup
    hit = (nc.peer[:, None, :] == peers[..., None]) & en[..., None]  # [N,R,C]
    found = torch.any(hit, -1)
    col_hit = torch.argmax(hit.to(I32), -1)
    hit_col_any = torch.any(hit, 1)                                 # [N, C]
    order = torch.sort(torch.where(hit_col_any, 2 ** 62, nc.last), dim=1,
                       stable=True).indices                         # LRU first
    miss = en & ~found
    miss_rank = torch.cumsum(miss.to(I32), 1) - 1
    col_miss = take(order, torch.clamp(miss_rank, 0, c - 1))
    col = torch.where(found, col_hit, col_miss)
    ok = en & (found | (miss_rank < c))
    cc = torch.clamp(col, 0, c - 1)
    old_mean = torch.where(found, take(nc.rtt_mean, cc), -1.0)
    has_hist = found & (old_mean >= 0)
    mean = torch.where(has_hist, (1 - ALPHA) * old_mean + ALPHA * rtt_s,
                       rtt_s)
    var = torch.where(has_hist, (1 - BETA) * take(nc.rtt_var, cc)
                      + BETA * torch.abs(rtt_s - old_mean), 0.0)
    now = torch.broadcast_to(torch.as_tensor(now, device=dev), peers.shape)
    return NcState(
        peer=put(nc.peer, cc, peers, ok),
        rtt_mean=put(nc.rtt_mean, cc, mean.to(F32), ok),
        rtt_var=put(nc.rtt_var, cc, var.to(F32), ok),
        last=put(nc.last, cc, now, ok),
        live=put(nc.live, cc, S_ALIVE, ok))


def feed_response_rtts(nc: NcState, rtt_src, rtt_s, now, ok) -> NcState:
    """A tick's RPC-response RTT samples (``lookup.response_rtts``) into
    the cache in one pass."""
    return insert_rtts_batch(nc, rtt_src, rtt_s, now, ok)


def get_prox(nc: NcState, peer):
    """Last-known RTT for ``peer`` [N, *P] (seconds; -1 unknown) and
    whether its entry is not timed out."""
    found, col = _find(nc.peer, peer)
    rtt = torch.where(found, take(nc.rtt_mean, col), -1.0)
    alive = found & (take(nc.live, col) != S_TIMEOUT)
    return rtt, alive


def node_timeout(nc: NcState, peer, default_s):
    """Adaptive RPC timeout in seconds (getRttBasedTimeout): (mean +
    4·var, or mean·1.2 with one sample) · 1.3; ``default_s`` when the
    peer has no sample."""
    rtt, _ = get_prox(nc, peer)
    found, col = _find(nc.peer, peer)
    var = torch.where(found, take(nc.rtt_var, col), 0.0)
    t = torch.where(var > 0, rtt + 4.0 * var, rtt * 1.2)
    t = t * RTT_TIMEOUT_ADJUSTMENT
    return torch.where(rtt > 0, t, default_s)


def adaptive_timeout_fn(nc: NcState, default_ns: int):
    """Per-destination RPC timeout callback for ``lookup.pump``
    (optimizeTimeouts → getNodeTimeout): ``dsts`` [N, L] → [N, L] ns,
    the float32 seconds times 1e9 truncated, then clipped to [0.2 s,
    ``default_ns``]."""
    def fn(cands):
        t_s = node_timeout(nc, cands, default_ns / 1e9)
        return torch.clamp((t_s * 1e9).to(I64), int(0.2e9), default_ns)
    return fn
