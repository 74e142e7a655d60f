"""Per-node RTT cache (NeighborCache) with adaptive timeouts, PyTorch.

Counterpart of ``oversim_tpu/common/neighborcache.py``: every node keeps
a bounded cache of peers with an exponential (mean, var) RTT estimate
and a liveness state.  ``insert_rtt`` records one sample per node
(evicting the least recently updated entry when full), ``get_prox``
answers the last-known RTT, and ``node_timeout`` /
``adaptive_timeout_fn`` give the TCP-style per-destination RPC timeout
(NeighborCache.cc:802-838) that Chord's lookups use.  Every function
runs over the whole node axis: a "row" is the ``[N, C]`` cache and a
peer is one ``[N]`` slot (or ``[N, L]`` slots) per node.  Float work is
float32 in the JAX package's order.  The batched sample fold
(``insert_rtts_batch``, ``feed_response_rtts``) and ``prox_fn`` are
still to be ported (ROADMAP Queue A).
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
