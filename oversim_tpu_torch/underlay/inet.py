"""Router-topology underlay: InetUnderlay and ReaSE (PyTorch).

Counterpart of ``oversim_tpu/underlay/inet.py`` (the reference's
InetUnderlay, InetUnderlayConfigurator.cc and AccessNet.cc: terminals
behind access routers on a router backbone; ReaSEUnderlay: the same on a
transit/stub AS hierarchy).  The routed path's delay is precomputed once:
a static router graph is built at init on the host (numpy, the
topology setup phase), its all-pairs shortest-path delays become an
``[R, R]`` float32 matrix on the device, and a message's propagation
delay is one gather:

    delay = access[src] + rr_delay[router[src], router[dst]]
          + access[dst] + sender queue + rx serialization

Sender-queue serialization, jitter, bit errors, dead destinations and
node-type partitions are ``underlay/simple.py``'s ``send_with_delay``;
there is no access channel delay term.  Topologies: ``"inet"``, routers
placed uniformly, each linked to its 2 nearest neighbors plus a ring;
``"rease"``, a fully meshed transit core with stubs attached
preferentially to it.
``channel_table``, ``connection_matrix`` and ``node_types`` are
``underlay/simple.py``'s (the engine reads ``connection_matrix`` here).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch.underlay.simple import (channel_table,
                                               connection_matrix,
                                               node_types, send_with_delay)

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
NS = 1_000_000_000


@dataclasses.dataclass(frozen=True)
class InetUnderlayParams:
    """InetUnderlay.ned / ReaSEUnderlay.ned and omnetpp.ini's
    accessRouterNum (JAX field names and defaults)."""

    topology: str = "inet"             # "inet" | "rease"
    routers: int = 16
    transit: int = 4                   # rease: transit-core size
    link_delay: float = 0.010          # per backbone link (s)
    access_delay_min: float = 0.001    # terminal to access router
    access_delay_max: float = 0.020
    jitter: float = 0.1
    send_queue_bytes: int = 1_000_000
    channel_types: tuple = ("simple_ethernetline",)
    header_bytes: int = 28
    num_node_types: int = 1
    type_boundaries: tuple = ()
    partition_events: tuple = ()

    def channel_table(self, device):
        return channel_table(self.channel_types, device)


def _apsp(adj: np.ndarray) -> np.ndarray:
    """All-pairs shortest paths (Floyd-Warshall) over a delay matrix."""
    d = adj.copy()
    for k in range(d.shape[0]):
        d = np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
    return d


def build_topology(seed: int, p: InetUnderlayParams) -> np.ndarray:
    """[R, R] float32 router-to-router delay matrix (host side, init
    only)."""
    r = p.routers
    rs = np.random.RandomState(seed)
    adj = np.full((r, r), 1e9, np.float64)
    np.fill_diagonal(adj, 0.0)

    def link(i, j, mult=1.0):
        d = p.link_delay * mult
        adj[i, j] = min(adj[i, j], d)
        adj[j, i] = min(adj[j, i], d)

    if p.topology == "rease":
        t = min(p.transit, r)
        # transit core: a full mesh of short links (AS core peering)
        for i in range(t):
            for j in range(i + 1, t):
                link(i, j, 0.5)
        # stubs: preferential attachment to the core, one stub peer
        for i in range(t, r):
            link(i, int(rs.randint(0, t)))
            if i > t:
                link(i, int(rs.randint(t, i)), 2.0)
    else:
        # flat backbone: a ring and 2-nearest-neighbor links
        pos = rs.uniform(0.0, 1.0, (r, 2))
        for i in range(r):
            link(i, (i + 1) % r)
        for i in range(r):
            d2 = np.sum((pos - pos[i]) ** 2, axis=1)
            d2[i] = np.inf
            for j in np.argsort(d2)[:2]:
                link(i, int(j))
    return _apsp(adj).astype(np.float32)


@dataclasses.dataclass
class InetUnderlayState:
    router: torch.Tensor       # [N] i32 access router per node
    access: torch.Tensor       # [N] f32 terminal to router delay (s)
    channel: torch.Tensor      # [N] i32 index into channel_table
    tx_finished: torch.Tensor  # [N] i64
    node_type: torch.Tensor    # [N] i32
    rr_delay: torch.Tensor     # [R, R] f32 backbone delay matrix


def _draw_access(rng, n, p):
    return rng_mod.uniform(rng, (n,), F32, p.access_delay_min,
                           p.access_delay_max)


def init(rng, n: int, p: InetUnderlayParams) -> InetUnderlayState:
    dev = rng.device
    keys = rng_mod.split(rng, 4)
    rk, ak, ck, tk = keys[0], keys[1], keys[2], keys[3]
    # the topology seed: JAX's default (x64) int64 draw, read on the
    # host once (init only)
    seed = int(rng_mod.randint(tk, (), 0, 2 ** 31 - 1, I64))
    rr = torch.as_tensor(build_topology(seed, p), device=dev)
    return InetUnderlayState(
        router=rng_mod.randint(rk, (n,), 0, p.routers, I32),
        access=_draw_access(ak, n, p),
        channel=rng_mod.randint(ck, (n,), 0, len(p.channel_types), I32),
        tx_finished=torch.zeros((n,), dtype=I64, device=dev),
        node_type=node_types(n, p, dev),
        rr_delay=rr)


def migrate(state: InetUnderlayState, mask, rng,
            p: InetUnderlayParams) -> InetUnderlayState:
    """Re-home created nodes on a fresh access router
    (InetUnderlayConfigurator::migrateNode re-runs addOverlayNode)."""
    n = state.router.shape[0]
    keys = rng_mod.split(rng)
    router = torch.where(mask, rng_mod.randint(keys[0], (n,), 0, p.routers,
                                               I32), state.router)
    access = torch.where(mask, _draw_access(keys[1], n, p), state.access)
    return dataclasses.replace(
        state, router=router, access=access,
        tx_finished=torch.where(mask, 0, state.tx_finished))


def send_batch(state: InetUnderlayState, p: InetUnderlayParams, rng, src,
               dst, size_bytes, t_send, want, alive, kind=None):
    """``underlay/simple.py send_batch``'s contract over the routed path:
    (t_deliver [N, M] i64, ok [N, M] bool, state', drop counts)."""
    del kind

    def total_ns(queue_ns, ch, dstl, tbl, rx_delay):
        # routed-path propagation: access + backbone shortest path + access
        router = state.router.long()
        backbone = state.rr_delay[router[:, None], router[dstl]]
        prop = state.access[:, None] + backbone + state.access[dstl]
        return queue_ns + ((prop + rx_delay) * NS).to(I64)

    return send_with_delay(state, p, rng, src, dst, size_bytes, t_send,
                           want, alive, total_ns)


# strategy-module aliases (engine/sim.py reads <module>.UnderlayParams)
UnderlayParams = InetUnderlayParams
UnderlayState = InetUnderlayState
