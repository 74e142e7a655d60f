"""Analytic underlay network model (SimpleUnderlay, PyTorch).

Counterpart of ``oversim_tpu/underlay/simple.py``.  Every node has a 2-D
coordinate and a channel; a packet's delay is

    send-queue carry + tx bandwidth delay + tx access delay
    + 0.001 * euclidean(coords_src, coords_dst)
    + rx bandwidth delay + rx access delay  (+ half-normal jitter)

computed for the whole ``[N, MOUT]`` outbox at once, with the JAX
package's float32 operation order (no fused multiply-add).  Ported: the
uniform coordinate field, channel drops, queue overruns, dead
destinations, jitter and node-type partitions (GlobalNodeList's
connectionMatrix: slots split into ``num_node_types`` types at
``type_boundaries``, a static schedule of one-directional
CONNECT/DISCONNECT_NODETYPES events replayed at each send, and the
``partition_lost`` drop, SimpleUDP.cc:349-358).  Coordinate pools,
PlanetLab delay faults and SimpleTCP are still to be ported and raise.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
NS = 1_000_000_000
T_MAX = 2 ** 62

CHANNELS = {
    "simple_ethernetline": (10e6, 0.0, 0.0),
    "simple_ethernetline_lossy": (10e6, 0.0, 1e-5),
    "simple_dsl": (1e6, 0.020, 0.0),
    "simple_dsl_lossy": (1e6, 0.020, 1e-5),
}


@dataclasses.dataclass(frozen=True)
class UnderlayParams:
    """default.ini:545-563 (JAX field names and defaults)."""

    dims: int = 2
    field_size: float = 150.0
    coord_source: str = ""
    coord_delay_per_unit: float = 0.001
    use_coordinate_based_delay: bool = True
    constant_delay: float = 0.050
    jitter: float = 0.1
    send_queue_bytes: int = 1_000_000
    channel_types: tuple = ("simple_ethernetline",)
    header_bytes: int = 28
    delay_fault_type: str = ""
    tcp_kinds: tuple = ()
    tcp_connection_cache: int = 8
    num_node_types: int = 1
    type_boundaries: tuple = ()
    partition_events: tuple = ()

    def channel_table(self, device):
        return channel_table(self.channel_types, device)

    def check_ported(self):
        if self.coord_source or self.delay_fault_type or self.tcp_kinds:
            raise NotImplementedError(
                "coordinate pools (nodeCoordinateSource), delay faults and "
                "SimpleTCP are not ported yet (ROADMAP Queue A 7a)")


def channel_table(channel_types, device):
    """[C, 3] f32 (bandwidth, access delay, bit-error rate) per channel
    type."""
    # fills, not a host-to-device copy (which would synchronise)
    return torch.stack([torch.stack([
        torch.full((), float(v), dtype=F32, device=device) for v in
        CHANNELS[c]]) for c in channel_types])


def node_types(n: int, p: UnderlayParams, device="cpu"):
    """[N] i32 node type per slot from the static boundaries."""
    idx = torch.arange(n, device=device)
    t = torch.zeros((n,), dtype=I32, device=device)
    for b in p.type_boundaries:
        t = t + (idx >= b).to(I32)
    return torch.clamp(t, 0, p.num_node_types - 1)


@dataclasses.dataclass
class UnderlayState:
    coords: torch.Tensor       # [N, D] f32
    channel: torch.Tensor      # [N] i32
    tx_finished: torch.Tensor  # [N] i64
    node_type: torch.Tensor    # [N] i32
    tcp_conn: torch.Tensor     # [N, Ct] i32


def _draw_coords(rng, n: int, p: UnderlayParams):
    return rng_mod.uniform(rng, (n, p.dims), F32, 0.0, p.field_size)


def init(rng, n: int, p: UnderlayParams) -> UnderlayState:
    p.check_ported()
    dev = rng.device
    ck, xk = rng_mod.split(rng)
    return UnderlayState(
        coords=_draw_coords(xk, n, p),
        channel=rng_mod.randint(ck, (n,), 0, len(p.channel_types), I32),
        tx_finished=torch.zeros((n,), dtype=I64, device=dev),
        node_type=node_types(n, p, dev),
        tcp_conn=torch.full((n, 0), -1, dtype=I32, device=dev))


def migrate(state: UnderlayState, mask, rng, p: UnderlayParams):
    """Redraw coordinates for masked nodes (node create)."""
    n = state.coords.shape[0]
    new_coords = _draw_coords(rng, n, p)
    return dataclasses.replace(
        state,
        coords=torch.where(mask[:, None], new_coords, state.coords),
        tx_finished=torch.where(mask, 0, state.tx_finished))


def connection_matrix(p: UnderlayParams, t_now):
    """[T, T] bool connectivity at simulated time ``t_now`` (i64 ns
    scalar), replayed from the schedule: fully connected, then each event
    at or before ``t_now`` sets its one direction (a full split names
    both)."""
    t = p.num_node_types
    conn = torch.ones((t * t,), dtype=torch.bool, device=t_now.device)
    for (ts, a, b, connect) in p.partition_events:
        en = int(ts * NS) <= t_now
        i = a * t + b
        conn = torch.cat([conn[:i], torch.where(en, bool(connect),
                                                conn[i:i + 1]),
                          conn[i + 1:]])
    return conn.reshape(t, t)


def send_batch(state: UnderlayState, p: UnderlayParams, rng, src, dst,
               size_bytes, t_send, want, alive, kind=None):
    """Deliver times and drop decisions for an ``[N, M]`` outbox batch:
    (t_deliver [N, M] i64, ok [N, M] bool, state', drop counts)."""
    del kind

    def total_ns(queue_ns, ch, dstl, tbl, rx_delay):
        if not p.use_coordinate_based_delay:
            return torch.full(src.shape, int(p.constant_delay * NS),
                              dtype=I64, device=src.device)
        tx_access = tbl[ch, 1][:, None]
        rx_access = tbl[ch[dstl], 1]
        d = state.coords[:, None, :] - state.coords[dstl]
        # float32 adds, left to right, as XLA reduces (torch.sum would
        # accumulate in double on the CPU); the root is taken in float64
        # and rounded once, which is the correctly rounded float32 root
        # (PyTorch's CPU float32 sqrt is not, XLA's is)
        sq = d * d
        acc = sq[..., 0]
        for k in range(1, sq.shape[-1]):
            acc = acc + sq[..., k]
        dist = torch.sqrt(acc.to(torch.float64)).to(F32)
        coord_delay = p.coord_delay_per_unit * dist
        return queue_ns + (
            (tx_access + coord_delay + rx_delay + rx_access) * NS).to(I64)

    return send_with_delay(state, p, rng, src, dst, size_bytes, t_send,
                           want, alive, total_ns)


def send_with_delay(state, p, rng, src, dst, size_bytes, t_send, want,
                    alive, total_ns_fn):
    """``send_batch``'s body for any underlay whose state has ``channel``,
    ``tx_finished`` and ``node_type``: the sender queue, jitter, bit
    errors, dead destinations and partitions.  ``total_ns_fn(queue_ns,
    ch, dstl, tbl, rx_delay)`` gives the [N, M] i64 delay before jitter
    from the sender-queue carry, the senders' channels, the wrapped
    destination rows, the channel table and the rx serialization delay
    (f32 seconds), in the underlay's own float order."""
    dev = src.device
    tbl = p.channel_table(dev)
    ch = state.channel.long()
    # a disabled lane may carry any payload word as its destination
    # (Koorde's and Broose's ext words): wrap and clamp it as the JAX
    # package's gathers do, so it reads a real row
    n = ch.shape[0]
    dstl = dst.long()
    dstl = torch.clamp(torch.where(dstl < 0, dstl + n, dstl), 0, n - 1)
    bits = (size_bytes + p.header_bytes) * 8
    bits_f = bits.to(F32)
    tx_bw = tbl[ch, 0][:, None]
    tx_ber = tbl[ch, 2][:, None]
    rx_bw = tbl[ch[dstl], 0]
    rx_ber = tbl[ch[dstl], 2]

    self_send = src == dst
    queued = want & ~self_send
    bw_delay_ns = torch.where(queued, bits_f / tx_bw * NS, 0.0).to(I64)
    start0 = torch.maximum(state.tx_finished[:, None], t_send)
    finish = start0 + torch.cumsum(bw_delay_ns, 1)
    max_queue_ns = (torch.full((), float(p.send_queue_bytes * 8), dtype=F32,
                               device=dev) / tx_bw * NS).to(I64)
    overrun = queued & (finish - t_send > max_queue_ns)
    sent = queued & ~overrun
    new_tx_finished = torch.where(
        torch.any(sent, 1), torch.max(torch.where(sent, finish, 0), 1).values,
        state.tx_finished)

    total_ns = total_ns_fn(finish - t_send, ch, dstl, tbl, bits_f / rx_bw)
    if p.jitter > 0:
        jit = torch.abs(rng_mod.normal(rng, src.shape, F32))
        total_ns = total_ns + (jit * p.jitter * total_ns.to(F32)).to(I64)

    one = torch.ones((), dtype=F32, device=dev)
    bit_err_p = one - torch.pow(one - tx_ber, bits_f) * torch.pow(
        one - rx_ber, bits_f)
    u = rng_mod.uniform(rng_mod.fold_in(rng, 1), src.shape, F32)
    bit_error = queued & (u < bit_err_p)
    dest_dead = want & ~alive[dstl]
    if p.partition_events:
        # the matrix at the batch's earliest send (SimpleUDP's check)
        t0 = torch.min(torch.where(want, t_send, T_MAX))
        conn = connection_matrix(p, t0)
        nt = state.node_type.long()
        part_cut = want & ~conn[nt[src.long()], nt[dstl]]
    else:
        part_cut = torch.zeros_like(want)
    ok = want & ~overrun & ~bit_error & ~dest_dead & ~part_cut
    t_deliver = torch.where(self_send, t_send, t_send + total_ns)
    drops = {
        "queue_lost": torch.sum(overrun & want),
        "bit_error_lost": torch.sum(bit_error),
        "dest_unavailable_lost": torch.sum(dest_dead),
        "partition_lost": torch.sum(part_cut),
    }
    return (t_deliver, ok,
            dataclasses.replace(state, tx_finished=new_tx_finished), drops)
