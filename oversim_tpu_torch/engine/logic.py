"""Per-node logic scaffolding: message views, outbox builder, tick context.

Counterpart of ``oversim_tpu/engine/logic.py``.  The JAX package writes a
logic's step for ONE node and vmaps it; the port writes it batched over a
leading ``[N]`` axis: a per-node scalar becomes an ``[N]`` tensor, a
per-node ``[R]`` array an ``[N, R]`` tensor, and the global tables of
``Ctx`` (node keys, alive, ready) stay unbatched.

Logic interface (duck-typed; see engine/sim.py):

  key_spec, stat_spec(), init(rng, n), reset(state, clear, join, t_now,
  rng), ready_mask(state), next_event(state) -> [N] i64, and
  step(ctx, state, msgs, rngs [N, 2], node_idx [N], *, outbox_slots,
  rmax) -> (state, Outbox, events) — all over the whole node axis.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod
from oversim_tpu_torch import tree

I32 = torch.int32
I64 = torch.int64
NO_NODE = -1


@dataclasses.dataclass
class Msg:
    """Batched view of inbox messages: every field is ``[N, R, ...]``."""

    valid: torch.Tensor
    t_deliver: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    kind: torch.Tensor
    key: torch.Tensor        # [N, R, KL] u32 lanes in int64
    nonce: torch.Tensor
    hops: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    nodes: torch.Tensor      # [N, R, rmax] i32
    size_b: torch.Tensor
    stamp: torch.Tensor

    def slot(self, r: int) -> "Msg":
        """Inbox slot r of every node (fields lose their R axis)."""
        return tree.tree_map(lambda x: x[:, r], self)


@dataclasses.dataclass
class Ctx:
    """Broadcast tick context (global tables, not batched per node)."""

    t_start: torch.Tensor      # i64 scalar
    t_end: torch.Tensor        # i64 scalar
    keys: torch.Tensor         # [N, KL]
    alive: torch.Tensor        # [N] bool
    ready: torch.Tensor        # [N] bool
    ready_cumsum: torch.Tensor  # [N] i32
    n_ready: torch.Tensor      # i32 scalar
    measuring: torch.Tensor    # bool scalar
    glob: object = None
    leaving: object = None
    graceful: object = None
    malicious: object = None
    node_type: object = None
    conn: object = None
    ready_cum_t: object = None
    ov: object = None

    def ov_get(self, name, default=None):
        if self.ov is None:
            return default
        return self.ov.get(name, default)

    def sample_ready(self, rng, me=None):
        """One uniformly random READY slot per key in ``rng`` ([..., 2]),
        -1 when none is ready (searchsorted over the ready cumsum).

        With partitions (``conn`` set) and ``me`` ([...] the drawing
        nodes' slots), each draw is restricted to the node types
        connected to its node's type (GlobalNodeList's per-type bootstrap
        vectors): a type by the connected types' ready counts, then a
        slot within it.  The per-type cumsums ``ready_cum_t`` [T, N] are
        searched as one nondecreasing vector (row t offset by t (N + 1)),
        so no row is gathered per node."""
        if self.conn is not None and me is not None:
            return self._sample_ready_typed(rng, me)
        k = rng_mod.randint(rng, (), 0, torch.clamp(self.n_ready, min=1),
                            dtype=I32)
        idx = torch.searchsorted(self.ready_cumsum, (k + 1).contiguous(),
                                 side="left").to(I32)
        return torch.where(self.n_ready > 0, idx, NO_NODE)

    def _sample_ready_typed(self, rng, me):
        cum_rows = self.ready_cum_t                      # [T, N] i32
        nt, n = cum_rows.shape
        allowed = self.conn[self.node_type[me.long()].long()]   # [..., T]
        counts = cum_rows[:, -1]
        eff = torch.where(allowed, counts, 0)
        total = torch.sum(eff, -1, dtype=I32)
        k = rng_mod.randint(rng, (), 0, torch.clamp(total, min=1),
                            dtype=I32)
        cum_t = torch.cumsum(eff, -1, dtype=I32)
        tpick = torch.searchsorted(cum_t, (k + 1)[..., None].contiguous(),
                                   side="left")
        tpick = torch.clamp(tpick, 0, nt - 1)
        below = torch.gather(cum_t, -1, torch.clamp(tpick - 1, min=0))
        within = (k[..., None] - torch.where(tpick > 0, below, 0))[..., 0]
        tpick = tpick[..., 0]
        off = torch.arange(nt, dtype=I64, device=cum_rows.device) * (n + 1)
        flat = (cum_rows.to(I64) + off[:, None]).reshape(-1)
        pos = torch.searchsorted(flat, (within.to(I64) + 1 + tpick * (n + 1))
                                 .contiguous(), side="left")
        idx = (pos - tpick * n).to(I32)
        return torch.where(total > 0, idx, NO_NODE)


class Outbox:
    """Append-only batched message emitter.

    ``send`` records a batch of B candidate messages per node (``en``
    ``[N]`` for one, ``[N, B]`` for B); field values are python scalars,
    per-node ``[N]`` tensors or per-lane ``[N, B]`` tensors (keys
    ``[N, KL]`` / ``[N, B, KL]``, node lists ``[N, r]`` / ``[N, B, r]``).
    ``finish`` compacts each node's enabled sends, in call order, into
    its first slots with one stable argsort — the JAX Outbox's layout,
    disabled-lane contents included."""

    def __init__(self, n: int, m: int, key_lanes: int, rmax: int, device):
        self.n = n
        self.m = m
        self.key_lanes = key_lanes
        self.rmax = rmax
        self.device = device
        self._en = []
        self._rows = []
        self._consts = {}

    def _lanes(self, v, b, dt, lane_dims=0):
        """Broadcast a field value to ``[N, B, *lane]``."""
        if not isinstance(v, torch.Tensor):
            # a fill, not a host-to-device copy (which would synchronise),
            # made once per value and dtype for all of the step's sends
            key = (v, dt)
            if key not in self._consts:
                self._consts[key] = torch.full((), v, dtype=dt,
                                               device=self.device)
            v = self._consts[key]
        v = v.to(dt)
        if v.dim() == 0:
            return v.expand(self.n, b)
        if v.dim() == 1 + lane_dims:
            v = v.unsqueeze(1)
        return v.expand((self.n, b) + tuple(v.shape[2:]))

    def send(self, en, t_send, dst, kind, *, key=None, nonce=0, hops=0,
             a=0, b=0, c=0, d=0, nodes=None, size_b=40, stamp=0):
        if not isinstance(en, torch.Tensor):
            en = torch.full((self.n,), bool(en), device=self.device)
        if en.dim() == 1:
            en = en.unsqueeze(1)
        bdim = en.shape[1]
        if key is not None:
            key = self._lanes(key, bdim, I64, 1)
        if nodes is not None:
            nodes = self._lanes(nodes, bdim, I32, 1)
            if nodes.shape[-1] > self.rmax:
                raise ValueError("node-list payload exceeds RMAX")
        self._en.append(en)
        f = self._lanes
        self._rows.append(dict(
            t_send=f(t_send, bdim, I64), dst=f(dst, bdim, I32),
            kind=f(kind, bdim, I32), key=key, nonce=f(nonce, bdim, I32),
            hops=f(hops, bdim, I32), a=f(a, bdim, I32), b=f(b, bdim, I32),
            c=f(c, bdim, I32), d=f(d, bdim, I32), nodes=nodes,
            size_b=f(size_b, bdim, I32), stamp=f(stamp, bdim, I64)))

    def finish(self):
        """Returns (fields dict of [N, M, ...], valid [N, M], overflow [N])."""
        n, m, dev = self.n, self.m, self.device
        s = sum(int(e.shape[1]) for e in self._en)
        if s == 0:
            z32 = torch.zeros((n, m), dtype=I32, device=dev)
            fields = dict(
                t_send=torch.zeros((n, m), dtype=I64, device=dev),
                dst=z32, kind=z32,
                key=torch.zeros((n, m, self.key_lanes), dtype=I64,
                                device=dev),
                nonce=z32, hops=z32, a=z32, b=z32, c=z32, d=z32,
                nodes=torch.full((n, m, self.rmax), NO_NODE, dtype=I32,
                                 device=dev),
                size_b=z32, stamp=torch.zeros((n, m), dtype=I64, device=dev))
            return (fields, torch.zeros((n, m), dtype=torch.bool, device=dev),
                    torch.zeros((n,), dtype=I32, device=dev))
        en = torch.cat([e.to(I64) for e in self._en], dim=1)     # [N, S]
        slots = torch.cumsum(en, 1) - en
        order_key = torch.where(en > 0, slots, s)
        src = torch.sort(order_key, dim=1, stable=True).indices[:, :m]
        n_sent = torch.sum(en, 1)

        def pick(name, fill):
            rows = []
            for e, r in zip(self._en, self._rows):
                v = r[name]
                bb = int(e.shape[1])
                if name == "key" and v is None:
                    v = torch.zeros((n, bb, self.key_lanes), dtype=I64,
                                    device=dev)
                elif name == "nodes":
                    if v is None:
                        v = torch.full((n, bb, self.rmax), NO_NODE,
                                       dtype=I32, device=dev)
                    elif v.shape[-1] < self.rmax:
                        v = torch.cat([v, torch.full(
                            v.shape[:-1] + (self.rmax - v.shape[-1],),
                            NO_NODE, dtype=I32, device=dev)], dim=-1)
                rows.append(v)
            stacked = torch.cat(rows, dim=1)                     # [N, S, ...]
            ix = src.reshape(src.shape + (1,) * (stacked.dim() - 2))
            out = torch.gather(stacked, 1, ix.expand(
                (n, src.shape[1]) + tuple(stacked.shape[2:])))
            pad = m - out.shape[1]
            if pad > 0:
                out = torch.cat([out, torch.full(
                    (n, pad) + tuple(out.shape[2:]), fill, dtype=out.dtype,
                    device=dev)], dim=1)
            return out

        fields = dict(
            t_send=pick("t_send", 0), dst=pick("dst", 0),
            kind=pick("kind", 0), key=pick("key", 0),
            nonce=pick("nonce", 0), hops=pick("hops", 0),
            a=pick("a", 0), b=pick("b", 0), c=pick("c", 0), d=pick("d", 0),
            nodes=pick("nodes", NO_NODE), size_b=pick("size_b", 0),
            stamp=pick("stamp", 0))
        valid = torch.arange(m, device=dev)[None, :] < n_sent[:, None]
        overflow = torch.clamp(n_sent - m, min=0).to(I32)
        return fields, valid, overflow


def keys_of(ctx, slots):
    """[...] node slots → [..., KL] keys; NO_NODE and payload words of
    other kinds clamp at both ends, as the JAX package's gathers do."""
    return ctx.keys[torch.clamp(slots, 0, ctx.keys.shape[0] - 1).long()]


def first_true(mask):
    """Index of the first True along the last axis (0 when none): JAX's
    ``argmax`` of a bool, through int32 (torch's argmax takes no bool)."""
    return torch.argmax(mask.to(I32), -1)


def one_hot(idx, width: int):
    """``idx`` [...] → [..., width] bool, True at each index."""
    return torch.arange(width, device=idx.device) == idx[..., None]


def bcast(pred, x):
    """Right-pad ``pred``'s shape with singleton dims up to ``x``'s rank."""
    while pred.dim() < x.dim():
        pred = pred.unsqueeze(-1)
    return pred


def select_tree(pred, a, b):
    """Per-node predicated merge of two state trees (pred [N])."""
    return tree.tree_map(lambda x, y: torch.where(bcast(pred, x), x, y), a, b)


def take(x, idx):
    """Per-node gather along axis 1: ``x`` [N, A, *rest], ``idx`` [N, *I]
    (any int dtype, in [0, A)) → [N, *I, *rest] (``x_n[idx_n]``)."""
    n, a = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    ishape = tuple(idx.shape[1:])
    flat = idx.reshape(n, -1).long()
    xf = x.reshape(n, a, -1)
    out = torch.gather(xf, 1, flat[:, :, None].expand(n, flat.shape[1],
                                                       xf.shape[2]))
    return out.reshape((n,) + ishape + rest)


def put(x, idx, val, en):
    """Per-node masked scatter along axis 1 (``.at[idx].set(val,
    mode="drop")`` with the dropped lanes masked off by ``en``).

    ``x`` [N, A, *rest], ``idx``/``en`` [N, K], ``val`` a scalar or
    broadcastable to [N, K, *rest].  Runs as a gather: the inverse map
    target -> lane is one ``amax`` scatter, so a repeated target takes
    the last enabled lane's value, deterministically."""
    n, a = x.shape[0], x.shape[1]
    k_dim = idx.shape[1]
    rest = tuple(x.shape[2:])
    dev = x.device
    tgt = torch.where(en, idx.long(), a)
    lanes = torch.arange(k_dim, device=dev).expand(n, k_dim)
    inv = torch.full((n, a + 1), -1, dtype=I64, device=dev).scatter_reduce(
        1, tgt, lanes, reduce="amax")[:, :a]
    hit = inv >= 0
    val = rng_mod.device_scalar(val, x.dtype, dev)
    if val.dim():
        val = take(torch.broadcast_to(val, (n, k_dim) + rest).contiguous(),
                   torch.clamp(inv, min=0))
    return torch.where(bcast(hit, x), val, x)


def put2(x, row, col, val, en):
    """``put`` on a per-node 2-D table ``x`` [N, A, B, *rest] at
    (``row``, ``col``) [N, K]."""
    n, a, b = x.shape[0], x.shape[1], x.shape[2]
    rest = tuple(x.shape[3:])
    flat = row.long() * b + col.long()
    out = put(x.reshape((n, a * b) + rest), flat, val, en)
    return out.reshape(x.shape)
