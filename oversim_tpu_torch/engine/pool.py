"""Global bounded message pool (PyTorch counterpart of engine/pool.py).

All in-flight messages live in one structure of arrays of P slots: the
``[P]`` valid mask, the two int64 times and ONE ``[P, W]`` int32 block
holding every 32-bit field (``SCAL_COLS``, then the key lanes bitcast
to int32, then the ``rmax`` node list).  Each tick:

* the due messages are grouped by destination into an ``[N, R]`` index
  table ordered by ``(t_deliver, pool index)`` — ``build_inbox_scatter``
  (R rounds of scatter-min, the oracle) or the hand-written CUDA kernel
  ``kernels.inbox.inbox_select_gather`` (``impl="pallas"``);
* delivered slots are freed and the tick's outbox is written into free
  slots — the j-th wanted message takes the j-th free slot, from two
  exclusive prefix sums or from ``kernels.outbox.alloc_dest``.

Every scatter here has unique targets or is an ``amin`` reduction, so the
results are deterministic on the card.
"""

from __future__ import annotations

import dataclasses

import torch

I32 = torch.int32
I64 = torch.int64
T_INF = 2 ** 62
NO_NODE = -1
M32 = 0xFFFFFFFF

SCAL_COLS = ("src", "dst", "kind", "nonce", "hops", "a", "b", "c", "d",
             "size_b")
_COL = {name: i for i, name in enumerate(SCAL_COLS)}

def key_to_i32(key):
    """u32 lanes held in int64 → their int32 bit pattern."""
    return key.to(I32)


def key_from_i32(lanes):
    """int32 bit pattern → u32 lanes held in int64."""
    return lanes.to(I64) & M32


@dataclasses.dataclass
class MsgPool:
    """Packed pool: [P] masks/times + one [P, W] int32 payload block."""

    valid: torch.Tensor      # [P] bool
    t_deliver: torch.Tensor  # [P] i64 ns
    stamp: torch.Tensor      # [P] i64 ns
    blk: torch.Tensor        # [P, W] i32
    kl: int = dataclasses.field(default=5, metadata=dict(static=True))
    rmax: int = dataclasses.field(default=8, metadata=dict(static=True))

    @property
    def capacity(self):
        return self.valid.shape[0]

    @property
    def dst(self):
        return self.blk[:, _COL["dst"]]

    @property
    def kind(self):
        return self.blk[:, _COL["kind"]]


def pack_block(out: dict, kl: int, rmax: int):
    """Field dict ([Q]-leading tensors) → the [Q, W] int32 block."""
    cols = [out[name].to(I32)[:, None] for name in SCAL_COLS]
    cols.append(key_to_i32(out["key"]).reshape(-1, kl))
    cols.append(out["nodes"].to(I32).reshape(-1, rmax))
    return torch.cat(cols, dim=1)


def empty(p: int, key_lanes: int, rmax: int, device="cpu") -> MsgPool:
    w = len(SCAL_COLS) + key_lanes + rmax
    blk = torch.zeros((p, w), dtype=I32, device=device)
    blk[:, _COL["src"]] = NO_NODE
    blk[:, _COL["dst"]] = NO_NODE
    blk[:, len(SCAL_COLS) + key_lanes:] = NO_NODE
    return MsgPool(
        valid=torch.zeros((p,), dtype=torch.bool, device=device),
        t_deliver=torch.full((p,), T_INF, dtype=I64, device=device),
        stamp=torch.zeros((p,), dtype=I64, device=device),
        blk=blk, kl=key_lanes, rmax=rmax)


def next_deliver_time(pool: MsgPool):
    """Earliest pending deliver time (i64 scalar; T_INF when empty)."""
    return torch.min(torch.where(pool.valid, pool.t_deliver, T_INF))


def due_masks(pool: MsgPool, n: int, t_end, alive, hold=None):
    """(due, to_dead) [P] masks shared by every inbox implementation."""
    due = pool.valid & (pool.t_deliver < t_end)
    if hold is not None:
        due = due & ~hold
    to_dead = due & ~alive[torch.clamp(pool.dst, 0, n - 1).long()]
    return due & ~to_dead, to_dead


def build_inbox_sort(pool: MsgPool, n: int, r: int, t_end, alive,
                     hold=None):
    """Oracle grouping by one stable lexicographic (dst, t_deliver) sort."""
    p = pool.capacity
    dev = pool.valid.device
    due, to_dead = due_masks(pool, n, t_end, alive, hold)
    dst_k = torch.where(due, pool.dst.long(), n)
    t_k = torch.where(due, pool.t_deliver, T_INF)
    o1 = torch.sort(t_k, stable=True).indices
    o2 = torch.sort(dst_k[o1], stable=True).indices
    idx_s = o1[o2]
    dst_s = dst_k[idx_s]
    first = torch.searchsorted(dst_s, dst_s, side="left")
    rank = torch.arange(p, device=dev) - first
    take = (dst_s < n) & (rank < r)
    inbox = torch.full((n, r), NO_NODE, dtype=I32, device=dev)
    inbox[dst_s[take], rank[take]] = idx_s[take].to(I32)
    delivered = torch.zeros((p,), dtype=torch.bool, device=dev)
    delivered[idx_s] = take
    return inbox, delivered, to_dead


def build_inbox_scatter(pool: MsgPool, n: int, r: int, t_end, alive,
                        hold=None):
    """Zero-sort grouping: R rounds of deterministic scatter-min.

    Round k takes each destination's minimum remaining due ``t_deliver``
    (``scatter_reduce("amin")``), then the minimum pool index among the
    messages at that time, and masks the winners out — the stable
    ``(t_deliver, idx)`` order, in O(R·P)."""
    p = pool.capacity
    dev = pool.valid.device
    due, to_dead = due_masks(pool, n, t_end, alive, hold)
    idx = torch.arange(p, dtype=I64, device=dev)
    dstc = torch.clamp(pool.dst, 0, n - 1).long()
    tkey = torch.where(due, pool.t_deliver, T_INF)
    cols = []
    delivered = torch.zeros((p,), dtype=torch.bool, device=dev)
    for _ in range(r):
        min_t = torch.full((n,), T_INF, dtype=I64, device=dev).scatter_reduce(
            0, dstc, tkey, reduce="amin")
        cand = (tkey < T_INF) & (tkey == min_t[dstc])
        win = torch.full((n,), p, dtype=I64, device=dev).scatter_reduce(
            0, dstc, torch.where(cand, idx, p), reduce="amin")
        cols.append(torch.where(win < p, win, NO_NODE))
        is_win = cand & (idx == win[dstc])
        delivered = delivered | is_win
        tkey = torch.where(is_win, T_INF, tkey)
    return torch.stack(cols, dim=1).to(I32), delivered, to_dead


def build_inbox(pool: MsgPool, n: int, r: int, t_end, alive,
                impl: str = "scatter", hold=None):
    """``[N, R]`` inbox index table (-1 empty), delivered [P], to_dead [P].

    ``impl``: ``"scatter"`` (the torch-ops oracle, default), ``"pallas"``
    (the hand-written CUDA selection kernel; the name is kept so a JAX
    configuration carries over unchanged) or ``"sort"``."""
    if impl == "sort":
        return build_inbox_sort(pool, n, r, t_end, alive, hold)
    if impl == "scatter":
        return build_inbox_scatter(pool, n, r, t_end, alive, hold)
    if impl == "pallas":
        from oversim_tpu_torch.kernels import inbox as inbox_k
        inbox, delivered, to_dead, _ = inbox_k.fused_inbox(
            pool, n, r, t_end, alive, hold)
        return inbox, delivered, to_dead
    raise ValueError(f"unknown inbox_impl: {impl!r} "
                     "(expected 'scatter', 'pallas' or 'sort')")


def free(pool: MsgPool, mask) -> MsgPool:
    return dataclasses.replace(
        pool, valid=pool.valid & ~mask,
        t_deliver=torch.where(mask, T_INF, pool.t_deliver))


def alloc_dest_cumsum(valid, want):
    """The oracle destination mapping: (dest [Q] i32, overflow i64)."""
    p = valid.shape[0]
    dev = valid.device
    n_want = torch.sum(want.to(I64))
    free_ = ~valid
    n_free = torch.sum(free_.to(I64))
    free_i = free_.to(I64)
    free_rank = torch.cumsum(free_i, 0) - free_i
    want_i = want.to(I64)
    want_rank = torch.cumsum(want_i, 0) - want_i
    # compact free-slot list; non-free slots land in the spare entry p
    fslot = torch.full((p + 1,), p, dtype=I64, device=dev).scatter_reduce(
        0, torch.where(free_, free_rank, p),
        torch.arange(p, device=dev), reduce="amin")
    dest = torch.where(want & (want_rank < n_free),
                       fslot[torch.clamp(want_rank, max=p - 1)], p)
    overflow = torch.clamp(n_want - n_free, min=0)
    return dest.to(I32), overflow


def alloc(pool: MsgPool, out: dict, want, impl: str = "scatter"):
    """Write the outbox into free slots: (pool', overflow i64 scalar).

    ``impl="pallas"`` maps messages to slots with the hand-written CUDA
    kernel (``kernels.outbox.alloc_dest``); otherwise the cumsum oracle.
    The payload write is shared and runs as a gather: the inverse map
    slot -> message is one ``amax`` scatter (wanted messages have unique
    slots; dropped ones land in the spare entry p), so it is
    deterministic and needs no host sync."""
    p = pool.capacity
    dev = pool.valid.device
    if impl == "pallas":
        from oversim_tpu_torch.kernels import outbox as outbox_k
        dest, overflow = outbox_k.alloc_dest(pool.valid, want)
    else:
        dest, overflow = alloc_dest_cumsum(pool.valid, want)
    q = dest.shape[0]
    inv = torch.full((p + 1,), -1, dtype=I64, device=dev).scatter_reduce(
        0, dest.long(), torch.arange(q, device=dev), reduce="amax")[:p]
    hit = inv >= 0
    src = torch.clamp(inv, min=0)
    out_blk = pack_block(out, pool.kl, pool.rmax)
    return dataclasses.replace(
        pool,
        blk=torch.where(hit[:, None], out_blk[src], pool.blk),
        t_deliver=torch.where(hit, out["t_deliver"].to(I64)[src],
                              pool.t_deliver),
        stamp=torch.where(hit, out["stamp"].to(I64)[src], pool.stamp),
        valid=pool.valid | hit), overflow.to(I64)
